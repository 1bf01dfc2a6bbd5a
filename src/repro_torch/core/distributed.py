"""Distributed PASS build and serving helpers on a shard layout; the port
of ``repro/core/distributed.py``.

The reference shards rows, queries or sample slots over a device mesh
(``"data"`` x ``"model"``) with ``shard_map`` and merges with ``psum``.
The port takes a :class:`~repro_torch.sharded.mesh.ShardMesh` of the same
named axes on one device: each block runs in turn, and each ``psum`` /
``pmin`` / ``pmax`` is a fold over the blocks in block order
(:func:`repro_torch.sharded.merge.fold`).

Build (paper §3.2 at cluster scale): rows are dealt over the data axes;
each block's per-leaf aggregates come from row 5 (``segment_reduce``) and
fold into one (k, 5) result, SUM/SUMSQ/COUNT added and MIN/MAX combined
(the mergeable-summaries property). The merged bytes are O(k).

Serve, two modes:
  * :func:`serve_queries_sharded`: the synopsis serves whole (it is O(K)
    small); the query batch is cut into one block per mesh position, each
    answered through ``PassEngine``.
  * :func:`serve_samples_sharded`: the per-leaf samples are cut on the
    ``"model"`` axis; each block's moments (row 2) fold before the
    estimator epilogue.
"""
from __future__ import annotations

import math

import torch

from .. import minmax
from ..kernels import ops
from ..sharded.merge import fold
from ..sharded.mesh import ShardMesh
from .types import AGG_COUNT, AGG_SUM, QueryBatch, REL_PARTIAL, Synopsis


def local_leaf_aggregates(values: torch.Tensor, assign: torch.Tensor,
                          k: int) -> torch.Tensor:
    """(k, 5) aggregates of one block's rows: row 5 on a CUDA tensor."""
    return ops.segment_reduce(values.to(torch.float32),
                              assign.to(torch.int32), k)


def build_leaf_aggregates(mesh: ShardMesh, values, assign, k: int,
                          data_axes=("data",)) -> torch.Tensor:
    """Global (k, 5) leaf aggregates over rows dealt in contiguous blocks
    over the product of ``data_axes``, on the mesh's device. A ragged tail
    is padded with id -1 (dropped by row 5)."""
    axes = (data_axes,) if isinstance(data_axes, str) else tuple(data_axes)
    blocks = math.prod(mesh.shape[ax] for ax in axes)
    v = torch.as_tensor(values, device=mesh.device).to(torch.float32)
    ids = torch.as_tensor(assign, device=mesh.device).to(torch.int32)
    v, ids = v.reshape(-1), ids.reshape(-1)
    v = pad_to(v, blocks)
    ids = pad_to(ids, blocks, fill=-1)
    parts = torch.stack([local_leaf_aggregates(vb, ib, k) for vb, ib in
                         zip(v.chunk(blocks), ids.chunk(blocks))])
    return torch.cat([fold(parts[:, :, 0:3]),
                      fold(parts[:, :, 3:4], minmax.minimum),
                      fold(parts[:, :, 4:5], minmax.maximum)], 1)


def serve_queries_sharded(mesh: ShardMesh, syn: Synopsis,
                          queries: QueryBatch, kind: str = "sum",
                          lam: float = 2.576):
    """shard_queries mode: the synopsis serves whole, the query batch is
    cut into ``mesh.size`` blocks answered one after another by one
    ``PassEngine`` on the mesh's device. Q pads up to a multiple of the
    mesh size with zero (point) queries, whose rows are sliced off.
    Returns (estimate, ci_half, lower, upper), each (Q,)."""
    from ..api import PassEngine, ServingConfig
    eng = PassEngine(syn, serving=ServingConfig(kinds=(kind,), lam=lam),
                     device=mesh.device)
    q = queries.num_queries
    n_dev = mesh.size
    q_lo = pad_to(queries.lo.to(mesh.device), n_dev)
    q_hi = pad_to(queries.hi.to(mesh.device), n_dev)
    outs = []
    for lo, hi in zip(q_lo.chunk(n_dev), q_hi.chunk(n_dev)):
        res = eng.answer(QueryBatch(lo, hi))[kind]
        outs.append((res.estimate, res.ci_half, res.lower, res.upper))
    return tuple(torch.cat(col)[:q] for col in zip(*outs))


def serve_samples_sharded(mesh: ShardMesh, syn: Synopsis,
                          queries: QueryBatch, kind: str = "sum",
                          lam: float = 2.576, sample_axis: str = "model"):
    """shard_samples mode: every stratum's sample slots are cut into
    ``mesh.shape[sample_axis]`` blocks (the slot axis padded with invalid
    slots to a multiple); row 2 runs on each block and the moments fold in
    block order; row 1 classifies the leaves; the estimator epilogue runs
    on the folded moments. Returns (estimate, ci_half), each (Q,): the
    moment-based estimates only (the hard bounds are aggregate-only and
    equal to the whole-synopsis path's)."""
    if kind not in ("sum", "count"):
        raise ValueError("shard_samples serves sum/count")
    dev = mesh.device
    blocks = mesh.shape[sample_axis]
    q_lo = queries.lo.to(dev, torch.float32).contiguous()
    q_hi = queries.hi.to(dev, torch.float32).contiguous()
    sc = pad_to(syn.sample_c.to(dev, torch.float32), blocks, axis=1)
    sa = pad_to(syn.sample_a.to(dev, torch.float32), blocks, axis=1)
    sv = pad_to(syn.sample_valid.to(dev), blocks, axis=1, fill=False)
    mom = torch.stack([torch.stack(ops.stratified_moments(c, a, v, q_lo,
                                                          q_hi))
                       for c, a, v in zip(sc.chunk(blocks, 1),
                                          sa.chunk(blocks, 1),
                                          sv.chunk(blocks, 1))])
    kp, sm, sq = fold(mom).unbind(0)                      # each (Q, k)
    rel, exact = ops.query_eval(syn.leaf_lo.to(dev), syn.leaf_hi.to(dev),
                                syn.leaf_agg.to(dev, torch.float32),
                                q_lo, q_hi)
    partf = (rel == REL_PARTIAL).to(torch.float32)
    ni = syn.n_rows.to(dev, torch.float32)[None]
    ki = torch.clamp(syn.k_per_leaf.to(dev), min=1).to(torch.float32)[None]
    if kind == "sum":
        est = exact[:, AGG_SUM] + torch.sum(partf * ni / ki * sm, 1)
        var_phi = ni * ni * minmax.max0(sq / ki - (sm / ki) ** 2)
    else:
        est = exact[:, AGG_COUNT] + torch.sum(partf * ni / ki * kp, 1)
        p = kp / ki
        var_phi = ni * ni * minmax.max0(p - p * p)
    ci = lam * torch.sqrt(torch.sum(partf * var_phi / ki, 1))
    return est, ci


def pad_to(x: torch.Tensor, mult: int, axis: int = 0, fill=0
           ) -> torch.Tensor:
    """``x`` padded along ``axis`` with ``fill`` up to a multiple of
    ``mult``; ``x`` itself when it already is one."""
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_full(shape, fill)], axis)


__all__ = ["local_leaf_aggregates", "build_leaf_aggregates",
           "serve_queries_sharded", "serve_samples_sharded", "pad_to"]
