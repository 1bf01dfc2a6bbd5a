"""`JoinSynopsis`: a PASS synopsis augmented for approximate fk-joins
(DESIGN.md §13); the port of ``repro/joins/synopsis.py``.

The base fact synopsis keeps its partition tree, exact leaf aggregates
and stratified sample; the join augmentation adds, per leaf stratum:

* a **universe sample** on the declared fk key (``universe.universe_mask``
  with the shared ``key_root``), stored row-wise with the pre-joined
  dimension attributes, so serving never touches the dimension relation;
* **pre-joined cell aggregates** ``cell_agg[(leaf, dim partition)]``:
  exact [SUM, SUMSQ, COUNT, MIN, MAX] of the fact measure over each
  (fact stratum x dim partition) cell. Cells whose fact leaf and dim
  partition are both covered by a join query are answered exactly from
  them; overlapping cells fall to the Horvitz-Thompson estimate over the
  universe sample.

The build is host float64 numpy, step for step the reference's, with the
membership decision drawn on ``device`` (``key_root`` is the port's
``PRNGKey(seed)``); every buffer and ``cell_agg`` equal the reference's on
the same inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import random as trandom
from ..core.synopsis import partition_assign, synopsis_from_assignment
from ..core.types import (Synopsis, QueryBatch, NUM_AGGS, AGG_SUM,
                          AGG_SUMSQ, AGG_COUNT, AGG_MIN, AGG_MAX, _to)
from ..device import resolve_device, to_numpy
from .dim import DimTable
from .universe import universe_mask

JOIN_KINDS = ("sum", "count", "avg")


@dataclasses.dataclass
class JoinSynopsis:
    """Fact synopsis + fk universe samples + pre-joined cell aggregates.

    ``cell_agg`` (k, P, NUM_AGGS) f32: exact fact-measure aggregates per
    (leaf stratum, dim partition) cell. Universe sample per stratum
    (capacity ``su`` slots, masked by ``u_valid``): coords ``u_c`` (k, su,
    d_fact) f32, measure ``u_a`` (k, su) f32, fk ``u_key`` (k, su) int32,
    pre-joined dim attrs ``u_dattr`` (k, su, d_dim) f32, dim partition
    ``u_part`` (k, su) int32 (-1: key absent from the dim side).
    ``u_count`` (k,) int32 filled slots; ``u_overflow`` (k,) int32
    universe rows dropped for capacity (those strata lose the HT
    unbiasedness, so their sampled cells take the deterministic fallback).
    ``key_root`` is the shared threefry root of the key universe, a (2,)
    int64 key (``repro_torch.random``); ``p_u`` the key inclusion
    probability.
    """
    base: Synopsis
    dim: DimTable
    cell_agg: torch.Tensor
    u_c: torch.Tensor
    u_a: torch.Tensor
    u_key: torch.Tensor
    u_dattr: torch.Tensor
    u_part: torch.Tensor
    u_valid: torch.Tensor
    u_count: torch.Tensor
    u_overflow: torch.Tensor
    key_root: torch.Tensor
    p_u: float
    key_name: str

    # -- structure ----------------------------------------------------------
    @property
    def num_leaves(self) -> int:
        return self.base.num_leaves

    @property
    def num_partitions(self) -> int:
        return self.dim.num_partitions

    @property
    def d_fact(self) -> int:
        return self.base.d

    @property
    def d_dim(self) -> int:
        return self.dim.d_attr

    @property
    def u_capacity(self) -> int:
        return self.u_a.shape[1]

    @property
    def device(self) -> torch.device:
        return self.cell_agg.device

    def to(self, device) -> "JoinSynopsis":
        return dataclasses.replace(_to(self, device),
                                   base=self.base.to(device),
                                   dim=self.dim.to(device))

    # -- serving hooks ------------------------------------------------------
    def as_synopsis(self) -> Synopsis:
        """Single-table serving view: the unchanged base synopsis."""
        return self.base

    def as_join_synopsis(self) -> "JoinSynopsis":
        return self


def join_queries(fact: QueryBatch, dim: QueryBatch) -> QueryBatch:
    """The join rectangle over ``[fact coords ‖ dim attrs]``: fact-side and
    dim-side rectangles concatenated column-wise, float32, on the fact
    batch's device."""
    if fact.lo.shape[0] != dim.lo.shape[0]:
        raise ValueError(
            f"fact/dim query counts differ: {fact.lo.shape[0]} vs "
            f"{dim.lo.shape[0]}")

    def t(x, like=None):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        x = x.to(torch.float32)
        return x if like is None else x.to(like.device)

    f_lo, f_hi = t(fact.lo), t(fact.hi)
    return QueryBatch(torch.cat([f_lo, t(dim.lo, f_lo)], 1),
                      torch.cat([f_hi, t(dim.hi, f_hi)], 1))


def resolve_join_synopsis(source) -> JoinSynopsis:
    """A :class:`JoinSynopsis`, or the join view of a source that exposes
    ``as_join_synopsis()`` (a ``JoinStreamingIngestor``)."""
    if hasattr(source, "as_join_synopsis"):
        return source.as_join_synopsis()
    raise TypeError(
        "join serving needs a JoinSynopsis source (build_join_synopsis) "
        "or a source exposing as_join_synopsis() such as "
        f"JoinStreamingIngestor; got {type(source).__name__}")


def build_join_synopsis(c, a, keys, dim: DimTable, *, k: int = 64,
                        p_u: float = 0.1, u_capacity: int | None = None,
                        key_name: str = "fk", seed: int = 0,
                        sample_budget: int | None = None,
                        sample_rate: float | None = 0.005,
                        kind: str = "sum", method: str = "adp",
                        opt_samples: int = 4096, delta_frac: float = 0.01,
                        allocation: str = "equal", device=None
                        ) -> tuple[JoinSynopsis, dict]:
    """Build a join-augmented PASS synopsis over fact rows (c, a, keys) on
    ``device`` (None = the CUDA card).

    The partitioning and sampling knobs are
    :func:`~repro_torch.core.synopsis.build_synopsis`'s (the base synopsis
    comes from the same assignment). ``p_u`` is the key-universe inclusion
    probability; ``u_capacity`` caps universe rows per stratum (default:
    what the build needs, so no overflow). Returns (synopsis, report).
    """
    if not 0.0 < p_u <= 1.0:
        raise ValueError(f"p_u must be in (0, 1], got {p_u}")
    dev = resolve_device(device)
    c2 = np.asarray(c, dtype=np.float64)
    if c2.ndim == 1:
        c2 = c2[:, None]
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    keys = np.asarray(keys).reshape(-1).astype(np.int64)
    n, d = c2.shape
    if keys.shape[0] != n:
        raise ValueError(f"keys rows {keys.shape[0]} != fact rows {n}")
    if sample_budget is None:
        sample_budget = int(np.ceil((sample_rate or 0.005) * n))

    assign, k, _vmax = partition_assign(
        c2, a, k=k, method=method, kind=kind, opt_samples=opt_samples,
        delta_frac=delta_frac, seed=seed)
    base, _info = synopsis_from_assignment(
        c2, a, assign, k, sample_budget=sample_budget,
        allocation=allocation, seed=seed + 1, device=dev)

    # fk -> dim partition / attrs: the host mirror of dim_lookup
    dkeys = to_numpy(dim.key_sorted).astype(np.int64)
    dparts = to_numpy(dim.part_sorted).astype(np.int32)
    dattrs = to_numpy(dim.attr_sorted).astype(np.float64)
    P, d_d = dim.num_partitions, dim.d_attr
    idx = np.clip(np.searchsorted(dkeys, keys), 0, dkeys.size - 1)
    found = dkeys[idx] == keys
    part = np.where(found, dparts[idx], -1).astype(np.int64)

    # Pre-joined exact cell aggregates on host f64.
    cell = assign.astype(np.int64) * P + part
    agg = np.zeros((k * P, NUM_AGGS), dtype=np.float64)
    agg[:, AGG_MIN] = np.inf
    agg[:, AGG_MAX] = -np.inf
    cj, aj = cell[found], a[found]
    np.add.at(agg[:, AGG_SUM], cj, aj)
    np.add.at(agg[:, AGG_SUMSQ], cj, aj * aj)
    np.add.at(agg[:, AGG_COUNT], cj, 1.0)
    np.minimum.at(agg[:, AGG_MIN], cj, aj)
    np.maximum.at(agg[:, AGG_MAX], cj, aj)

    # Universe membership: the one decision function of both sides.
    key_root = trandom.PRNGKey(seed, dev)
    member = to_numpy(universe_mask(key_root, keys, p_u)) & found
    counts = np.bincount(assign[member], minlength=k).astype(np.int64)
    su = int(u_capacity) if u_capacity is not None \
        else max(int(counts.max()) if counts.size else 1, 1)
    su = max(su, 1)

    midx = np.flatnonzero(member)
    leaves = assign[midx]
    order = np.argsort(leaves, kind="stable")
    midx, leaves = midx[order], leaves[order]
    occ = np.arange(midx.size) - np.searchsorted(leaves, leaves)
    keep = occ < su
    overflow = np.bincount(leaves[~keep], minlength=k).astype(np.int32)
    mi, lv, oc = midx[keep], leaves[keep], occ[keep]

    u_c = np.zeros((k, su, d), np.float32)
    u_a = np.zeros((k, su), np.float32)
    u_key = np.zeros((k, su), np.int32)
    u_dattr = np.zeros((k, su, d_d), np.float32)
    u_part = np.full((k, su), -1, np.int32)
    u_valid = np.zeros((k, su), bool)
    u_c[lv, oc] = c2[mi]
    u_a[lv, oc] = a[mi]
    u_key[lv, oc] = keys[mi]
    u_dattr[lv, oc] = dattrs[idx[mi]]
    u_part[lv, oc] = part[mi]
    u_valid[lv, oc] = True

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    jsyn = JoinSynopsis(
        base=base, dim=dim.to(dev),
        cell_agg=t(agg.reshape(k, P, NUM_AGGS).astype(np.float32)),
        u_c=t(u_c), u_a=t(u_a), u_key=t(u_key), u_dattr=t(u_dattr),
        u_part=t(u_part), u_valid=t(u_valid),
        u_count=t(np.minimum(counts, su).astype(np.int32)),
        u_overflow=t(overflow), key_root=key_root, p_u=float(p_u),
        key_name=str(key_name))
    report = {
        "k": k, "num_partitions": P, "p_u": float(p_u), "u_capacity": su,
        "universe_rows": int(keep.sum()),
        "universe_overflow": int((~keep).sum()),
        "unmatched_fact_rows": int((~found).sum()),
        "nonempty_cells": int((agg[:, AGG_COUNT] > 0).sum()),
    }
    return jsyn, report


__all__ = ["JoinSynopsis", "build_join_synopsis", "join_queries",
           "resolve_join_synopsis", "JOIN_KINDS"]
