"""O(k) merge of the sharded state (DESIGN.md §11); the port of
``repro/sharded/merge.py``.

The PASS aggregates are mergeable summaries, so the combine across shards
is a sum of the (k, 3) additive columns, a MIN/MAX of the extremes and
boxes, and a gather that reassembles the per-shard reservoir slices into
the (k, S) serving arrays. The reference does this with ``psum``,
``pmin`` / ``pmax`` and a tiled ``all_gather`` over the mesh; with every
shard on one device each becomes a fixed-order operation over the leading
axis:

* a sum is the left fold ``x[0] + x[1] + ... + x[D-1]`` in shard order
  (``torch.sum(dim=0)`` on the card would sum in the reduction's order);
* MIN and MAX are the same fold through :mod:`repro_torch.minmax`, which
  keeps XLA's signed-zero bits;
* the gather is ``transpose(0, 1).reshape(k, D * ss, ...)``, the inverse
  of ``init_sharded_state``'s split.

The gathered single-device state then goes through the single-device
:func:`~repro_torch.streaming.delta.merge_synopsis`, so the serving
epilogue is the same program at every D, and the merged sample shape
(k, S) does not depend on the shard count.
"""
from __future__ import annotations

import operator

import torch

from .. import minmax
from ..core.types import Synopsis
from ..streaming.delta import merge_synopsis
from ..streaming.ingest import StreamState
from .mesh import ShardMesh, num_shards


def fold(x: torch.Tensor, op=operator.add) -> torch.Tensor:
    """``op`` folded over the leading axis from the left, in index order:
    ``op(...op(op(x[0], x[1]), x[2])..., x[D-1])``."""
    out = x[0]
    for i in range(1, x.shape[0]):
        out = op(out, x[i])
    return out


def gather_state(state: StreamState) -> StreamState:
    """Sharded (D, ...) state -> the global single-device StreamState."""
    D, k, ss = state.sample_a.shape
    delta = state.delta_agg

    def tile(x):
        return x.transpose(0, 1).reshape(k, D * ss, *x.shape[3:])

    return StreamState(
        leaf_lo=fold(state.leaf_lo, minmax.minimum),
        leaf_hi=fold(state.leaf_hi, minmax.maximum),
        delta_agg=torch.cat([fold(delta[:, :, 0:3]),
                             fold(delta[:, :, 3:4], minmax.minimum),
                             fold(delta[:, :, 4:5], minmax.maximum)], 1),
        sample_c=tile(state.sample_c), sample_a=tile(state.sample_a),
        sample_valid=tile(state.sample_valid),
        k_per_leaf=fold(state.k_per_leaf), seen=fold(state.seen),
        oob=fold(state.oob), quarantined=fold(state.quarantined))


def merge_sharded(base: Synopsis, state: StreamState, subtree, *,
                  total_rows, mesh: ShardMesh) -> Synopsis:
    """Serving synopsis = base merged with the gathered sharded delta."""
    if state.sample_a.shape[0] != num_shards(mesh):
        raise ValueError(
            f"state has {state.sample_a.shape[0]} shards, the mesh "
            f"{num_shards(mesh)}")
    return merge_synopsis(base, gather_state(state), subtree,
                          total_rows=total_rows)


__all__ = ["merge_sharded", "gather_state", "fold"]
