"""Dynamic updates (paper §4.5): per-row insertions with reservoir sampling.

Each inserted row updates, in O(height) time: the exact aggregates of its
leaf and of every ancestor (SUM/SUMSQ/COUNT exactly; MIN/MAX
monotonically), the leaf's data bounding box, and, with reservoir
probability, one slot of the leaf's stratified sample. Estimates remain
statistically consistent for SUM/COUNT/AVG (Vitter [41]).

This host-side per-row path is the *legacy/reference* implementation, a
float64 numpy copy of the JAX package's, draw for draw: it re-uploads the
whole synopsis on every ``snapshot()`` and loops Python per row. The
serving hot path lives in :mod:`repro_torch.streaming`: vectorized batched
inserts through the ``segment_reduce`` (and, in d > 1, ``route_multid``)
kernels, delta-merge on the card, and the drift-triggered
re-optimization; ``to_streaming()`` bridges an updatable synopsis onto it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import to_numpy
from .types import Synopsis, AGG_SUM, AGG_SUMSQ, AGG_COUNT, AGG_MIN, AGG_MAX


def _f64(x) -> np.ndarray:
    return to_numpy(x).astype(np.float64)


class UpdatableSynopsis:
    """Host-side mutable wrapper around an immutable :class:`Synopsis`.

    Inserts mutate float64 numpy buffers; ``snapshot()`` re-materializes
    the immutable float32 synopsis on the wrapped synopsis's device.
    """

    def __init__(self, syn: Synopsis, seed: int = 0):
        self.device = syn.device
        self.leaf_lo = _f64(syn.leaf_lo)
        self.leaf_hi = _f64(syn.leaf_hi)
        self.leaf_agg = _f64(syn.leaf_agg)
        self.sample_c = _f64(syn.sample_c)
        self.sample_a = _f64(syn.sample_a)
        self.sample_valid = to_numpy(syn.sample_valid).copy()
        self.k_per_leaf = to_numpy(syn.k_per_leaf).copy()
        self.seen = self.leaf_agg[:, AGG_COUNT].astype(np.int64).copy()
        self.tree_agg = _f64(syn.tree.agg)
        self.tree_lo = _f64(syn.tree.lo)
        self.tree_hi = _f64(syn.tree.hi)
        self._tpl = syn
        self.rng = np.random.default_rng(seed)
        self.total_rows = int(syn.total_rows)
        self.inserts_since_build = 0
        # leaf node ids in the (heap-layout) tree
        leaf_id = to_numpy(syn.tree.leaf_id)
        self.leaf_node = np.full(syn.num_leaves, -1, dtype=np.int64)
        for v, lid in enumerate(leaf_id):
            if 0 <= lid < syn.num_leaves:
                self.leaf_node[lid] = v

    def _route(self, c_row: np.ndarray) -> int:
        """Leaf whose box contains (or is nearest to) the row."""
        inside = np.all((self.leaf_lo <= c_row) & (c_row <= self.leaf_hi),
                        axis=1)
        hit = np.where(inside)[0]
        if hit.size:
            return int(hit[0])
        # outside every box (new value range): nearest box by L1 distance
        d = (np.maximum(self.leaf_lo - c_row, 0)
             + np.maximum(c_row - self.leaf_hi, 0)).sum(axis=1)
        d = np.where(np.all(self.leaf_lo <= self.leaf_hi, axis=1), d, np.inf)
        return int(np.argmin(d))

    def insert(self, c_row, a_val: float):
        c_row = np.atleast_1d(np.asarray(c_row, dtype=np.float64))
        leaf = self._route(c_row)
        # exact aggregate + box maintenance, leaf -> root
        self.leaf_agg[leaf, AGG_SUM] += a_val
        self.leaf_agg[leaf, AGG_SUMSQ] += a_val * a_val
        self.leaf_agg[leaf, AGG_COUNT] += 1
        self.leaf_agg[leaf, AGG_MIN] = min(self.leaf_agg[leaf, AGG_MIN], a_val)
        self.leaf_agg[leaf, AGG_MAX] = max(self.leaf_agg[leaf, AGG_MAX], a_val)
        self.leaf_lo[leaf] = np.minimum(self.leaf_lo[leaf], c_row)
        self.leaf_hi[leaf] = np.maximum(self.leaf_hi[leaf], c_row)
        v = int(self.leaf_node[leaf])
        while v >= 0:
            self.tree_agg[v, AGG_SUM] += a_val
            self.tree_agg[v, AGG_SUMSQ] += a_val * a_val
            self.tree_agg[v, AGG_COUNT] += 1
            self.tree_agg[v, AGG_MIN] = min(self.tree_agg[v, AGG_MIN], a_val)
            self.tree_agg[v, AGG_MAX] = max(self.tree_agg[v, AGG_MAX], a_val)
            self.tree_lo[v] = np.minimum(self.tree_lo[v], c_row)
            self.tree_hi[v] = np.maximum(self.tree_hi[v], c_row)
            v = (v - 1) // 2 if v > 0 else -1
        # reservoir (Vitter): uniform leaf sample under inserts
        self.seen[leaf] += 1
        cap = self.sample_c.shape[1]
        kl = int(self.k_per_leaf[leaf])
        if kl < cap:
            slot = kl
            self.k_per_leaf[leaf] = kl + 1
        else:
            j = int(self.rng.integers(0, self.seen[leaf]))
            slot = -1 if j >= cap else j
        if slot >= 0:
            self.sample_c[leaf, slot] = c_row
            self.sample_a[leaf, slot] = a_val
            self.sample_valid[leaf, slot] = True
        self.total_rows += 1
        self.inserts_since_build += 1

    def insert_batch(self, c_rows, a_vals):
        """Per-row loop (legacy). For bulk ingest use
        ``repro_torch.streaming.StreamingIngestor.ingest``: one vectorized
        device pass per batch instead of B Python iterations."""
        c_rows = np.asarray(c_rows, dtype=np.float64)
        if c_rows.ndim == 1:
            c_rows = c_rows[:, None]
        for i in range(c_rows.shape[0]):
            self.insert(c_rows[i], float(a_vals[i]))

    def to_streaming(self, *, seed: int = 0, backend: str | None = None):
        """Bridge to the batched subsystem: a ``StreamingIngestor``
        anchored on this synopsis's current snapshot (aggregates, boxes and
        reservoir state carry over; later ingest is vectorized on the
        snapshot's device). ``backend`` must be None."""
        from ..streaming import StreamingIngestor
        if backend is not None:
            raise ValueError(f"backend={backend!r}: repro_torch has no named "
                             "backends, so backend must be None")
        return StreamingIngestor(self.snapshot(), seed=seed,
                                 device=self.device)

    def staleness(self) -> float:
        """Fraction of rows inserted since the last (re)build: the signal
        a split-and-merge re-optimization policy would threshold."""
        return self.inserts_since_build / max(self.total_rows, 1)

    def snapshot(self) -> Synopsis:
        """The immutable float32 synopsis of the current state, uploaded to
        the wrapped synopsis's device."""
        t, dev = self._tpl, self.device

        def f32(x):
            return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dev)

        return dataclasses.replace(
            t,
            leaf_lo=f32(self.leaf_lo), leaf_hi=f32(self.leaf_hi),
            leaf_agg=f32(self.leaf_agg),
            n_rows=f32(self.leaf_agg[:, AGG_COUNT]),
            sample_c=f32(self.sample_c), sample_a=f32(self.sample_a),
            sample_valid=torch.from_numpy(self.sample_valid.copy()).to(dev),
            k_per_leaf=torch.from_numpy(
                self.k_per_leaf.astype(np.int32)).to(dev),
            tree=dataclasses.replace(
                t.tree, agg=f32(self.tree_agg), lo=f32(self.tree_lo),
                hi=f32(self.tree_hi)),
            total_rows=f32(np.float32(self.total_rows)))


__all__ = ["UpdatableSynopsis"]
