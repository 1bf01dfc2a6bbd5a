"""Data-parallel streaming ingest over a shard axis (DESIGN.md §11); the
port of ``repro/sharded/ingest.py``.

The sharded state is one :class:`~repro_torch.streaming.ingest.StreamState`
whose every field carries a leading shard axis D: each shard owns its
delta aggregates, its leaf boxes and its own Vitter reservoir slice of
every stratum. A batch is dealt into D contiguous row blocks and each
block goes through the single-device state transition (``_ingest_core``
or ``_apply_routed``) on its own shard, in shard order. On one card the
shards run one after another: each launches row 5 (``segment_reduce``)
once, and row 7 (``route_multid``) once where it routes in d > 1. Rows are
never gathered across shards; the only cross-shard step is the O(k) merge
at serve time (:mod:`repro_torch.sharded.merge`).

Two steps share the single-device transition:

* :func:`_ingest_step`, live-box routing (the streaming rule), for
  serving-phase ingest on an already-built base;
* :func:`_build_step`, routing against a *static* cut skeleton (1-D
  thresholds or stretched KD tiling boxes). The skeleton never moves, so
  the row -> leaf assignment does not depend on the shard count, which is
  what keeps the data-parallel build's per-leaf aggregates bit-stable
  across D on integer-valued data.

Each shard's rows go through their own row-5 launch. Folding the D shards
into one launch with offset ids would change each shard's float bits: row
5's summation order is fixed by the row count and k alone.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.types import AGG_COUNT, Synopsis
from ..device import to_numpy
from ..kernels import ops
from ..streaming.ingest import (STATE_FIELDS, StreamState, _apply_routed,
                                _f32, _ingest_core, empty_delta_agg,
                                quarantine_mask)
from ..testing import faults as _faults
from .. import random as trandom
from .mesh import ShardMesh, data_mesh, num_shards, split_rows

# Containment policy for failed shard dispatches: retry with exponential
# backoff, then drop the batch and count it (tests patch these down).
DISPATCH_RETRIES = 4
DISPATCH_BACKOFF_S = 0.001


def init_sharded_state(base: Synopsis, n_shards: int) -> StreamState:
    """Stacked (D, ...) per-shard delta states anchored on one base, on the
    base's device.

    Boxes and the (empty) delta replicate per shard; the base's stratified
    sample splits into D contiguous slot blocks (shard i owns slots
    ``[i*ss, (i+1)*ss)`` of every stratum, the exact inverse of the merge's
    gather), after padding the slot axis (invalid) to a multiple of D.
    A fresh base's validity is a per-stratum prefix, so each block's is
    too. The Vitter denominator ``seen`` splits as ``kpl_shard +
    fair_share(seen - kpl)``: every shard has ``seen >= filled`` and the
    shards' total is the base count exactly.
    """
    D = int(n_shards)
    k, d = base.num_leaves, base.d
    dev = base.device
    sc = base.sample_c.to(torch.float32)
    sa = base.sample_a.to(torch.float32)
    sv = base.sample_valid.to(torch.bool)
    s = sc.shape[1]
    pad = (-s) % D
    if pad:
        sc = torch.cat([sc, sc.new_zeros((k, pad, d))], 1)
        sa = torch.cat([sa, sa.new_zeros((k, pad))], 1)
        sv = torch.cat([sv, sv.new_zeros((k, pad))], 1)
    ss = (s + pad) // D
    sc = sc.reshape(k, D, ss, d).transpose(0, 1).contiguous()
    sa = sa.reshape(k, D, ss).transpose(0, 1).contiguous()
    sv = sv.reshape(k, D, ss).transpose(0, 1).contiguous()

    kpl_g = base.k_per_leaf.to(torch.int32)                     # (k,)
    block = torch.arange(D, dtype=torch.int32, device=dev)[:, None]
    kpl = torch.clamp(kpl_g[None, :] - block * ss, 0, ss)       # (D, k)
    seen_g = base.leaf_agg[:, AGG_COUNT].to(torch.float32).to(torch.int32)
    extra = torch.clamp(seen_g - kpl_g, min=0)                  # (k,)
    extra_i = (torch.div(extra[None, :], D, rounding_mode="floor")
               + (block < extra[None, :] % D).to(torch.int32))

    def rep(x):
        return x[None].expand(D, *x.shape).clone()

    return StreamState(
        leaf_lo=rep(base.leaf_lo.to(torch.float32)),
        leaf_hi=rep(base.leaf_hi.to(torch.float32)),
        delta_agg=rep(empty_delta_agg(k, dev)),
        sample_c=sc, sample_a=sa, sample_valid=sv,
        k_per_leaf=kpl.to(torch.int32),
        seen=(kpl + extra_i).to(torch.int32),
        oob=torch.zeros((D,), dtype=torch.int32, device=dev),
        quarantined=torch.zeros((D,), dtype=torch.int32, device=dev))


def shard_state(state: StreamState, i: int) -> StreamState:
    """Shard i's single-device state (views into the stacked fields)."""
    return StreamState(**{f: getattr(state, f)[i] for f in STATE_FIELDS})


def stack_states(states: list) -> StreamState:
    """Per-shard states, in shard order -> the stacked (D, ...) state."""
    return StreamState(**{f: torch.stack([getattr(s, f) for s in states])
                          for f in STATE_FIELDS})


def route_static(route_lo, route_hi, c):
    """Rows against a static cut skeleton: (leaf (B,) int32, distance (B,)
    f32). 1-D skeletons are threshold intervals: ``searchsorted(side=
    "right")``, a tie at a cut going to the upper leaf, as the host
    build assigns; KD skeletons tile R^d with outer faces at +-BIG, so
    every row is contained and row 7's lowest-id tie-break decides. Both
    are independent of the shard count and of the ingestion order."""
    if c.shape[1] == 1:
        leaf = torch.searchsorted(route_lo[1:, 0].contiguous(),
                                  c[:, 0].contiguous(), right=True)
        return (leaf.to(torch.int32),
                torch.zeros(c.shape[0], dtype=torch.float32,
                            device=c.device))
    return ops.route_multid(route_lo, route_hi, c)


def _ingest_step(state, csh, ash, keys, mask, qlo, qhi) -> StreamState:
    """Streaming-phase step: live per-shard box routing, shard by shard.
    ``keys`` (D, 2) holds each shard's threefry subkey."""
    bs = ash.shape[1]
    return stack_states([
        _ingest_core(shard_state(state, i), csh[i], ash[i],
                     trandom.uniform(keys[i], (bs,)), mask=mask[i],
                     qlo=qlo, qhi=qhi)
        for i in range(ash.shape[0])])


def _build_step(state, csh, ash, keys, mask, route_lo, route_hi, qlo,
                qhi) -> StreamState:
    """Build-phase step: each shard routes against the static skeleton
    (:func:`route_static`), quarantined rows masked out and routed from
    zeros, then the shared transition."""
    out = []
    for i in range(ash.shape[0]):
        cb, ab, mb = csh[i], ash[i], mask[i]
        bad = quarantine_mask(cb, ab, qlo, qhi)
        n_quar = (bad & mb).sum().to(torch.int32)
        mb = mb & ~bad
        cb = torch.where(bad[:, None], 0.0, cb)
        u = trandom.uniform(keys[i], (ab.shape[0],))
        leaf, dsel = route_static(route_lo, route_hi, cb)
        out.append(_apply_routed(shard_state(state, i), cb, ab, u, leaf,
                                 dsel, mb, n_quar=n_quar))
    return stack_states(out)


class ShardedIngestor:
    """Data-parallel drop-in for :class:`StreamingIngestor` (DESIGN.md §11).

    Same front end (``ingest()``, ``as_synopsis()``, ``epoch``, drift
    signals), so :class:`~repro_torch.api.PassEngine` and
    :class:`~repro_torch.streaming.policy.DriftPolicy` consume it
    unchanged. The state carries a leading shard axis of ``mesh``'s
    ``"shards"`` size, on the mesh's device (``mesh=None``: a
    ``data_mesh`` on ``device``, None = the CUDA card); ``as_synopsis()``
    runs the O(k) merge. ``route_boxes`` switches routing to a static cut
    skeleton (the build phase); ``commit()`` folds the merged result in as
    the new immutable base and returns to live-box streaming.
    """

    def __init__(self, base: Synopsis, *, mesh: ShardMesh | None = None,
                 seed: int = 0, key=None, route_boxes: tuple | None = None,
                 quarantine_box: tuple | None = None, device=None):
        from ..streaming.delta import subtree_leaf_matrix
        self.mesh = mesh if mesh is not None else data_mesh(device=device)
        self.device = self.mesh.device
        self.n_shards = num_shards(self.mesh)
        self.base = base.to(self.device)
        self._subtree = subtree_leaf_matrix(self.base.tree,
                                            self.base.num_leaves)
        self._key = (trandom.PRNGKey(seed, self.device) if key is None
                     else torch.tensor(to_numpy(key).astype(np.int64),
                                       device=self.device))
        self.state = init_sharded_state(self.base, self.n_shards)
        self._route = None
        if route_boxes is not None:
            self._route = tuple(_f32(x, self.device) for x in route_boxes)
        # The quarantine box is always (d,) tensors; +-inf means the
        # non-finite checks only.
        if quarantine_box is not None:
            self._qlo, self._qhi = (_f32(x, self.device).reshape(-1)
                                    for x in quarantine_box)
        else:
            d = self.base.d
            self._qlo = torch.full((d,), -np.inf, device=self.device)
            self._qhi = torch.full((d,), np.inf, device=self.device)
        self.n_stream = 0
        self._base_rows = int(self.base.total_rows)
        self._epoch = 0
        self._merged: Synopsis | None = None
        self._fault_stats = {"dispatch_retries": 0, "dropped_batches": 0,
                             "poisoned_batches": 0}

    @property
    def epoch(self) -> int:
        """Monotone merge epoch (see ``StreamingIngestor.epoch``)."""
        return self._epoch

    @property
    def shard_capacity(self) -> int:
        """Per-shard reservoir slots per stratum."""
        return self.state.sample_a.shape[-1]

    # -- ingestion ---------------------------------------------------------
    def ingest(self, c_rows, a_vals) -> "ShardedIngestor":
        """Deal a (B, d) batch into per-shard blocks and ingest them, shard
        by shard. Each shard draws from its own threefry subkey, so a
        seeded run is deterministic for a fixed shard count (other counts
        draw other reservoirs: the invariants across D are on
        aggregates, not samples). Nothing is read back to the host."""
        inj = _faults.active()
        if inj is not None:
            c_rows, a_vals, poisoned = inj.poison_batch(
                to_numpy(c_rows).astype(np.float32),
                to_numpy(a_vals).astype(np.float32))
            self._fault_stats["poisoned_batches"] += int(poisoned)
        c = _f32(c_rows, self.device)
        if c.dim() == 1:
            c = c.reshape(-1, 1)
        a = _f32(a_vals, self.device).reshape(-1)
        b = a.shape[0]
        csh, ash, mask = split_rows(c, a, self.n_shards)
        # The key splits before dispatch, so a retried dispatch draws the
        # very same per-shard subkeys: a transient shard failure that
        # recovers is bit-identical to a clean run.
        keys = trandom.split(self._key, self.n_shards + 1)
        self._key = keys[0]
        new_state = self._dispatch(csh, ash, keys[1:], mask, inj)
        if new_state is None:                  # dropped after the retries
            self._fault_stats["dropped_batches"] += 1
            return self
        self.state = new_state
        self.n_stream += b
        self._epoch += 1
        self._merged = None
        return self

    def _dispatch(self, csh, ash, keys, mask, inj):
        """One sharded step with the fault hook: retry with exponential
        backoff on :class:`~repro_torch.testing.faults.InjectedFault`,
        give up (drop the batch, keep serving) after
        ``DISPATCH_RETRIES``."""
        for attempt in range(DISPATCH_RETRIES + 1):
            try:
                if inj is not None and inj.shard_dispatch_fails(attempt):
                    raise _faults.InjectedFault(
                        f"shard dispatch (attempt {attempt})")
                if self._route is None:
                    return _ingest_step(self.state, csh, ash, keys, mask,
                                        self._qlo, self._qhi)
                return _build_step(self.state, csh, ash, keys, mask,
                                   *self._route, self._qlo, self._qhi)
            except _faults.InjectedFault:
                if attempt >= DISPATCH_RETRIES:
                    return None
                self._fault_stats["dispatch_retries"] += 1
                time.sleep(DISPATCH_BACKOFF_S * (2 ** attempt))
        return None

    def fault_stats(self) -> dict:
        """Containment counters (dispatch retries, dropped and poisoned
        batches) for ``engine.stats()['faults']``."""
        return dict(self._fault_stats)

    # -- drift signals -----------------------------------------------------
    @property
    def n_oob(self) -> int:
        return int(self.state.oob.sum())

    @property
    def n_quarantined(self) -> int:
        """Rows rejected by ingest validation, summed over shards (a host
        readback)."""
        return int(self.state.quarantined.sum())

    @property
    def total_rows(self) -> int:
        return self._base_rows + self.n_stream - self.n_quarantined

    def staleness(self) -> float:
        return self.n_stream / max(self.total_rows, 1)

    def oob_frac(self) -> float:
        return self.n_oob / max(self.n_stream, 1)

    # -- serving -----------------------------------------------------------
    def as_synopsis(self) -> Synopsis:
        """Merged serving synopsis (cached until the next ingest)."""
        if self._merged is None:
            from .merge import merge_sharded
            self._merged = merge_sharded(self.base, self.state,
                                         self._subtree,
                                         total_rows=self.total_rows,
                                         mesh=self.mesh)
        return self._merged

    def commit(self) -> Synopsis:
        """Fold the merged state in as the new immutable base.

        Ends the build phase: the delta zeroes, every shard's boxes snap to
        the merged (global) boxes so all shards route alike again, the
        static skeleton is dropped and later ``ingest()`` calls stream
        against live boxes. The reservoirs stay in place (the merged base's
        samples are their concatenation). The served synopsis is unchanged
        bit for bit, so the epoch does not bump.
        """
        merged = self.as_synopsis()
        D, k, d = self.n_shards, self.base.num_leaves, self.base.d
        self.base = merged
        self.state = dataclasses.replace(
            self.state,
            leaf_lo=merged.leaf_lo[None].expand(D, k, d).clone(),
            leaf_hi=merged.leaf_hi[None].expand(D, k, d).clone(),
            delta_agg=empty_delta_agg(k, self.device)[None].expand(
                D, k, 5).clone(),
            oob=torch.zeros((D,), dtype=torch.int32, device=self.device))
        self._route = None
        self.n_stream = 0
        self._base_rows = int(merged.total_rows)
        self._merged = merged
        return merged


__all__ = ["ShardedIngestor", "init_sharded_state", "shard_state",
           "stack_states", "route_static", "DISPATCH_RETRIES",
           "DISPATCH_BACKOFF_S"]
