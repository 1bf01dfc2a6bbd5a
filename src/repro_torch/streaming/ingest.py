"""Vectorized batched inserts (paper §4.5 at batch granularity).

The port of ``repro/streaming/ingest.py``. A batch of B rows is ingested
in one pass of tensor ops on the state's device:

1. **Route** — every row goes to the leaf box that contains it, else to
   the L1-nearest box, the lowest leaf id on ties, against the boxes as
   they were when the batch arrived (boxes expand between batches, not
   between rows of one batch). 1-D routes by binary search
   (:func:`_route_1d`, no kernel); d > 1 through ``ops.route_multid`` (the
   CUDA kernel ``route_multid`` on the card).
2. **Aggregate** — the value column's per-leaf [SUM, SUMSQ, COUNT, MIN,
   MAX] delta from one ``ops.segment_reduce`` call (the CUDA kernel
   ``segment_reduce`` on the card); the leaf boxes grow by two scatter
   extremes.
3. **Reservoir** — batched Vitter replacement. Each row's rank inside its
   leaf within the batch, the stratum's running ``seen`` count and one
   uniform decide fill or replace as the sequential algorithm would;
   several rows aiming at one (leaf, slot) resolve last-row-wins through a
   scatter-max of row indices.

Each ingest makes a new :class:`StreamState`, as the JAX package's pure
step does, so a state or merged synopsis a caller holds never changes
under it. The step allocates the new fields once and updates them in
place (scatters into the cloned boxes and the winner buffer) rather than
building further copies.

``ingest_batch_reference`` is the sequential per-row host oracle with the
same semantics.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import minmax
from ..core.types import Synopsis, AGG_COUNT
from ..device import resolve_device, to_numpy
from ..kernels import ops
from ..kernels.segment_reduce import NEG_BIG, POS_BIG
from ..testing import faults as _faults
from .. import random as trandom

STATE_FIELDS = ("leaf_lo", "leaf_hi", "delta_agg", "sample_c", "sample_a",
                "sample_valid", "k_per_leaf", "seen", "oob", "quarantined")


@dataclasses.dataclass
class StreamState:
    """Device-resident mutable part of a streaming synopsis.

    ``delta_agg`` holds the aggregates of streamed rows only (a mergeable
    summary, combined with the immutable base at serve time); the sample
    arrays are the live reservoir (they start as the base's stratified
    sample); ``seen`` is the Vitter denominator (base row count plus
    streamed rows per stratum). ``oob`` counts streamed rows outside every
    box and ``quarantined`` rejected rows (non-finite, or outside the
    quarantine box), both as 0-d int32 tensors on the device, so the hot
    loop never reads back to the host.
    """
    leaf_lo: torch.Tensor       # (k, d) f32 current boxes (base U streamed)
    leaf_hi: torch.Tensor       # (k, d) f32
    delta_agg: torch.Tensor     # (k, 5) f32 [sum, sumsq, count, min, max]
    sample_c: torch.Tensor      # (k, s, d) f32
    sample_a: torch.Tensor      # (k, s) f32
    sample_valid: torch.Tensor  # (k, s) bool
    k_per_leaf: torch.Tensor    # (k,) int32 filled slots
    seen: torch.Tensor          # (k,) int32 rows ever routed to the stratum
    oob: torch.Tensor           # () int32 streamed rows outside every box
    quarantined: torch.Tensor   # () int32 rejected rows


def stream_state_from_numpy(fields: dict, key=None, *, device=None
                            ) -> tuple[StreamState, torch.Tensor | None]:
    """Carry a stream state across from host arrays, dtypes kept as given:
    ``fields`` maps each :class:`StreamState` field to an array (a JAX
    ``StreamState`` as ``{f: np.asarray(getattr(state, f))}``; a missing
    or None ``quarantined`` reads 0). A sharded state carries a leading
    shard axis D on every field, ``oob`` and ``quarantined`` then (D,).
    ``key`` is a raw ``uint32[2]`` threefry key, returned as the port's
    (2,) int64 key, or None. The companion of
    :func:`~repro_torch.core.types.synopsis_from_numpy`."""
    dev = resolve_device(device)
    vals = dict(fields)
    if vals.get("quarantined") is None:
        vals["quarantined"] = np.zeros_like(np.asarray(vals["oob"]),
                                            np.int32)
    state = StreamState(**{f: torch.tensor(np.asarray(vals[f]), device=dev)
                           for f in STATE_FIELDS})
    if key is not None:
        key = torch.tensor(np.asarray(key).astype(np.int64), device=dev)
    return state, key


def empty_delta_agg(k: int, device=None) -> torch.Tensor:
    """(k, 5) identity element of the mergeable-summary combine."""
    agg = torch.zeros((k, 5), dtype=torch.float32,
                      device=resolve_device(device))
    agg[:, 3] = POS_BIG
    agg[:, 4] = NEG_BIG
    return agg


def _route_1d(leaf_lo, leaf_hi, c):
    """O(B log k) 1-D routing, equal to the dense argmin
    (``ingest.py`` ``_route_1d``).

    1-D leaves are intervals in ascending id order, disjoint or touching
    (equal-depth cuts on duplicate values make ``hi[i] == lo[i+1]`` and
    even degenerate ``[v, v]`` leaves); streaming expansion keeps this. A
    contained row goes to the first box, in sorted (== id) order, whose hi
    reaches it. Otherwise the nearer of (a) the first box carrying the
    largest hi below the row and (b) the first box whose lo exceeds it;
    ``<=`` prefers (a) on a tie. Empty (inverted) leaves sort past every
    finite coordinate and are masked out of the hi searches. Every search
    and the argsort are stable. Returns (leaf ids (B,) int32, distance
    (B,) f32), the distance bit-equal to the dense formulation's.
    """
    lo = leaf_lo[:, 0].contiguous()
    hi = leaf_hi[:, 0].contiguous()
    k = lo.shape[0]
    order = torch.argsort(lo, stable=True)
    lo_s = lo[order]
    hi_s = hi[order]
    hi_eff = torch.where(lo_s > hi_s, float("inf"), hi_s)
    cj = c[:, 0].contiguous()
    # lowest-index box containing c, when one exists
    jc = torch.clamp(torch.searchsorted(hi_eff, cj, side="left"), 0, k - 1)
    contained = (lo_s[jc] <= cj) & (cj <= hi_s[jc])
    # otherwise: (a) first box sharing the largest hi below c ...
    jl = torch.searchsorted(hi_eff, hi_eff[torch.clamp(jc - 1, min=0)],
                            side="left")
    # ... vs (b) first box with lo above c
    ju = torch.clamp(torch.searchsorted(lo_s, cj, side="right"), 0, k - 1)
    d_l = torch.clamp(torch.maximum(lo_s[jl] - cj, cj - hi_s[jl]), min=0.0)
    d_u = torch.clamp(torch.maximum(lo_s[ju] - cj, cj - hi_s[ju]), min=0.0)
    take_l = d_l <= d_u
    sel = torch.where(contained, jc, torch.where(take_l, jl, ju))
    dist = torch.where(contained, 0.0, torch.where(take_l, d_l, d_u))
    return order[sel].to(torch.int32), dist


def route_rows(leaf_lo, leaf_hi, c):
    """The routing step of an ingest: (leaf (B,) int32, distance (B,) f32)
    of finite rows c (B, d) against the boxes. 1-D takes the binary
    search (:func:`_route_1d`); d > 1 the ``route_multid`` op, which on
    the card is the CUDA kernel."""
    if c.shape[1] == 1:
        return _route_1d(leaf_lo, leaf_hi, c)
    return ops.route_multid(leaf_lo, leaf_hi, c)


def quarantine_mask(c, a, qlo=None, qhi=None) -> torch.Tensor:
    """(B,) bool: rows to quarantine. Non-finite measure or coordinates
    always (a NaN measure poisons every moment for good); coordinates
    outside the per-dimension ``[qlo, qhi]`` box when one is given."""
    bad = ~torch.isfinite(a) | ~torch.isfinite(c).all(1)
    if qlo is not None:
        bad = bad | ((c < qlo[None]) | (c > qhi[None])).any(1)
    return bad


def _batch_occupancy(leaf) -> torch.Tensor:
    """Within-batch rank of each row inside its leaf group (0-based)."""
    b = leaf.shape[0]
    order = torch.argsort(leaf, stable=True)
    sl = leaf[order]
    idx = torch.arange(b, dtype=torch.int32, device=leaf.device)
    is_start = torch.ones(b, dtype=torch.bool, device=leaf.device)
    is_start[1:] = sl[1:] != sl[:-1]
    start = torch.cummax(torch.where(is_start, idx, -1), 0).values
    occ = torch.empty_like(idx)
    occ[order] = idx - start
    return occ


def _ingest_core(state: StreamState, c, a, u, mask=None, qlo=None,
                 qhi=None) -> StreamState:
    """One ingested batch -> new state; every counter stays on the device.

    ``mask`` (B,) bool marks real rows; ``False`` rows are padding and
    complete no-ops: routed (fixed shapes) but contributing nothing.
    Quarantined rows (:func:`quarantine_mask`) take the same no-op path
    and bump the ``quarantined`` counter.
    """
    b = c.shape[0]
    if mask is None:
        mask = torch.ones(b, dtype=torch.bool, device=c.device)
    bad = quarantine_mask(c, a, qlo, qhi)
    n_quar = (bad & mask).sum().to(torch.int32)
    mask = mask & ~bad
    # 1. route. NaN coordinates would make the comparisons unordered; any
    # in-range leaf id works for a masked-out row, so route from zeros.
    leaf, dsel = route_rows(state.leaf_lo, state.leaf_hi,
                            torch.where(bad[:, None], 0.0, c))
    return _apply_routed(state, c, a, u, leaf, dsel, mask, n_quar=n_quar)


def _apply_routed(state: StreamState, c, a, u, leaf, dsel, mask=None,
                  n_quar=None) -> StreamState:
    """Aggregate, box expansion and reservoir update for pre-routed rows.

    Split out of :func:`_ingest_core` so another routing policy (the
    sharded build routes against a static cut skeleton) reuses the same
    state transition.
    """
    b, d = c.shape
    k, cap = state.sample_a.shape
    dev = c.device
    if mask is None:
        mask = torch.ones(b, dtype=torch.bool, device=dev)
    leaf = leaf.to(torch.int32)
    leaf64 = leaf.long()
    oob = ((dsel > 0.0) & mask).sum().to(torch.int32)

    # 2. per-leaf delta (dropped rows carry id -1); the boxes grow by two
    #    scatter extremes into the new state's copies, in place (dropped
    #    rows scatter +-inf, a no-op); MIN/MAX, of the aggregates and of
    #    the boxes, follow the reference's signed-zero rule
    a32 = a.to(torch.float32)
    agg_b = ops.segment_reduce(a32, torch.where(mask, leaf, -1), k)
    flat = (leaf64[:, None] * d
            + torch.arange(d, device=dev)[None]).reshape(-1)
    new_lo = state.leaf_lo.clone()
    new_hi = state.leaf_hi.clone()
    minmax.scatter_min_(new_lo.view(-1), flat, torch.where(
        mask[:, None], c, float("inf")).reshape(-1))
    minmax.scatter_max_(new_hi.view(-1), flat, torch.where(
        mask[:, None], c, float("-inf")).reshape(-1))
    delta = state.delta_agg
    new_delta = torch.cat(
        [delta[:, 0:3] + agg_b[:, 0:3],
         minmax.minimum(delta[:, 3:4], agg_b[:, 3:4]),
         minmax.maximum(delta[:, 4:5], agg_b[:, 4:5])], 1)

    # 3. batched Vitter reservoir (dropped rows group under id k, so real
    #    rows' ranks are unaffected, and their slot is forced to -1)
    counts = agg_b[:, 2].to(torch.int32)                      # (k,)
    occ = _batch_occupancy(torch.where(mask, leaf, k))        # (B,)
    seen_at = state.seen[leaf64] + occ + 1
    fill_pos = state.k_per_leaf[leaf64] + occ
    j_draw = torch.floor(u.to(torch.float32)
                         * seen_at.to(torch.float32)).to(torch.int32)
    slot = torch.where(fill_pos < cap, fill_pos,
                       torch.where(j_draw < cap, j_draw, -1))
    slot = torch.where(mask, slot, -1)
    key = torch.where(slot >= 0, leaf64 * cap + slot, k * cap)
    rows = torch.arange(b, dtype=torch.int32, device=dev)
    winner = torch.full((k * cap + 1,), -1, dtype=torch.int32, device=dev)
    winner.scatter_reduce_(0, key, rows, "amax")
    winner = winner[:k * cap].reshape(k, cap)
    take = winner >= 0
    wclip = torch.clamp(winner, min=0).long()
    new_sa = torch.where(take, a32[wclip], state.sample_a)
    new_sc = torch.where(take[..., None], c[wclip], state.sample_c)

    if n_quar is None:
        n_quar = torch.zeros((), dtype=torch.int32, device=dev)
    return StreamState(
        leaf_lo=new_lo, leaf_hi=new_hi, delta_agg=new_delta,
        sample_c=new_sc, sample_a=new_sa,
        sample_valid=state.sample_valid | take,
        k_per_leaf=torch.clamp(state.k_per_leaf + counts, max=cap),
        seen=state.seen + counts, oob=state.oob + oob,
        quarantined=state.quarantined + n_quar)


def init_state(base: Synopsis) -> StreamState:
    """Fresh delta state anchored on an immutable base synopsis, on the
    base's device."""
    f32 = torch.float32
    return StreamState(
        leaf_lo=base.leaf_lo.to(f32).clone(),
        leaf_hi=base.leaf_hi.to(f32).clone(),
        delta_agg=empty_delta_agg(base.num_leaves, base.device),
        sample_c=base.sample_c.to(f32), sample_a=base.sample_a.to(f32),
        sample_valid=base.sample_valid.to(torch.bool),
        k_per_leaf=base.k_per_leaf.to(torch.int32),
        seen=base.leaf_agg[:, AGG_COUNT].to(f32).to(torch.int32),
        oob=torch.zeros((), dtype=torch.int32, device=base.device),
        quarantined=torch.zeros((), dtype=torch.int32, device=base.device))


def _f32(x, device) -> torch.Tensor:
    """A float32 tensor on ``device`` from a tensor or an array-like."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    return x.to(device=device, dtype=torch.float32)


class StreamingIngestor:
    """Batched streaming front end over an immutable base synopsis.

    ``ingest()`` is the vectorized hot path; ``as_synopsis()`` delta-merges
    base and stream state into a serving-ready :class:`Synopsis` (cached
    until the next ingest; ``PassEngine`` accepts the ingestor as its
    source). Drift signals: :meth:`staleness` (fraction of rows streamed
    since the base build) and :meth:`oob_frac` (fraction of streamed rows
    outside every box). ``device=None`` means the CUDA card; the base
    synopsis is moved there.
    """

    def __init__(self, base: Synopsis, *, seed: int = 0, key=None,
                 quarantine_box: tuple | None = None, device=None):
        from .delta import subtree_leaf_matrix
        self.device = resolve_device(device)
        self.base = base.to(self.device)
        self.state = init_state(self.base)
        self._subtree = subtree_leaf_matrix(self.base.tree,
                                            self.base.num_leaves)
        # Quarantine box: NaN/Inf rows are always rejected; an explicit
        # (lo, hi) also rejects coordinates outside it.
        self._qlo = self._qhi = None
        if quarantine_box is not None:
            self._qlo, self._qhi = (
                torch.tensor(np.asarray(x, np.float32).reshape(-1),
                             device=self.device) for x in quarantine_box)
        # Threefry key threaded through reservoir replacement: each ingest
        # splits off a per-batch subkey, so a seeded sequence draws the
        # JAX package's uniforms.
        self._key = (trandom.PRNGKey(seed, self.device) if key is None
                     else torch.tensor(to_numpy(key).astype(np.int64),
                                       device=self.device))
        self.n_stream = 0
        self._base_rows = int(self.base.total_rows)
        self._epoch = 0
        self._merged: Synopsis | None = None

    @property
    def epoch(self) -> int:
        """Monotone delta-merge epoch: bumps on every ingested batch, so
        ``PassEngine`` re-pins prepared entries pinned to a stale merge."""
        return self._epoch

    def ingest(self, c_rows, a_vals, u=None) -> "StreamingIngestor":
        """Ingest a (B, d) coordinate batch and a (B,) value batch. The
        reservoir uniforms are drawn from the threaded key unless ``u``
        (B,) is given. Nothing is read back to the host.

        With a fault injector installed (``repro_torch.testing``), the batch
        may be poisoned on the host first; the quarantine then makes it a
        counted no-op that still consumes its split of the key, so the
        batches after it draw what a clean run draws."""
        inj = _faults.active()
        if inj is not None:
            c_rows, a_vals, _ = inj.poison_batch(
                to_numpy(c_rows).astype(np.float32),
                to_numpy(a_vals).astype(np.float32))
        c = _f32(c_rows, self.device)
        if c.dim() == 1:
            c = c.reshape(-1, 1)
        a = _f32(a_vals, self.device).reshape(-1)
        b = a.shape[0]
        if u is None:
            keys = trandom.split(self._key)
            self._key = keys[0]
            u = trandom.uniform(keys[1], (b,))
        else:
            u = _f32(u, self.device).reshape(-1)
        self.state = _ingest_core(self.state, c, a, u, qlo=self._qlo,
                                  qhi=self._qhi)
        self.n_stream += b
        self._epoch += 1
        self._merged = None
        return self

    # -- drift signals -----------------------------------------------------
    @property
    def n_oob(self) -> int:
        return int(self.state.oob)

    @property
    def n_quarantined(self) -> int:
        """Rows rejected by ingest validation (a host readback: read it at
        serve or telemetry time, not in the ingest loop)."""
        return int(self.state.quarantined)

    @property
    def total_rows(self) -> int:
        """Served row count (base plus streamed, less quarantined)."""
        return self._base_rows + self.n_stream - self.n_quarantined

    def staleness(self) -> float:
        """Fraction of rows streamed since the base build (§4.5)."""
        return self.n_stream / max(self.total_rows, 1)

    def oob_frac(self) -> float:
        """Fraction of streamed rows that fell outside every leaf box."""
        return self.n_oob / max(self.n_stream, 1)

    # -- serving -----------------------------------------------------------
    def as_synopsis(self) -> Synopsis:
        """Delta-merged serving synopsis (cached until the next ingest)."""
        if self._merged is None:
            from .delta import merge_synopsis
            self._merged = merge_synopsis(self.base, self.state,
                                          self._subtree,
                                          total_rows=self.total_rows)
        return self._merged


def ingest_batch_reference(state: StreamState, c_rows, a_vals, u,
                           qlo=None, qhi=None) -> StreamState:
    """Sequential per-row host oracle for one batch (numpy, f32).

    Same semantics as the vectorized step: routing against the batch-entry
    boxes, one uniform per row, last writer wins on a reservoir slot,
    quarantined rows no-ops that keep their batch position (``u[i]`` stays
    theirs). Returns the new state as CPU tensors.
    """
    c = np.asarray(to_numpy(c_rows), np.float32)
    if c.ndim == 1:
        c = c[:, None]
    a = np.asarray(to_numpy(a_vals), np.float32).reshape(-1)
    u = np.asarray(to_numpy(u), np.float32).reshape(-1)
    s = {f: to_numpy(getattr(state, f)).copy() for f in STATE_FIELDS}
    lo, hi, delta = s["leaf_lo"], s["leaf_hi"], s["delta_agg"]
    sc, sa, sv = s["sample_c"], s["sample_a"], s["sample_valid"]
    kpl, seen = s["k_per_leaf"], s["seen"]
    cap = sa.shape[1]
    lo0, hi0 = lo.copy(), hi.copy()          # batch-entry routing snapshot
    oob, quar = int(s["oob"]), int(s["quarantined"])
    for i in range(a.shape[0]):
        bad = not (np.isfinite(a[i]) and np.all(np.isfinite(c[i])))
        if qlo is not None:
            bad = bad or bool(np.any(
                (c[i] < np.asarray(to_numpy(qlo), np.float32))
                | (c[i] > np.asarray(to_numpy(qhi), np.float32))))
        if bad:
            quar += 1
            continue
        dist = np.sum(np.maximum(np.maximum(lo0 - c[i], c[i] - hi0),
                                 np.float32(0.0)), axis=-1)
        leaf = int(np.argmin(dist))
        oob += int(dist[leaf] > 0.0)
        delta[leaf, 0] += a[i]
        delta[leaf, 1] += a[i] * a[i]
        delta[leaf, 2] += np.float32(1.0)
        delta[leaf, 3] = min(delta[leaf, 3], a[i])
        delta[leaf, 4] = max(delta[leaf, 4], a[i])
        lo[leaf] = np.minimum(lo[leaf], c[i])
        hi[leaf] = np.maximum(hi[leaf], c[i])
        seen[leaf] += 1
        if kpl[leaf] < cap:
            slot = int(kpl[leaf])
            kpl[leaf] += 1
        else:
            j = int(np.float32(u[i]) * np.float32(seen[leaf]))
            slot = j if j < cap else -1
        if slot >= 0:
            sc[leaf, slot] = c[i]
            sa[leaf, slot] = a[i]
            sv[leaf, slot] = True
    s["oob"] = np.int32(oob)
    s["quarantined"] = np.int32(quar)
    return StreamState(**{f: torch.from_numpy(np.asarray(s[f]))
                          for f in STATE_FIELDS})


__all__ = ["StreamState", "StreamingIngestor", "ingest_batch_reference",
           "init_state", "empty_delta_agg", "quarantine_mask",
           "stream_state_from_numpy", "route_rows", "STATE_FIELDS"]
