"""Streaming ingest for join-augmented synopses (DESIGN.md §13); the port
of ``repro/streaming/join_ingest.py``.

One step per batch extends the base streaming transition
(``streaming.ingest._apply_routed``: aggregates, boxes, reservoir, on the
same routing) with the join state's:

* **cell aggregates**: each routed row's (leaf, dim partition) cell takes
  its measure through one more ``ops.segment_reduce`` over the k*P cell
  ids (the CUDA kernel on the card); rows whose key misses the dimension
  side, and quarantined rows, carry id -1 and are dropped;
* **universe append**: membership is evaluated again with the synopsis's
  own ``key_root``, so a key streamed later joins (or stays out of) the
  universe the build chose. Member rows go to the fixed-capacity buffers
  of their strata (within-batch ranks make the slots unique); rows past
  capacity only bump ``u_overflow`` and are parked on the host, and the
  next ingest grows the buffers and appends them (:meth:`regrow`).

``JoinStreamingIngestor.as_join_synopsis()`` is the serving view: the
delta-merged base, build cells combined with streamed cells, and the
live universe buffers, cached per epoch. Each ingest reads one (B,) bool
back to the host, the rows that overflowed, as the reference does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import minmax
from ..device import to_numpy
from ..kernels import ops
from ..kernels.segment_reduce import NEG_BIG, POS_BIG
from ..testing import faults as _faults
from .. import random as trandom
from .ingest import (StreamingIngestor, _apply_routed, _batch_occupancy,
                     _f32, quarantine_mask, route_rows)

JSTATE_FIELDS = ("cell_delta", "u_c", "u_a", "u_key", "u_dattr", "u_part",
                 "u_valid", "u_count", "u_overflow")


@dataclasses.dataclass
class JoinStreamState:
    """The join augmentation's mutable state: streamed-rows-only cell
    aggregates (mergeable; combined with the build's cells at serve time)
    and the live universe buffers (appended, not a reservoir: every member
    row is kept up to capacity)."""
    cell_delta: torch.Tensor   # (k, P, 5) f32 streamed-cell aggregates
    u_c: torch.Tensor          # (k, su, d_fact) f32
    u_a: torch.Tensor          # (k, su) f32
    u_key: torch.Tensor        # (k, su) int32
    u_dattr: torch.Tensor      # (k, su, d_dim) f32
    u_part: torch.Tensor       # (k, su) int32
    u_valid: torch.Tensor      # (k, su) bool
    u_count: torch.Tensor      # (k,) int32 filled slots
    u_overflow: torch.Tensor   # (k,) int32 member rows dropped for capacity


def _empty_cell_delta(k: int, p: int, device) -> torch.Tensor:
    agg = torch.zeros((k, p, 5), dtype=torch.float32, device=device)
    agg[:, :, 3] = POS_BIG
    agg[:, :, 4] = NEG_BIG
    return agg


def _combine_cell_agg(base_cells, delta_cells):
    """Mergeable-summary combine of two (k, P, 5) cell aggregates, MIN and
    MAX under the reference's signed-zero rule."""
    return torch.cat(
        [base_cells[..., 0:3] + delta_cells[..., 0:3],
         minmax.minimum(base_cells[..., 3:4], delta_cells[..., 3:4]),
         minmax.maximum(base_cells[..., 4:5], delta_cells[..., 4:5])], -1)


def _append(jstate: JoinStreamState, leaf, member, c, a, keys, dattr, part):
    """Append the member rows to their strata's buffers: (new buffers dict,
    accepted (B,) bool, members per leaf (k,) int32). Accepted rows land on
    distinct (leaf, slot) pairs; the rest all go to one dummy slot, cut
    off again."""
    k, su = jstate.u_a.shape
    b = leaf.shape[0]
    dev = leaf.device
    leaf64 = leaf.long()
    occ = _batch_occupancy(torch.where(member, leaf, k).to(torch.int32))
    slot = jstate.u_count[leaf64] + occ
    ok = member & (slot < su)
    flat = torch.where(ok, leaf64 * su + slot, k * su)

    def put(buf, vals):
        ext = torch.cat([buf.reshape(k * su, *buf.shape[2:]),
                         buf.new_zeros((1, *buf.shape[2:]))])
        ext[flat] = vals.to(buf.dtype)
        return ext[:k * su].reshape(buf.shape)

    mcnt = torch.zeros(k + 1, dtype=torch.int32, device=dev).index_add_(
        0, torch.where(member, leaf64, k),
        torch.ones(b, dtype=torch.int32, device=dev))[:k]
    bufs = dict(u_c=put(jstate.u_c, c), u_a=put(jstate.u_a, a),
                u_key=put(jstate.u_key, keys),
                u_dattr=put(jstate.u_dattr, dattr),
                u_part=put(jstate.u_part, part),
                u_valid=put(jstate.u_valid,
                            torch.ones(b, dtype=torch.bool, device=dev)))
    return bufs, ok, mcnt


def _join_ingest_core(state, jstate, c, a, u, keys, dim, key_root, p_u,
                      qlo=None, qhi=None):
    """One batch -> (new StreamState, new JoinStreamState, overflowed (B,)
    bool). Quarantined rows are dropped from both transitions: the base
    one through its padding mask, the join one as keys not found."""
    from ..joins.dim import dim_lookup
    from ..joins.universe import universe_mask
    bad = quarantine_mask(c, a, qlo, qhi)
    n_quar = bad.sum().to(torch.int32)
    leaf, dsel = route_rows(state.leaf_lo, state.leaf_hi,
                            torch.where(bad[:, None], 0.0, c))
    new_state = _apply_routed(state, c, a, u, leaf, dsel, mask=~bad,
                              n_quar=n_quar)

    k, su = jstate.u_a.shape
    p = dim.num_partitions
    part, dattr, found = dim_lookup(dim, keys)
    found = found & ~bad
    # Streamed cell aggregates: unmatched and quarantined rows carry -1.
    cell = torch.where(found, leaf.long() * p + part, -1).to(torch.int32)
    cell_b = ops.segment_reduce(a.to(torch.float32), cell, k * p)
    new_cells = _combine_cell_agg(jstate.cell_delta, cell_b.reshape(k, p, 5))

    member = universe_mask(key_root, keys, p_u) & found
    bufs, ok, mcnt = _append(jstate, leaf, member, c, a, keys, dattr, part)
    grown = jstate.u_count + mcnt
    new_jstate = JoinStreamState(
        cell_delta=new_cells, **bufs,
        u_count=torch.clamp(grown, max=su),
        u_overflow=jstate.u_overflow + torch.clamp(grown - su, min=0))
    return new_state, new_jstate, member & ~ok


def _universe_regrow(state, jstate, c, a, keys, dim, key_root, p_u
                     ) -> JoinStreamState:
    """Append earlier overflowed member rows into (grown) universe buffers.
    Universe append only: the rows' aggregates and cell deltas were folded
    in at their first ingest. Accepted rows pay back ``u_overflow``."""
    from ..joins.dim import dim_lookup
    from ..joins.universe import universe_mask
    k = jstate.u_a.shape[0]
    leaf, _dsel = route_rows(state.leaf_lo, state.leaf_hi, c)
    part, dattr, found = dim_lookup(dim, keys)
    member = universe_mask(key_root, keys, p_u) & found
    bufs, ok, _ = _append(jstate, leaf, member, c, a, keys, dattr, part)
    acc = torch.zeros(k + 1, dtype=torch.int32, device=c.device).index_add_(
        0, torch.where(ok, leaf.long(), k),
        torch.ones(ok.shape[0], dtype=torch.int32, device=c.device))[:k]
    return dataclasses.replace(
        jstate, **bufs, u_count=jstate.u_count + acc,
        u_overflow=torch.clamp(jstate.u_overflow - acc, min=0))


class JoinStreamingIngestor(StreamingIngestor):
    """Streaming front end over a :class:`~repro_torch.joins.JoinSynopsis`.

    ``ingest()`` also takes the batch's fk ``keys``; ``as_synopsis()``
    keeps serving the single-table view, ``as_join_synopsis()`` the join
    view, both cached per epoch.

    Universe members that arrive at a full stratum are parked on the host
    and the next ingest grows every stratum's capacity by the parked row
    count and appends them (:meth:`regrow`), paying back ``u_overflow``:
    the estimator takes the truncation fallback only between the batch
    that overflowed and the next one. (Overflow recorded by the build has
    no parked rows and stays a fallback.)
    """

    def __init__(self, jsyn, *, seed: int = 0, key=None,
                 quarantine_box: tuple | None = None, device=None):
        super().__init__(jsyn.base, seed=seed, key=key,
                         quarantine_box=quarantine_box, device=device)
        jb = jsyn.to(self.device)
        self._join_base = jb
        self.jstate = JoinStreamState(
            cell_delta=_empty_cell_delta(jb.num_leaves, jb.num_partitions,
                                         self.device),
            u_c=jb.u_c, u_a=jb.u_a, u_key=jb.u_key, u_dattr=jb.u_dattr,
            u_part=jb.u_part, u_valid=jb.u_valid, u_count=jb.u_count,
            u_overflow=jb.u_overflow)
        self._jmerged = None
        self._pending: list[tuple] = []  # host (c, a, keys) of overflowed rows
        self.n_regrown = 0

    def _keys(self, keys) -> torch.Tensor:
        if not isinstance(keys, torch.Tensor):
            keys = torch.from_numpy(np.asarray(keys).astype(np.int32))
        return keys.to(self.device, torch.int32).reshape(-1)

    def ingest(self, c_rows, a_vals, keys=None,
               u=None) -> "JoinStreamingIngestor":
        """Ingest (B, d) coordinates, (B,) values and (B,) fk keys in one
        step (the base and the join transition share the routing). The
        reservoir uniforms come from the threaded key unless ``u`` is
        given; a fault injector may poison the batch on the host first."""
        if keys is None:
            raise ValueError(
                "JoinStreamingIngestor.ingest needs the batch's fk keys "
                "(universe membership and cell routing are keyed)")
        inj = _faults.active()
        if inj is not None:
            c_rows, a_vals, _ = inj.poison_batch(
                to_numpy(c_rows).astype(np.float32),
                to_numpy(a_vals).astype(np.float32))
        c = _f32(c_rows, self.device)
        if c.dim() == 1:
            c = c.reshape(-1, 1)
        a = _f32(a_vals, self.device).reshape(-1)
        kv = self._keys(keys)
        # Overflow of earlier batches regrows the buffers before this one
        # appends, so they never fall further behind the stream.
        self.regrow()
        jb = self._join_base
        if u is None:
            split = trandom.split(self._key)
            self._key = split[0]
            u = trandom.uniform(split[1], (a.shape[0],))
        else:
            u = _f32(u, self.device).reshape(-1)
        self.state, self.jstate, dropped = _join_ingest_core(
            self.state, self.jstate, c, a, u, kv, jb.dim, jb.key_root,
            jb.p_u, qlo=self._qlo, qhi=self._qhi)
        dropped = to_numpy(dropped)
        if dropped.any():
            self._pending.append((to_numpy(c)[dropped], to_numpy(a)[dropped],
                                  to_numpy(kv)[dropped]))
        self.n_stream += int(a.shape[0])
        self._epoch += 1
        self._merged = None
        self._jmerged = None
        return self

    def regrow(self) -> "JoinStreamingIngestor":
        """Grow every stratum's universe capacity by the parked row count
        (an upper bound on any one stratum's backlog) and append the parked
        overflow rows. No-op without them; ``ingest()`` calls it first."""
        if not self._pending:
            return self
        c = np.concatenate([p[0] for p in self._pending], axis=0)
        a = np.concatenate([p[1] for p in self._pending])
        kv = np.concatenate([p[2] for p in self._pending])
        self._pending = []
        js = self.jstate
        k = js.u_a.shape[0]
        grow = int(a.shape[0])

        def gpad(buf, fill):
            return torch.cat([buf, buf.new_full((k, grow, *buf.shape[2:]),
                                                fill)], 1)

        grown = dataclasses.replace(
            js, u_c=gpad(js.u_c, 0.0), u_a=gpad(js.u_a, 0.0),
            u_key=gpad(js.u_key, 0), u_dattr=gpad(js.u_dattr, 0.0),
            u_part=gpad(js.u_part, -1), u_valid=gpad(js.u_valid, False))
        jb = self._join_base
        self.jstate = _universe_regrow(
            self.state, grown, _f32(c, self.device),
            _f32(a, self.device), self._keys(kv), jb.dim, jb.key_root,
            jb.p_u)
        self.n_regrown += grow
        # The buffers changed shape: serving views and prepared entries
        # re-pin.
        self._epoch += 1
        self._merged = None
        self._jmerged = None
        return self

    def as_join_synopsis(self):
        """The join serving view (cached until the next ingest)."""
        if self._jmerged is None:
            jb, js = self._join_base, self.jstate
            self._jmerged = dataclasses.replace(
                jb, base=self.as_synopsis(),
                cell_agg=_combine_cell_agg(jb.cell_agg, js.cell_delta),
                u_c=js.u_c, u_a=js.u_a, u_key=js.u_key, u_dattr=js.u_dattr,
                u_part=js.u_part, u_valid=js.u_valid, u_count=js.u_count,
                u_overflow=js.u_overflow)
        return self._jmerged


__all__ = ["JoinStreamState", "JoinStreamingIngestor", "JSTATE_FIELDS"]
