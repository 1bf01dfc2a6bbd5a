"""Join executor: one artifact pass answers a whole batch of fk-join
queries for every requested kind (DESIGN.md §13); the port of
``repro/joins/executor.py``.

1. ``engine.planner.classify_join_cells`` classifies every (fact stratum
   x dim partition) cell against each query: two ``query_eval`` calls.
2. The universe sample's key groups and the kernel's sorted layout
   (:func:`~repro_torch.kernels.join_moments.join_slots`) are derived once
   per synopsis epoch and pinned with it.
3. ``ops.join_cell_moments`` (row 9: the hand-written CUDA kernel on the
   card, the reference's jnp formulation on the CPU) evaluates the join
   rectangle on every universe slot, folds the HT-weighted (``1/p``)
   contributions into per-group totals and those into the per-cell
   statistics, and sums the covered cells' exact aggregates.
4. ``ops.join_epilogue`` (row 11: one launch of a hand-written CUDA kernel
   on the card, ``assemble_join`` + ``compose_join_interval`` +
   ``_with_interval`` a kind on the CPU) turns them into every requested
   kind's estimate, half-width, hard bounds and interval.

:func:`join_answer` is the serving entry ``api.PassEngine.answer_join``
pins in its plan cache.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.types import QueryBatch
from ..engine.planner import classify_join_cells
from ..kernels import ops
from ..kernels import join_moments as _jm
from .synopsis import JoinSynopsis, resolve_join_synopsis, JOIN_KINDS


@dataclasses.dataclass
class JoinArtifacts:
    """Shared per-(query, cell) join statistics, cell id = leaf * P + part.

    ``cover`` / ``sampled`` (Q, k*P) bool; ``exact3`` (Q, 3): [SUM, SUMSQ,
    COUNT] over the covered cells. Per cell, all (Q, k*P) f32: HT totals
    ``s_cell`` / ``c_cell``, variance estimates ``v_s`` / ``v_c`` and the
    SUM-COUNT covariance ``cov_sc``, the contributing key-group count
    ``n_grp``, and the Bernstein range proxies ``r_s`` / ``r_c`` (largest
    |group total|). ``touched`` (Q,) the fraction of rows in sampled cells.
    """
    cover: torch.Tensor
    sampled: torch.Tensor
    exact3: torch.Tensor
    s_cell: torch.Tensor
    c_cell: torch.Tensor
    v_s: torch.Tensor
    v_c: torch.Tensor
    cov_sc: torch.Tensor
    n_grp: torch.Tensor
    r_s: torch.Tensor
    r_c: torch.Tensor
    touched: torch.Tensor


def universe_group_ids(jsyn: JoinSynopsis):
    """Per-slot (leaf, key) group ids of the universe sample: (flat_gid
    (k*su,) int64, -1 on invalid slots; g_cell (k*su,) int64, group id ->
    cell id, k*P for a group without a dim partition or without rows)."""
    return _jm.universe_group_ids(jsyn.u_key, jsyn.u_part, jsyn.u_valid,
                                  jsyn.num_partitions)


def join_slots(jsyn: JoinSynopsis) -> _jm.JoinSlots:
    """The universe sample in row 9's two layouts, on the synopsis's
    device (once per synopsis epoch)."""
    return _jm.join_slots(jsyn.u_c, jsyn.u_dattr, jsyn.u_a, jsyn.u_key,
                          jsyn.u_part, jsyn.u_valid, jsyn.num_partitions)


def compute_join_artifacts(jsyn: JoinSynopsis, queries: QueryBatch,
                           slots: _jm.JoinSlots | None = None
                           ) -> JoinArtifacts:
    """The join artifact stage for one batch; ``slots`` is
    :func:`join_slots` of ``jsyn`` (derived here when None)."""
    if slots is None:
        slots = join_slots(jsyn)
    kp = jsyn.num_leaves * jsyn.num_partitions
    q_lo = queries.lo.to(torch.float32)
    q_hi = queries.hi.to(torch.float32)
    cover, sampled, _, _ = classify_join_cells(jsyn, QueryBatch(q_lo, q_hi))
    m = ops.join_cell_moments(slots, q_lo, q_hi, cover, sampled,
                              jsyn.cell_agg.reshape(kp, -1),
                              jsyn.base.total_rows, jsyn.p_u)
    return JoinArtifacts(cover=cover, sampled=sampled, exact3=m.exact3,
                         s_cell=m.s_cell, c_cell=m.c_cell, v_s=m.v_s,
                         v_c=m.v_c, cov_sc=m.cov_sc, n_grp=m.n_grp,
                         r_s=m.r_s, r_c=m.r_c, touched=m.touched)


def join_answer(pinned, queries: QueryBatch, plan_masks=None, *, kinds,
                lam: float, level: float | None, small_n_threshold: int,
                delta_budget: str):
    """One join artifact stage feeding one epilogue for every requested
    kind (``ops.join_epilogue``: row 11's one launch on the card).
    ``pinned`` is a (JoinSynopsis, JoinSlots) pair; ``level=None`` is the
    plain path (``lam``-scaled CLT half-width, no calibrated endpoints).
    ``plan_masks`` is accepted and ignored (the prepared-entry signature).
    """
    jsyn, slots = pinned
    jart = compute_join_artifacts(jsyn, queries, slots)
    return ops.join_epilogue(jsyn, jart, kinds, lam=lam, level=level,
                             small_n_threshold=small_n_threshold,
                             delta_budget=delta_budget)


__all__ = ["JoinArtifacts", "compute_join_artifacts", "universe_group_ids",
           "join_slots", "join_answer", "resolve_join_synopsis",
           "JOIN_KINDS"]
