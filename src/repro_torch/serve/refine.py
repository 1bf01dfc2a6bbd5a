"""Graceful degradation ladder: tier-0 aggregate-only answers and
progressive sample refinement (DESIGN.md §15); the port of
``repro/serve/refine.py``.

PASS's aggregate tree always has *some* valid answer: exact on covered
strata, deterministically hard-bounded (§2.3) everywhere else. Tier 0
serves exactly that: a host-side planner descent (Minimal Coverage
Frontier) plus the §2.3 bound epilogue, in host numpy, with no sample work
and no kernel launch, so it can never miss a deadline. It is the
algorithm, not a fallback: the same numpy code as the reference's, and so
bit-equal to the JAX package's tier 0 on the same synopsis and queries.

Refinement tiers then re-answer the same batch through the ordinary engine
path on the engine's device, restricted to the first ``slots`` sample
slots per stratum (:func:`~repro_torch.engine.executor.slice_sample_slots`,
a uniform subsample, so every tier is unbiased). Each tier's interval is
intersected with the running one (intervals only tighten; a crossing,
possible between independent sample subsets, collapses to the previous
envelope's point nearest the new estimate), so the ladder's interval
sequence is monotone by construction. The last tier (``slots=None``) is
the plain full-sample entry and shares its plan-cache slot with ordinary
``answer()`` calls.

Stop criteria: a wall-clock ``deadline_ms`` (checked against an EWMA of
observed per-tier latency, so the ladder stops before it blows the budget)
and/or ``CIConfig.max_ci_width``. :class:`RefinementHandle` is the anytime
surface: the tier-0 result at once, ``refine()`` one tier at a time,
``final()`` to the end. Results on the ladder are host numpy
:class:`~repro_torch.core.types.QueryResult`\\ s; each sample tier's
answer comes back in one device-to-host copy.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core.types import (PartitionTree, QueryResult, AGG_SUM, AGG_COUNT,
                          AGG_MIN, AGG_MAX)
from ..device import to_numpy
from ..engine.planner import plan_queries

_BIG = np.float32(3.4e38)

# EWMA smoothing for the per-tier latency predictor.
_EWMA_ALPHA = 0.3

_TREE_FIELDS = ("lo", "hi", "agg", "left", "right", "leaf_id", "level")


# -- tier 0: host-only planner + hard-bound epilogue -----------------------

def _tier0_snapshot(engine) -> dict:
    """Host copy of the aggregate tree and per-leaf aggregates, cached on
    the engine per (epoch, generation): one device readback per ingest
    epoch, none on the serving path."""
    key = (engine.epoch, engine._generation)
    snap = getattr(engine, "_tier0_cache", None)
    if snap is not None and snap[0] == key:
        return snap[1]
    syn = engine.resolve()
    host = dict(
        tree=PartitionTree(**{f: to_numpy(getattr(syn.tree, f))
                              for f in _TREE_FIELDS}),
        num_leaves=int(syn.num_leaves),
        leaf_agg=to_numpy(syn.leaf_agg).astype(np.float32),
        n_rows=to_numpy(syn.n_rows).astype(np.float32),
        total_rows=float(to_numpy(syn.total_rows)),
        sample_cap=int(syn.sample_a.shape[1]))
    engine._tier0_cache = (key, host)
    return host


def tier0_answer(engine, queries, kinds) -> dict[str, QueryResult]:
    """Aggregates-only answer: planner MCF descent + §2.3 hard bounds.

    Pure host numpy (f64 planner combine, f32 epilogue: the dtypes the
    device path uses after ``plan_to_masks``). Estimates sit at the
    midpoint of the hard-bound envelope, which degenerates to the exact
    covered aggregate when a query is fully covered. MIN/MAX mirror the
    device epilogue with zero samples (the observed-extreme end of the
    envelope is the covered-leaf extreme alone).
    """
    snap = _tier0_snapshot(engine)
    q_lo = to_numpy(queries.lo).astype(np.float32)
    q_hi = to_numpy(queries.hi).astype(np.float32)
    plan = plan_queries(snap["tree"], q_lo, q_hi, snap["num_leaves"])

    leaf_agg = snap["leaf_agg"]
    cover = plan.cover_leaf_mask
    partial_m = plan.partial_leaf_mask
    partf = partial_m.astype(np.float32)
    exact = plan.exact_agg.astype(np.float32)          # (Q, 5)
    leaf_sum = leaf_agg[:, AGG_SUM][None]
    leaf_cnt = leaf_agg[:, AGG_COUNT][None]
    leaf_min = leaf_agg[:, AGG_MIN][None]
    leaf_max = leaf_agg[:, AGG_MAX][None]
    Ni = snap["n_rows"][None]
    touched = ((partf * Ni).sum(axis=1)
               / np.float32(max(snap["total_rows"], 1.0))).astype(np.float32)

    out = {}
    for kind in kinds:
        if kind in ("sum", "count"):
            if kind == "sum":
                ex = exact[:, AGG_SUM]
                p_ub = np.minimum(Ni * np.maximum(leaf_max, np.float32(0)),
                                  leaf_sum
                                  - Ni * np.minimum(leaf_min, np.float32(0)))
                p_lb = np.maximum(Ni * np.minimum(leaf_min, np.float32(0)),
                                  leaf_sum
                                  - Ni * np.maximum(leaf_max, np.float32(0)))
            else:
                ex = exact[:, AGG_COUNT]
                p_ub = leaf_cnt
                p_lb = np.zeros_like(leaf_cnt)
            lower = ex + (partf * p_lb).sum(axis=1, dtype=np.float32)
            upper = ex + (partf * p_ub).sum(axis=1, dtype=np.float32)
            est = np.where(partial_m.any(axis=1),
                           (lower + upper) * np.float32(0.5), ex)
        elif kind == "avg":
            has_cover = cover.any(axis=1)
            c_sum = (cover.astype(np.float32) * leaf_sum).sum(
                axis=1, dtype=np.float32)
            c_cnt = (cover.astype(np.float32) * leaf_cnt).sum(
                axis=1, dtype=np.float32)
            avg_cover = c_sum / np.maximum(c_cnt, np.float32(1))
            p_only = partial_m & ~cover
            p_any = p_only.any(axis=1)
            pmax = np.where(p_only, leaf_max, -_BIG).max(axis=1)
            pmin = np.where(p_only, leaf_min, _BIG).min(axis=1)
            upper = np.where(has_cover & p_any, np.maximum(avg_cover, pmax),
                             np.where(has_cover, avg_cover, pmax))
            lower = np.where(has_cover & p_any, np.minimum(avg_cover, pmin),
                             np.where(has_cover, avg_cover, pmin))
            est = np.where(p_any, (lower + upper) * np.float32(0.5),
                           avg_cover)
        elif kind in ("min", "max"):
            sign = np.float32(1.0 if kind == "min" else -1.0)
            key_leaf = leaf_min if kind == "min" else leaf_max
            # Zero samples: the observed extreme is the covered-leaf
            # extreme alone (partial strata contribute no observations).
            cover_ext = np.where(cover, sign * key_leaf, _BIG)
            est_s = cover_ext.min(axis=1)
            opt = np.where(cover | partial_m, sign * key_leaf,
                           _BIG).min(axis=1)
            est = sign * est_s
            lower = np.where(sign > 0, sign * opt, sign * est_s)
            upper = np.where(sign > 0, sign * est_s, sign * opt)
        else:
            raise ValueError(f"unknown kind: {kind}")
        est = est.astype(np.float32)
        lower = lower.astype(np.float32)
        upper = upper.astype(np.float32)
        half = ((upper - lower) * np.float32(0.5)).astype(np.float32)
        out[kind] = QueryResult(est, half, lower, upper, touched,
                                ci_lo=lower, ci_hi=upper)
    return out


# -- monotone interval intersection ----------------------------------------

def _merge_one(prev: QueryResult, new: QueryResult) -> QueryResult:
    """Intersect a refinement step's interval with the running envelope.

    Interval endpoints only move inward. Independent sample subsets can
    produce a (rare) empty intersection; the guard collapses it to the
    previous envelope's point nearest the new estimate, so consumers
    never see lo > hi. Both results are host numpy.
    """
    _, p_lo, p_hi = (np.asarray(x, np.float32) for x in prev.interval())
    n_est, n_lo, n_hi = (np.asarray(x, np.float32) for x in new.interval())
    lo = np.maximum(p_lo, n_lo)
    hi = np.minimum(p_hi, n_hi)
    crossed = lo > hi
    pin = np.clip(n_est, p_lo, p_hi)
    lo = np.where(crossed, pin, lo)
    hi = np.where(crossed, pin, hi)
    est = np.clip(n_est, lo, hi).astype(np.float32)
    lower = np.maximum(np.asarray(prev.lower, np.float32),
                       np.asarray(new.lower, np.float32))
    upper = np.minimum(np.asarray(prev.upper, np.float32),
                       np.asarray(new.upper, np.float32))
    bad = lower > upper
    lower = np.where(bad, np.minimum(lo, upper), lower)
    upper = np.where(bad, np.maximum(hi, lower), upper)
    return QueryResult(
        est, ((hi - lo) * np.float32(0.5)).astype(np.float32),
        lower.astype(np.float32), upper.astype(np.float32),
        np.asarray(new.frac_rows_touched, np.float32),
        ci_lo=lo.astype(np.float32), ci_hi=hi.astype(np.float32))


def merge_refinement(prev: dict, new: dict) -> dict:
    """Per-kind monotone merge of two ladder steps' host result dicts."""
    return {k: _merge_one(prev[k], new[k]) for k in prev}


def ladder_tiers(cap: int) -> list:
    """Sample-slot schedule: geometric slices up to the full reservoir.
    The final ``None`` tier is the ordinary full-sample entry."""
    tiers: list = []
    for frac in (8, 4, 2):
        s = max(1, cap // frac)
        if s < cap and (not tiers or s > tiers[-1]):
            tiers.append(s)
    tiers.append(None)
    return tiers


# -- the handle ------------------------------------------------------------

class RefinementHandle:
    """Anytime answer: tier 0 at once, sample tiers on demand.

    ``results`` always holds the best (monotonically tightened) host
    answer so far; ``refine()`` advances one tier, ``final()`` runs the
    remaining tiers, ``run()`` refines under the deadline / CI-width stop
    criteria (what ``engine.answer(deadline_ms=...)`` calls). ``tier``
    counts completed sample tiers (0 = aggregates only); ``last_step`` is
    the last tier's own answer on the host, before the merge (after
    ``final()``, the plain full-sample answer).
    """

    def __init__(self, engine, queries, serving, ci, *,
                 deadline_ms: float | None = None):
        self._engine = engine
        self._queries = queries
        self._serving = serving
        self._t0 = time.monotonic()
        self.deadline_ms = deadline_ms
        self.max_ci_width = None if ci is None else ci.max_ci_width
        # Tier steps go through engine.answer(); strip max_ci_width so the
        # step takes the direct path (the ladder owns the stop criteria).
        # max_ci_width is not part of CIConfig.cache_key(), so the stripped
        # config hits the same prepared entries.
        self._ci = (None if ci is None
                    else dataclasses.replace(ci, max_ci_width=None))
        cap = _tier0_snapshot(engine)["sample_cap"]
        self._tiers = ladder_tiers(cap)
        self.tier = 0
        self.last_step = None
        self.results = tier0_answer(engine, queries, serving.kinds)
        engine._stats["tier0_serves"] += 1

    # -- progress ----------------------------------------------------------
    @property
    def done(self) -> bool:
        return not self._tiers

    def elapsed_ms(self) -> float:
        return (time.monotonic() - self._t0) * 1e3

    def width(self) -> float:
        """Widest current interval over all kinds and queries."""
        w = 0.0
        for res in self.results.values():
            _, lo, hi = res.interval()
            w = max(w, float(np.max(np.asarray(hi) - np.asarray(lo))))
        return w

    def width_met(self) -> bool:
        return (self.max_ci_width is not None
                and self.width() <= self.max_ci_width)

    # -- stepping ----------------------------------------------------------
    def refine(self) -> dict[str, QueryResult]:
        """Run the next sample tier and tighten the running intervals."""
        from .coalescer import host_results
        if not self._tiers:
            return self.results
        slots = self._tiers.pop(0)
        eng = self._engine
        sv = dataclasses.replace(self._serving, sample_slots=slots)
        t0 = time.monotonic()
        step = host_results(eng.answer(self._queries, ci=self._ci,
                                       serving=sv))
        self.last_step = step
        self.results = merge_refinement(self.results, step)
        dt_ms = (time.monotonic() - t0) * 1e3
        prev = getattr(eng, "_refine_ewma_ms", 0.0)
        eng._refine_ewma_ms = (dt_ms if prev == 0.0
                               else (1 - _EWMA_ALPHA) * prev
                               + _EWMA_ALPHA * dt_ms)
        self.tier += 1
        eng._stats["refine_steps"] += 1
        return self.results

    def final(self) -> dict[str, QueryResult]:
        """Exhaust the ladder (the last tier is the full-sample answer)."""
        while self._tiers:
            self.refine()
        return self.results

    def run(self) -> dict[str, QueryResult]:
        """Refine until a stop criterion fires.

        Deadline: a tier only starts if the EWMA-predicted step latency
        still fits the remaining budget (the first step ever is optimistic:
        there is no estimate yet and tier 0 already guaranteed an answer).
        Width: stop as soon as every interval is at or under
        ``max_ci_width``. With neither criterion set, runs to the end.
        """
        while self._tiers:
            if self.width_met():
                break
            if self.deadline_ms is not None:
                predicted = getattr(self._engine, "_refine_ewma_ms", 0.0)
                if self.elapsed_ms() + predicted >= self.deadline_ms:
                    self._engine._stats["degraded_serves"] += 1
                    break
            self.refine()
        return self.results


__all__ = ["RefinementHandle", "tier0_answer", "merge_refinement",
           "ladder_tiers"]
