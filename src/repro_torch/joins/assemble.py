"""Join answer assembly: SUM/COUNT/AVG estimates, deterministic hard
bounds and CLT variances from the shared join artifacts (DESIGN.md §13);
the port of ``repro/joins/assemble.py``.

Universe-sampling Horvitz-Thompson: covered (fact stratum x dim
partition) cells are answered from the pre-joined ``cell_agg`` with zero
variance; each sampled cell contributes its key groups' HT totals, with
variance ``(1 - p) sum_g t_g^2`` and the SUM-COUNT covariance for AVG;
hard bounds come from the exact cell aggregates. Every MIN/MAX, clamp at
zero and masked extreme goes through :mod:`repro_torch.minmax`, so its
zeros carry the reference's signs.
"""
from __future__ import annotations

import torch

from .. import minmax
from ..core.types import QueryResult, AGG_SUM, AGG_COUNT, AGG_MIN, AGG_MAX

_BIG = 3.4e38


def join_cell_bounds(jsyn, kind: str):
    """(p_lb, p_ub): each (k*P,) f32 deterministic bounds on one cell's
    contribution to a query it overlaps; empty cells bound to [0, 0]."""
    kp = jsyn.num_leaves * jsyn.num_partitions
    cell = jsyn.cell_agg.reshape(kp, -1)
    cnt = cell[:, AGG_COUNT]
    if kind == "count":
        return torch.zeros_like(cnt), cnt
    if kind != "sum":
        raise ValueError(f"no join cell bounds for kind: {kind}")
    s = cell[:, AGG_SUM]
    # where-mask, not multiply: empty cells carry +/-inf extremes
    mn = torch.where(cnt > 0, cell[:, AGG_MIN], 0.0)
    mx = torch.where(cnt > 0, cell[:, AGG_MAX], 0.0)
    p_ub = minmax.minimum(cnt * minmax.max0(mx), s - cnt * minmax.min0(mn))
    p_lb = minmax.maximum(cnt * minmax.min0(mn), s - cnt * minmax.max0(mx))
    return p_lb, p_ub


def join_sum_count(jart):
    """Shared (S, C) estimates: exact covered part + HT sampled part; C is
    clamped to >= 1 for ratio use."""
    sampf = jart.sampled.to(torch.float32)
    s = jart.exact3[:, AGG_SUM] + (sampf * jart.s_cell).sum(1)
    c = jart.exact3[:, AGG_COUNT] + (sampf * jart.c_cell).sum(1)
    return s, torch.clamp(c, min=1.0)


def assemble_join(jsyn, jart, kind: str, lam) -> QueryResult:
    """One kind's QueryResult from shared join artifacts. ``lam`` scales
    the plain CLT half-width; the calibrated path replaces it through
    ``uncertainty.intervals.compose_join_interval``."""
    sampf = jart.sampled.to(torch.float32)
    touched = jart.touched

    if kind in ("sum", "count"):
        if kind == "sum":
            exact = jart.exact3[:, AGG_SUM]
            est = exact + (sampf * jart.s_cell).sum(1)
            var = (sampf * jart.v_s).sum(1)
        else:
            exact = jart.exact3[:, AGG_COUNT]
            est = exact + (sampf * jart.c_cell).sum(1)
            var = (sampf * jart.v_c).sum(1)
        ci = lam * torch.sqrt(var)
        p_lb, p_ub = join_cell_bounds(jsyn, kind)
        lower = exact + (sampf * p_lb[None]).sum(1)
        upper = exact + (sampf * p_ub[None]).sum(1)
        return QueryResult(est, ci, lower, upper, touched)

    if kind == "avg":
        s, c = join_sum_count(jart)
        est = s / c
        vs = (sampf * jart.v_s).sum(1)
        vc = (sampf * jart.v_c).sum(1)
        csc = (sampf * jart.cov_sc).sum(1)
        var_ratio = minmax.max0(vs - 2 * est * csc + est * est * vc) / (c * c)
        ci = lam * torch.sqrt(var_ratio)
        # Hard bounds: the covered cells' exact average against the sampled
        # cells' extremes, the single-table assembler's logic per cell.
        kp = jsyn.num_leaves * jsyn.num_partitions
        cell = jsyn.cell_agg.reshape(kp, -1)
        exact_c = jart.exact3[:, AGG_COUNT]
        has_cover = exact_c > 0
        avg_cover = jart.exact3[:, AGG_SUM] / torch.clamp(exact_c, min=1.0)
        p_any = jart.sampled.any(1)
        pmax = minmax.masked_max(cell[:, AGG_MAX][None], jart.sampled, -_BIG,
                                 1)
        pmin = minmax.masked_min(cell[:, AGG_MIN][None], jart.sampled, _BIG,
                                 1)
        both = has_cover & p_any
        upper = torch.where(both, minmax.maximum(avg_cover, pmax),
                            torch.where(has_cover, avg_cover, pmax))
        lower = torch.where(both, minmax.minimum(avg_cover, pmin),
                            torch.where(has_cover, avg_cover, pmin))
        return QueryResult(est, ci, lower, upper, touched)

    raise ValueError(f"unsupported join kind: {kind} "
                     "(join serving supports sum/count/avg)")


__all__ = ["assemble_join", "join_cell_bounds", "join_sum_count"]
