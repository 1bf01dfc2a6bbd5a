"""Answer assembly: derive every requested aggregate kind from the shared
executor artifacts (paper §2.2, §2.3, §3.3, §3.4).

  * SUM/COUNT: per-stratum Horvitz-Thompson scaling, with the exact part
    read from the executor's covered-aggregate accumulation.
  * AVG: 'ratio' answers est-SUM / est-COUNT with a delta-method CI;
    'stratum' is the paper-literal w_i = N_i / N_q weighting over
    relevant strata.
  * CLT confidence intervals with the finite-population correction.
  * Deterministic hard bounds from SUM/COUNT/MIN/MAX (§2.3), generalized
    to possibly-negative values.
  * 0-variance rule for AVG (§3.4).

``answer_batch`` is the serving core: one artifact stage answers the whole
``kinds`` tuple.
"""
from __future__ import annotations

import torch

from .. import minmax
from ..core.types import (Synopsis, QueryBatch, QueryResult, AGG_SUM,
                          AGG_COUNT, AGG_MIN, AGG_MAX)
from .executor import Artifacts, compute_artifacts

_BIG = 3.4e38

KINDS = ("sum", "count", "avg", "min", "max")


def _fpc(n_rows, k_leaf):
    """Finite population correction (N-K)/(N-1), clamped to [0, 1] (the
    reference's ``jnp.clip``). The quotient is never -0.0 (N >= 1), and on
    every other input ``clamp`` gives XLA's bits."""
    n = torch.clamp(n_rows, min=1.0)
    return torch.clamp((n - k_leaf) / torch.clamp(n - 1.0, min=1.0), 0.0, 1.0)


def avg_ratio_terms(syn: Synopsis, art: Artifacts, use_fpc: bool = True):
    """Shared AVG ratio-estimator pieces (§2.2 with estimated
    relevant-count weights, exact counts on covered strata).

    Returns (est, C, sampled, var_s, var_c, cov_sc): est/C are (Q,); the
    per-stratum delta-method variance terms are (Q, k). Consumed by the
    serving epilogue and by the interval composition."""
    leaf_agg = syn.leaf_agg.to(torch.float32)
    Ni = syn.n_rows.to(torch.float32)[None]
    k_leaf = syn.k_per_leaf.to(torch.float32)[None]
    Ki = torch.clamp(k_leaf, min=1.0)
    fpc = _fpc(Ni, k_leaf) if use_fpc else torch.ones_like(Ni)
    cover = art.cover
    k_pred, s_sum, s_sumsq = art.k_pred, art.s_sum, art.s_sumsq
    sampled = art.partial & ~cover & (k_pred >= 1.0)
    relf = (cover | sampled).to(torch.float32)
    leaf_sum = leaf_agg[:, AGG_SUM][None]
    leaf_cnt = leaf_agg[:, AGG_COUNT][None]
    s_hat_i = torch.where(cover, leaf_sum, Ni / Ki * s_sum) * relf
    c_hat_i = torch.where(cover, leaf_cnt, Ni / Ki * k_pred) * relf
    S = s_hat_i.sum(1)
    C = torch.clamp(c_hat_i.sum(1), min=1.0)
    est = S / C
    p = k_pred / Ki
    var_s = (Ni * Ni * minmax.max0(s_sumsq / Ki - (s_sum / Ki) ** 2)
             / Ki * fpc)
    var_c = Ni * Ni * minmax.max0(p - p * p) / Ki * fpc
    cov_sc = Ni * Ni * (s_sum / Ki) * (1.0 - p) / Ki * fpc
    return est, C, sampled, var_s, var_c, cov_sc


def assemble(syn: Synopsis, art: Artifacts, kind: str = "sum",
             lam=2.576, use_fpc: bool = True, zero_var_rule: bool = True,
             use_aggregates: bool = True, avg_mode: str = "ratio"
             ) -> QueryResult:
    """Derive one aggregate kind's QueryResult from shared artifacts.
    ``lam`` is the CI multiplier (a float, or a float32 0-d tensor)."""
    leaf_agg = syn.leaf_agg.to(torch.float32)
    n_rows = syn.n_rows.to(torch.float32)                # (k,)
    k_leaf = syn.k_per_leaf.to(torch.float32)            # (k,)
    cover = art.cover
    partial_m = art.partial
    k_pred, s_sum, s_sumsq = art.k_pred, art.s_sum, art.s_sumsq

    leaf_sum = leaf_agg[:, AGG_SUM][None]                 # (1, k)
    leaf_cnt = leaf_agg[:, AGG_COUNT][None]
    leaf_min = leaf_agg[:, AGG_MIN][None]
    leaf_max = leaf_agg[:, AGG_MAX][None]
    Ni = n_rows[None]
    Ki = torch.clamp(k_leaf[None], min=1.0)
    fpc = _fpc(Ni, k_leaf[None]) if use_fpc else torch.ones_like(Ni)

    partf = partial_m.to(torch.float32)
    touched = art.touched

    if kind in ("sum", "count"):
        if kind == "sum":
            exact = art.exact[:, AGG_SUM]
            est_part = Ni / Ki * s_sum
            mean_phi = s_sum / Ki                        # E[pred*a]
            mean_phi2 = s_sumsq / Ki                     # E[pred*a^2]
        else:
            exact = art.exact[:, AGG_COUNT]
            est_part = Ni / Ki * k_pred
            mean_phi = k_pred / Ki
            mean_phi2 = k_pred / Ki
        est = exact + (partf * est_part).sum(1)
        var_phi = Ni * Ni * minmax.max0(mean_phi2 - mean_phi ** 2)
        v_i = var_phi / Ki * fpc
        ci = lam * torch.sqrt((partf * v_i).sum(1))
        # Hard bounds (§2.3, sign-generalized).
        if kind == "sum":
            p_ub = minmax.minimum(Ni * minmax.max0(leaf_max),
                                  leaf_sum - Ni * minmax.min0(leaf_min))
            p_lb = minmax.maximum(Ni * minmax.min0(leaf_min),
                                  leaf_sum - Ni * minmax.max0(leaf_max))
        else:
            p_ub = leaf_cnt
            p_lb = torch.zeros_like(leaf_cnt)
        if use_aggregates:
            lower = exact + (partf * p_lb).sum(1)
            upper = exact + (partf * p_ub).sum(1)
        else:
            lower = torch.full_like(est, -_BIG)
            upper = torch.full_like(est, _BIG)
        return QueryResult(est, ci, lower, upper, touched)

    if kind == "avg":
        zv = (leaf_min == leaf_max) & (leaf_cnt > 0)
        # 0-variance rule (§3.4): only sound with whole-stratum weighting;
        # the ratio path already credits zv strata with zero variance.
        promote_zv = zero_var_rule and avg_mode == "stratum"
        cover_like = cover | (partial_m & zv) if promote_zv else cover
        sampled = partial_m & ~cover_like & (k_pred >= 1.0)
        relevant = cover_like | sampled
        relf = relevant.to(torch.float32)
        sampf = sampled.to(torch.float32)
        mean_cover = leaf_sum / torch.clamp(leaf_cnt, min=1.0)
        mean_samp = s_sum / torch.clamp(k_pred, min=1.0)
        mean_i = torch.where(cover_like, mean_cover, mean_samp)
        kp = torch.clamp(k_pred, min=1.0)

        if avg_mode == "stratum":
            # Paper-literal §2.2 weights: w_i = N_i / N_q over relevant
            # strata.
            Nq = torch.clamp((relf * Ni).sum(1, keepdim=True), min=1.0)
            w = relf * Ni / Nq                           # (Q, k)
            est = (w * mean_i * relf).sum(1)
            e_phi2 = (Ki / kp) ** 2 * (s_sumsq / Ki)
            var_phi = minmax.max0(e_phi2 - mean_samp ** 2)
            v_i = var_phi / Ki * fpc
            ci = lam * torch.sqrt((sampf * (w ** 2) * v_i).sum(1))
        else:
            # Ratio estimator AVG = est-SUM / est-COUNT with the
            # delta-method terms shared with the interval composition.
            est, C, sampled_r, var_s, var_c, cov_sc = avg_ratio_terms(
                syn, art, use_fpc)
            sampf_r = sampled_r.to(torch.float32)
            VS = (sampf_r * var_s).sum(1)
            VC = (sampf_r * var_c).sum(1)
            CSC = (sampf_r * cov_sc).sum(1)
            var_ratio = (minmax.max0(VS - 2 * est * CSC + est * est * VC)
                         / (C * C))
            ci = lam * torch.sqrt(var_ratio)

        # Hard bounds (§2.3): any relevant stratum counts.
        if use_aggregates:
            has_cover = cover_like.any(1)
            coverf = cover_like.to(torch.float32)
            c_sum = (coverf * leaf_sum).sum(1)
            c_cnt = (coverf * leaf_cnt).sum(1)
            avg_cover = c_sum / torch.clamp(c_cnt, min=1.0)
            part_only = partial_m & ~cover_like
            p_any = part_only.any(1)
            # The bounds are outputs: their MIN/MAX follow the reference's
            # signed-zero rule (a stratum's extreme may be -0.0 or +0.0).
            pmax = minmax.masked_max(leaf_max, part_only, -_BIG, 1)
            pmin = minmax.masked_min(leaf_min, part_only, _BIG, 1)
            upper = torch.where(has_cover & p_any,
                                minmax.maximum(avg_cover, pmax),
                                torch.where(has_cover, avg_cover, pmax))
            lower = torch.where(has_cover & p_any,
                                minmax.minimum(avg_cover, pmin),
                                torch.where(has_cover, avg_cover, pmin))
        else:
            lower = torch.full_like(est, -_BIG)
            upper = torch.full_like(est, _BIG)
        return QueryResult(est, ci, lower, upper, touched)

    if kind in ("min", "max"):
        sign = 1.0 if kind == "min" else -1.0
        key_leaf = leaf_min if kind == "min" else leaf_max
        # Relevant-sample extreme per stratum (from the shared extreme pass).
        samp_ext = art.samp_min if kind == "min" else -art.samp_max
        # The reference's min of the covered leaves' extremes and the min of
        # the partial strata's sample extremes, as one min over both (cover
        # and partial are exclusive); signed zeros follow its rule.
        relevant = cover | partial_m
        est_s = minmax.masked_min(torch.where(cover, sign * key_leaf,
                                              samp_ext), relevant, _BIG, 1)
        # Bounds: the true extreme lies between the optimistic leaf extreme
        # over all relevant strata and the observed estimate.
        opt = minmax.masked_min(sign * key_leaf, relevant, _BIG, 1)
        est = sign * est_s
        lower = sign * opt if sign > 0 else sign * est_s
        upper = sign * est_s if sign > 0 else sign * opt
        ci = torch.abs(upper - lower) * 0.5  # deterministic envelope
        # The estimate sits at one END of the envelope, so the envelope
        # itself is the interval.
        return QueryResult(est, ci, lower, upper, touched,
                           ci_lo=lower, ci_hi=upper)

    raise ValueError(f"unknown kind: {kind}")


def answer_batch(syn: Synopsis, queries: QueryBatch, plan_masks=None, *,
                 kinds, lam, use_fpc: bool, zero_var_rule: bool,
                 use_aggregates: bool, avg_mode: str
                 ) -> dict[str, QueryResult]:
    """One artifact stage feeding every requested kind's epilogue."""
    art = compute_artifacts(syn, queries, kinds,
                            use_aggregates=use_aggregates,
                            plan_masks=plan_masks)
    return {k: assemble(syn, art, k, lam, use_fpc, zero_var_rule,
                        use_aggregates, avg_mode)
            for k in kinds}


def answer(syn: Synopsis, queries: QueryBatch, kinds=("sum",), *,
           lam: float | None = None, use_fpc: bool | None = None,
           zero_var_rule: bool | None = None,
           use_aggregates: bool | None = None, avg_mode: str | None = None,
           backend: str | None = None,
           plan=None, ci: float | None = None, ci_method: str | None = None,
           small_n_threshold: int | None = None, n_boot: int | None = None,
           ci_key=None, device=None) -> dict[str, QueryResult]:
    """Deprecated shim: answer a batch of rectangular aggregate queries for
    every requested aggregate kind from one shared artifact pass.

    Returns ``{kind: QueryResult}``. Use ``repro_torch.api.PassEngine``
    instead: the frozen ``ServingConfig`` / ``CIConfig`` dataclasses there
    are the single source of truth for every default this signature used
    to duplicate (unset kwargs below inherit them), and a long-lived
    engine additionally caches prepared per-shape plans across calls.
    ``backend`` must be None; ``device=None`` serves on the CUDA card.
    """
    from .. import api
    from ..api.config import merge_overrides
    api.warn_once(
        "repro_torch.engine.answer",
        "repro_torch.api.PassEngine(source, serving=ServingConfig(kinds=...), "
        "ci=CIConfig(level=...)).answer(queries)")
    serving = merge_overrides(
        api.ServingConfig(kinds=kinds, backend=backend),
        lam=lam, use_fpc=use_fpc, zero_var_rule=zero_var_rule,
        use_aggregates=use_aggregates, avg_mode=avg_mode)
    ci_cfg = None
    if ci is not None:
        ci_cfg = merge_overrides(
            api.CIConfig(level=float(ci)), method=ci_method,
            small_n_threshold=small_n_threshold, n_boot=n_boot, key=ci_key)
    eng = api.PassEngine(syn, serving=serving, ci=ci_cfg, device=device)
    return eng.answer(queries, plan=plan)


__all__ = ["assemble", "answer", "answer_batch", "avg_ratio_terms", "KINDS"]
