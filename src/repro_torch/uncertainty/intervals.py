"""Stratified confidence intervals with exact-strata zeroing and
small-stratum fallbacks (paper §2.1.1, §3.3).

* strata resolved exactly (covered leaves) contribute exactly zero
  variance, so fully covered queries get zero-width intervals;
* sampled strata with a healthy effective sample size use the CLT
  per-stratum variance with the finite-population correction;
* sampled strata whose relevant-sample count ``k_pred`` falls below
  ``small_n_threshold`` use an empirical-Bernstein bound (Maurer-Pontil)
  from the same moments plus the stratum's exact value range, and the
  deterministic range bound when the stratum holds no samples at all;
* endpoints are clipped into the §2.3 deterministic hard bounds.

The composed half-width is ``z * sqrt(sum CLT variances) + sum fallback
half-widths``.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import minmax
from ..core.types import Synopsis, QueryBatch, QueryResult, AGG_MIN, AGG_MAX
from ..engine.assemble import _fpc, assemble, avg_ratio_terms
from ..engine.executor import compute_artifacts


def _z_of(level: float, device=None) -> torch.Tensor:
    """Two-sided standard-normal quantile as a float32 0-d tensor: float32
    ``ndtri(0.5 + level / 2)``, as the reference evaluates it."""
    half = torch.tensor(level, dtype=torch.float32, device=device) / 2.0
    return torch.special.ndtri(0.5 + half)


def normal_quantile(level: float) -> float:
    """Two-sided standard-normal quantile: z with P(|N(0,1)| <= z) = level."""
    if not 0.0 < level < 1.0:
        raise ValueError(f"confidence level must be in (0, 1), got {level}")
    return float(_z_of(level))


def _stratum_terms(syn: Synopsis, art, kind: str, use_fpc: bool):
    """Per-(query, stratum) CLT variance + empirical-Bernstein ingredients
    for one linear kind ('sum' | 'count').

    Returns (v_clt, var_hat, range_hi, range_lo, no_sample_half), each
    broadcastable to (Q, k)."""
    leaf_agg = syn.leaf_agg.to(torch.float32)
    Ni = syn.n_rows.to(torch.float32)[None]
    k_leaf = syn.k_per_leaf.to(torch.float32)[None]
    Ki = torch.clamp(k_leaf, min=1.0)
    fpc = _fpc(Ni, k_leaf) if use_fpc else torch.ones_like(Ni)
    leaf_min = leaf_agg[:, AGG_MIN][None]
    leaf_max = leaf_agg[:, AGG_MAX][None]

    if kind == "sum":
        mean_phi = art.s_sum / Ki                        # E[pred * a]
        mean_phi2 = art.s_sumsq / Ki
        range_lo = minmax.min0(leaf_min)                 # phi support
        range_hi = minmax.max0(leaf_max)
        # range_hi is never -0.0, so where the max is a zero XLA's is
        # +0.0; max0 makes every zero +0.0 and keeps the rest.
        no_sample_half = Ni * minmax.max0(torch.maximum(range_hi, -range_lo))
    elif kind == "count":
        mean_phi = art.k_pred / Ki                       # E[pred]
        mean_phi2 = mean_phi
        range_lo = torch.zeros_like(Ni)
        range_hi = torch.ones_like(Ni)
        no_sample_half = Ni
    else:
        raise ValueError(f"no stratum terms for kind: {kind}")

    var_hat = minmax.max0(mean_phi2 - mean_phi ** 2)
    v_clt = Ni * Ni * var_hat / Ki * fpc
    return v_clt, var_hat * fpc, range_hi, range_lo, no_sample_half


def _fallback_half(syn: Synopsis, var_hat, range_hi, range_lo,
                   no_sample_half, log_term):
    """(Q, k) empirical-Bernstein half-width of each stratum's contribution:
    Ni * (sqrt(2 V L / K) + 3 R L / K), degrading to the deterministic range
    bound for strata with zero allocated samples."""
    Ni = syn.n_rows.to(torch.float32)[None]
    k_leaf = syn.k_per_leaf.to(torch.float32)[None]
    Ki = torch.clamp(k_leaf, min=1.0)
    rng = minmax.max0(range_hi - range_lo)
    bern = Ni * (torch.sqrt(2.0 * var_hat * log_term / Ki)
                 + 3.0 * rng * log_term / Ki)
    return torch.where(k_leaf > 0, bern, no_sample_half)


def compose_interval(syn: Synopsis, art, kind: str, level: float,
                     small_n_threshold: int = 12, use_fpc: bool = True,
                     avg_mode: str = "ratio", delta_budget: str = "stratum"):
    """Half-width of the ``level`` interval for one kind from shared
    artifacts. Returns (half, n_fallback), both (Q,).

    ``delta_budget``: 'stratum' gives every fallback stratum the full
    delta = 1 - level; 'union' splits delta / n_fallback per query (the
    union bound making the joint fallback guarantee hold at the level).
    """
    if delta_budget not in ("stratum", "union"):
        raise ValueError(f"unknown delta_budget: {delta_budget!r}")
    dev = art.cover.device
    z = _z_of(level, dev)
    delta = 1.0 - level
    sampled = art.partial & ~art.cover
    sampf = sampled.to(torch.float32)
    fb = sampled & (art.k_pred < float(small_n_threshold))
    fbf = fb.to(torch.float32)
    cltf = sampf * (1.0 - fbf)
    n_fallback = fbf.sum(1)
    if delta_budget == "union":
        # (Q, 1): each stratum's Bernstein bound runs at delta / n_fb.
        log_term = torch.log(
            3.0 * torch.clamp(n_fallback, min=1.0) / delta)[:, None]
    else:
        log_term = torch.log(torch.tensor(3.0 / delta, dtype=torch.float32,
                                          device=dev))

    if kind in ("sum", "count"):
        v_clt, var_hat, r_hi, r_lo, ns_half = _stratum_terms(
            syn, art, kind, use_fpc)
        half_clt = z * torch.sqrt((cltf * v_clt).sum(1))
        h_fb = _fallback_half(syn, var_hat, r_hi, r_lo, ns_half, log_term)
        # where-mask, not multiply: empty leaves carry +/-inf extremes and
        # 0 * inf would leak NaN through a multiplicative mask
        return half_clt + torch.where(fb, h_fb, 0.0).sum(1), n_fallback

    if kind == "avg":
        if avg_mode != "ratio":
            raise ValueError(
                "calibrated intervals support avg_mode='ratio' only")
        est, C, sampled_r, var_s, var_c, cov_sc = avg_ratio_terms(
            syn, art, use_fpc)
        clt_r = (sampled_r & ~fb).to(torch.float32)
        VS = (clt_r * var_s).sum(1)
        VC = (clt_r * var_c).sum(1)
        CSC = (clt_r * cov_sc).sum(1)
        var_ratio = (minmax.max0(VS - 2 * est * CSC + est * est * VC)
                     / (C * C))
        half_clt = z * torch.sqrt(var_ratio)
        # Fallback strata perturb both numerator and denominator:
        # |S/C - S*/C*| <= (hS + |est| hC) / max(C - hC, 1).
        _, vh_sum, rhi_s, rlo_s, ns_s = _stratum_terms(syn, art, "sum",
                                                       use_fpc)
        _, vh_cnt, rhi_c, rlo_c, ns_c = _stratum_terms(syn, art, "count",
                                                       use_fpc)
        hS = torch.where(fb, _fallback_half(syn, vh_sum, rhi_s, rlo_s, ns_s,
                                            log_term), 0.0).sum(1)
        hC = torch.where(fb, _fallback_half(syn, vh_cnt, rhi_c, rlo_c, ns_c,
                                            log_term), 0.0).sum(1)
        half_fb = (hS + torch.abs(est) * hC) / torch.clamp(C - hC, min=1.0)
        return half_clt + half_fb, n_fallback

    raise ValueError(f"no interval composition for kind: {kind}")


def _join_fb_half(jsyn, jart, kind: str, log_term, over_cell):
    """(Q, k*P) fallback half-width of each sampled cell's contribution:
    empirical Bernstein on the key-group HT sum, degrading to the
    deterministic cell range when the cell has no contributing group or
    its stratum's universe buffer overflowed (truncation breaks the HT
    unbiasedness the Bernstein bound rests on)."""
    from ..joins.assemble import join_cell_bounds
    p_lb, p_ub = join_cell_bounds(jsyn, kind)
    e = jart.s_cell if kind == "sum" else jart.c_cell
    v = jart.v_s if kind == "sum" else jart.v_c
    r = jart.r_s if kind == "sum" else jart.r_c
    # The HT estimate may fall outside the deterministic cell range: the
    # bound is the distance from the estimate to the farther end.
    det = minmax.maximum(p_ub[None] - e, e - p_lb[None])
    bern = torch.sqrt(2.0 * v * log_term) + (2.0 / 3.0) * r * log_term
    return torch.where((jart.n_grp > 0) & ~over_cell,
                       minmax.minimum(bern, det), det)


def compose_join_interval(jsyn, jart, kind: str, level: float,
                          small_n_threshold: int = 12,
                          delta_budget: str = "stratum"):
    """Half-width of the ``level`` interval for one join kind from shared
    join artifacts (DESIGN.md §13). Returns (half, n_fallback), both (Q,).

    :func:`compose_interval` at cell granularity: covered cells contribute
    zero (a query of covered cells only gets a zero-width interval);
    sampled cells with enough contributing key groups use the CLT
    variance of the HT estimate; cells below ``small_n_threshold`` groups,
    or in strata whose universe buffer overflowed, fall back to
    min(empirical Bernstein, deterministic cell range).
    """
    if delta_budget not in ("stratum", "union"):
        raise ValueError(f"unknown delta_budget: {delta_budget!r}")
    dev = jart.sampled.device
    z = _z_of(level, dev)
    delta = 1.0 - level
    p_dim = jsyn.num_partitions
    over_cell = torch.repeat_interleave(jsyn.u_overflow > 0, p_dim)[None]
    fb = jart.sampled & ((jart.n_grp < float(small_n_threshold))
                         | over_cell)
    cltf = (jart.sampled & ~fb).to(torch.float32)
    n_fallback = fb.to(torch.float32).sum(1)
    if delta_budget == "union":
        log_term = torch.log(
            3.0 * torch.clamp(n_fallback, min=1.0) / delta)[:, None]
    else:
        log_term = torch.log(torch.tensor(3.0 / delta, dtype=torch.float32,
                                          device=dev))

    if kind in ("sum", "count"):
        v = jart.v_s if kind == "sum" else jart.v_c
        half_clt = z * torch.sqrt((cltf * v).sum(1))
        h = _join_fb_half(jsyn, jart, kind, log_term, over_cell)
        return half_clt + torch.where(fb, h, 0.0).sum(1), n_fallback

    if kind == "avg":
        from ..joins.assemble import join_sum_count
        s, c = join_sum_count(jart)
        est = s / c
        vs = (cltf * jart.v_s).sum(1)
        vc = (cltf * jart.v_c).sum(1)
        csc = (cltf * jart.cov_sc).sum(1)
        var_ratio = minmax.max0(vs - 2 * est * csc + est * est * vc) / (c * c)
        h_s = torch.where(fb, _join_fb_half(jsyn, jart, "sum", log_term,
                                            over_cell), 0.0).sum(1)
        h_c = torch.where(fb, _join_fb_half(jsyn, jart, "count", log_term,
                                            over_cell), 0.0).sum(1)
        half_fb = (h_s + torch.abs(est) * h_c) / torch.clamp(c - h_c,
                                                             min=1.0)
        return z * torch.sqrt(var_ratio) + half_fb, n_fallback

    raise ValueError(f"no join interval composition for kind: {kind}")


def compose_two_stage(t_hat, v_within, h_fb, pi, mask, z):
    """Two-stage (partition-sampling x within-stratum) composition for the
    catalog tier (DESIGN.md §14).

    Per-partition inputs, all (Q, P) but ``pi`` (P,): ``t_hat`` the
    within-partition estimate of the partition's contribution,
    ``v_within`` its summed within-stratum CLT variance, ``h_fb`` its
    summed small-stratum fallback half-widths, ``pi`` the recorded
    inclusion probabilities and ``mask`` the (Q, P) float32 mask of the
    partitions serving query q through the sampled (overlapping,
    selected) stage.

    Returns ``(ht, half, v)``: the Horvitz-Thompson total ``sum
    mask·t_hat/pi``, the half-width ``z·sqrt(V) + sum mask·h_fb/pi`` and
    the two-stage variance estimate

        V = sum mask · [ (1 - pi)·t_hat² + v_within ] / pi²

    (plugging t_hat² for t² biases V upward by v_within(1-pi)/pi², as
    PS3's accounting does). Exact-covered partitions never enter the mask,
    so a fully pruned or covered query gets a zero-width interval.
    """
    pi_ = torch.clamp(pi, min=1e-6)[None]
    ht = (mask * t_hat / pi_).sum(1)
    v = (mask * ((1.0 - pi_) * t_hat * t_hat + v_within)
         / (pi_ * pi_)).sum(1)
    half = z * torch.sqrt(minmax.max0(v)) + (mask * h_fb / pi_).sum(1)
    return ht, half, v


def _with_interval(res: QueryResult, half, clip_bounds: bool) -> QueryResult:
    lo = res.estimate - half
    hi = res.estimate + half
    if clip_bounds:
        # Truth always lies inside the deterministic hard bounds, so the
        # clip preserves coverage while tightening the interval; both ends
        # in one clip, zero ties as the reference's jnp.clip.
        lo, hi = minmax.clip(torch.stack([lo, hi]), res.lower,
                             res.upper).unbind()
    return dataclasses.replace(res, ci_half=half, ci_lo=lo, ci_hi=hi)


def ci_answer(syn: Synopsis, queries: QueryBatch, plan_masks=None, *,
              kinds, level: float, small_n_threshold: int, use_fpc: bool,
              zero_var_rule: bool, use_aggregates: bool, avg_mode: str,
              delta_budget: str) -> dict[str, QueryResult]:
    """One artifact stage feeding every requested kind's estimate epilogue
    AND its interval composition."""
    z = _z_of(level, syn.device)
    art = compute_artifacts(syn, queries, kinds,
                            use_aggregates=use_aggregates,
                            plan_masks=plan_masks)
    out = {}
    for kind in kinds:
        res = assemble(syn, art, kind, z, use_fpc, zero_var_rule,
                       use_aggregates, avg_mode)
        if kind in ("sum", "count", "avg"):
            half, _ = compose_interval(syn, art, kind, level,
                                       small_n_threshold=small_n_threshold,
                                       use_fpc=use_fpc, avg_mode=avg_mode,
                                       delta_budget=delta_budget)
            out[kind] = _with_interval(res, half, clip_bounds=use_aggregates)
        else:
            # MIN/MAX: assemble already set the deterministic envelope as
            # the interval (the estimate sits at one end of it).
            out[kind] = res
    return out


def answer_with_ci(syn, queries: QueryBatch, kinds, *, level: float,
                   small_n_threshold: int = 12, use_fpc: bool = True,
                   zero_var_rule: bool = True, use_aggregates: bool = True,
                   avg_mode: str = "ratio", backend: str | None = None,
                   plan=None, delta_budget: str = "stratum", device=None
                   ) -> dict[str, QueryResult]:
    """Deprecated shim: every requested kind's QueryResult carries
    calibrated ``ci_lo``/``ci_hi`` endpoints from ONE artifact pass.

    Use ``repro_torch.api.PassEngine(syn, serving=ServingConfig(
    kinds=...), ci=CIConfig(level=...)).answer(queries)`` instead: the
    configs there are the single source of truth for these defaults.
    ``backend`` must be None; ``device=None`` serves on the CUDA card.
    """
    from .. import api
    api.warn_once(
        "repro_torch.uncertainty.answer_with_ci",
        "repro_torch.api.PassEngine(syn, serving=ServingConfig(kinds=...), "
        "ci=CIConfig(level=..., method='clt')).answer(queries)")
    eng = api.PassEngine(
        syn,
        serving=api.ServingConfig(
            kinds=tuple(kinds), backend=backend, use_fpc=use_fpc,
            zero_var_rule=zero_var_rule, use_aggregates=use_aggregates,
            avg_mode=avg_mode),
        ci=api.CIConfig(level=float(level), method="clt",
                        small_n_threshold=int(small_n_threshold),
                        delta_budget=delta_budget),
        device=device)
    return eng.answer(queries, plan=plan)


__all__ = ["normal_quantile", "compose_interval", "compose_join_interval",
           "compose_two_stage", "ci_answer", "answer_with_ci"]
