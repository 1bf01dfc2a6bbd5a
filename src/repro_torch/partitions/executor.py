"""Catalog-tier serving: one artifact pass over stacked partition
synopses and Horvitz-Thompson composition (DESIGN.md §14); the port of
``repro/partitions/executor.py``.

The selected partitions' PASS synopses have one shape (k strata x s
samples, :class:`~repro_torch.api.CatalogConfig`), so they stack along the
stratum axis into one pseudo-synopsis of ``P_pad·k`` strata. The artifact
stage (``engine/executor.compute_artifacts``) reads only the leaf and
sample arrays, never the tree, so the stacked view goes through the flat
path's two kernels, ``query_eval`` and ``stratified_moments``, once a
batch however many partitions were picked. Per-partition terms come from
reshaping the (Q, P_pad·k) artifacts to (Q, P_pad, k) and summing the
stratum axis, and compose as

    estimate(q) = exact_covered(q) + sum_{p in S∩O(q)} t_hat_qp / pi_p

with the two-stage variance of
:func:`repro_torch.uncertainty.intervals.compose_two_stage` on top of the
within-stratum CLT / Bernstein terms, and §2.3 hard bounds at catalog
granularity (valid under any selection: they bound the unpicked mass
too). Estimates and interval ends are clipped into those bounds.

The selected-partition count is padded to a power of two with empty
blocks (no rows, pi = 1, masked out of every query): inverted +-inf leaf
boxes and +inf / -inf MIN / MAX aggregates, which ``query_eval`` never
marks covered and ``stratified_moments`` finds empty. Every MIN, MAX and
clip follows the reference's signed-zero rule (:mod:`repro_torch.minmax`).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import minmax
from ..core.types import (Synopsis, PartitionTree, QueryResult, NUM_AGGS,
                          AGG_SUM, AGG_COUNT, AGG_MIN, AGG_MAX)
from ..device import resolve_device
from ..engine.assemble import _fpc
from ..engine.executor import compute_artifacts
from ..uncertainty.intervals import (_z_of, _stratum_terms, _fallback_half,
                                     compose_two_stage)

CATALOG_KINDS = ("sum", "count", "avg")

_INF = float("inf")
_BIG = 3.4e38


def _dummy_tree(d: int, device) -> PartitionTree:
    """1-node placeholder tree: the stacked pseudo-synopsis is served by
    the artifact stage only, which never reads the tree."""
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return PartitionTree(
        lo=torch.full((1, d), _INF, **f32),
        hi=torch.full((1, d), -_INF, **f32),
        agg=torch.zeros((1, NUM_AGGS), **f32),
        left=torch.full((1,), -1, **i32), right=torch.full((1,), -1, **i32),
        leaf_id=torch.full((1,), -1, **i32), level=torch.zeros((1,), **i32))


def empty_partition_synopsis(k: int, s: int, d: int,
                             device=None) -> Synopsis:
    """All-empty partition synopsis of the uniform shape (the pad block)
    on ``device`` (None = the CUDA card): inverted leaf boxes classify as
    no relation against every query, invalid samples give zero moments."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    agg = torch.zeros((k, NUM_AGGS), **f32)
    agg[:, AGG_MIN] = _INF
    agg[:, AGG_MAX] = -_INF
    return Synopsis(
        leaf_lo=torch.full((k, d), _INF, **f32),
        leaf_hi=torch.full((k, d), -_INF, **f32),
        leaf_agg=agg,
        n_rows=torch.zeros((k,), **f32),
        sample_c=torch.zeros((k, s, d), **f32),
        sample_a=torch.zeros((k, s), **f32),
        sample_valid=torch.zeros((k, s), dtype=torch.bool, device=dev),
        k_per_leaf=torch.zeros((k,), dtype=torch.int32, device=dev),
        tree=_dummy_tree(d, dev), num_leaves=k, d=d,
        total_rows=torch.zeros((), **f32))


_STACKED = ("leaf_lo", "leaf_hi", "leaf_agg", "n_rows", "sample_c",
            "sample_a", "sample_valid", "k_per_leaf")


def _cat(blocks, name: str) -> torch.Tensor:
    return torch.cat([getattr(b, name) for b in blocks], 0)


def pad_partition_synopsis(syn: Synopsis, k: int, d: int) -> Synopsis:
    """Pad a partition synopsis whose realized stratum count came in under
    the configured ``k`` (kd partitioning realizes <= k leaves) with empty
    strata, so every partition stacks at shape k."""
    k0 = int(syn.num_leaves)
    if k0 == k:
        return syn
    if k0 > k:
        raise ValueError(f"partition synopsis has {k0} strata > k={k}")
    s = syn.sample_a.shape[1]
    pad = empty_partition_synopsis(k - k0, s, d, syn.device)
    return dataclasses.replace(
        syn, **{f: _cat((syn, pad), f) for f in _STACKED},
        tree=_dummy_tree(d, syn.device), num_leaves=k)


def stack_synopses(syns, pad_to: int, k: int, s: int, d: int,
                   device=None) -> Synopsis:
    """Stack uniform-shape partition synopses along the stratum axis into
    one pseudo-synopsis of ``pad_to * k`` strata on their device (on
    ``device`` when there is none), empty blocks padding the tail: one
    ``torch.cat`` a field. ``total_rows`` is the sum of the blocks' row
    counts, integers, so its float32 sum is exact in any order below
    2**24 rows."""
    if len(syns) > pad_to:
        raise ValueError(f"{len(syns)} synopses > pad_to={pad_to}")
    dev = syns[0].device if syns else resolve_device(device)
    blocks = list(syns)
    if pad_to > len(blocks):
        empty = empty_partition_synopsis(k, s, d, dev)
        blocks += [empty] * (pad_to - len(blocks))
    return Synopsis(
        **{f: _cat(blocks, f) for f in _STACKED},
        tree=_dummy_tree(d, dev), num_leaves=pad_to * k, d=d,
        total_rows=torch.stack([b.total_rows for b in blocks]).sum())


def _linear_leaf_terms(syn, art, kind):
    """(Q, kt) exact and sampled per-stratum contribution terms of one
    linear kind over the stacked pseudo-synopsis."""
    leaf_agg = syn.leaf_agg.to(torch.float32)
    Ni = syn.n_rows.to(torch.float32)[None]
    Ki = torch.clamp(syn.k_per_leaf.to(torch.float32)[None], min=1.0)
    if kind == "sum":
        leaf_val = leaf_agg[:, AGG_SUM][None]
        est_l = Ni / Ki * art.s_sum
    else:
        leaf_val = leaf_agg[:, AGG_COUNT][None]
        est_l = Ni / Ki * art.k_pred
    exact_l = torch.where(art.cover, leaf_val, 0.0)
    samp_l = torch.where(art.partial, est_l, 0.0)
    return exact_l, samp_l


def _cov_sc_leaf(syn, art, use_fpc):
    """(Q, kt) per-stratum SUM/COUNT delta-method covariance (the
    ``avg_ratio_terms`` formula, so the catalog path composes the cross
    term the flat ratio interval uses)."""
    Ni = syn.n_rows.to(torch.float32)[None]
    k_leaf = syn.k_per_leaf.to(torch.float32)[None]
    Ki = torch.clamp(k_leaf, min=1.0)
    fpc = _fpc(Ni, k_leaf) if use_fpc else torch.ones_like(Ni)
    p = art.k_pred / Ki
    return Ni * Ni * (art.s_sum / Ki) * (1.0 - p) / Ki * fpc


def _sum_bounds(cat_m_agg, cat_cover, cat_overlap):
    """Catalog-granularity §2.3 hard bounds for SUM, valid under any
    partition selection (they bound the unpicked overlap mass too)."""
    S = cat_m_agg[:, AGG_SUM][None]
    n = cat_m_agg[:, AGG_COUNT][None]
    m0 = minmax.min0(cat_m_agg[:, AGG_MIN][None])
    M0 = minmax.max0(cat_m_agg[:, AGG_MAX][None])
    p_ub = minmax.minimum(n * M0, S - n * m0)
    p_lb = minmax.maximum(n * m0, S - n * M0)
    exact = (cat_cover * S).sum(1)
    return (exact + (cat_overlap * p_lb).sum(1),
            exact + (cat_overlap * p_ub).sum(1))


def _count_bounds(cat_m_agg, cat_cover, cat_overlap):
    n = cat_m_agg[:, AGG_COUNT][None]
    exact = (cat_cover * n).sum(1)
    return exact, exact + (cat_overlap * n).sum(1)


def _degrade_result(res, degm, has_ci):
    """Widen one kind's result to the catalog-granularity hard-bound
    envelope for the queries flagged in ``degm`` (they overlap a partition
    whose synopsis could not be built, DESIGN.md §15): the estimate at the
    envelope's midpoint, the interval the whole envelope."""
    mid = 0.5 * (res.lower + res.upper)
    wide = 0.5 * (res.upper - res.lower)
    out = dataclasses.replace(
        res, estimate=torch.where(degm, mid, res.estimate),
        ci_half=torch.where(degm, wide, res.ci_half))
    if has_ci:
        out = dataclasses.replace(
            out, ci_lo=torch.where(degm, res.lower, res.ci_lo),
            ci_hi=torch.where(degm, res.upper, res.ci_hi))
    return out


def _clipped(res: QueryResult, est, half) -> QueryResult:
    """``res`` with ci_lo / ci_hi = est -/+ half clipped into its hard
    bounds (both ends in one clip, zero ties as ``jnp.clip``'s)."""
    lo, hi = minmax.clip(torch.stack([est - half, est + half]), res.lower,
                         res.upper).unbind()
    return dataclasses.replace(res, ci_lo=lo, ci_hi=hi)


def catalog_answer(syn, queries, lam, pi, ov_sel, cat_cover, cat_overlap,
                   cat_m_agg, total_rows, deg_q, *, kinds, k_part: int,
                   level, small_n_threshold: int, use_fpc: bool,
                   delta_budget: str) -> dict[str, QueryResult]:
    """One artifact pass over the stacked partitions feeding every kind's
    HT composition (the reference's ``_catalog_answer_jit``).

    ``pi`` (P_pad,) and ``ov_sel`` (Q, P_pad) mask the stacked partitions;
    ``cat_cover`` / ``cat_overlap`` (Q, P_cat) and ``cat_m_agg`` (P_cat,
    NUM_AGGS) carry the catalog-level exact terms and bounds over every
    partition, selected or not; ``lam`` and ``total_rows`` are 0-d. All
    on the synopsis's device. ``level=None`` serves the lam-scaled width
    (no Bernstein fallback split). ``deg_q`` (Q,) flags the queries that
    overlap a degraded partition, or is None when there are none.
    """
    dev = syn.device
    art = compute_artifacts(syn, queries, kinds, use_aggregates=True)
    q = queries.lo.shape[0]
    p_pad = syn.num_leaves // k_part

    def per_part(x):
        return x.reshape(q, p_pad, k_part).sum(2)

    z = lam if level is None else _z_of(level, dev)
    sampled = art.partial
    if level is None:
        fb = torch.zeros_like(sampled)
        log_term = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        fb = sampled & (art.k_pred < float(small_n_threshold))
        n_fb = fb.to(torch.float32).sum(1)
        delta = 1.0 - level
        if delta_budget == "union":
            log_term = torch.log(
                3.0 * torch.clamp(n_fb, min=1.0) / delta)[:, None]
        else:
            log_term = torch.log(torch.tensor(3.0 / delta,
                                              dtype=torch.float32,
                                              device=dev))
    cltf = (sampled & ~fb).to(torch.float32)

    total = torch.clamp(total_rows, min=1.0)
    rel_cat = torch.maximum(cat_cover, cat_overlap)
    touched = (rel_cat * cat_m_agg[:, AGG_COUNT][None]).sum(1) / total

    lin = {}

    def linear(kind):
        """(exact_cov, ht, half, v, h_qp, exact_l, samp_l) of one linear
        kind, computed once an answer."""
        if kind not in lin:
            exact_l, samp_l = _linear_leaf_terms(syn, art, kind)
            t_qp = per_part(exact_l + samp_l)
            v_clt, var_hat, r_hi, r_lo, ns_half = _stratum_terms(
                syn, art, kind, use_fpc)
            v_qp = per_part(cltf * v_clt)
            h_l = _fallback_half(syn, var_hat, r_hi, r_lo, ns_half,
                                 log_term)
            h_qp = per_part(torch.where(fb, h_l, 0.0))
            ht, half, v = compose_two_stage(t_qp, v_qp, h_qp, pi, ov_sel,
                                            z)
            key = AGG_SUM if kind == "sum" else AGG_COUNT
            exact_cov = (cat_cover * cat_m_agg[:, key][None]).sum(1)
            lin[kind] = (exact_cov, ht, half, v, h_qp, exact_l, samp_l)
        return lin[kind]

    out = {}
    for kind in kinds:
        if kind in ("sum", "count"):
            exact_cov, ht, half = linear(kind)[:3]
            lower, upper = (_sum_bounds if kind == "sum" else _count_bounds)(
                cat_m_agg, cat_cover, cat_overlap)
            est = minmax.clip(exact_cov + ht, lower, upper)
            res = QueryResult(est, half, lower, upper, touched)
            out[kind] = res if level is None else _clipped(res, est, half)
        elif kind == "avg":
            exact_s, ht_s, _hs, v_s, hq_s, el_s, sl_s = linear("sum")
            exact_c, ht_c, _hc, v_c, hq_c, el_c, sl_c = linear("count")
            s_tot = exact_s + ht_s
            c_tot = torch.clamp(exact_c + ht_c, min=1.0)
            est = s_tot / c_tot
            # Two-stage SUM/COUNT covariance, built as the variances
            # above; Python's sum() starts at int 0, as the reference's.
            t_s = per_part(sum((el_s, sl_s)))
            t_c = per_part(sum((el_c, sl_c)))
            csc_qp = per_part(cltf * _cov_sc_leaf(syn, art, use_fpc))
            pi_ = torch.clamp(pi, min=1e-6)[None]
            csc = (ov_sel * ((1.0 - pi_) * t_s * t_c + csc_qp)
                   / (pi_ * pi_)).sum(1)
            var_ratio = minmax.max0(v_s - 2 * est * csc + est * est * v_c
                                    ) / (c_tot * c_tot)
            h_s = (ov_sel * hq_s / pi_).sum(1)
            h_c = (ov_sel * hq_c / pi_).sum(1)
            half = z * torch.sqrt(var_ratio) \
                + (h_s + torch.abs(est) * h_c) / torch.clamp(c_tot - h_c,
                                                             min=1.0)
            rel = rel_cat > 0
            upper = minmax.masked_max(cat_m_agg[:, AGG_MAX][None], rel,
                                      -_BIG, 1)
            lower = minmax.masked_min(cat_m_agg[:, AGG_MIN][None], rel,
                                      _BIG, 1)
            res = QueryResult(est, half, lower, upper, touched)
            out[kind] = res if level is None else _clipped(res, est, half)
        else:
            raise ValueError(
                f"catalog serving supports kinds {CATALOG_KINDS}, "
                f"got {kind!r}")
    if deg_q is None:
        return out
    degm = deg_q > 0
    return {k: _degrade_result(r, degm, level is not None)
            for k, r in out.items()}


__all__ = ["CATALOG_KINDS", "stack_synopses", "pad_partition_synopsis",
           "empty_partition_synopsis", "catalog_answer"]
