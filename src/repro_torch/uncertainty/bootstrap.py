"""Deterministic, key-threaded Poisson bootstrap on the card (DESIGN.md §7,
§10).

The cross-check interval for non-linear aggregates (AVG is a ratio of two
HT estimates, where the delta-method CLT holds only asymptotically). Each
replicate draws i.i.d. Poisson(1) resample weights over the stratified
sample, one weight per slot, and re-runs the per-stratum estimate through
the weighted moment kernels. The resampled stratum sizes
``K*_i = sum_j w_ij`` feed the Hajek scale ``N_i / K*_i`` that keeps AVG
replicates stable when a stratum resamples light or heavy.

Two strategies give bit-identical replicates:

* **fused** (the default, ``CIConfig(boot_fused=True)``): all R weight
  matrices drawn at once (:func:`poisson_weights`, one launch of row 10
  on the card), then one ``ops.bootstrap_moments`` for the whole
  (R, Q, k, 3) block;
* **scan** (the reference, ``boot_fused=False``): a Python loop of R
  draws (the same entry at R = 1) and R ``ops.weighted_moments`` calls,
  stacked into the same contiguous block.

Both hand the block to one shared epilogue, so they agree bit for bit as
long as the two moment ops do (``kernels/bootstrap.py``). The weights come
from ``fold_in(key, r)`` exactly as in the JAX package, so a (key, R)
draws the same weights there, on the CPU and on the card. Exactly covered
strata enter every replicate through the exact accumulation, with no
resample noise, so a fully covered query gets a zero-width interval.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import minmax
from .. import random as trandom
from ..core.types import QueryBatch, QueryResult, AGG_SUM, AGG_COUNT
from ..engine import executor as _executor
from ..engine.assemble import assemble
from ..engine.executor import compute_artifacts
from ..kernels import ops, threefry

BOOT_KINDS = ("sum", "count", "avg")

# Poisson(1) CDF table for inverse-CDF sampling: P(X <= t) for t = 0..15,
# built with the JAX package's Python-float expression and cast to
# float32, so the table is the same bits. A float32 uniform has 24-bit
# granularity, so u never exceeds P(X <= 10) = 1 - 1.0e-8 > 1 - 2^-24: the
# table is exhaustive for the draw, not a truncation.
_P1_CDF = torch.tensor(
    [float(sum((2.718281828459045 ** -1) / _f
               for _f in [1, 1, 2, 6, 24, 120, 720, 5040, 40320, 362880,
                          3628800, 39916800, 479001600, 6227020800,
                          87178291200, 1307674368000][:t + 1]))
     for t in range(16)], dtype=torch.float32)


def key_tensor(key, device) -> torch.Tensor:
    """A PRNG key as the (2,) int64 tensor of two uint32 words on
    ``device``: an int is a seed (``PRNGKey``); an array or tensor of two
    words is taken as it is, a JAX key as numpy ``uint32 (2,)`` included."""
    if isinstance(key, (int, np.integer)):
        return trandom.PRNGKey(int(key), device)
    if not isinstance(key, torch.Tensor):
        key = torch.as_tensor(np.asarray(key).astype(np.int64))
    if key.shape != (2,):
        raise ValueError(f"a PRNG key is two uint32 words, got shape "
                         f"{tuple(key.shape)}")
    return key.to(device=device, dtype=torch.int64) & trandom.MASK32


def _draw_weights(key, r, shape) -> torch.Tensor:
    """Poisson(1) resample weights of replicate r by inverse CDF from one
    ``fold_in(key, r)`` uniform per slot: w = #{t : u >= P(X <= t)}. A
    (R,) tensor of r draws all R replicates in one pass, (R, *shape). The
    int64 torch ops of ``random``'s plain versions, on the key's device."""
    u = trandom.uniform_plain(trandom.fold_in_plain(key, r), shape)
    return (u[..., None] >= _P1_CDF.to(u.device)).sum(-1).to(torch.float32)


def poisson_weights_plain(key, valid, n_boot: int, r0: int = 0):
    """The weights of replicates r0 .. r0 + n_boot - 1, +0.0 on invalid
    slots: W (n_boot, k, s) float32 and the resampled sizes K* = W.sum(-1)
    (n_boot, k). K* sums small integers: exact in float32 in any order."""
    r = torch.arange(r0, r0 + n_boot, device=key.device)
    W = torch.where(valid[None], _draw_weights(key, r, tuple(valid.shape)),
                    0.0)
    return W, W.sum(-1)


_CDF_ON: dict = {}


def poisson_weights(key, valid, n_boot: int, r0: int = 0):
    """:func:`poisson_weights_plain` by the key's device: a CUDA key draws
    W and K* in one launch of row 10 (``kernels/threefry.py``), against the
    table ``_P1_CDF`` copied to the card once; a CPU key takes the plain
    version."""
    if key.device.type != "cuda":
        return poisson_weights_plain(key, valid, n_boot, r0)
    cdf = _CDF_ON.get(key.device)
    if cdf is None:
        cdf = _CDF_ON[key.device] = _P1_CDF.to(key.device)
    return threefry.poisson_weights_cuda(key, cdf, valid.contiguous(),
                                         n_boot, r0)


def _scan_moments(syn, queries, key, n_boot):
    """The reference strategy: one draw and one ``weighted_moments`` per
    replicate, R passes over the samples. Returns the (R, Q, k, 3) moment
    block and the resampled sizes K* (R, k)."""
    k, s = syn.sample_valid.shape
    Q = queries.lo.shape[0]
    dev = syn.sample_a.device
    mom = torch.empty((n_boot, Q, k, 3), dtype=torch.float32, device=dev)
    k_star = torch.empty((n_boot, k), dtype=torch.float32, device=dev)
    for r in range(n_boot):
        w, ks = poisson_weights(key, syn.sample_valid, 1, r)
        k_star[r] = ks[0]
        mom[r] = ops.weighted_moments(syn.sample_c, syn.sample_a,
                                      syn.sample_valid, w[0], queries.lo,
                                      queries.hi)
    return mom, k_star


def _fused_moments(syn, queries, key, n_boot):
    """The fused strategy: all R weight matrices in one draw (the scan's
    draws bit for bit: the same entry at R = 1 there), then one
    ``bootstrap_moments`` for the whole block, a single pass over the
    samples."""
    W, k_star = poisson_weights(key, syn.sample_valid, n_boot)  # (R, k, s)
    mom = ops.bootstrap_moments(syn.sample_c, syn.sample_a, syn.sample_valid,
                                W, queries.lo, queries.hi)     # (R, Q, k, 3)
    return mom, k_star


def _replicates(syn, art, queries, key, kinds, n_boot, normalize, fused):
    """(R, K, Q) replicate estimates. The strategies differ only in how
    the moment block is made; the epilogue is shared, so identical blocks
    give identical replicates."""
    strategy = _fused_moments if fused else _scan_moments
    mom, k_star = strategy(syn, queries, key, n_boot)
    return _estimates(syn, art, mom, k_star, kinds, normalize)


def _estimates(syn, art, mom, k_star, kinds, normalize):
    """The replicate-batched epilogue: (R, K, Q) estimates from the
    (R, Q, k, 3) moment block and the resampled sizes K* (R, k)."""
    w_pred, ws_sum = mom[..., 0], mom[..., 1]                  # (R, Q, k)
    Ni = syn.n_rows.to(torch.float32)
    if normalize == "hajek":
        scale = (Ni / torch.clamp(k_star, min=1.0))[:, None, :]  # (R, 1, k)
    else:                                   # 'ht': fixed design scale
        Ki = torch.clamp(syn.k_per_leaf.to(torch.float32), min=1.0)
        scale = (Ni / Ki)[None, None, :]
    partf = (art.partial & ~art.cover).to(torch.float32)[None]
    s_part = (partf * scale * ws_sum).sum(-1)                  # (R, Q)
    c_part = (partf * scale * w_pred).sum(-1)
    est = {}
    if "sum" in kinds:
        est["sum"] = art.exact[:, AGG_SUM] + s_part
    if "count" in kinds:
        est["count"] = art.exact[:, AGG_COUNT] + c_part
    if "avg" in kinds:
        S = art.exact[:, AGG_SUM] + s_part
        C = torch.clamp(art.exact[:, AGG_COUNT] + c_part, min=1.0)
        est["avg"] = S / C
    return torch.stack([est[k] for k in kinds], dim=1)         # (R, K, Q)


def _quantiles(x: torch.Tensor, qs) -> torch.Tensor:
    """``jnp.quantile(x, qs, axis=0)`` with the 'linear' method (jax's
    formula, ``numpy/reductions.py`` ``_quantile``): sort along axis 0,
    then low * (1 - f) + high * f at position q * (n - 1), all in float32;
    a NaN anywhere along the axis makes that column NaN. ``torch.quantile``
    refuses inputs of more than 2**24 elements. Returns (len(qs), ...)."""
    n = x.shape[0]
    srt = torch.sort(x, dim=0).values
    srt = torch.where(torch.isnan(x).any(0, keepdim=True), torch.nan, srt)
    pos = torch.tensor(qs, dtype=torch.float32) * float(n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    lo_i = torch.clamp(low, 0, n - 1).long().tolist()
    hi_i = torch.clamp(high, 0, n - 1).long().tolist()
    out = [srt[li] * lw[j].item() + srt[hi] * hw[j].item()
           for j, (li, hi) in enumerate(zip(lo_i, hi_i))]
    return torch.stack(out)


def bootstrap_answer(syn, queries: QueryBatch, plan_masks=None, *, key,
                     kinds, n_boot: int, level: float, normalize: str,
                     use_aggregates: bool, fused: bool
                     ) -> dict[str, QueryResult]:
    """Percentile bootstrap intervals for ``kinds`` (a subset of
    BOOT_KINDS): ``estimate`` is the plain estimator, ``ci_lo``/``ci_hi``
    the (1 - level)/2 replicate percentiles clipped to the hard bounds,
    ``ci_half`` half their distance. ``key`` is a (2,) key tensor on the
    synopsis's device."""
    art = compute_artifacts(syn, queries, kinds,
                            use_aggregates=use_aggregates,
                            plan_masks=plan_masks)
    reps = _replicates(syn, art, queries, key, kinds, n_boot, normalize,
                       fused)                                  # (R, K, Q)
    alpha = (1.0 - level) / 2.0
    qs = _quantiles(reps, (alpha, 1.0 - alpha))
    out = {}
    for i, kind in enumerate(kinds):
        res = assemble(syn, art, kind, use_aggregates=use_aggregates)
        lo_hi = qs[:, i]
        if use_aggregates:
            # zero ties as the reference's jnp.clip
            lo_hi = minmax.clip(lo_hi, res.lower, res.upper)
        lo, hi = lo_hi.unbind()
        out[kind] = dataclasses.replace(res, ci_half=0.5 * (hi - lo),
                                        ci_lo=lo, ci_hi=hi)
    return out


def bootstrap_replicates(syn, queries: QueryBatch, kinds=("avg",), *,
                         n_boot: int = 200, key=None, seed: int = 0,
                         normalize: str = "hajek",
                         use_aggregates: bool = True,
                         fused: bool = True) -> torch.Tensor:
    """(R, K, Q) replicate estimates for ``kinds`` (a subset of
    BOOT_KINDS), the resampling distribution behind the percentile
    intervals, on the synopsis's device (``queries`` must lie there too).
    ``key`` (None = ``PRNGKey(seed)``) fixes the weights; ``fused=True``
    runs the one-pass kernel, ``fused=False`` the per-replicate loop, and
    the two are bit-identical."""
    from ..api.config import BOOT_NORMALIZE
    kinds = (kinds,) if isinstance(kinds, str) else tuple(kinds)
    for kind in kinds:
        if kind not in BOOT_KINDS:
            raise ValueError(f"bootstrap supports {BOOT_KINDS}, got {kind!r}")
    if normalize not in BOOT_NORMALIZE:
        raise ValueError(f"unknown normalize: {normalize!r}")
    syn = _executor.resolve_synopsis(syn)
    k = key_tensor(key if key is not None else seed, syn.device)
    art = compute_artifacts(syn, queries, kinds,
                            use_aggregates=use_aggregates)
    return _replicates(syn, art, queries, k, kinds, int(n_boot), normalize,
                       bool(fused))


def poisson_bootstrap(syn, queries: QueryBatch, kinds=("avg",), *,
                      level: float = 0.95, n_boot: int = 200, key=None,
                      seed: int = 0, normalize: str = "hajek",
                      use_aggregates: bool = True,
                      backend: str | None = None, plan=None,
                      device=None) -> dict[str, QueryResult]:
    """Deprecated shim: percentile bootstrap intervals for ``kinds`` (a
    subset of SUM/COUNT/AVG). Returns ``{kind: QueryResult}`` with
    ``ci_lo``/``ci_hi`` the (1 - level)/2 replicate percentiles and
    ``estimate`` the plain (non-resampled) estimator.

    ``key`` (or ``seed``) fully determines the resample weights
    (``fold_in(key, r)``), so results are bit-reproducible.
    ``normalize='hajek'`` rescales each stratum by its resampled size;
    ``'ht'`` keeps the fixed N_i/K_i design scale. The fused one-pass
    kernel serves it.

    Use ``repro_torch.api.PassEngine(syn, serving=ServingConfig(
    kinds=...), ci=CIConfig(method='bootstrap', ...)).answer(queries)``
    instead. ``backend`` must be None; ``device=None`` serves on the CUDA
    card.
    """
    from .. import api
    api.warn_once(
        "repro_torch.uncertainty.poisson_bootstrap",
        "repro_torch.api.PassEngine(syn, serving=ServingConfig(kinds=...), "
        "ci=CIConfig(level=..., method='bootstrap', n_boot=..., key=...))"
        ".answer(queries)")
    eng = api.PassEngine(
        syn,
        serving=api.ServingConfig(kinds=kinds,
                                  use_aggregates=use_aggregates,
                                  backend=backend),
        ci=api.CIConfig(level=level, method="bootstrap", n_boot=int(n_boot),
                        key=key if key is not None else int(seed),
                        boot_normalize=normalize),
        device=device)
    return eng.answer(queries, plan=plan)


__all__ = ["BOOT_KINDS", "bootstrap_answer", "bootstrap_replicates",
           "key_tensor", "poisson_bootstrap"]
