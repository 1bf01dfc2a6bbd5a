"""Ground truth, workload generators and error metrics (paper §5.1).

`answer` is the deprecated single-kind entry over ``PassEngine``.
`ground_truth` computes exact answers with chunked host scans for scoring.
The generators reproduce the paper's query distributions: random
rectangles anchored on data values (§5.1.2) and "challenging" queries
drawn from the max-variance interval of the discretization oracle (§5.3).
Each generator draws from ``np.random.default_rng(seed)`` exactly as the
JAX package does and returns float32 tensors on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, to_numpy
from . import prefix as px
from .types import QueryBatch, QueryResult


def answer(syn, queries: QueryBatch, kind: str = "sum",
           lam: float | None = None, use_fpc: bool | None = None,
           zero_var_rule: bool | None = None,
           use_aggregates: bool | None = None, avg_mode: str | None = None,
           kinds=None, backend: str | None = None,
           plan=None, ci: float | None = None, ci_method: str | None = None,
           small_n_threshold: int | None = None, n_boot: int | None = None,
           ci_key=None, device=None):
    """Deprecated single-kind compatibility entry over the serving facade.

    Pass ``kinds=(...)`` to answer several aggregate kinds from one shared
    classification + moment pass; the result is then a ``{kind:
    QueryResult}`` dict. Use ``repro_torch.api.PassEngine`` instead: unset
    kwargs inherit the ``ServingConfig`` / ``CIConfig`` defaults, and a
    long-lived engine caches prepared plans. ``backend`` must be None;
    ``device=None`` serves on the CUDA card.
    """
    from .. import api
    from ..api.config import merge_overrides
    api.warn_once(
        "repro_torch.core.answer",
        "repro_torch.api.PassEngine(source, serving=ServingConfig(kinds=...), "
        "ci=CIConfig(level=...)).answer(queries)")
    multi = kinds is not None
    serving = merge_overrides(
        api.ServingConfig(kinds=kinds if multi else (kind,),
                          backend=backend),
        lam=lam, use_fpc=use_fpc, zero_var_rule=zero_var_rule,
        use_aggregates=use_aggregates, avg_mode=avg_mode)
    ci_cfg = None
    if ci is not None:
        ci_cfg = merge_overrides(
            api.CIConfig(level=float(ci)), method=ci_method,
            small_n_threshold=small_n_threshold, n_boot=n_boot, key=ci_key)
    out = api.PassEngine(syn, serving=serving, ci=ci_cfg,
                         device=device).answer(queries, plan=plan)
    return out if multi else out[kind]


def ground_truth(c, a, queries: QueryBatch, kind: str = "sum",
                 chunk: int = 262144) -> np.ndarray:
    """Exact answers by a chunked host float64 scan over every row. Each
    chunk computes only what ``kind`` needs, by the reference's own
    operations, so the answers are its bits."""
    if kind not in ("sum", "count", "avg", "min", "max"):
        raise ValueError(kind)
    c = np.asarray(c, dtype=np.float64)
    c2 = c[:, None] if c.ndim == 1 else c
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    q_lo = to_numpy(queries.lo).astype(np.float64)
    q_hi = to_numpy(queries.hi).astype(np.float64)
    Q = q_lo.shape[0]
    s = np.zeros(Q)
    cnt = np.zeros(Q)
    mn = np.full(Q, np.inf)
    mx = np.full(Q, -np.inf)
    for start in range(0, c2.shape[0], chunk):
        cc = c2[start:start + chunk]
        aa = a[start:start + chunk]
        # Column by column: the reference's all(lo <= c <= hi) over the
        # columns, without its (Q, chunk, d) intermediates.
        pred = np.ones((Q, cc.shape[0]), bool)
        for j in range(cc.shape[1]):
            pred &= q_lo[:, j, None] <= cc[None, :, j]
            pred &= cc[None, :, j] <= q_hi[:, j, None]
        if kind in ("sum", "avg"):
            s += pred @ aa
        if kind in ("count", "avg"):
            cnt += pred.sum(axis=1)
        if kind == "min":
            mn = np.minimum(mn, np.where(pred, aa[None], np.inf).min(axis=1))
        if kind == "max":
            mx = np.maximum(mx, np.where(pred, aa[None], -np.inf).max(axis=1))
    return {"sum": s, "count": cnt, "min": mn, "max": mx,
            "avg": s / np.maximum(cnt, 1)}[kind]


def ground_truth_join(c, a, keys, dim_keys, dim_attrs, queries: QueryBatch,
                      kind: str = "sum", chunk: int = 262144) -> np.ndarray:
    """Exact fk-join aggregates by materializing the join on the host.

    Fact rows (c, a, keys) inner-join dimension rows (dim_keys, dim_attrs)
    on the key; each joined row's coordinates are ``[fact coords ‖ dim
    attrs]``, the join rectangle's layout (``repro_torch.joins``). The
    scoring oracle of the join tests and of ``chip_smoke.py``, host f64.
    """
    c = np.asarray(c, dtype=np.float64)
    c2 = c[:, None] if c.ndim == 1 else c
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    keys = np.asarray(keys).reshape(-1).astype(np.int64)
    dim_keys = np.asarray(dim_keys).reshape(-1).astype(np.int64)
    dim_attrs = np.asarray(dim_attrs, dtype=np.float64)
    if dim_attrs.ndim == 1:
        dim_attrs = dim_attrs[:, None]
    order = np.argsort(dim_keys, kind="stable")
    dk, da = dim_keys[order], dim_attrs[order]
    idx = np.clip(np.searchsorted(dk, keys), 0, dk.size - 1)
    found = dk[idx] == keys
    joined_c = np.concatenate([c2[found], da[idx[found]]], axis=1)
    return ground_truth(joined_c, a[found], queries, kind, chunk=chunk)


def _batch(lo: np.ndarray, hi: np.ndarray, device) -> QueryBatch:
    dev = resolve_device(device)
    return QueryBatch(lo=torch.from_numpy(lo.astype(np.float32)).to(dev),
                      hi=torch.from_numpy(hi.astype(np.float32)).to(dev))


def random_queries(c, num: int, seed: int = 0, min_frac: float = 0.005,
                   max_frac: float = 0.3, device=None) -> QueryBatch:
    """Random rectangles with endpoints anchored on data rows (§4.2: all
    meaningful predicates are grounded on tuple values)."""
    resolve_device(device)
    c = np.asarray(c, dtype=np.float64)
    c2 = c[:, None] if c.ndim == 1 else c
    n, d = c2.shape
    rng = np.random.default_rng(seed)
    lo = np.zeros((num, d))
    hi = np.zeros((num, d))
    for j in range(d):
        vals = np.sort(c2[:, j])
        width = rng.uniform(min_frac, max_frac, size=num)
        start = rng.uniform(0, 1 - width)
        lo_idx = (start * (n - 1)).astype(np.int64)
        hi_idx = np.minimum(((start + width) * (n - 1)).astype(np.int64),
                            n - 1)
        lo[:, j] = vals[lo_idx]
        hi[:, j] = vals[hi_idx]
    return _batch(lo, hi, device)


def challenging_queries(c, a, num: int, seed: int = 0,
                        opt_samples: int = 4096, delta_frac: float = 0.02,
                        device=None) -> QueryBatch:
    """Queries concentrated on the max-variance region found by the fast
    discretization oracle (paper §5.3 'challenging queries')."""
    resolve_device(device)
    c = np.asarray(c, dtype=np.float64).reshape(-1)
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    rng = np.random.default_rng(seed)
    m = min(opt_samples, c.shape[0])
    idx = rng.choice(c.shape[0], size=m, replace=False)
    cs, as_ = c[idx], a[idx]
    order = np.argsort(cs, kind="stable")
    cs, as_ = cs[order], as_[order]
    _s1, s2 = px.prefix_moments(as_)
    win = max(2, int(round(delta_frac * m)))
    best = int(np.argmax(px.window_sqsum(s2, win)))
    lo_v, hi_v = cs[best], cs[min(best + win, m - 1)]
    span = max(hi_v - lo_v, 1e-9)
    centre = rng.uniform(lo_v - 0.5 * span, hi_v + 0.5 * span, size=num)
    width = rng.uniform(0.2 * span, 2.0 * span, size=num)
    return _batch((centre - width / 2)[:, None],
                  (centre + width / 2)[:, None], device)


def relative_error(res: QueryResult, truth: np.ndarray) -> np.ndarray:
    est = to_numpy(res.estimate).astype(np.float64)
    t = np.asarray(truth, dtype=np.float64)
    return np.abs(est - t) / np.maximum(np.abs(t), 1e-12)


def ci_ratio(res: QueryResult, truth: np.ndarray) -> np.ndarray:
    t = np.asarray(truth, dtype=np.float64)
    return to_numpy(res.ci_half).astype(np.float64) / np.maximum(np.abs(t),
                                                                 1e-12)


__all__ = ["answer", "ground_truth", "ground_truth_join", "random_queries",
           "challenging_queries",
           "relative_error", "ci_ratio"]
