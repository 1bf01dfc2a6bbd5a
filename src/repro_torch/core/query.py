"""Ground truth, workload generators and error metrics (paper §5.1).

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


def ground_truth(c, a, queries: QueryBatch, kind: str = "sum",
                 chunk: int = 262144) -> np.ndarray:
    """Exact answers by a chunked host float64 scan over every row."""
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
        pred = (np.all(q_lo[:, None, :] <= cc[None], axis=-1)
                & np.all(cc[None] <= q_hi[:, None, :], axis=-1))
        s += pred @ aa
        cnt += pred.sum(axis=1)
        mn = np.minimum(mn, np.where(pred, aa[None], np.inf).min(axis=1))
        mx = np.maximum(mx, np.where(pred, aa[None], -np.inf).max(axis=1))
    if kind == "sum":
        return s
    if kind == "count":
        return cnt
    if kind == "avg":
        return s / np.maximum(cnt, 1)
    if kind == "min":
        return mn
    if kind == "max":
        return mx
    raise ValueError(kind)


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


__all__ = ["ground_truth", "random_queries", "challenging_queries",
           "relative_error", "ci_ratio"]
