"""Partitioning optimizers (paper §4.3, Appendix A), host float64 numpy.

* ``equal_depth_boundaries`` — Lemma A.1: optimal for 1-D COUNT; also the
  "EQ" baseline of §5.3.
* ``dp_exact`` — the O(k n^2) DP over the exact oracle (small n only).
* ``dp_monotone`` — "Sampling + Discretization" (the ** algorithm of the
  paper's experiments): monotone DP with a vectorized lock-step binary
  search over the split point and the O(1) discretized variance oracles.
* ``adp_partition`` — end to end: uniform sample of m rows -> sort ->
  ``dp_monotone`` -> value-space thresholds for the full dataset.
* ``dp_monotone_device`` / ``cuts_to_thresholds_device`` — the same DP
  (SUM oracle) and threshold map as float32 tensor ops on the values'
  device, for the streaming re-optimization (``streaming/policy.py``).

Boundary convention: a partitioning of m sorted samples is given by cut
ranks 0 = c_0 <= c_1 <= ... <= c_k = m; partition j covers sample ranks
[c_j, c_{j+1}).
"""
from __future__ import annotations

import numpy as np
import torch

from . import prefix as px


def equal_depth_boundaries(n: int, k: int) -> np.ndarray:
    """Equal-size (equal-depth) cut ranks; optimal for COUNT (Lemma A.1)."""
    return np.round(np.linspace(0, n, k + 1)).astype(np.int64)


def dp_exact(values_sorted: np.ndarray, k: int, kind: str,
             min_len: int = 1) -> tuple[np.ndarray, float]:
    """O(k n^2) DP over the full exact-oracle table (itself O(n^2) per
    cell); the Naive DP row of the §4.3 table and the oracle the tests hold
    the monotone DP against.

    Returns (cut ranks (k+1,), optimal max variance). Small n only.
    """
    v = np.asarray(values_sorted, dtype=np.float64)
    n = v.shape[0]
    s1, s2 = px.prefix_moments(v)
    # M[g, w] = max variance of any subquery of partition [g, w)
    M = np.zeros((n + 1, n + 1), dtype=np.float64)
    for g in range(n + 1):
        for w in range(g + 1, n + 1):
            M[g, w] = px.oracle_exact(s1, s2, g, w, kind, min_len)
    INF = np.inf
    A = np.full((n + 1, k + 1), INF)
    parent = np.zeros((n + 1, k + 1), dtype=np.int64)
    A[0, :] = 0.0
    A[:, 0] = INF
    A[0, 0] = 0.0
    for j in range(1, k + 1):
        for i in range(0, n + 1):
            # h = left cut of the last partition [h, i)
            best, arg = INF, 0
            for h in range(0, i + 1):
                cand = max(A[h, j - 1], M[h, i])
                if cand < best:
                    best, arg = cand, h
            A[i, j] = best
            parent[i, j] = arg
    cuts = np.zeros(k + 1, dtype=np.int64)
    cuts[k] = n
    i = n
    for j in range(k, 0, -1):
        i = parent[i, j]
        cuts[j - 1] = i
    return cuts, float(A[n, k])


def _make_oracle(values_sorted: np.ndarray, kind: str, delta_frac: float,
                 scale: float = 1.0):
    """Return (oracle(g, w) vectorized, win)."""
    v = np.asarray(values_sorted, dtype=np.float64)
    m = v.shape[0]
    s1, s2 = px.prefix_moments(v)
    if kind in ("sum", "count"):
        if kind == "count":
            s1, s2 = px.prefix_moments(np.ones_like(v))

        def oracle(g, w):
            return px.oracle_sum_split(s1, s2, g, w, scale)
        return oracle, 1
    if kind == "avg":
        win = max(2, int(round(delta_frac * m)))
        table = px.SparseTableArgmax(px.window_sqsum(s2, win))

        def oracle(g, w):
            return px.oracle_avg_window(s1, s2, table, win, g, w)
        return oracle, win
    raise ValueError(f"unknown query kind: {kind}")


def dp_monotone(values_sorted: np.ndarray, k: int, kind: str = "sum",
                delta_frac: float = 0.01, scale: float = 1.0,
                ) -> tuple[np.ndarray, float]:
    """Monotone DP (paper §4.3 + §4.3.1 discretized oracles). Returns
    (cut ranks (k+1,), max variance).

    The binary search over the split point h runs in lock-step for every
    prefix length i; it is valid because A[h, j-1] is non-decreasing and
    M([h, i)) non-increasing in h.
    """
    v = np.asarray(values_sorted, dtype=np.float64)
    m = v.shape[0]
    oracle, _win = _make_oracle(v, kind, delta_frac, scale)
    if k <= 1:
        return (np.array([0, m], dtype=np.int64),
                float(oracle(np.array([0]), np.array([m]))[0]))
    i_vec = np.arange(m + 1, dtype=np.int64)
    A_prev = np.asarray(oracle(np.zeros(m + 1, dtype=np.int64), i_vec),
                        dtype=np.float64)                       # j = 1
    parents = np.zeros((k + 1, m + 1), dtype=np.int64)
    steps = int(np.ceil(np.log2(m + 2)))
    for j in range(2, k + 1):
        lo = np.zeros(m + 1, dtype=np.int64)
        hi = i_vec.copy()
        for _ in range(steps):
            mid = (lo + hi) // 2
            pred = A_prev[mid] >= oracle(mid, i_vec)
            hi = np.where(pred & (lo < hi), mid, hi)
            lo = np.where(pred | (lo >= hi), lo, np.minimum(mid + 1, hi))
        h1 = lo
        h0 = np.maximum(h1 - 1, 0)
        val1 = np.maximum(A_prev[h1], oracle(h1, i_vec))
        val0 = np.maximum(A_prev[h0], oracle(h0, i_vec))
        take0 = val0 < val1
        parents[j] = np.where(take0, h0, h1)
        A_prev = np.where(take0, val0, val1)
    cuts = np.zeros(k + 1, dtype=np.int64)
    cuts[k] = m
    i = m
    for j in range(k, 1, -1):
        i = int(parents[j][i])
        cuts[j - 1] = i
    return cuts, float(A_prev[m])


def cuts_to_thresholds(sample_c_sorted: np.ndarray, cuts: np.ndarray
                       ) -> np.ndarray:
    """Sample-rank cuts -> k-1 value thresholds usable on the full data:
    the midpoint between the last sample of partition i and the first of
    partition i+1. Duplicate cuts yield duplicated thresholds (empty
    leaves), which the padded synopsis handles."""
    c = np.asarray(sample_c_sorted, dtype=np.float64)
    m = c.shape[0]
    inner = np.asarray(cuts[1:-1], dtype=np.int64)
    lo_idx = np.clip(inner - 1, 0, m - 1)
    hi_idx = np.clip(inner, 0, m - 1)
    return 0.5 * (c[lo_idx] + c[hi_idx])


def dp_monotone_device(values_sorted: torch.Tensor, k: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The monotone DP with the Lemma A.3 (SUM) oracle in float32 tensor
    ops on the values' device: the JAX package's ``dp_monotone_jnp``, its
    ``scan`` over layers and ``fori_loop`` binary search written as Python
    loops. Returns (cuts (k+1,) int32, max variance as a 0-d f32 tensor).
    Degenerate inputs (no values, k < 1, k > m) raise."""
    v = values_sorted.to(torch.float32)
    if v.dim() != 1:
        raise ValueError(f"values_sorted must be 1-D, got shape "
                         f"{tuple(v.shape)}")
    m = v.shape[0]
    if m == 0:
        raise ValueError("dp_monotone_device: empty value vector (empty "
                         "stratum/reservoir) — nothing to partition")
    if k < 1:
        raise ValueError(f"dp_monotone_device: need k >= 1 partitions, "
                         f"got {k}")
    if k > m:
        raise ValueError(
            f"dp_monotone_device: k={k} partitions over m={m} values — the "
            f"DP needs k <= m (duplicate cut ranks would produce empty "
            f"leaves and NaN thresholds); reduce k or pool more samples")
    dev = v.device
    s1, s2 = px.prefix_moments_device(v)

    def oracle(g, w):
        n_i = (w - g).to(torch.float32)
        x = g + torch.div(w - g, 2, rounding_mode="floor")
        sq1 = s1[x] - s1[g]
        sqq1 = s2[x] - s2[g]
        sq2 = s1[w] - s1[x]
        sqq2 = s2[w] - s2[x]
        ni = torch.clamp(n_i, min=1.0)
        v1 = (ni * sqq1 - sq1 * sq1) / ni
        v2 = (ni * sqq2 - sq2 * sq2) / ni
        return torch.where(n_i > 1, torch.maximum(v1, v2), 0.0)

    i_vec = torch.arange(m + 1, dtype=torch.int64, device=dev)
    A = oracle(torch.zeros_like(i_vec), i_vec)
    if k == 1:
        return torch.tensor([0, m], dtype=torch.int32, device=dev), A[m]
    steps = int(np.ceil(np.log2(m + 2)))
    parents = torch.empty((k - 1, m + 1), dtype=torch.int64, device=dev)
    for layer in range(k - 1):
        lo = torch.zeros_like(i_vec)
        hi = i_vec.clone()
        for _ in range(steps):
            mid = torch.div(lo + hi, 2, rounding_mode="floor")
            pred = A[mid] >= oracle(mid, i_vec)
            hi, lo = (torch.where(pred & (lo < hi), mid, hi),
                      torch.where(pred | (lo >= hi), lo,
                                  torch.minimum(mid + 1, hi)))
        h1 = lo
        h0 = torch.clamp(h1 - 1, min=0)
        val1 = torch.maximum(A[h1], oracle(h1, i_vec))
        val0 = torch.maximum(A[h0], oracle(h0, i_vec))
        take0 = val0 < val1
        A = torch.where(take0, val0, val1)
        parents[layer] = torch.where(take0, h0, h1)
    # back-track from i = m through the layers, last first, on the device
    cuts = torch.zeros(k + 1, dtype=torch.int64, device=dev)
    cuts[k] = m
    i = cuts[k]
    for j in range(k - 1, 0, -1):
        i = parents[j - 1][i]
        cuts[j] = i
    return cuts.to(torch.int32), A[m]


def cuts_to_thresholds_device(sample_c_sorted: torch.Tensor,
                              cuts: torch.Tensor) -> torch.Tensor:
    """Midpoint thresholds from sorted sample coordinates and (k+1,) cut
    ranks, in float32 on the device: the JAX package's
    ``cuts_to_thresholds_jnp``. Degenerate inputs raise, as there."""
    c = sample_c_sorted
    if c.dim() != 1:
        raise ValueError(f"sample_c_sorted must be 1-D, got shape "
                         f"{tuple(c.shape)}")
    m = c.shape[0]
    if m == 0:
        raise ValueError("cuts_to_thresholds_device: empty coordinate "
                         "vector (empty stratum/reservoir) — no thresholds "
                         "exist")
    if cuts.shape[0] < 2:
        raise ValueError(
            f"cuts_to_thresholds_device: cut vector must hold at least "
            f"[0, m], got shape {tuple(cuts.shape)}")
    if cuts.shape[0] - 1 > m:
        raise ValueError(
            f"cuts_to_thresholds_device: {cuts.shape[0] - 1} partitions "
            f"over m={m} samples — duplicate cut ranks would yield "
            f"duplicated thresholds (empty leaves); reduce k or pool more "
            f"samples")
    inner = cuts[1:-1].long()
    lo_idx = torch.clamp(inner - 1, 0, m - 1)
    hi_idx = torch.clamp(inner, 0, m - 1)
    return 0.5 * (c[lo_idx] + c[hi_idx])


def adp_partition(c: np.ndarray, a: np.ndarray, k: int, m: int,
                  kind: str = "sum", delta_frac: float = 0.01,
                  seed: int = 0) -> tuple[np.ndarray, np.ndarray, float]:
    """The paper's ** algorithm (Sampling + Discretization), 1-D.

    Returns (thresholds (k-1,), leaf assignment of every row (N,), achieved
    sample-space max variance).
    """
    c = np.asarray(c).reshape(-1)
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    n = c.shape[0]
    rng = np.random.default_rng(seed)
    m_eff = min(m, n)
    idx = rng.choice(n, size=m_eff, replace=False)
    cs, as_ = c[idx], a[idx]
    order = np.argsort(cs, kind="stable")
    cs, as_ = cs[order], as_[order]
    if kind == "count":
        cuts = equal_depth_boundaries(m_eff, k)  # Lemma A.1 (optimal)
        vmax = 0.0
    else:
        scale = (n / max(m_eff, 1)) ** 2
        cuts, vmax = dp_monotone(as_, k, kind=kind, delta_frac=delta_frac,
                                 scale=scale)
    thresholds = cuts_to_thresholds(cs, cuts)
    assign = np.searchsorted(thresholds, c, side="right").astype(np.int32)
    return thresholds, assign, vmax


__all__ = ["equal_depth_boundaries", "dp_exact", "dp_monotone", "cuts_to_thresholds",
           "adp_partition", "dp_monotone_device",
           "cuts_to_thresholds_device"]
