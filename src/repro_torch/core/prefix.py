"""Prefix-sum interval statistics and variance oracles (paper §4.2.1, §A).

The O(1) building blocks of the partitioning optimizer, on host float64
numpy (the optimizer runs offline on a uniform sample of m << N rows),
and the float32 prefix moments of the device DP (``dp.dp_monotone_device``):

* interval moments from prefix sums,
* the paper's single-partition variance formulas for SUM/COUNT/AVG,
* the discretized max-variance oracles: the equal-sample median split for
  SUM/COUNT (Lemma A.3) and the range-max over length-(delta*m) window
  scores sum(t^2) for AVG (Lemma A.4/A.5).
"""
from __future__ import annotations

import numpy as np
import torch


def prefix_moments(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return (S1, S2) with S1[i] = sum(values[:i]), S2[i] = sum(values[:i]^2).
    Length n+1, float64."""
    v = np.asarray(values, dtype=np.float64)
    s1 = np.zeros(v.shape[0] + 1, dtype=np.float64)
    s2 = np.zeros(v.shape[0] + 1, dtype=np.float64)
    np.cumsum(v, out=s1[1:])
    np.cumsum(v * v, out=s2[1:])
    return s1, s2


def prefix_moments_device(values: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 (S1, S2) of length n+1 on the values' device; the JAX
    package's ``prefix_moments_jnp``."""
    v = values.to(torch.float32)
    z = torch.zeros(1, dtype=torch.float32, device=v.device)
    return torch.cat([z, torch.cumsum(v, 0)]), \
        torch.cat([z, torch.cumsum(v * v, 0)])


def interval_moments(s1, s2, g, w):
    """Moments of the half-open rank interval [g, w): (count, sum, sumsq)."""
    return (w - g), np.take(s1, w) - np.take(s1, g), \
        np.take(s2, w) - np.take(s2, g)


# Paper variance formulas (§4.2.1 / §A.2) in sample space: for a partition
# with n_i samples and a subquery with moments (n_q, sq, sqq), the core
# V(q) = n_i * sqq - sq^2; SUM/COUNT scale it by 1/n_i (times the common
# (N/m)^2 constant), AVG by 1 / (n_i * n_q^2).

def core_v(n_i, sq, sqq):
    return n_i * sqq - sq * sq


def v_sum(n_i, n_q, sq, sqq, scale=1.0):
    """SUM-query variance objective for a subquery inside a partition."""
    if not np.isscalar(n_i):
        n_i = np.asarray(n_i, dtype=sqq.dtype)
    return scale * core_v(n_i, sq, sqq) / np.maximum(n_i, 1)


def v_avg(n_i, n_q, sq, sqq):
    return core_v(n_i, sq, sqq) / (np.maximum(n_i, 1)
                                   * np.maximum(n_q, 1) ** 2)


def oracle_sum_split(s1, s2, g, w, scale=1.0):
    """Lemma A.3 oracle: split [g, w) at the equal-count median x and return
    max(V(q1), V(q2)) for q1 = [g, x), q2 = [x, w). Vectorized over g, w."""
    n_i = w - g
    x = g + n_i // 2
    n1, sq1, sqq1 = interval_moments(s1, s2, g, x)
    n2, sq2, sqq2 = interval_moments(s1, s2, x, w)
    v1 = v_sum(n_i, n1, sq1, sqq1, scale)
    v2 = v_sum(n_i, n2, sq2, sqq2, scale)
    return np.where(n_i > 1, np.maximum(v1, v2), np.zeros_like(v1))


def window_sqsum(s2: np.ndarray, win: int) -> np.ndarray:
    """A[i] = sum of t^2 over the length-`win` window starting at sample i."""
    m = s2.shape[0] - 1
    num = m - win + 1
    if num <= 0:
        return np.zeros((0,), dtype=s2.dtype)
    idx = np.arange(num)
    return np.take(s2, idx + win) - np.take(s2, idx)


class SparseTableArgmax:
    """Static range-argmax (RMQ) over a score array; O(m log m) build, O(1)
    query, vectorized over query batches."""

    def __init__(self, scores: np.ndarray):
        scores = np.asarray(scores, dtype=np.float64)
        m = scores.shape[0]
        self.m = m
        levels = max(1, int(np.floor(np.log2(max(m, 1)))) + 1)
        # table[j][i] = argmax of scores[i : i + 2^j]
        self.table = np.zeros((levels, max(m, 1)), dtype=np.int64)
        self.scores = scores
        if m == 0:
            return
        self.table[0] = np.arange(m)
        for j in range(1, levels):
            half = 1 << (j - 1)
            prev = self.table[j - 1]
            lead = prev[: m - half] if m - half > 0 else prev[:0]
            trail = prev[half: m] if m - half > 0 else prev[:0]
            take_right = scores[trail] > scores[lead]
            merged = np.where(take_right, trail, lead)
            self.table[j, : m - half] = merged
            self.table[j, m - half:] = prev[m - half:]

    def argmax(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """Vectorized argmax of scores over [lo, hi) per element; requires
        hi > lo."""
        lo = np.asarray(lo, dtype=np.int64)
        hi = np.asarray(hi, dtype=np.int64)
        length = np.maximum(hi - lo, 1)
        j = np.floor(np.log2(length)).astype(np.int64)
        left = self.table[j, lo]
        right = self.table[j, hi - (1 << j)]
        return np.where(self.scores[right] > self.scores[left], right, left)


def oracle_avg_window(s1, s2, table: SparseTableArgmax, win: int, g, w):
    """Lemma A.5 oracle: the max-variance AVG subquery of partition [g, w).
    Partitions with fewer than 2*win samples score 0 (paper §A.4)."""
    n_i = w - g
    valid = n_i >= 2 * win
    lo = np.minimum(g, table.m - 1 if table.m else 0)
    hi_excl = np.maximum(np.minimum(w - win + 1, table.m), lo + 1)
    if table.m == 0:
        return np.zeros_like(np.asarray(g, dtype=np.float64))
    best = table.argmax(lo, hi_excl)
    n_q, sq, sqq = interval_moments(s1, s2, best, best + win)
    return np.where(valid, v_avg(n_i, n_q, sq, sqq), 0.0)


def oracle_exact(s1: np.ndarray, s2: np.ndarray, g: int, w: int,
                 kind: str, min_len: int = 1, scale: float = 1.0) -> float:
    """Maximum variance over all contiguous subqueries [a, b) of [g, w)
    with b - a >= min_len. O((w-g)^2): the oracle the tests hold the
    discretized ones against."""
    n_i = w - g
    if n_i <= 0:
        return 0.0
    starts, ends = np.triu_indices(n_i + 1, k=min_len)
    n_q, sq, sqq = interval_moments(s1, s2, g + starts, g + ends)
    if kind in ("sum", "count"):
        v = v_sum(n_i, n_q, sq, sqq, scale)
    elif kind == "avg":
        v = v_avg(n_i, n_q, sq, sqq)
    else:
        raise ValueError(kind)
    return float(v.max()) if v.size else 0.0


__all__ = [
    "prefix_moments", "prefix_moments_device", "interval_moments", "core_v",
    "v_sum", "v_avg",
    "oracle_sum_split", "window_sqsum", "SparseTableArgmax",
    "oracle_avg_window", "oracle_exact",
]
