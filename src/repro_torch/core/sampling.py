"""Uniform and stratified sampling (paper §2.1, §2.2), host numpy.

Randomness is ``np.random.default_rng(seed)``, drawn in the same order as
the JAX package's build, so both packages draw the same samples.
"""
from __future__ import annotations

import numpy as np


def uniform_sample(c: np.ndarray, a: np.ndarray, size: int, seed: int = 0
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Uniform sample without replacement; returns (c_s, a_s, idx)."""
    n = a.shape[0]
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=min(size, n), replace=False)
    return np.asarray(c)[idx], np.asarray(a)[idx], idx


def stratified_sample(c: np.ndarray, a: np.ndarray, assign: np.ndarray,
                      k: int, s_per_leaf, seed: int = 0
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """Per-leaf uniform samples (the strata of §3.2), padded to fixed shape.

    ``s_per_leaf`` is a scalar budget or a (k,) array of per-stratum
    budgets; arrays are padded to the largest and masked by ``valid``.
    Returns (sample_c (k, s, d), sample_a (k, s), valid (k, s) bool,
    k_per_leaf (k,) int32). Strata smaller than their budget are sampled
    whole.
    """
    c = np.asarray(c, dtype=np.float64)
    if c.ndim == 1:
        c = c[:, None]
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    assign = np.asarray(assign, dtype=np.int64)
    d = c.shape[1]
    per_leaf = np.broadcast_to(np.asarray(s_per_leaf, dtype=np.int64),
                               (k,)).copy()
    s_pad = max(1, int(per_leaf.max()) if per_leaf.size else 1)
    rng = np.random.default_rng(seed)
    sample_c = np.zeros((k, s_pad, d), dtype=np.float64)
    sample_a = np.zeros((k, s_pad), dtype=np.float64)
    valid = np.zeros((k, s_pad), dtype=bool)
    k_per_leaf = np.zeros(k, dtype=np.int32)
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    starts = np.searchsorted(sorted_assign, np.arange(k), side="left")
    ends = np.searchsorted(sorted_assign, np.arange(k), side="right")
    for i in range(k):
        rows = order[starts[i]:ends[i]]
        if rows.size == 0 or per_leaf[i] <= 0:
            continue
        take = min(int(per_leaf[i]), rows.size)
        sel = rng.choice(rows, size=take, replace=False)
        sample_c[i, :take] = c[sel]
        sample_a[i, :take] = a[sel]
        valid[i, :take] = True
        k_per_leaf[i] = take
    return sample_c, sample_a, valid, k_per_leaf


def proportional_allocation(n_rows: np.ndarray, total_budget: int,
                            min_per_leaf: int = 4) -> np.ndarray:
    """Sample-budget split across strata proportional to stratum size.

    Always ``alloc <= n_rows`` per stratum and ``alloc.sum() <=
    total_budget``; the ``min_per_leaf`` floor holds while the budget
    allows (largest-remainder rounding distributes the rest).
    """
    n_rows = np.asarray(n_rows, dtype=np.float64)
    cap = np.maximum(n_rows, 0).astype(np.int64)
    budget = int(total_budget)
    alloc = np.zeros(cap.shape[0], dtype=np.int64)
    floors = np.minimum(min_per_leaf, cap)
    if floors.sum() <= budget:
        alloc = floors.copy()
    else:
        # The budget cannot honor the floor everywhere: seed the largest.
        for i in np.argsort(-n_rows, kind="stable"):
            if budget - alloc.sum() <= 0:
                break
            alloc[i] = min(cap[i], 1)
    rem = budget - int(alloc.sum())
    while rem > 0:
        headroom = cap - alloc
        w = np.where(headroom > 0, np.maximum(n_rows, 0), 0.0)
        if w.sum() <= 0:
            break
        share = rem * w / w.sum()
        extra = np.minimum(np.floor(share).astype(np.int64), headroom)
        if extra.sum() == 0:
            # Hand out the last units by largest fractional share.
            for i in np.argsort(-share, kind="stable"):
                if rem <= 0:
                    break
                if alloc[i] < cap[i]:
                    alloc[i] += 1
                    rem -= 1
            break
        alloc += extra
        rem -= int(extra.sum())
    if alloc.sum() > total_budget:
        raise AssertionError((int(alloc.sum()), total_budget))
    return alloc


def neyman_allocation(n_rows: np.ndarray, stds: np.ndarray,
                      total_budget: int, min_per_leaf: int = 1
                      ) -> np.ndarray:
    """Sample-budget split proportional to ``n_h * sigma_h`` (Neyman
    allocation, the variance-minimizing split for a stratified SUM/MEAN).

    ``stds`` are per-stratum standard deviations of the measure; strata
    with zero (or unknown) spread get weight from their size alone via a
    tiny tie-breaker, and if every weight vanishes the split degrades to
    :func:`proportional_allocation`. Same contract as that function:
    ``alloc <= n_rows`` per stratum, ``alloc.sum() <= total_budget``,
    ``min_per_leaf`` honored while the budget allows.
    """
    n_rows = np.asarray(n_rows, dtype=np.float64)
    stds = np.asarray(stds, dtype=np.float64)
    w = np.maximum(n_rows, 0) * np.maximum(stds, 0)
    if w.sum() <= 0:
        return proportional_allocation(n_rows, total_budget,
                                       min_per_leaf=min_per_leaf)
    cap = np.maximum(n_rows, 0).astype(np.int64)
    budget = int(total_budget)
    alloc = np.zeros(cap.shape[0], dtype=np.int64)
    floors = np.minimum(min_per_leaf, cap)
    if floors.sum() <= budget:
        alloc = floors.copy()
    else:
        for i in np.argsort(-w, kind="stable"):
            if budget - alloc.sum() <= 0:
                break
            alloc[i] = min(cap[i], 1)
    rem = budget - int(alloc.sum())
    while rem > 0:
        headroom = cap - alloc
        ww = np.where(headroom > 0, w, 0.0)
        if ww.sum() <= 0:
            # Neyman weights exhausted (all spread-y strata are full):
            # spill the rest proportionally into the remaining headroom.
            ww = np.where(headroom > 0, np.maximum(n_rows, 0), 0.0)
            if ww.sum() <= 0:
                break
        share = rem * ww / ww.sum()
        extra = np.minimum(np.floor(share).astype(np.int64), headroom)
        if extra.sum() == 0:
            for i in np.argsort(-share, kind="stable"):
                if rem <= 0:
                    break
                if alloc[i] < cap[i]:
                    alloc[i] += 1
                    rem -= 1
            break
        alloc += extra
        rem -= int(extra.sum())
    if alloc.sum() > total_budget:
        raise AssertionError((int(alloc.sum()), total_budget))
    return alloc


class ReservoirStratum:
    """Reservoir sampler for one stratum (Vitter [41]; paper §4.5 dynamic
    updates). Maintains a uniform sample under insertions, drawing from
    ``default_rng(seed)`` as the JAX package's sampler does; aggregate
    stats are updated exactly and pushed up the tree by the synopsis
    owner."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self.rng = np.random.default_rng(seed)
        self.seen = 0
        self.c: list[np.ndarray] = []
        self.a: list[float] = []

    def insert(self, c_row: np.ndarray, a_val: float) -> tuple[bool, int]:
        """Returns (accepted, replaced_slot or -1)."""
        self.seen += 1
        if len(self.a) < self.capacity:
            self.c.append(np.asarray(c_row, dtype=np.float64))
            self.a.append(float(a_val))
            return True, len(self.a) - 1
        j = int(self.rng.integers(0, self.seen))
        if j < self.capacity:
            self.c[j] = np.asarray(c_row, dtype=np.float64)
            self.a[j] = float(a_val)
            return True, j
        return False, -1


__all__ = ["uniform_sample", "stratified_sample", "proportional_allocation",
           "neyman_allocation", "ReservoirStratum"]
