"""Sketch-guided partition selection (DESIGN.md §14; after PS3); the port
of ``repro/partitions/picker.py``, host numpy as there, so the same seed
draws the same picks.

Given the catalog and a query batch, the picker splits partitions into
three exact classes per query using the per-partition boxes:

* **disjoint** — the box misses the rectangle (or the partition is
  empty): contributes exactly zero, pruned;
* **covered**  — the box lies inside the rectangle: answered exactly
  from the catalog's measure aggregates, no synopsis needed;
* **overlapping** — everything else: the only partitions whose rows must
  be estimated.

Overlapping candidates are then sampled by **weighted importance**: each
partition's weight multiplies its histogram-estimated relevant row mass
(per-dimension bin-overlap fractions, PS3's selectivity sketch) by the
RMS of its measure (sqrt(E[a²]) from SUMSQ/COUNT), i.e. an estimate of
the second moment its rows contribute to a SUM. Inclusion probabilities
come from water-filling ``pi_p = min(1, c·w_p)`` with ``sum pi = budget``
(partitions whose weight saturates get pi=1 and the remainder is
redistributed), floored at ``pi_floor`` so every candidate keeps a
nonzero chance — the Horvitz–Thompson estimator downstream divides by
``pi``. The realized pick is an independent (Poisson) draw per
partition, recorded in a :class:`Selection` together with the
probabilities, so the two-stage interval composition can account for
the partition-sampling stage.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.types import AGG_SUMSQ, AGG_COUNT
from ..device import to_numpy
from .catalog import PartitionCatalog


def _host(x) -> np.ndarray:
    """A catalog field as host float64 (copied off the device if there)."""
    return np.asarray(to_numpy(x), np.float64)


@dataclasses.dataclass(frozen=True)
class Selection:
    """One selection decision over a query batch.

    ``cover``/``overlap`` are (Q, P) bool masks from the exact box
    classification. ``pi`` (P,) holds inclusion probabilities: 1.0 for
    partitions picked with certainty (including every covered-only
    partition, served exactly), the water-filled probability for
    overlapping candidates, 0.0 for partitions no query can reach.
    ``picked`` (P,) bool is the realized draw — exactly the partitions
    to materialize synopses for.
    """
    cover: np.ndarray
    overlap: np.ndarray
    pi: np.ndarray
    picked: np.ndarray
    weights: np.ndarray
    seed: int


def classify_partitions(cat: PartitionCatalog, q_lo, q_hi
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Exact per-(query, partition) box classification -> (cover, overlap)
    bool masks, (Q, P). Inclusive predicate semantics (lo <= c <= hi),
    matching the kernel classification; empty partitions (inverted boxes)
    are disjoint from everything."""
    lo = _host(cat.col_lo)[None]                       # (1, P, d)
    hi = _host(cat.col_hi)[None]
    n = _host(cat.n)[None]                             # (1, P)
    ql = np.asarray(q_lo, np.float64)[:, None]             # (Q, 1, d)
    qh = np.asarray(q_hi, np.float64)[:, None]
    nonempty = n > 0
    disjoint = np.any((hi < ql) | (lo > qh), axis=2) | ~nonempty
    cover = np.all((ql <= lo) & (hi <= qh), axis=2) & nonempty & ~disjoint
    overlap = ~disjoint & ~cover
    return cover, overlap


def _overlap_fraction(cat: PartitionCatalog, q_lo, q_hi) -> np.ndarray:
    """(Q, P) histogram-estimated fraction of each partition's rows inside
    each rectangle: product over dimensions of the bin-mass overlap, with
    partial end bins weighted by linear interpolation."""
    hist = _host(cat.hist)                             # (P, d, B)
    bins = cat.bins
    blo = _host(cat.bin_lo)                            # (d,)
    bhi = _host(cat.bin_hi)
    width = np.maximum(bhi - blo, 1e-30) / bins
    edges = blo[:, None] + width[:, None] * np.arange(bins + 1)[None]
    e_lo, e_hi = edges[:, :-1], edges[:, 1:]               # (d, B)
    ql = np.asarray(q_lo, np.float64)                      # (Q, d)
    qh = np.asarray(q_hi, np.float64)
    # (Q, d, B) fraction of each bin's width inside [ql, qh]
    inter = (np.minimum(qh[:, :, None], e_hi[None])
             - np.maximum(ql[:, :, None], e_lo[None]))
    frac_bin = np.clip(inter / np.maximum(e_hi - e_lo, 1e-30)[None], 0.0, 1.0)
    mass = np.maximum(hist.sum(axis=2), 1.0)               # (P, d)
    # (Q, P, d): per-dim fraction of partition mass inside the rectangle
    per_dim = np.einsum("pdb,qdb->qpd", hist, frac_bin) / mass[None]
    return np.clip(np.prod(per_dim, axis=2), 0.0, 1.0)


def importance_weights(cat: PartitionCatalog, q_lo, q_hi,
                       overlap: np.ndarray) -> np.ndarray:
    """(P,) importance of each overlapping candidate across the batch:
    sum over queries of (estimated relevant rows) x (measure RMS)."""
    n = _host(cat.n)                                   # (P,)
    m_agg = _host(cat.m_agg)
    rms = np.sqrt(m_agg[:, AGG_SUMSQ] / np.maximum(m_agg[:, AGG_COUNT], 1.0))
    frac = _overlap_fraction(cat, q_lo, q_hi)              # (Q, P)
    est_rows = frac * n[None]
    w = (est_rows * np.where(overlap, 1.0, 0.0)).sum(axis=0) * (rms + 1e-12)
    return np.where(overlap.any(axis=0), np.maximum(w, 1e-12), 0.0)


def waterfill_pi(weights: np.ndarray, budget: int,
                 pi_floor: float = 0.05) -> np.ndarray:
    """Inclusion probabilities with expected pick count ~= ``budget``:
    iterate ``pi = min(1, c·w)`` raising c until the unsaturated mass uses
    exactly the budget left over by the saturated (pi=1) partitions, then
    floor at ``pi_floor``. Candidates are rows with weight > 0."""
    w = np.asarray(weights, np.float64)
    cand = w > 0
    m = int(cand.sum())
    pi = np.zeros_like(w)
    if m == 0:
        return pi
    if budget >= m:
        pi[cand] = 1.0
        return pi
    budget = float(max(budget, 1))
    saturated = np.zeros_like(cand)
    for _ in range(m):
        free = cand & ~saturated
        rem = budget - saturated.sum()
        if rem <= 0 or not free.any():
            break
        scale = rem / w[free].sum()
        newly = free & (w * scale >= 1.0)
        if not newly.any():
            pi[free] = w[free] * scale
            break
        saturated |= newly
    pi[saturated] = 1.0
    return np.where(cand, np.clip(pi, pi_floor, 1.0), 0.0)


def pick_partitions(cat: PartitionCatalog, q_lo, q_hi, *,
                    budget: int | None, pi_floor: float = 0.05,
                    seed: int = 0) -> Selection:
    """Classify + weight + draw: the full selection decision for a batch.

    ``budget=None`` (or >= the candidate count) selects every overlapping
    candidate with pi=1 — the estimator then has no partition-sampling
    stage at all. Covered-only and unreachable partitions are never
    materialized regardless of budget (exact pruning)."""
    cover, overlap = classify_partitions(cat, q_lo, q_hi)
    w = importance_weights(cat, q_lo, q_hi, overlap)
    cand = overlap.any(axis=0)
    if budget is None or budget >= int(cand.sum()):
        pi = np.where(cand, 1.0, 0.0)
        picked = cand.copy()
    else:
        pi = waterfill_pi(w, budget, pi_floor=pi_floor)
        rng = np.random.default_rng(seed)
        picked = rng.uniform(size=pi.shape[0]) < pi
    # Covered-only partitions are served exactly: record pi=1 (their
    # "selection" is deterministic) without materializing them.
    pi = np.where(cover.any(axis=0) & ~cand, 1.0, pi)
    return Selection(cover=cover, overlap=overlap, pi=pi, picked=picked,
                     weights=w, seed=int(seed))


__all__ = ["Selection", "classify_partitions", "importance_weights",
           "waterfill_pi", "pick_partitions"]
