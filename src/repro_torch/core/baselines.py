"""Baselines: US, ST, AQP++ and KD-US (paper §5.1.3, §5.4).

Uniform sampling (US) and stratified sampling (ST) are PASS synopses (k = 1
/ k = B equal-depth leaves): with a single whole-data leaf the PASS
estimator reduces exactly to §2.1 uniform sampling, and with B equal-depth
leaves served with ``use_aggregates=False`` (strata are almost never fully
covered, so cover credit is disabled) to §2.2 stratified sampling. Both
serve through ``PassEngine`` and its kernels like any synopsis.

AQP++ [36] follows the paper's description: precomputed aggregates on a
hill-climbed interval partitioning (BP-cube replaced by hill climbing in
1-D, as §5.1.3 states; KD-US's balanced kd boxes in d-D), gap corrected
with a *global uniform* sample, the key contrast with PASS's per-stratum
samples. The structure is built on the host in float64 numpy, draw for
draw the JAX package's, and :meth:`AQPPP.estimate` runs in float64 on the
structure's device, the reference's own dtype, chunked over queries so
that no (queries, samples) plane passes ~1 GB.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import minmax
from . import dp as dp_mod
from . import kdtree
from . import partition_tree as pt
from . import prefix as px
from .synopsis import build_synopsis
from .types import QueryBatch, QueryResult, AGG_SUM, AGG_COUNT, AGG_MIN, AGG_MAX

# Elements of one (queries, samples) float64 plane of AQPPP.estimate: 1 GiB.
PLANE_ELEMS = 1 << 27


def uniform_synopsis(c, a, sample_budget: int, seed: int = 0, device=None):
    """US baseline: one stratum = classic uniform sampling (§2.1). Returns
    ``build_synopsis``'s (synopsis, report); ``device=None`` is the card."""
    return build_synopsis(c, a, k=1, sample_budget=sample_budget,
                          method="eq", seed=seed, device=device)


def stratified_synopsis(c, a, k: int, sample_budget: int, seed: int = 0,
                        device=None):
    """ST baseline: equal-depth strata (§5.1.3)."""
    return build_synopsis(c, a, k=k, sample_budget=sample_budget,
                          method="eq", seed=seed, device=device)


@dataclasses.dataclass
class AQPPP:
    """AQP++ baseline (1-D and KD variants), float64 tensors on one device."""
    bound_lo: torch.Tensor     # (B, d) partition boxes
    bound_hi: torch.Tensor
    agg: torch.Tensor          # (B, 5) exact partition aggregates
    sample_c: torch.Tensor     # (K, d) global uniform sample
    sample_a: torch.Tensor     # (K,)
    sample_leaf: torch.Tensor  # (K,) int64 partition id of each sample
    n: int

    @property
    def device(self) -> torch.device:
        return self.agg.device

    def _bounds(self, kind: str):
        """Per-partition hard bounds (positive-shifted as §2.3), numpy's
        MIN/MAX rule as in the reference."""
        agg = self.agg
        cnt = agg[:, AGG_COUNT]
        if kind == "sum":
            zero = torch.zeros_like(cnt)
            mx0 = minmax.maximum_np(agg[:, AGG_MAX], zero)
            mn0 = minmax.minimum_np(agg[:, AGG_MIN], zero)
            p_ub = minmax.minimum_np(cnt * mx0, agg[:, AGG_SUM] - cnt * mn0)
            p_lb = minmax.maximum_np(cnt * mn0, agg[:, AGG_SUM] - cnt * mx0)
            return p_lb, p_ub
        return torch.zeros_like(cnt), cnt

    def _estimate_rows(self, q_lo, q_hi, kind: str, lam: float):
        lo, hi = self.bound_lo, self.bound_hi
        nonempty = (lo <= hi).all(-1)
        cover = ((q_lo[:, None, :] <= lo[None]).all(-1)
                 & (hi[None] <= q_hi[:, None, :]).all(-1)
                 & nonempty[None])                                  # (Q,B)
        disjoint = ((q_hi[:, None, :] < lo[None]).any(-1)
                    | (q_lo[:, None, :] > hi[None]).any(-1)
                    | ~nonempty[None])
        partial = (~cover & ~disjoint).to(torch.float64)
        K = self.sample_a.shape[0]
        in_q = ((q_lo[:, None, :] <= self.sample_c[None]).all(-1)
                & (self.sample_c[None] <= q_hi[:, None, :]).all(-1))
        gapf = (in_q & ~cover[:, self.sample_leaf]).to(torch.float64)  # (Q,K)
        coverf = cover.to(torch.float64)
        if kind == "sum":
            exact = (coverf * self.agg[None, :, AGG_SUM]).sum(1)
            phi = gapf * self.sample_a[None] * self.n
        else:
            exact = (coverf * self.agg[None, :, AGG_COUNT]).sum(1)
            phi = gapf * self.n
        del gapf
        mean_phi = phi.mean(1)
        var_phi = minmax.maximum_np((phi * phi).mean(1) - mean_phi ** 2,
                                    torch.zeros_like(mean_phi))
        est = exact + mean_phi
        ci = lam * torch.sqrt(var_phi / K)
        p_lb, p_ub = self._bounds(kind)
        lower = exact + (partial * p_lb[None]).sum(1)
        upper = exact + (partial * p_ub[None]).sum(1)
        touched = (partial * self.agg[None, :, AGG_COUNT]).sum(1) \
            / max(self.n, 1)
        return est, ci, lower, upper, touched

    def estimate(self, queries: QueryBatch, kind: str = "sum",
                 lam: float = 2.576) -> QueryResult:
        """SUM / COUNT / AVG estimates with a CLT half-width and hard
        bounds, float32 tensors on the structure's device. AVG is SUM over
        COUNT of the combined estimates, with a first-order delta-method
        interval, in float32 as the reference computes it."""
        if kind == "avg":
            s = self.estimate(queries, "sum", lam)
            cnt = self.estimate(queries, "count", lam)
            one = torch.ones_like(cnt.estimate)
            denom = minmax.maximum_np(cnt.estimate, one)
            est = s.estimate / denom
            ci = (s.ci_half + torch.abs(est) * cnt.ci_half) / denom
            lob = s.lower / minmax.maximum_np(cnt.upper, one)
            upb = s.upper / minmax.maximum_np(cnt.lower, one)
            return QueryResult(est, ci, lob, upb, s.frac_rows_touched)
        if kind not in ("sum", "count"):
            raise ValueError(kind)
        dev = self.device
        q_lo = queries.lo.to(dev, torch.float64)
        q_hi = queries.hi.to(dev, torch.float64)
        K = max(self.sample_a.shape[0], 1)
        step = max(1, PLANE_ELEMS // K)
        parts = [self._estimate_rows(q_lo[i:i + step], q_hi[i:i + step],
                                     kind, lam)
                 for i in range(0, q_lo.shape[0], step)]
        est, ci, lower, upper, touched = (
            torch.cat(x).to(torch.float32) for x in zip(*parts))
        return QueryResult(est, ci, lower, upper, touched)


def _hill_climb_cuts(c_sorted_vals: np.ndarray, a_sorted: np.ndarray, k: int,
                     iters: int = 3, candidates: int = 8, seed: int = 0
                     ) -> np.ndarray:
    """AQP++'s iterative hill climbing over interval boundaries [36].

    Objective: sum over partitions of the §4.2.1 SUM variance (the expected
    gap-estimation error proxy). Moves one boundary at a time to the best
    of a few local candidates.
    """
    s1, s2 = px.prefix_moments(a_sorted)
    n = a_sorted.shape[0]
    cuts = dp_mod.equal_depth_boundaries(n, k).copy()

    def part_cost(g, w):
        nn, sq, sqq = px.interval_moments(s1, s2, np.asarray(g), np.asarray(w))
        return np.maximum(nn * sqq - sq * sq, 0.0) / np.maximum(nn, 1)

    for _ in range(iters):
        for b in range(1, k):
            lo, hi = cuts[b - 1], cuts[b + 1]
            if hi - lo < 2:
                continue
            cand = np.unique(np.clip(
                np.linspace(lo + 1, hi - 1, candidates).astype(np.int64),
                lo + 1, hi - 1))
            costs = np.maximum(part_cost(np.full_like(cand, lo), cand),
                               part_cost(cand, np.full_like(cand, hi)))
            cuts[b] = cand[int(np.argmin(costs))]
    return cuts


def aqppp_synopsis(c, a, k: int, sample_budget: int, seed: int = 0,
                   method: str = "hill", device=None) -> AQPPP:
    """Build the AQP++ baseline structure on the host, as the JAX package
    builds it: hill-climbed intervals in 1-D (``method='hill'``), KD-US's
    balanced kd boxes otherwise, and ``default_rng(seed).choice`` for the
    global sample; then place it on ``device`` (None = the CUDA card)."""
    from .types import aqppp_from_numpy
    c = np.asarray(c, dtype=np.float64)
    c2 = c[:, None] if c.ndim == 1 else c
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    n, d = c2.shape
    rng = np.random.default_rng(seed)
    if d == 1 and method == "hill":
        order = np.argsort(c2[:, 0], kind="stable")
        cuts = _hill_climb_cuts(c2[order, 0], a[order], k, seed=seed)
        ranks = np.empty(n, dtype=np.int64)
        ranks[order] = np.arange(n)
        assign = np.searchsorted(cuts[1:-1], ranks, side="right").astype(np.int32)
        B = k
    else:
        # KD-US (§5.4): kd-tree always expanding the shallowest leaf =
        # balanced equal-count boxes; equivalent to kd median splits.
        assign, _ = kdtree.kd_partition(c2, np.ones_like(a), k=k, m=4096,
                                        kind="count", seed=seed)
        B = int(assign.max()) + 1
    agg, lo, hi = pt.leaf_stats(c2, a, assign, B)
    idx = rng.choice(n, size=min(sample_budget, n), replace=False)
    return aqppp_from_numpy(
        {"bound_lo": lo, "bound_hi": hi, "agg": agg, "sample_c": c2[idx],
         "sample_a": a[idx], "sample_leaf": assign[idx].astype(np.int64),
         "n": n}, device=device)


__all__ = ["uniform_synopsis", "stratified_synopsis", "AQPPP",
           "aqppp_synopsis", "PLANE_ELEMS"]
