"""Drift-triggered re-optimization (closing the paper's §4.5 open loop).

The port of ``repro/streaming/policy.py``. A :class:`DriftPolicy`
thresholds two live signals of the ingestor, ``staleness`` (fraction of
rows streamed since the base build) and ``oob_frac`` (fraction of
streamed rows outside every leaf box), and when either trips re-runs the
paper's "Sampling + Discretization" optimizer on the device:
``dp_monotone_device`` over the live reservoir pool gives fresh cuts, and
the synopsis is rebuilt through the synopsis build's shared assembly
(``synopsis_from_assignment``) with re-stratified samples.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import dp as dp_mod
from ..core.sampling import neyman_allocation
from ..core.synopsis import synopsis_from_assignment
from ..device import to_numpy
from .ingest import StreamingIngestor


def reoptimize_cuts(ing: StreamingIngestor, k: int | None = None
                    ) -> tuple[torch.Tensor, float]:
    """Re-partitioning on the device: the monotone DP (SUM oracle) over
    the valid reservoir samples sorted by coordinate, its cut ranks mapped
    to value thresholds. Returns ((k-1,) f32 thresholds on the device, the
    sample-space max variance). 1-D synopses only.

    The pooled reservoir is a per-stratum equal-capacity sample, not a
    uniform sample of the current data, so strata that grew far beyond
    their slots are under-represented: the cuts adapt to the drift but are
    not the cuts a fresh uniform-sample run would pick. The rebuild's
    aggregates and samples are exact and fresh either way.
    """
    base = ing.base
    if base.d != 1:
        raise ValueError("on-device re-optimization supports 1-D synopses; "
                         "rebuild KD synopses with build_synopsis(method='kd')")
    k = k or base.num_leaves
    state = ing.state
    valid = state.sample_valid.reshape(-1)
    m = int(valid.sum())
    if m < k + 1:
        raise ValueError(f"reservoir pool too small to re-optimize: "
                         f"{m} < {k + 1}")
    cs = state.sample_c.reshape(-1)
    as_ = state.sample_a.reshape(-1)
    order = torch.argsort(torch.where(valid, cs, float("inf")),
                          stable=True)[:m]
    cuts, vmax = dp_mod.dp_monotone_device(as_[order], k)
    thr = dp_mod.cuts_to_thresholds_device(cs[order], cuts)
    return thr, float(vmax)


def reoptimize(ing: StreamingIngestor, c, a, *, k: int | None = None,
               s_per_leaf: int | None = None, seed: int = 0,
               allocation: str = "neyman"
               ) -> tuple[StreamingIngestor, dict]:
    """Drift-adapted rebuild: device DP cuts, then the build's assembly
    (exact stats and re-stratified samples on the host). ``c``/``a`` are
    the current full dataset (base plus streamed rows). Returns a fresh
    ingestor on the same device, anchored on the new base, and a report.

    ``allocation`` (used only when ``s_per_leaf`` is None) splits the old
    total sample budget over the new strata: ``'neyman'`` weights each by
    n_h * sigma_h from the data's exact moments; ``'equal'`` gives each
    the old per-leaf capacity.
    """
    thr, vmax = reoptimize_cuts(ing, k)
    k = thr.shape[0] + 1
    thr_np = to_numpy(thr)
    c_np = np.asarray(c, dtype=np.float64).reshape(-1)
    a_np = np.asarray(a, dtype=np.float64).reshape(-1)
    assign = np.searchsorted(thr_np, c_np, side="right").astype(np.int32)
    if s_per_leaf is None:
        cap = ing.base.sample_c.shape[1]
        if allocation == "neyman":
            counts = np.bincount(assign, minlength=k).astype(np.float64)
            sums = np.bincount(assign, weights=a_np, minlength=k)
            sumsqs = np.bincount(assign, weights=a_np * a_np, minlength=k)
            mean = sums / np.maximum(counts, 1.0)
            stds = np.sqrt(np.maximum(
                sumsqs / np.maximum(counts, 1.0) - mean * mean, 0.0))
            s_per_leaf = neyman_allocation(counts, stds, cap * k)
        elif allocation == "equal":
            s_per_leaf = cap
        else:
            raise ValueError(f"unknown allocation: {allocation!r}")
    syn, _ = synopsis_from_assignment(c_np, a_np, assign, k,
                                      s_per_leaf=s_per_leaf, seed=seed,
                                      device=ing.device)
    report = {"k": k, "sample_max_variance": vmax, "thresholds": thr_np,
              "staleness_at_reopt": ing.staleness(),
              "oob_frac_at_reopt": ing.oob_frac()}
    return StreamingIngestor(syn, seed=seed + 1, device=ing.device), report


@dataclasses.dataclass
class DriftPolicy:
    """Thresholded drift triggers for the re-optimization loop.

    ``staleness_threshold``: re-optimize once this fraction of the data
    arrived after the base build. ``oob_threshold``: once this fraction of
    streamed rows landed outside every leaf box. ``min_stream_rows``
    suppresses triggers before the signals mean anything.
    """
    staleness_threshold: float = 0.25
    oob_threshold: float = 0.05
    min_stream_rows: int = 1024

    def should_reoptimize(self, ing: StreamingIngestor) -> bool:
        if ing.n_stream < self.min_stream_rows:
            return False
        return (ing.staleness() >= self.staleness_threshold
                or ing.oob_frac() >= self.oob_threshold)

    def maybe_reoptimize(self, ing: StreamingIngestor, c, a, **kw
                         ) -> tuple[StreamingIngestor, dict | None]:
        """Re-optimize iff a drift signal trips; returns (ingestor, report),
        the report None when nothing happened."""
        if not self.should_reoptimize(ing):
            return ing, None
        return reoptimize(ing, c, a, **kw)


__all__ = ["DriftPolicy", "reoptimize_cuts", "reoptimize"]
