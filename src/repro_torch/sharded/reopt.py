"""Sharded drift re-optimization (DESIGN.md §11, paper §4.5); the port of
``repro/sharded/reopt.py``.

The loop of :mod:`repro_torch.streaming.policy`, over the shard axis: the
drift signals (``staleness`` / ``oob_frac``) accumulate per shard inside
the sharded ingestor; when a :class:`DriftPolicy` trips, the DP runs over
the *merged* reservoir pool (no raw rows move), the fresh cuts become the
static skeleton of every shard, and the rebuild streams the caller's rows
through the data-parallel fill, the O(N) part.
"""
from __future__ import annotations

import torch

from ..core import dp as dp_mod
from ..device import to_numpy
from ..streaming.policy import DriftPolicy
from .build import fill_skeleton, thresholds_to_boxes
from .ingest import ShardedIngestor


def reoptimize_cuts_sharded(ing: ShardedIngestor, k: int | None = None
                            ) -> tuple[torch.Tensor, float]:
    """DP cuts over the merged (all-shard) reservoir pool, on the
    ingestor's device. 1-D only: KD synopses rebuild through
    ``build_synopsis_sharded``. Carries the equal-capacity-pool caveat of
    ``streaming.policy.reoptimize_cuts``."""
    merged = ing.as_synopsis()
    if merged.d != 1:
        raise ValueError("sharded re-optimization supports 1-D synopses; "
                         "rebuild KD synopses with build_synopsis_sharded")
    k = k or merged.num_leaves
    valid = merged.sample_valid.reshape(-1)
    m = int(valid.sum())
    if m < k + 1:
        raise ValueError(
            f"merged reservoir pool too small to re-optimize: {m} < {k + 1}")
    cs = merged.sample_c.reshape(-1)
    as_ = merged.sample_a.reshape(-1)
    order = torch.argsort(torch.where(valid, cs, float("inf")),
                          stable=True)[:m]
    cuts, vmax = dp_mod.dp_monotone_device(as_[order], k)
    thr = dp_mod.cuts_to_thresholds_device(cs[order], cuts)
    return thr, float(vmax)


def reoptimize_sharded(ing: ShardedIngestor, c, a, *, k: int | None = None,
                       seed: int = 0, batch_rows: int = 1 << 16
                       ) -> tuple[ShardedIngestor, dict]:
    """Full sharded rebuild: merged-pool DP -> the cuts as every shard's
    skeleton -> per-shard fill. ``c`` / ``a`` are the current full dataset
    (base plus streamed rows, owned by the caller). Returns (a fresh
    committed ingestor on the same mesh, report)."""
    thr, vmax = reoptimize_cuts_sharded(ing, k)
    thr = to_numpy(thr)
    route_lo, route_hi = thresholds_to_boxes(thr)
    report = {"k": int(route_lo.shape[0]),
              "sample_max_variance": vmax,
              "thresholds": thr,
              "n_shards": ing.n_shards,
              "staleness_at_reopt": ing.staleness(),
              "oob_frac_at_reopt": ing.oob_frac()}
    new_ing = fill_skeleton(c, a, route_lo, route_hi, mesh=ing.mesh,
                            s_cap=ing.base.sample_c.shape[1],
                            seed=seed + 1, batch_rows=batch_rows)
    return new_ing, report


def maybe_reoptimize_sharded(policy: DriftPolicy, ing: ShardedIngestor,
                             c, a, **kw
                             ) -> tuple[ShardedIngestor, dict | None]:
    """Sharded counterpart of ``DriftPolicy.maybe_reoptimize`` (the policy
    reads the ingestor's drift signals as they are)."""
    if not policy.should_reoptimize(ing):
        return ing, None
    return reoptimize_sharded(ing, c, a, **kw)


__all__ = ["reoptimize_cuts_sharded", "reoptimize_sharded",
           "maybe_reoptimize_sharded"]
