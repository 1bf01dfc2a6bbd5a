"""Data-parallel PASS synopsis build (DESIGN.md §11); the port of
``repro/sharded/build.py``.

The paper's partition *search* runs on a small uniform subsample
(§4.2/§4.4), so it stays on the host; only the O(N) pass that fills the
partition with exact aggregates and stratified samples needs the card:

1. **Skeleton** (host, subsample): 1-D, ADP or equal-depth cuts over
   ``opt_samples`` rows -> (k-1,) thresholds; KD, greedy ``kd_partition``
   boxes over the subsample with outer faces stretched to +-BIG so the
   skeleton tiles all of R^d. Its cost depends on neither N nor D.
2. **Fill** (card, full data): rows stream through the sharded ingestor
   in batches, routed against the static skeleton. Each shard computes
   its block's exact (k, 5) aggregates with row 5, grows exact per-leaf
   boxes by scatter extremes and fills its own slice of every stratum's
   reservoir.
3. **Merge and commit** (O(k)): the merge gives the serving synopsis,
   which ``commit()`` folds in as the new immutable base.

The skeleton is frozen before the fill, so the row -> leaf assignment,
hence every exact aggregate, is the same whatever the shard count
(bit-identical on integer-valued data, where float32 sums are exact).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core import dp as dp_mod
from ..core import kdtree
from ..core import partition_tree as pt
from ..core.types import PartitionTree, Synopsis
from ..device import resolve_device
from ..kernels.segment_reduce import NEG_BIG, POS_BIG
from .ingest import ShardedIngestor
from .mesh import ShardMesh, data_mesh, num_shards


def _subsample(n: int, opt_samples: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = min(int(opt_samples), n)
    return rng.choice(n, size=m, replace=False) if m < n else np.arange(n)


def cut_skeleton_1d(c, a, k: int, *, method: str = "adp",
                    opt_samples: int = 4096, seed: int = 0
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(k, 1) routing interval boxes from subsample cuts.

    ``method='adp'`` runs the paper's Sampling+Discretization DP (SUM
    oracle, float32 as the reference's ``dp_monotone_jnp``) on the
    subsample, on the host; ``'eq'`` takes equal-depth cuts. Returns
    (route_lo, route_hi) with the outer faces at -/+BIG; interval i is
    ``(thr[i-1], thr[i]]`` under the upper-leaf tie rule of the build step.
    """
    c = np.asarray(c, np.float32)
    if c.ndim == 1:
        c = c[:, None]
    a = np.asarray(a, np.float32).reshape(-1)
    idx = _subsample(a.shape[0], opt_samples, seed)
    sc, sa = c[idx, 0], a[idx]
    order = np.argsort(sc, kind="stable")
    c_sorted = torch.from_numpy(np.ascontiguousarray(sc[order]))
    if method == "adp":
        cuts, _ = dp_mod.dp_monotone_device(
            torch.from_numpy(np.ascontiguousarray(sa[order])), k)
    elif method == "eq":
        cuts = torch.from_numpy(dp_mod.equal_depth_boundaries(idx.size, k))
    else:
        raise ValueError(f"unknown skeleton method {method!r}")
    thr = dp_mod.cuts_to_thresholds_device(c_sorted, cuts).numpy()
    return thresholds_to_boxes(thr)


def thresholds_to_boxes(thr) -> tuple[np.ndarray, np.ndarray]:
    """(k-1,) value thresholds -> (k, 1) static routing interval boxes."""
    thr = np.asarray(thr, np.float32).reshape(-1)
    lo = np.concatenate([[NEG_BIG], thr]).astype(np.float32)[:, None]
    hi = np.concatenate([thr, [POS_BIG]]).astype(np.float32)[:, None]
    return lo, hi


def cut_skeleton_kd(c, a, k: int, *, kind: str = "sum",
                    opt_samples: int = 4096, seed: int = 0,
                    delta_frac: float = 0.01
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(k, d) static KD routing boxes from a greedy subsample partition.

    ``kd_partition`` tiles the subsample's bounding box; faces flush with
    that root box stretch to +-BIG, so every later row (the full data,
    drift included) is *contained*: routing never falls into the
    nearest-box regime and does not depend on the shard count.
    """
    c = np.asarray(c, np.float64)
    if c.ndim == 1:
        c = c[:, None]
    a = np.asarray(a, np.float64).reshape(-1)
    idx = _subsample(a.shape[0], opt_samples, seed)
    _, boxes = kdtree.kd_partition(c[idx], a[idx], k=k, m=idx.size,
                                   kind=kind, delta_frac=delta_frac,
                                   seed=seed)
    lo = boxes[:, :, 0].astype(np.float32)
    hi = boxes[:, :, 1].astype(np.float32)
    root_lo = lo.min(axis=0)
    root_hi = hi.max(axis=0)
    lo = np.where(lo <= root_lo, NEG_BIG, lo).astype(np.float32)
    hi = np.where(hi >= root_hi, POS_BIG, hi).astype(np.float32)
    return lo, hi


def skeleton_synopsis(k: int, d: int, s_cap: int, device=None) -> Synopsis:
    """Empty k-leaf synopsis on ``device`` (None = the CUDA card): zero
    aggregates, inverted (+inf/-inf) boxes. The fill's scatter MIN/MAX
    grows those into the *exact data* boxes (the classification-exactness
    invariant of DESIGN.md §3), with no slack seeded from the skeleton."""
    dev = resolve_device(device)
    agg = np.zeros((k, 5))
    agg[:, 3] = np.inf
    agg[:, 4] = -np.inf
    lo = np.full((k, d), np.inf)
    hi = np.full((k, d), -np.inf)
    tree = pt.build_tree_from_leaves(agg, lo, hi)
    f32 = dict(dtype=torch.float32, device=dev)

    def t(x):
        return torch.as_tensor(x, **f32)

    return Synopsis(
        leaf_lo=t(lo), leaf_hi=t(hi), leaf_agg=t(agg),
        n_rows=torch.zeros(k, **f32),
        sample_c=torch.zeros((k, s_cap, d), **f32),
        sample_a=torch.zeros((k, s_cap), **f32),
        sample_valid=torch.zeros((k, s_cap), dtype=torch.bool, device=dev),
        k_per_leaf=torch.zeros(k, dtype=torch.int32, device=dev),
        tree=PartitionTree(
            lo=t(tree.lo), hi=t(tree.hi), agg=t(tree.agg),
            left=tree.left.to(dev), right=tree.right.to(dev),
            leaf_id=tree.leaf_id.to(dev), level=tree.level.to(dev)),
        num_leaves=k, d=d, total_rows=torch.zeros((), **f32))


def fill_skeleton(c, a, route_lo, route_hi, *, mesh: ShardMesh,
                  s_cap: int, seed: int = 0,
                  batch_rows: int = 1 << 16) -> ShardedIngestor:
    """Stream the full dataset through a sharded build-phase ingestor on
    the mesh's device and commit. The shared tail of
    :func:`build_synopsis_sharded` and of the re-optimizer
    (:mod:`repro_torch.sharded.reopt`)."""
    c = np.asarray(c, np.float32)
    if c.ndim == 1:
        c = c[:, None]
    a = np.asarray(a, np.float32).reshape(-1)
    k = route_lo.shape[0]
    ing = ShardedIngestor(
        skeleton_synopsis(k, c.shape[1], s_cap, device=mesh.device),
        mesh=mesh, seed=seed, route_boxes=(route_lo, route_hi))
    for i in range(0, a.shape[0], batch_rows):
        ing.ingest(c[i:i + batch_rows], a[i:i + batch_rows])
    ing.commit()
    return ing


def build_synopsis_sharded(c, a, *, k: int = 64,
                           mesh: ShardMesh | None = None,
                           method: str = "adp", kind: str = "sum",
                           sample_budget: int | None = None,
                           opt_samples: int = 4096, seed: int = 0,
                           batch_rows: int = 1 << 16, device=None
                           ) -> tuple[ShardedIngestor, dict]:
    """Data-parallel analogue of ``core.synopsis.build_synopsis``.

    Returns (committed :class:`ShardedIngestor`, report). The ingestor
    serves at once (``PassEngine(ing)``) and goes on streaming; ``method``
    picks the 1-D skeleton ('adp' | 'eq'), d > 1 always takes the KD
    skeleton. ``mesh=None`` is a ``data_mesh`` on ``device`` (None = the
    CUDA card). The per-leaf sample capacity is rounded up to a multiple
    of D, so the merged serving shape (k, S) is the same for every shard
    count whose rounding coincides (e.g. any capacity that is a multiple
    of the counts compared).
    """
    mesh = mesh if mesh is not None else data_mesh(device=device)
    D = num_shards(mesh)
    c = np.asarray(c, np.float32)
    if c.ndim == 1:
        c = c[:, None]
    a = np.asarray(a, np.float32).reshape(-1)
    n, d = c.shape
    if sample_budget is None:
        sample_budget = max(k, int(0.005 * n))
    s_cap = max(1, -(-int(sample_budget) // k))
    s_cap = D * (-(-s_cap // D))                     # a multiple of D
    t0 = time.perf_counter()
    if d == 1:
        route_lo, route_hi = cut_skeleton_1d(
            c, a, k, method=method, opt_samples=opt_samples, seed=seed)
    else:
        route_lo, route_hi = cut_skeleton_kd(
            c, a, k, kind=kind, opt_samples=opt_samples, seed=seed)
    t1 = time.perf_counter()
    ing = fill_skeleton(c, a, route_lo, route_hi, mesh=mesh, s_cap=s_cap,
                        seed=seed + 1, batch_rows=batch_rows)
    t2 = time.perf_counter()
    report = {"k": int(route_lo.shape[0]), "n": n, "d": d,
              "n_shards": D, "s_cap": int(s_cap),
              "seconds_total": t2 - t0, "seconds_skeleton": t1 - t0,
              "seconds_fill": t2 - t1,
              "rows_per_sec": n / max(t2 - t1, 1e-9)}
    return ing, report


__all__ = ["build_synopsis_sharded", "fill_skeleton", "skeleton_synopsis",
           "cut_skeleton_1d", "cut_skeleton_kd", "thresholds_to_boxes"]
