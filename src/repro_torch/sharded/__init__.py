"""Sharded synopsis: data-parallel PASS build, streaming ingest and drift
re-optimization over a shard axis (DESIGN.md §11); the port of
``repro.sharded``.

The synopsis itself is O(K) small and serves whole; what scales with the
data is the O(N) work of *filling* it: exact per-leaf aggregates, boxes
and per-stratum reservoirs. This package splits that work row-wise over a
``"shards"`` axis with no cross-shard step in the hot path and an O(k)
merge at serve time. On one card the D shards are the leading axis of
every state field, run one after another.

Entry points:
    build_synopsis_sharded(c, a, k=...)   data-parallel build -> ingestor
    ShardedIngestor(base)                 data-parallel streaming ingest
    reoptimize_sharded(ing, c, a)         sharded drift rebuild
    PassEngine.from_sharded(c, a, ...)    build and serve in one call
"""
from .mesh import (SHARD_AXIS, ShardMesh, data_mesh, make_mesh, num_shards,
                   shard_leading, split_rows)
from .ingest import ShardedIngestor, init_sharded_state
from .merge import merge_sharded
from .catalog import catalog_delta_sharded
from .build import (build_synopsis_sharded, fill_skeleton, skeleton_synopsis,
                    cut_skeleton_1d, cut_skeleton_kd, thresholds_to_boxes)
from .reopt import (reoptimize_cuts_sharded, reoptimize_sharded,
                    maybe_reoptimize_sharded)

__all__ = [
    "SHARD_AXIS", "ShardMesh", "data_mesh", "make_mesh", "num_shards",
    "shard_leading", "split_rows",
    "ShardedIngestor", "init_sharded_state", "merge_sharded",
    "catalog_delta_sharded",
    "build_synopsis_sharded", "fill_skeleton", "skeleton_synopsis",
    "cut_skeleton_1d", "cut_skeleton_kd", "thresholds_to_boxes",
    "reoptimize_cuts_sharded", "reoptimize_sharded",
    "maybe_reoptimize_sharded",
]
