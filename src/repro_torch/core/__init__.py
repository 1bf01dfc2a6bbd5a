"""Synopsis types, host build (partitioning, aggregates, stratified
samples), query workloads and the legacy single-kind shims, exported
name for name as the JAX package's ``repro.core``."""
from .types import (PartitionTree, Synopsis, QueryBatch, QueryResult,
                    AGG_SUM, AGG_SUMSQ, AGG_COUNT, AGG_MIN, AGG_MAX,
                    REL_NONE, REL_PARTIAL, REL_COVER)
from .synopsis import build_synopsis, BuildReport, delta_encode, delta_decode
from .query import (answer, ground_truth, random_queries,
                    challenging_queries, relative_error, ci_ratio)
from .estimators import estimate, classify_leaves, ess, skip_rate

__all__ = ["PartitionTree", "Synopsis", "QueryBatch", "QueryResult",
           "AGG_SUM", "AGG_SUMSQ", "AGG_COUNT", "AGG_MIN", "AGG_MAX",
           "REL_NONE", "REL_PARTIAL", "REL_COVER", "build_synopsis",
           "BuildReport", "delta_encode", "delta_decode", "answer",
           "ground_truth", "random_queries", "challenging_queries",
           "relative_error", "ci_ratio", "estimate", "classify_leaves",
           "ess", "skip_rate"]
