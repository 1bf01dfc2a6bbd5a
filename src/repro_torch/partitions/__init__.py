"""Partition-selection tier: sketch-guided stratum materialization for
data far larger than any one synopsis (DESIGN.md §14); the port of
``repro.partitions``.

The tier sits above ``build_synopsis``. A cheap mergeable
:class:`PartitionCatalog` of per-partition sketches (row count,
per-column boxes and moments, a small histogram, measure aggregates) is
the only thing that sees every row. At query time :func:`pick_partitions`
prunes disjoint partitions exactly, answers covered ones exactly from the
catalog and samples the overlapping rest by weighted importance with
recorded inclusion probabilities; PASS synopses are built only for the
picked partitions, served in one artifact pass over their stack and
composed by Horvitz-Thompson with two-stage intervals
(:func:`repro_torch.uncertainty.intervals.compose_two_stage`).

Front door: ``PassEngine.from_catalog(parts, catalog=CatalogConfig(...))``.
"""
from .catalog import (PartitionCatalog, empty_catalog, partition_stats,
                      combine_catalogs, global_bin_edges, build_catalog)
from .store import PartitionStore, partition_rows
from .picker import (Selection, classify_partitions, importance_weights,
                     waterfill_pi, pick_partitions)
from .executor import (CATALOG_KINDS, stack_synopses,
                       pad_partition_synopsis, empty_partition_synopsis)
from .source import CatalogSource

__all__ = [
    "PartitionCatalog", "empty_catalog", "partition_stats",
    "combine_catalogs", "global_bin_edges", "build_catalog",
    "PartitionStore", "partition_rows",
    "Selection", "classify_partitions", "importance_weights",
    "waterfill_pi", "pick_partitions",
    "CATALOG_KINDS", "stack_synopses", "pad_partition_synopsis",
    "empty_partition_synopsis",
    "CatalogSource",
]
