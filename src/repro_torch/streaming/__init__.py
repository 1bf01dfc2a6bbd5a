"""Streaming ingestion (paper §4.5, closed re-optimization loop).

* :mod:`ingest` — ``StreamingIngestor``: batch routing against the leaf
  boxes, leaf aggregate deltas through the ``segment_reduce`` kernel, and
  batched Vitter reservoir replacement.
* :mod:`delta` — delta-merge of the immutable base synopsis with the
  device-resident stream delta into a serving-ready synopsis.
* :mod:`policy` — drift signals and the on-device re-optimization loop.
"""
from .ingest import (StreamingIngestor, StreamState, ingest_batch_reference,
                     stream_state_from_numpy)
from .delta import merge_synopsis, subtree_leaf_matrix, reservoir_moments
from .policy import DriftPolicy, reoptimize_cuts, reoptimize

__all__ = [
    "StreamingIngestor", "StreamState", "ingest_batch_reference",
    "stream_state_from_numpy",
    "merge_synopsis", "subtree_leaf_matrix", "reservoir_moments",
    "DriftPolicy", "reoptimize_cuts", "reoptimize",
]
