"""Streaming ingestion (paper §4.5, closed re-optimization loop).

* :mod:`ingest` — ``StreamingIngestor``: batch routing against the leaf
  boxes, leaf aggregate deltas through the ``segment_reduce`` kernel, and
  batched Vitter reservoir replacement.
* :mod:`delta` — delta-merge of the immutable base synopsis with the
  device-resident stream delta into a serving-ready synopsis.
* :mod:`policy` — drift signals and the on-device re-optimization loop.
* :mod:`join_ingest` — ``JoinStreamingIngestor``: the same transition for
  a join synopsis, plus streamed cell aggregates and universe appends.
"""
from .ingest import (StreamingIngestor, StreamState, ingest_batch_reference,
                     stream_state_from_numpy)
from .delta import merge_synopsis, subtree_leaf_matrix, reservoir_moments
from .policy import DriftPolicy, reoptimize_cuts, reoptimize
from .join_ingest import JoinStreamingIngestor, JoinStreamState

__all__ = [
    "StreamingIngestor", "StreamState", "ingest_batch_reference",
    "stream_state_from_numpy",
    "merge_synopsis", "subtree_leaf_matrix", "reservoir_moments",
    "DriftPolicy", "reoptimize_cuts", "reoptimize",
    "JoinStreamingIngestor", "JoinStreamState",
]
