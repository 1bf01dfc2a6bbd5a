"""Query engine: plan -> execute -> assemble.

* :mod:`planner`  — the Minimal Coverage Frontier over internal tree
  nodes (host numpy), batched level-synchronously over the query batch.
* :mod:`executor` — the shared per-batch artifacts (relation masks, exact
  aggregates, stratified moments), computed once per batch.
* :mod:`assemble` — every requested aggregate kind derived from them.

The user-facing serving entry is :mod:`repro_torch.api` (``PassEngine``);
this package's ``answer`` is a deprecated shim over it.
"""
from .planner import QueryPlan, plan_queries, relation_masks
from .executor import (Artifacts, artifacts, compute_artifacts,
                       plan_to_masks, OP_COUNTS, reset_op_counts)
from .assemble import answer, assemble, KINDS

__all__ = ["QueryPlan", "plan_queries", "relation_masks", "Artifacts",
           "artifacts", "compute_artifacts", "plan_to_masks", "OP_COUNTS",
           "reset_op_counts", "answer", "assemble", "KINDS"]
