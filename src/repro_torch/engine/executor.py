"""Query executor: computes the shared per-batch artifacts exactly once.

One ``Artifacts`` bundle answers every aggregate kind: the leaf relation
masks and the exact covered-aggregate accumulation come from one
``query_eval`` call (or from a planner ``QueryPlan``'s masks, passed as
``plan_masks``), the stratified sample moments from one
``stratified_moments`` call, and the relevant-sample extremes (only for
MIN/MAX) from one pass. The assembler derives each requested kind from
these without touching the samples again.

``OP_COUNTS`` counts executions of each artifact stage, so tests can
assert that a 3-kind ``answer()`` performs one classification and one
moment pass.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.types import Synopsis, QueryBatch, QueryResult, NUM_AGGS, \
    REL_PARTIAL, REL_COVER
from ..kernels import ops
from .planner import QueryPlan

# Execution counters for the artifact stages (see module docstring).
OP_COUNTS = {"classify": 0, "moments": 0, "extremes": 0}

# Pad rows: empty predicates (lo > hi) match no leaf and no sample. Finite,
# so no distance or comparison in any kernel meets an inf.
PAD_LO, PAD_HI = 3.0e38, -3.0e38

# Batches of fewer rows are served padded to this many, so that a row's
# bits do not depend on the batch it came in. The epilogue's float sums
# over the k strata are PyTorch reductions, and CUDA's picks its block
# shape from the number of rows: below 16 rows it gives each row more
# threads and sums in another order (on an H100, 3-D rows at Q = 8 and 15
# differed from the same rows at Q >= 16 in their last bits); from 16 rows
# up every row had the same bits at every Q measured, up to 2048. The
# coalescer promises a tenant's padded rows bit-equal to its own answer.
MIN_ROWS = 16


def reset_op_counts():
    for key in OP_COUNTS:
        OP_COUNTS[key] = 0


@dataclasses.dataclass
class Artifacts:
    """Shared per-(query batch) artifacts; every field is (Q, ...)-shaped.

    ``exact`` (Q, NUM_AGGS): its SUM/SUMSQ/COUNT columns are the exact part
    of the answer (the MIN/MAX columns are not meaningful). Moment fields
    are None when no sampled kind was requested; extreme fields are None
    unless MIN/MAX was requested.
    """
    rel: torch.Tensor                 # (Q, k) int32
    cover: torch.Tensor               # (Q, k) bool
    partial: torch.Tensor             # (Q, k) bool
    exact: torch.Tensor               # (Q, NUM_AGGS) f32
    k_pred: torch.Tensor | None       # (Q, k) f32
    s_sum: torch.Tensor | None        # (Q, k) f32
    s_sumsq: torch.Tensor | None      # (Q, k) f32
    samp_min: torch.Tensor | None     # (Q, k) f32
    samp_max: torch.Tensor | None     # (Q, k) f32
    touched: torch.Tensor             # (Q,) f32 fraction of rows not skipped


def _needs_moments(kinds) -> bool:
    return any(k in ("sum", "count", "avg") for k in kinds)


def _needs_extremes(kinds) -> bool:
    return any(k in ("min", "max") for k in kinds)


def compute_artifacts(syn: Synopsis, queries: QueryBatch, kinds,
                      use_aggregates: bool = True,
                      plan_masks=None) -> Artifacts:
    """One classification + one moment pass for ``kinds``.

    ``plan_masks``: optional (cover_leaf_mask, partial_leaf_mask,
    exact_agg) triple of tensors on the synopsis's device
    (:func:`plan_to_masks`); when given, the planner's frontier replaces
    the ``query_eval`` classification and its internal-node aggregates the
    kernel's exact accumulation.
    """
    if plan_masks is not None:
        cover, partial_m, exact = plan_masks
        Q, k = queries.lo.shape[0], syn.num_leaves
        shapes = [tuple(getattr(m, "shape", ())) for m in plan_masks]
        if shapes != [(Q, k), (Q, k), (Q, NUM_AGGS)]:
            raise ValueError(f"plan masks of shapes {shapes} do not fit a "
                             f"batch of {Q} queries over {k} leaves")
        rel = torch.where(cover, REL_COVER,
                          torch.where(partial_m, REL_PARTIAL, 0)
                          ).to(torch.int32)
    else:
        rel, exact = ops.query_eval(syn.leaf_lo, syn.leaf_hi, syn.leaf_agg,
                                    queries.lo, queries.hi)
        exact = exact[:, :NUM_AGGS]
        cover = rel == REL_COVER
        partial_m = rel == REL_PARTIAL

    if not use_aggregates:
        # Classic stratified sampling (§2.2): every relevant stratum is
        # estimated from its samples and the exact shortcut is disabled.
        partial_m = cover | partial_m
        cover = torch.zeros_like(cover)
        exact = torch.zeros_like(exact)

    n_rows = syn.n_rows.to(torch.float32)[None]               # (1, k)
    total = torch.clamp(syn.total_rows.to(torch.float32), min=1.0)
    touched = (partial_m.to(torch.float32) * n_rows).sum(1) / total

    k_pred = s_sum = s_sumsq = None
    if _needs_moments(kinds):
        k_pred, s_sum, s_sumsq = ops.stratified_moments(
            syn.sample_c, syn.sample_a, syn.sample_valid,
            queries.lo, queries.hi)
    samp_min = samp_max = None
    if _needs_extremes(kinds):
        samp_min, samp_max = ops.sample_extremes(
            syn.sample_c, syn.sample_a, syn.sample_valid,
            queries.lo, queries.hi)
    return Artifacts(rel=rel, cover=cover, partial=partial_m, exact=exact,
                     k_pred=k_pred, s_sum=s_sum, s_sumsq=s_sumsq,
                     samp_min=samp_min, samp_max=samp_max, touched=touched)


def count_artifact_pass(kinds) -> None:
    """Record one execution of the artifact stage for ``kinds``."""
    OP_COUNTS["classify"] += 1
    if _needs_moments(kinds):
        OP_COUNTS["moments"] += 1
    if _needs_extremes(kinds):
        OP_COUNTS["extremes"] += 1


def resolve_synopsis(syn) -> Synopsis:
    """A plain :class:`Synopsis` as it is, or the delta-merged synopsis of
    a source that exposes ``as_synopsis()`` (a ``StreamingIngestor``)."""
    return syn.as_synopsis() if hasattr(syn, "as_synopsis") else syn


def slice_sample_slots(syn: Synopsis, slots: int | None) -> Synopsis:
    """Restrict a synopsis to the first ``slots`` sample slots per stratum
    (the refinement-ladder view). Validity is a per-stratum prefix, so the
    view is a uniform without-replacement subsample of each stratum.
    ``slots=None`` or >= the capacity returns the same object."""
    if slots is None:
        return syn
    if slots >= syn.sample_a.shape[1]:
        return syn
    return dataclasses.replace(
        syn,
        sample_c=syn.sample_c[:, :slots].contiguous(),
        sample_a=syn.sample_a[:, :slots].contiguous(),
        sample_valid=syn.sample_valid[:, :slots].contiguous(),
        k_per_leaf=torch.clamp(syn.k_per_leaf, max=slots))


def pad_rows(queries: QueryBatch, plan_masks, rows: int):
    """The batch and its optional plan masks with pad rows appended up to
    ``rows``: empty predicates, no covered or partial leaf, zero exact
    aggregates. Returns (queries, plan_masks)."""
    n, d = queries.lo.shape
    pad = rows - n
    lo = torch.cat([queries.lo, queries.lo.new_full((pad, d), PAD_LO)])
    hi = torch.cat([queries.hi, queries.hi.new_full((pad, d), PAD_HI)])
    if plan_masks is not None:
        plan_masks = tuple(torch.cat([m, m.new_zeros((pad, m.shape[1]))])
                           for m in plan_masks)
    return QueryBatch(lo, hi), plan_masks


def take_rows(results: dict, n: int) -> dict:
    """The first n rows of every field of ``{kind: QueryResult}``."""
    return {kind: QueryResult(**{
        f.name: None if getattr(r, f.name) is None else getattr(r, f.name)[:n]
        for f in dataclasses.fields(r)}) for kind, r in results.items()}


def plan_to_masks(plan, device):
    """A planner :class:`~repro_torch.engine.planner.QueryPlan` as the
    (cover, partial, exact float32) tensor triple on ``device`` that
    :func:`compute_artifacts` takes; None passes through."""
    if plan is None:
        return None
    if not isinstance(plan, QueryPlan):
        raise TypeError(f"plan must be a QueryPlan from plan_queries, got "
                        f"{type(plan).__name__}")
    return (torch.as_tensor(plan.cover_leaf_mask, device=device),
            torch.as_tensor(plan.partial_leaf_mask, device=device),
            torch.as_tensor(plan.exact_agg, device=device
                            ).to(torch.float32))


def artifacts(syn: Synopsis, queries: QueryBatch, kinds,
              use_aggregates: bool = True, backend: str | None = None,
              plan=None) -> Artifacts:
    """Eager entry: one artifact-stage execution on the synopsis's device
    (``queries`` must lie there too), counted in ``OP_COUNTS``.
    ``backend`` must be None: the tensors' device picks each kernel."""
    if backend is not None:
        raise ValueError(f"backend={backend!r}: repro_torch has no named "
                         "backends, so backend must be None")
    kinds = tuple(kinds)
    count_artifact_pass(kinds)
    syn = resolve_synopsis(syn)
    return compute_artifacts(syn, queries, kinds, use_aggregates,
                             plan_to_masks(plan, syn.device))


__all__ = ["Artifacts", "artifacts", "compute_artifacts", "resolve_synopsis",
           "slice_sample_slots", "count_artifact_pass", "plan_to_masks",
           "pad_rows", "take_rows", "PAD_LO", "PAD_HI", "MIN_ROWS",
           "OP_COUNTS", "reset_op_counts"]
