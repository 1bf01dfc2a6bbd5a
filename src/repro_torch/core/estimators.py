"""Compatibility shim over the layered query engine (``repro_torch.engine``).

The engine splits the PASS estimators into plan / execute / assemble
layers; this module keeps the original public surface: ``estimate``
answers one kind through ``PassEngine`` (a loop over kinds costs one
artifact pass per kind; ``PassEngine(syn, serving=ServingConfig(
kinds=...))`` shares one), ``classify_leaves`` / ``sample_moments``
re-export the plain PyTorch semantics of the kernels, and ``ess`` /
``skip_rate`` share one cached classification per (synopsis, batch) pair
(``engine.planner.relation_masks``: the ``query_eval`` kernel on a CUDA
synopsis).
"""
from __future__ import annotations

import torch

from .. import minmax
from ..kernels.query_eval import classify_leaves
from ..kernels.stratified_estimate import sample_moments
from .types import Synopsis, QueryBatch, QueryResult, REL_PARTIAL


def estimate(syn: Synopsis, queries: QueryBatch, kind: str = "sum",
             lam: float | None = None, use_fpc: bool | None = None,
             zero_var_rule: bool | None = None,
             use_aggregates: bool | None = None,
             avg_mode: str | None = None, device=None) -> QueryResult:
    """Deprecated shim: answer one aggregate kind from the synopsis.

    ``use_aggregates=False`` disables the exact-cover shortcut and the
    deterministic bounds: every relevant stratum is estimated from its
    samples. This turns the engine into classic stratified sampling
    (§2.2), used by the ST/US baselines, and into uniform sampling (§2.1)
    when the synopsis has a single stratum. ``avg_mode``: 'ratio'
    (default, estimated SUM over estimated COUNT) or 'stratum' (the
    paper's literal whole-stratum weighting).

    Use ``repro_torch.api.PassEngine(syn,
    serving=ServingConfig(kinds=(kind,))).answer(queries)[kind]`` instead;
    unset kwargs inherit the ``ServingConfig`` defaults. ``device=None``
    serves on the CUDA card.
    """
    from .. import api
    from ..api.config import merge_overrides
    api.warn_once(
        "repro_torch.core.estimators.estimate",
        "repro_torch.api.PassEngine(source, "
        "serving=ServingConfig(kinds=(kind,))).answer(queries)[kind]")
    serving = merge_overrides(
        api.ServingConfig(kinds=(kind,)),
        lam=lam, use_fpc=use_fpc, zero_var_rule=zero_var_rule,
        use_aggregates=use_aggregates, avg_mode=avg_mode)
    return api.PassEngine(syn, serving=serving,
                          device=device).answer(queries)[kind]


def _partial_mask(syn: Synopsis, queries: QueryBatch) -> torch.Tensor:
    from ..engine import planner
    rel = planner.relation_masks(syn, queries)
    return (rel == REL_PARTIAL).to(torch.float32)


def ess(syn: Synopsis, queries: QueryBatch) -> torch.Tensor:
    """Effective-sampling-size numerator: samples processed per query
    (paper §5.1.4) = sum of stratum sample counts over partial leaves.
    (Q,) float32 on the synopsis's device."""
    partf = _partial_mask(syn, queries)
    return torch.sum(partf * syn.k_per_leaf.to(torch.float32)[None], dim=1)


def skip_rate(syn: Synopsis, queries: QueryBatch) -> torch.Tensor:
    """Fraction of tuples safely skipped (paper §5.1.2). Shares one cached
    classification with ``ess`` for the same (synopsis, batch) objects."""
    partf = _partial_mask(syn, queries)
    total = syn.total_rows.to(torch.float32)
    total = minmax.maximum(total, torch.ones_like(total))
    return 1.0 - torch.sum(partf * syn.n_rows.to(torch.float32)[None],
                           dim=1) / total


__all__ = ["classify_leaves", "sample_moments", "estimate", "ess",
           "skip_rate"]
