"""Approximate fk-joins (DESIGN.md §13); the port of ``repro/joins``.

Universe-sampled join synopses (:func:`build_join_synopsis`) and the
join-aware cell planner and executor behind
``api.PassEngine.answer_join``.
"""
from .universe import key_uniforms, universe_mask
from .dim import DimTable, build_dim_table, dim_lookup
from .synopsis import (JoinSynopsis, build_join_synopsis, join_queries,
                       resolve_join_synopsis, JOIN_KINDS)
from .executor import (JoinArtifacts, compute_join_artifacts,
                       universe_group_ids, join_slots)
from .assemble import assemble_join, join_cell_bounds

__all__ = [
    "key_uniforms", "universe_mask",
    "DimTable", "build_dim_table", "dim_lookup",
    "JoinSynopsis", "build_join_synopsis", "join_queries",
    "resolve_join_synopsis", "JOIN_KINDS",
    "JoinArtifacts", "compute_join_artifacts", "universe_group_ids",
    "join_slots", "assemble_join", "join_cell_bounds",
]
