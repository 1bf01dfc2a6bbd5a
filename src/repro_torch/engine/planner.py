"""Query planner: the Minimal Coverage Frontier over internal tree nodes
(paper §3.2 Algorithm 1, batched; DESIGN.md §3).

The descent is host numpy, as in the JAX package: it walks the aggregate
tree level by level for all Q queries at once. A frontier of live (query,
node) pairs starts at the root; each level classifies every live pair
against the node boxes in one pass. Covered pairs retire into the
frontier and add the node's exact aggregates (no leaf expansion),
disjoint pairs are pruned with their subtrees, and partial internal pairs
fan out to their children. The visited nodes are exactly those of the
recursive ``core.partition_tree.mcf_reference``.

The plan's (Q, k) leaf masks and exact aggregates replace the executor's
``query_eval`` classification when passed as ``answer(plan=...)``.
:func:`relation_masks` caches the kernel classification of one (synopsis,
batch) pair for telemetry.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.types import (Synopsis, PartitionTree, QueryBatch, NUM_AGGS,
                          AGG_SUM, AGG_SUMSQ, AGG_COUNT, AGG_MIN, AGG_MAX,
                          REL_PARTIAL, REL_COVER)
from ..device import to_numpy
from ..kernels import ops


@dataclasses.dataclass
class QueryPlan:
    """The frontier descent's result for Q queries over a k-leaf tree.

    ``covered_nodes[q]`` / ``partial_leaves[q]`` are the MCF of query q:
    covered node ids (internal or leaf) and partial leaf ids.
    ``cover_leaf_mask`` / ``partial_leaf_mask`` are their (Q, k) leaf
    expansions, which the executor consumes; ``exact_agg`` (Q, NUM_AGGS)
    combines the covered nodes' summaries (SUM/SUMSQ/COUNT add, MIN/MAX
    combine). ``visited`` counts classified nodes per query;
    ``frontier_size`` = |covered| + |partial|.
    """
    covered_nodes: list[np.ndarray]
    partial_leaves: list[np.ndarray]
    cover_leaf_mask: np.ndarray      # (Q, k) bool
    partial_leaf_mask: np.ndarray    # (Q, k) bool
    exact_agg: np.ndarray            # (Q, NUM_AGGS) f64
    visited: np.ndarray              # (Q,) int64
    frontier_size: np.ndarray        # (Q,) int64
    num_leaves: int

    @property
    def num_queries(self) -> int:
        return self.cover_leaf_mask.shape[0]


def _subtree_leaf_ranges(left: np.ndarray, right: np.ndarray,
                         leaf_id: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-node [first, last] leaf slot range (inclusive), bottom-up.

    Leaves are ordered by slot in the trees ``build_tree_from_leaves``
    builds, so every subtree spans a contiguous slot range. Slot i is leaf
    id i (padded slots carry leaf_id -1 but still hold their slot).
    """
    n = left.shape[0]
    first = np.zeros(n, dtype=np.int64)
    last = np.zeros(n, dtype=np.int64)
    is_leaf = left < 0
    slots = np.cumsum(is_leaf) - 1
    first[is_leaf] = slots[is_leaf]
    last[is_leaf] = slots[is_leaf]
    for v in range(n - 1, -1, -1):
        if left[v] >= 0:
            first[v] = first[left[v]]
            last[v] = last[right[v]]
    return first, last


def plan_queries(tree: PartitionTree, q_lo, q_hi, num_leaves: int,
                 zero_variance_rule: bool = False) -> QueryPlan:
    """Batched MCF descent. ``q_lo``/``q_hi`` are (Q, d) arrays or tensors
    (any float dtype); the tree may lie on any device.

    ``zero_variance_rule``: stop descending at partial nodes whose values
    are constant (MIN == MAX, §3.4), as ``mcf_reference``'s flag; those
    nodes retire as partial.
    """
    lo = to_numpy(tree.lo).astype(np.float64)
    hi = to_numpy(tree.hi).astype(np.float64)
    agg = to_numpy(tree.agg).astype(np.float64)
    left = to_numpy(tree.left)
    right = to_numpy(tree.right)
    leaf_id = to_numpy(tree.leaf_id)
    q_lo = to_numpy(q_lo).astype(np.float64)
    q_hi = to_numpy(q_hi).astype(np.float64)
    Q = q_lo.shape[0]
    k = int(num_leaves)

    first_slot, last_slot = _subtree_leaf_ranges(left, right, leaf_id)

    cover_mask = np.zeros((Q, k), dtype=bool)
    partial_mask = np.zeros((Q, k), dtype=bool)
    exact = np.zeros((Q, NUM_AGGS), dtype=np.float64)
    exact[:, AGG_MIN] = np.inf
    exact[:, AGG_MAX] = -np.inf
    visited = np.zeros(Q, dtype=np.int64)
    covered_nodes: list[list[int]] = [[] for _ in range(Q)]
    partial_leaves: list[list[int]] = [[] for _ in range(Q)]

    qi = np.arange(Q, dtype=np.int64)          # live pair: query index
    node = np.zeros(Q, dtype=np.int64)         # live pair: node id
    while qi.size:
        visited += np.bincount(qi, minlength=Q)
        nlo, nhi = lo[node], hi[node]          # (M, d)
        ql, qh = q_lo[qi], q_hi[qi]
        nonempty = np.all(nlo <= nhi, axis=-1)
        disjoint = (np.any(qh < nlo, axis=-1) | np.any(ql > nhi, axis=-1)
                    | ~nonempty)
        cover = (np.all(ql <= nlo, axis=-1) & np.all(nhi <= qh, axis=-1)
                 & nonempty & ~disjoint)
        partial = ~cover & ~disjoint
        is_leaf = left[node] < 0
        if zero_variance_rule:
            zv = ((agg[node, AGG_MIN] == agg[node, AGG_MAX])
                  & (agg[node, AGG_COUNT] > 0))
            stop_partial = partial & (is_leaf | zv)
        else:
            stop_partial = partial & is_leaf

        for m in np.nonzero(cover)[0]:
            q, v = int(qi[m]), int(node[m])
            covered_nodes[q].append(v)
            a, b = first_slot[v], last_slot[v]
            cover_mask[q, a:min(b + 1, k)] = True
            exact[q, AGG_SUM] += agg[v, AGG_SUM]
            exact[q, AGG_SUMSQ] += agg[v, AGG_SUMSQ]
            exact[q, AGG_COUNT] += agg[v, AGG_COUNT]
            exact[q, AGG_MIN] = min(exact[q, AGG_MIN], agg[v, AGG_MIN])
            exact[q, AGG_MAX] = max(exact[q, AGG_MAX], agg[v, AGG_MAX])
        for m in np.nonzero(stop_partial)[0]:
            q, v = int(qi[m]), int(node[m])
            if leaf_id[v] >= 0:                 # a real leaf stratum
                partial_leaves[q].append(int(leaf_id[v]))
                partial_mask[q, leaf_id[v]] = True
            else:                # zv-stopped internal node: expand to leaves
                a, b = first_slot[v], last_slot[v]
                for s in range(a, min(b + 1, k)):
                    partial_leaves[q].append(s)
                    partial_mask[q, s] = True

        expand = partial & ~stop_partial
        qi_next = np.concatenate([qi[expand], qi[expand]])
        node_next = np.concatenate([left[node[expand]],
                                    right[node[expand]]]).astype(np.int64)
        qi, node = qi_next, node_next

    return QueryPlan(
        covered_nodes=[np.asarray(sorted(v), dtype=np.int64)
                       for v in covered_nodes],
        partial_leaves=[np.asarray(sorted(v), dtype=np.int64)
                        for v in partial_leaves],
        cover_leaf_mask=cover_mask, partial_leaf_mask=partial_mask,
        exact_agg=exact, visited=visited,
        frontier_size=np.asarray([len(covered_nodes[q])
                                  + len(partial_leaves[q])
                                  for q in range(Q)], dtype=np.int64),
        num_leaves=k)


# Cached leaf relation codes of recent (synopsis, batch) pairs, keyed by
# identity; the entries hold their keys, so ids are not recycled while an
# entry lives.
_REL_CACHE: list[tuple] = []
_REL_CACHE_MAX = 8


def relation_masks(syn: Synopsis, queries: QueryBatch):
    """(Q, k) int32 relation codes from ``ops.query_eval`` (the kernel on
    a CUDA synopsis), cached by (synopsis, batch) identity, so repeated
    telemetry calls on the same objects cost one classification."""
    from . import executor
    for syn_ref, q_ref, rel in _REL_CACHE:
        if syn_ref is syn and q_ref is queries:
            return rel
    executor.OP_COUNTS["classify"] += 1
    rel, _ = ops.query_eval(syn.leaf_lo, syn.leaf_hi, syn.leaf_agg,
                            queries.lo, queries.hi)
    _REL_CACHE.append((syn, queries, rel))
    if len(_REL_CACHE) > _REL_CACHE_MAX:
        _REL_CACHE.pop(0)
    return rel


def clear_relation_cache():
    _REL_CACHE.clear()


# --------------------------------------------------------------------------
# Join-aware planning: (fact stratum x dim partition) cell classification
# --------------------------------------------------------------------------

def classify_join_cells(jsyn, queries: QueryBatch):
    """Classify every (fact stratum, dim partition) cell against each join
    query (DESIGN.md §13), through two ``ops.query_eval`` calls (the
    kernel on a CUDA synopsis).

    A join query is one rectangle over ``[fact coords ‖ dim attrs]``: its
    fact columns classify the k leaves, its dim columns the P partitions.
    A cell is *covered* when both sides cover it and it holds rows (the
    pre-joined ``cell_agg`` answers it exactly), *sampled* when both sides
    overlap it, it holds rows and it is not covered (the universe sample
    estimates it), and empty otherwise.

    Returns ``(cover, sampled, rel_f, rel_d)``: cover / sampled (Q, k*P)
    bool (cell id = leaf * P + part) and the relation codes (Q, k) and
    (Q, P). The column slices of the bounds are not contiguous;
    ``ops.query_eval`` makes them so.
    """
    base, dim = jsyn.base, jsyn.dim
    d_f = jsyn.d_fact
    q_lo, q_hi = queries.lo, queries.hi
    rel_f, _ = ops.query_eval(base.leaf_lo, base.leaf_hi, base.leaf_agg,
                              q_lo[:, :d_f], q_hi[:, :d_f])
    rel_d, _ = ops.query_eval(dim.part_lo, dim.part_hi, dim.part_agg,
                              q_lo[:, d_f:], q_hi[:, d_f:])
    q = q_lo.shape[0]
    kp = jsyn.num_leaves * jsyn.num_partitions
    nonempty = (jsyn.cell_agg[:, :, AGG_COUNT] > 0).reshape(1, kp)
    cover_raw = ((rel_f == REL_COVER)[:, :, None]
                 & (rel_d == REL_COVER)[:, None, :]).reshape(q, kp)
    overlap = ((rel_f >= REL_PARTIAL)[:, :, None]
               & (rel_d >= REL_PARTIAL)[:, None, :]).reshape(q, kp)
    cover = cover_raw & nonempty
    sampled = overlap & ~cover_raw & nonempty
    return cover, sampled, rel_f, rel_d


__all__ = ["QueryPlan", "plan_queries", "relation_masks",
           "clear_relation_cache", "classify_join_cells"]
