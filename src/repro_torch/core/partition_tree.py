"""Partition-tree construction and the reference MCF (paper §3.2).

* ``leaf_stats`` — exact per-leaf aggregates and data boxes (host f64).
* ``build_tree_from_leaves`` — the complete binary aggregate tree over
  the ordered leaves (1-D path; bottom-up aggregation §4.1).
* ``mcf_reference`` — the paper's recursive Algorithm 1 on host, the
  fidelity oracle for the batched leaf classification.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import to_numpy
from .types import (PartitionTree, NUM_AGGS, AGG_SUM, AGG_SUMSQ, AGG_COUNT,
                    AGG_MIN, AGG_MAX)


def leaf_stats(c: np.ndarray, a: np.ndarray, assign: np.ndarray, k: int
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact per-leaf aggregates and data bounding boxes.

    Returns (agg (k, NUM_AGGS) f64, lo (k, d) f64, hi (k, d) f64). Empty
    leaves get agg = [0, 0, 0, +inf, -inf] and an inverted box (lo > hi),
    which classifies as REL_NONE against every query.
    """
    c = np.asarray(c, dtype=np.float64)
    if c.ndim == 1:
        c = c[:, None]
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    assign = np.asarray(assign, dtype=np.int64)
    d = c.shape[1]
    agg = np.zeros((k, NUM_AGGS), dtype=np.float64)
    agg[:, AGG_SUM] = np.bincount(assign, weights=a, minlength=k)[:k]
    agg[:, AGG_SUMSQ] = np.bincount(assign, weights=a * a, minlength=k)[:k]
    agg[:, AGG_COUNT] = np.bincount(assign, minlength=k)[:k]
    agg[:, AGG_MIN] = np.inf
    agg[:, AGG_MAX] = -np.inf
    np.minimum.at(agg[:, AGG_MIN], assign, a)
    np.maximum.at(agg[:, AGG_MAX], assign, a)
    lo = np.full((k, d), np.inf)
    hi = np.full((k, d), -np.inf)
    for j in range(d):
        np.minimum.at(lo[:, j], assign, c[:, j])
        np.maximum.at(hi[:, j], assign, c[:, j])
    return agg, lo, hi


def combine_aggs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Mergeable-summary combine (paper §2.4)."""
    out = a.copy()
    out[..., AGG_SUM] = a[..., AGG_SUM] + b[..., AGG_SUM]
    out[..., AGG_SUMSQ] = a[..., AGG_SUMSQ] + b[..., AGG_SUMSQ]
    out[..., AGG_COUNT] = a[..., AGG_COUNT] + b[..., AGG_COUNT]
    out[..., AGG_MIN] = np.minimum(a[..., AGG_MIN], b[..., AGG_MIN])
    out[..., AGG_MAX] = np.maximum(a[..., AGG_MAX], b[..., AGG_MAX])
    return out


def build_tree_from_leaves(leaf_agg: np.ndarray, leaf_lo: np.ndarray,
                           leaf_hi: np.ndarray) -> PartitionTree:
    """Build the aggregate hierarchy bottom-up over the ordered leaves.

    Pads the leaf count to the next power of two with empty leaves; the
    tree is a complete binary heap (node v has children 2v+1, 2v+2) whose
    last K slots are the leaves, ids 0..k-1 (padded slots get -1). The
    result holds CPU tensors: float64 boxes/aggregates, int32 indices.
    """
    k = leaf_agg.shape[0]
    d = leaf_lo.shape[1]
    K = 1 << int(np.ceil(np.log2(max(k, 1)))) if k > 1 else 1
    empty_agg = np.zeros((K - k, NUM_AGGS))
    empty_agg[:, AGG_MIN] = np.inf
    empty_agg[:, AGG_MAX] = -np.inf
    num_nodes = 2 * K - 1
    agg = np.zeros((num_nodes, NUM_AGGS))
    lo = np.full((num_nodes, d), np.inf)
    hi = np.full((num_nodes, d), -np.inf)
    left = np.full(num_nodes, -1, dtype=np.int32)
    right = np.full(num_nodes, -1, dtype=np.int32)
    leaf_id = np.full(num_nodes, -1, dtype=np.int32)
    level = np.zeros(num_nodes, dtype=np.int32)

    agg[K - 1:] = np.concatenate([leaf_agg, empty_agg], axis=0)
    lo[K - 1:] = np.concatenate([leaf_lo, np.full((K - k, d), np.inf)], 0)
    hi[K - 1:] = np.concatenate([leaf_hi, np.full((K - k, d), -np.inf)], 0)
    ids = np.arange(K, dtype=np.int32)
    ids[k:] = -1
    leaf_id[K - 1:] = ids
    for v in range(K - 2, -1, -1):
        l, r = 2 * v + 1, 2 * v + 2
        left[v], right[v] = l, r
        agg[v] = combine_aggs(agg[l][None], agg[r][None])[0]
        lo[v] = np.minimum(lo[l], lo[r])
        hi[v] = np.maximum(hi[l], hi[r])
    for v in range(num_nodes):
        level[v] = int(np.floor(np.log2(v + 1)))
    return PartitionTree(*map(torch.from_numpy,
                              (lo, hi, agg, left, right, leaf_id, level)))


def _classify(node_lo, node_hi, q_lo, q_hi) -> int:
    """0 = disjoint, 1 = partial, 2 = covered by the query."""
    if np.any(node_lo > node_hi):           # empty node
        return 0
    if np.any(q_hi < node_lo) or np.any(q_lo > node_hi):
        return 0
    if np.all(q_lo <= node_lo) and np.all(node_hi <= q_hi):
        return 2
    return 1


def mcf_reference(tree: PartitionTree, q_lo, q_hi,
                  zero_variance_rule: bool = False
                  ) -> tuple[list[int], list[int], int]:
    """Recursive Minimal Coverage Frontier (paper Algorithm 1 + §3.4 rule).

    Returns (covered node ids, partial *leaf* node ids, nodes visited).
    ``zero_variance_rule`` treats MIN == MAX nodes as covered (§3.4).
    """
    lo, hi, agg = to_numpy(tree.lo), to_numpy(tree.hi), to_numpy(tree.agg)
    left, right = to_numpy(tree.left), to_numpy(tree.right)
    q_lo, q_hi = to_numpy(q_lo), to_numpy(q_hi)
    cover: list[int] = []
    partial: list[int] = []
    visited = 0

    def rec(v: int):
        nonlocal visited
        visited += 1
        rel = _classify(lo[v], hi[v], q_lo, q_hi)
        if rel == 0:
            return
        if rel == 2:
            cover.append(v)
            return
        if zero_variance_rule and agg[v, AGG_MIN] == agg[v, AGG_MAX] \
                and agg[v, AGG_COUNT] > 0:
            partial.append(v)
            return
        if left[v] < 0:
            partial.append(v)
            return
        rec(int(left[v]))
        rec(int(right[v]))

    rec(0)
    return cover, partial, visited


__all__ = ["leaf_stats", "combine_aggs", "build_tree_from_leaves",
           "mcf_reference"]
