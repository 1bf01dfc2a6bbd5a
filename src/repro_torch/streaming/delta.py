"""Delta-merge serving: immutable base synopsis plus the stream delta.

The port of ``repro/streaming/delta.py``. The paper's aggregates are
mergeable summaries (§2.4): SUM/SUMSQ/COUNT add, MIN/MAX combine. The
streamed-rows delta merges into the base synopsis with O(k) elementwise
ops plus one (num_nodes, k) masked reduce that lifts the per-leaf delta
onto every tree node, all on the state's device. The subtree incidence
matrix is computed once per base on the host from the explicit child
pointers, so it serves both the complete-heap 1-D trees and the
unbalanced KD trees.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import minmax
from ..core.types import PartitionTree, Synopsis, AGG_COUNT
from ..device import to_numpy
from ..kernels.segment_reduce import NEG_BIG, POS_BIG


def subtree_leaf_matrix(tree: PartitionTree, k: int) -> torch.Tensor:
    """(num_nodes, k) bool on the tree's device: leaf j lies in the subtree
    of node v. Built on the host once per base synopsis; children are
    stored after their parent (the heap and KD trees both guarantee it),
    so one reverse sweep suffices."""
    left = to_numpy(tree.left)
    right = to_numpy(tree.right)
    leaf_id = to_numpy(tree.leaf_id)
    num_nodes = left.shape[0]
    mat = np.zeros((num_nodes, k), dtype=bool)
    for v in range(num_nodes - 1, -1, -1):
        lid = int(leaf_id[v])
        if 0 <= lid < k:
            mat[v, lid] = True
        for ch in (int(left[v]), int(right[v])):
            if ch >= 0:
                if ch <= v:
                    raise ValueError(f"tree node {ch} is stored before its "
                                     f"parent {v}")
                mat[v] |= mat[ch]
    return torch.from_numpy(mat).to(tree.lo.device)


def merge_synopsis(base: Synopsis, state, subtree: torch.Tensor, *,
                   total_rows) -> Synopsis:
    """Serving synopsis = base merged with the delta, on the device.

    The merged sample arrays are the live reservoir, so interval
    estimation (``answer(..., ci=level)``) sees the delta strata's current
    moments and sample counts. The leaf delta reaches the tree nodes
    through ``subtree @ delta`` (a plain fp32 matrix product, as the JAX
    package leaves it to XLA) and masked min/max reduces; every MIN/MAX,
    of aggregates and of boxes, follows the reference's signed-zero rule
    (:mod:`repro_torch.minmax`).
    """
    delta = state.delta_agg                                      # (k, 5)
    base_leaf = base.leaf_agg.to(torch.float32)
    leaf_agg = torch.cat(
        [base_leaf[:, 0:3] + delta[:, 0:3],
         minmax.minimum(base_leaf[:, 3:4], delta[:, 3:4]),
         minmax.maximum(base_leaf[:, 4:5], delta[:, 4:5])], 1)

    sub = subtree[:, :, None]                                    # (V, k, 1)
    d_sums = subtree.to(torch.float32) @ delta[:, 0:3]           # (V, 3)
    d_min = minmax.masked_min(delta[:, 3][None], subtree, POS_BIG, 1)
    d_max = minmax.masked_max(delta[:, 4][None], subtree, NEG_BIG, 1)
    base_tree = base.tree.agg.to(torch.float32)
    tree_agg = torch.cat(
        [base_tree[:, 0:3] + d_sums,
         minmax.minimum(base_tree[:, 3:4], d_min[:, None]),
         minmax.maximum(base_tree[:, 4:5], d_max[:, None])], 1)
    # node boxes: the union of the current leaf boxes over each subtree
    t_lo = minmax.masked_min(state.leaf_lo[None], sub, float("inf"), 1)
    t_hi = minmax.masked_max(state.leaf_hi[None], sub, float("-inf"), 1)
    return dataclasses.replace(
        base, leaf_lo=state.leaf_lo, leaf_hi=state.leaf_hi,
        leaf_agg=leaf_agg, n_rows=leaf_agg[:, AGG_COUNT],
        sample_c=state.sample_c, sample_a=state.sample_a,
        sample_valid=state.sample_valid, k_per_leaf=state.k_per_leaf,
        tree=dataclasses.replace(
            base.tree, agg=tree_agg,
            lo=minmax.minimum(base.tree.lo, t_lo),
            hi=minmax.maximum(base.tree.hi, t_hi)),
        total_rows=torch.tensor(float(total_rows), dtype=torch.float32,
                                device=delta.device))


def reservoir_moments(state) -> torch.Tensor:
    """(k, 3) f32 per-stratum live-reservoir moments [n, mean, var] over
    the valid slots: what the interval composition sees when serving the
    merged state."""
    valid = state.sample_valid.to(torch.float32)
    n = valid.sum(1)
    nn = torch.clamp(n, min=1.0)
    a = state.sample_a.to(torch.float32)
    mean = (valid * a).sum(1) / nn
    var = torch.clamp((valid * a * a).sum(1) / nn - mean ** 2, min=0.0)
    return torch.stack([n, mean, var], -1)


__all__ = ["subtree_leaf_matrix", "merge_synopsis", "reservoir_moments"]
