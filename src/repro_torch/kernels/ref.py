"""Plain PyTorch oracles in the TPU kernels' calling convention.

Torch copies of the JAX package's ``kernels/ref.py``: the shapes follow the
Pallas kernels' calling convention exactly, including the transposed
(d_pad, .) coordinate layouts chosen there for TPU lane alignment, and the
``NEG_BIG`` / ``POS_BIG`` sentinels of empty segments. They are
correctness references for tests and are never on the serving path: the
port's kernels take the synopsis's own layouts (``kernels/ops.py``), and
each keeps its plain version beside it. MIN/MAX go through
:mod:`repro_torch.minmax`, so the bits are the reference's.
"""
from __future__ import annotations

import torch

from .. import minmax

NEG_BIG = -3.0e38
POS_BIG = 3.0e38


def _onehot(ids: torch.Tensor, k: int) -> torch.Tensor:
    """(N, k) float32: 1 where ids == column; -1 and out-of-range ids give
    an all-zero row."""
    return (ids[:, None] == torch.arange(k, dtype=torch.int32,
                                         device=ids.device)[None]
            ).to(torch.float32)


def segment_reduce_ref(values: torch.Tensor, seg_ids: torch.Tensor, k: int
                       ) -> torch.Tensor:
    """Per-segment [sum, sumsq, count, min, max].

    values (N,) f32; seg_ids (N,) int32 in [0, k) or -1 for padding rows.
    Returns (k, 5) f32; empty segments get [0, 0, 0, +BIG, -BIG].
    """
    onehot = _onehot(seg_ids, k)
    s = onehot.T @ values
    ssq = onehot.T @ (values * values)
    cnt = onehot.sum(0)
    member = onehot > 0
    vmin = minmax.masked_min(values[:, None], member, POS_BIG, 0)
    vmax = minmax.masked_max(values[:, None], member, NEG_BIG, 0)
    return torch.stack([s, ssq, cnt, vmin, vmax], dim=-1)


def weighted_segment_reduce_ref(values: torch.Tensor, weights: torch.Tensor,
                                seg_ids: torch.Tensor, k: int
                                ) -> torch.Tensor:
    """Per-segment weighted sums [sum w*v, sum w*v^2, sum w].

    values/weights (N,) f32; seg_ids (N,) int32 in [0, k) or -1 for padding
    (padding rows must carry weight 0). Returns (k, 3) f32.
    """
    onehot = _onehot(seg_ids, k)
    wv = weights * values
    return torch.stack([onehot.T @ wv, onehot.T @ (wv * values),
                        onehot.T @ weights], dim=-1)


def _pred(c_t, leaf, qlo_t, qhi_t, d) -> torch.Tensor:
    """(Q, S) bool: sample inside the query box on the first d coordinate
    rows, and not padding."""
    S, Q = leaf.shape[0], qlo_t.shape[1]
    pred = torch.ones((Q, S), dtype=torch.bool, device=leaf.device)
    for j in range(d):
        cj = c_t[j][None, :]
        pred = pred & (qlo_t[j][:, None] <= cj) & (cj <= qhi_t[j][:, None])
    return pred & (leaf >= 0)[None, :]


def _moments(predf, a, leaf, k) -> torch.Tensor:
    onehot = _onehot(leaf, k)                       # (S, k)
    return torch.stack([predf @ onehot, (predf * a[None]) @ onehot,
                        (predf * (a * a)[None]) @ onehot], dim=-1)


def stratified_moments_ref(c_t: torch.Tensor, a: torch.Tensor,
                           leaf: torch.Tensor, qlo_t: torch.Tensor,
                           qhi_t: torch.Tensor, k: int, d: int
                           ) -> torch.Tensor:
    """Per-(query, stratum) relevant-sample moments [k_pred, sum, sumsq].

    c_t (d_pad, S) transposed sample coords; a (S,) values; leaf (S,) int32
    stratum id (-1 = padding); qlo_t/qhi_t (d_pad, Q). Only the first ``d``
    coordinate rows participate. Returns (Q, k, 3) f32.
    """
    predf = _pred(c_t, leaf, qlo_t, qhi_t, d).to(torch.float32)
    return _moments(predf, a, leaf, k)


def stratified_weighted_moments_ref(c_t: torch.Tensor, a: torch.Tensor,
                                    leaf: torch.Tensor, w: torch.Tensor,
                                    qlo_t: torch.Tensor, qhi_t: torch.Tensor,
                                    k: int, d: int) -> torch.Tensor:
    """Weighted variant of :func:`stratified_moments_ref`: each sample's
    predicate contribution is scaled by ``w`` (S,) f32 (bootstrap resample
    weights; padding samples must carry ``w == 0``). Returns (Q, k, 3)
    [sum w*pred, sum w*pred*a, sum w*pred*a^2]."""
    predf = _pred(c_t, leaf, qlo_t, qhi_t, d).to(torch.float32) * w[None, :]
    return _moments(predf, a, leaf, k)


def query_eval_ref(leaf_lo_t: torch.Tensor, leaf_hi_t: torch.Tensor,
                   leaf_agg: torch.Tensor, qlo_t: torch.Tensor,
                   qhi_t: torch.Tensor, d: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Leaf classification + exact covered-aggregate accumulation.

    leaf_lo_t/leaf_hi_t (d_pad, k) transposed leaf boxes; leaf_agg (k, 8)
    padded aggregates [sum, sumsq, count, min, max, n_rows, 0, 0];
    qlo_t/qhi_t (d_pad, Q). Returns:
      rel     (Q, k) int32: 0 none / 1 partial / 2 cover,
      exact   (Q, 8) f32:  sum over covered leaves of leaf_agg.
    """
    Q, k = qlo_t.shape[1], leaf_lo_t.shape[1]
    dev = leaf_lo_t.device
    nonempty = torch.ones((k,), dtype=torch.bool, device=dev)
    cover = torch.ones((Q, k), dtype=torch.bool, device=dev)
    disjoint = torch.zeros((Q, k), dtype=torch.bool, device=dev)
    for j in range(d):
        lo = leaf_lo_t[j][None, :]
        hi = leaf_hi_t[j][None, :]
        nonempty = nonempty & (leaf_lo_t[j] <= leaf_hi_t[j])
        cover = cover & (qlo_t[j][:, None] <= lo) & (hi <= qhi_t[j][:, None])
        disjoint = (disjoint | (qhi_t[j][:, None] < lo)
                    | (qlo_t[j][:, None] > hi))
    disjoint = disjoint | ~nonempty[None]
    cover = cover & nonempty[None]
    rel = torch.where(cover, 2, torch.where(disjoint, 0, 1)).to(torch.int32)
    exact = cover.to(torch.float32) @ leaf_agg
    return rel, exact


__all__ = ["segment_reduce_ref", "weighted_segment_reduce_ref",
           "stratified_moments_ref", "stratified_weighted_moments_ref",
           "query_eval_ref", "NEG_BIG", "POS_BIG"]
