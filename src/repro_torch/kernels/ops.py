"""The port's kernel op surface, dispatched by the device of the tensors.

In place of the JAX package's named backend registry (``pallas | jnp |
ref``), the tensors decide: CUDA tensors launch the hand-written kernel
(or raise), CPU tensors run the plain PyTorch version. No environment
variable or config routes CUDA tensors to the plain version.

The flat-sample ops (``stratified_moments_flat``, ``weighted_moments_flat``,
the reference's ``stratified_moments_op`` / ``weighted_moments_op``) take
(S, d) samples with leaf ids in any order and lay them into the slot
layout the kernels read.
"""
from __future__ import annotations

import torch

from .bootstrap import bootstrap_moments_cuda, bootstrap_moments_plain
from .join_epilogue import join_epilogue_cuda, join_epilogue_plain
from .join_moments import join_cell_moments_cuda, join_cell_moments_plain
from .native import device_type
from .query_eval import query_eval_cuda, query_eval_plain
from .route import route_multid_cuda, route_multid_plain
from .sample_extremes import sample_extremes_cuda, sample_extremes_plain
from .segment_reduce import (segment_reduce_cuda, segment_reduce_plain,
                             weighted_segment_reduce_cuda,
                             weighted_segment_reduce_plain)
from .stratified_estimate import (stratified_moments_cuda,
                                  stratified_moments_plain,
                                  stratified_weighted_moments_cuda,
                                  tree_sum_last, weighted_moments_plain)


def query_eval(leaf_lo, leaf_hi, leaf_agg, q_lo, q_hi):
    """Classify leaves vs queries and accumulate exact covered aggregates.
    leaf_lo/leaf_hi (k, d), leaf_agg (k, A), q_lo/q_hi (Q, d).
    Returns (rel (Q, k) int32, exact (Q, A) f32)."""
    args = [t.contiguous() for t in (leaf_lo, leaf_hi, leaf_agg, q_lo, q_hi)]
    if device_type("query_eval", *args) == "cuda":
        return query_eval_cuda(*args)
    return query_eval_plain(*args)


def stratified_moments(sample_c, sample_a, sample_valid, q_lo, q_hi):
    """Per-(query, stratum) relevant-sample moments over the synopsis-shaped
    (k, s, .) sample arrays. Returns (k_pred, s_sum, s_sumsq), each (Q, k)."""
    args = [t.contiguous()
            for t in (sample_c, sample_a, sample_valid, q_lo, q_hi)]
    if device_type("stratified_moments", *args) == "cuda":
        out = stratified_moments_cuda(*args)
    else:
        out = stratified_moments_plain(*args)
    return out.unbind(-1)


def weighted_moments(sample_c, sample_a, sample_valid, weights, q_lo,
                     q_hi):
    """Per-(query, stratum) weighted relevant-sample moments for one
    resample-weight row ``weights`` (k, s); invalid slots count as weight
    0. Returns (Q, k, 3) = [sum w, sum w*a, sum w*a^2]."""
    args = [t.contiguous() for t in
            (sample_c, sample_a, sample_valid, weights, q_lo, q_hi)]
    if device_type("weighted_moments", *args) == "cuda":
        return stratified_weighted_moments_cuda(*args)
    return weighted_moments_plain(*args)


def bootstrap_moments(sample_c, sample_a, sample_valid, weights, q_lo,
                      q_hi):
    """:func:`weighted_moments` for R weight rows ``weights`` (R, k, s) in
    one pass. Returns (R, Q, k, 3); replicate r is bit-equal to
    ``weighted_moments`` with ``weights[r]`` on the same device."""
    args = [t.contiguous() for t in
            (sample_c, sample_a, sample_valid, weights, q_lo, q_hi)]
    if device_type("bootstrap_moments", *args) == "cuda":
        return bootstrap_moments_cuda(*args)
    return bootstrap_moments_plain(*args)


def flat_slots(sample_c, sample_a, sample_leaf, k: int, weights=None):
    """Lay flat samples into the synopsis's (k, s_max) slot layout.

    sample_c (S, d), sample_a (S,) and, when given, weights (S,) go to the
    slots of their stratum sample_leaf (S,) in input order (a stable sort
    on the leaf id); ids outside [0, k) (-1 pads) are dropped. s_max is
    the largest stratum's sample count (at least 1; one host readback of
    the (k,) counts). Returns (sample_c (k, s_max, d), sample_a,
    sample_valid, weights or None), zeros on unused slots.
    """
    d = sample_c.shape[1]
    dev = sample_c.device
    leaf = sample_leaf.to(torch.int64)
    ids = torch.where((leaf >= 0) & (leaf < k), leaf, k)
    counts = torch.bincount(ids, minlength=k + 1)[:k]
    counts_host = counts.cpu()
    s_max = max(int(counts_host.max()) if k else 0, 1)
    n_keep = int(counts_host.sum())
    order = torch.sort(ids, stable=True).indices[:n_keep]
    ids_kept = ids[order]
    starts = torch.cumsum(counts, 0) - counts
    slot = ids_kept * s_max + (torch.arange(n_keep, device=dev)
                               - starts[ids_kept])

    def lay(x, *trail):
        out = x.new_zeros((k * s_max, *trail))
        out[slot] = x[order]
        return out.reshape(k, s_max, *trail)

    valid = torch.zeros(k * s_max, dtype=torch.bool, device=dev)
    valid[slot] = True
    w = None if weights is None else lay(weights.to(torch.float32))
    return (lay(sample_c.to(torch.float32), d),
            lay(sample_a.to(torch.float32)), valid.reshape(k, s_max), w)


def stratified_moments_flat(sample_c, sample_a, sample_leaf, q_lo, q_hi,
                            k: int):
    """Flat-sample moments, the counterpart of the JAX package's
    ``stratified_moments_op``: sample_c (S, d), sample_a (S,), sample_leaf
    (S,) int ids (-1 = pad) in any order; q_lo/q_hi (Q, d). The samples
    are laid into the (k, s_max) slot layout (:func:`flat_slots`), then a
    CUDA tensor launches ``stratified_moments``' kernel and a CPU tensor
    runs its plain version. Returns (Q, k, 3) = [count, sum a, sum a^2]."""
    c, a, valid, _ = flat_slots(sample_c, sample_a, sample_leaf, k)
    return torch.stack(stratified_moments(c, a, valid, q_lo, q_hi), dim=-1)


def weighted_moments_flat(sample_c, sample_a, sample_leaf, weights, q_lo,
                          q_hi, k: int):
    """Flat-sample weighted moments (one bootstrap resample pass), the
    counterpart of ``weighted_moments_op``: as
    :func:`stratified_moments_flat` with a weight (S,) per sample (pads
    carry weight 0); a CUDA tensor launches
    ``stratified_weighted_moments``' kernel. Returns (Q, k, 3) =
    [sum w, sum w*a, sum w*a^2] over the relevant samples."""
    c, a, valid, w = flat_slots(sample_c, sample_a, sample_leaf, k, weights)
    return weighted_moments(c, a, valid, w, q_lo, q_hi)


def sample_extremes(sample_c, sample_a, sample_valid, q_lo, q_hi):
    """Per-(query, stratum) MIN/MAX over relevant samples; irrelevant
    strata read +BIG / -BIG. Returns (samp_min, samp_max), each (Q, k).
    The reference has no Pallas kernel for it (one jnp broadcast); CUDA
    tensors launch the hand-written kernel of ``csrc/sample_extremes.cu``,
    CPU tensors run that broadcast (``sample_extremes_plain``)."""
    args = [t.contiguous()
            for t in (sample_c, sample_a, sample_valid, q_lo, q_hi)]
    if device_type("sample_extremes", *args) == "cuda":
        return sample_extremes_cuda(*args)
    return sample_extremes_plain(*args)


def segment_reduce(values, seg_ids, k: int):
    """Per-segment [sum, sumsq, count, min, max] of values (N,) f32 by
    seg_ids (N,) int32; ids outside [0, k) are dropped. Returns (k, 5)."""
    args = [t.contiguous() for t in (values, seg_ids)]
    if device_type("segment_reduce", *args) == "cuda":
        return segment_reduce_cuda(*args, k)
    return segment_reduce_plain(*args, k)


def weighted_segment_reduce(values, weights, seg_ids, k: int):
    """Per-segment [sum w*v, sum w*v^2, sum w] of values (N,) f32 with
    weights (N,) f32 by seg_ids (N,) int32; ids outside [0, k) are dropped.
    Returns (k, 3)."""
    args = [t.contiguous() for t in (values, weights, seg_ids)]
    if device_type("weighted_segment_reduce", *args) == "cuda":
        return weighted_segment_reduce_cuda(*args, k)
    return weighted_segment_reduce_plain(*args, k)


def route_multid(leaf_lo, leaf_hi, c):
    """L1-nearest leaf box of each row, lowest id on ties. leaf_lo/leaf_hi
    (k, d), c (B, d). Returns (leaf (B,) int32, dist (B,) f32)."""
    args = [t.contiguous() for t in (leaf_lo, leaf_hi, c)]
    if device_type("route_multid", *args) == "cuda":
        return route_multid_cuda(*args)
    return route_multid_plain(*args)


def join_cell_moments(slots, q_lo, q_hi, cover, sampled, cell_agg,
                      total_rows, p_u: float):
    """The per-(query, cell) statistics of an fk-join answer from the
    universe sample's :class:`~repro_torch.kernels.join_moments.JoinSlots`
    (Q, D) query bounds, (Q, k*P) cover / sampled masks, (k*P, 5) cell
    aggregates and the 0-d row count. Returns a ``JoinMoments``. The
    reference has no Pallas kernel for it (plain jnp); CUDA tensors launch
    the hand-written kernels of ``csrc/join_moments.cu``, CPU tensors run
    that jnp formulation (``join_cell_moments_plain``)."""
    args = [t.contiguous() for t in (q_lo, q_hi, cover, sampled, cell_agg)]
    if device_type("join_cell_moments", slots.s_a, total_rows,
                   *args) == "cuda":
        return join_cell_moments_cuda(slots, *args, total_rows, p_u)
    return join_cell_moments_plain(slots, *args, total_rows, p_u)


def join_epilogue(jsyn, jart, kinds, *, lam: float, level: float | None,
                  small_n_threshold: int, delta_budget: str):
    """Every requested kind's QueryResult of an fk-join batch from the
    join synopsis and the batch's ``JoinArtifacts`` (row 9's planes,
    ``sampled``, ``exact3``, ``touched``): estimate, half-width, hard
    bounds and, with a ``level``, the clipped interval. The reference has
    no Pallas kernel for it (plain jnp); CUDA tensors launch the
    hand-written kernel of ``csrc/join_epilogue.cu`` once for all kinds,
    CPU tensors run the port's composition (``join_epilogue_plain``)."""
    kw = dict(lam=lam, level=level, small_n_threshold=small_n_threshold,
              delta_budget=delta_budget)
    if device_type("join_epilogue", jart.sampled, jart.exact3,
                   jsyn.cell_agg, jsyn.u_overflow) == "cuda":
        return join_epilogue_cuda(jsyn, jart, kinds, **kw)
    return join_epilogue_plain(jsyn, jart, kinds, **kw)


__all__ = ["query_eval", "stratified_moments", "weighted_moments",
           "flat_slots", "stratified_moments_flat", "weighted_moments_flat",
           "bootstrap_moments", "sample_extremes", "segment_reduce",
           "weighted_segment_reduce", "route_multid", "join_cell_moments",
           "join_epilogue", "tree_sum_last"]
