"""Per-(query, stratum) relevant-sample moments, plain and weighted.

``stratified_moments_cuda`` launches the hand-written kernel of
``csrc/stratified_moments.cu`` (which replaces the Pallas kernel
``repro/kernels/stratified_estimate.py::stratified_moments``);
``stratified_moments_plain`` is the broadcast formulation of the JAX
package's ``backends.sample_moments``, the version CPU tensors take and
the reference the kernel is held against on the card.

Both take the synopsis's leaf-major layout: sample_c (k, s, d) float32,
sample_a (k, s) float32, sample_valid (k, s) bool, q_lo/q_hi (Q, d)
float32, and return (Q, k, 3) float32 = [#relevant samples, sum a,
sum a^2]. A sample is relevant iff valid and inside the box, bounds
inclusive.

The weighted twin, one bootstrap replicate, takes a weight per slot
w (k, s) float32 and returns [sum w, sum w*a, sum w*a^2] over the
relevant samples; an invalid slot counts as w = 0 whatever w holds.
``stratified_weighted_moments_cuda`` launches the kernel of
``csrc/weighted_moments.cu`` (which replaces the Pallas kernel
``stratified_weighted_moments``); ``weighted_moments_plain`` is
``backends.weighted_sample_moments``, its slots reduced by the
fixed-order :func:`tree_sum_last`.
"""
from __future__ import annotations

import ctypes

import torch

from . import native


def samples_inside(sample_c, sample_valid, q_lo, q_hi) -> torch.Tensor:
    """(Q, k, s) bool: valid sample inside the query box."""
    inside = ((q_lo[:, None, None, :] <= sample_c[None]).all(-1)
              & (sample_c[None] <= q_hi[:, None, None, :]).all(-1))
    return inside & sample_valid[None]


def tree_sum_last(x: torch.Tensor) -> torch.Tensor:
    """Pairwise sum over the last axis in a fixed order (``backends.py``
    ``tree_sum_last``): zero-pad to a power of two, then add contiguous
    halves until one element is left. Elementwise adds give the same bits
    whatever the leading shape, so one replicate reduced alone equals the
    same replicate reduced inside a batch (DESIGN.md §10)."""
    n = x.shape[-1]
    pow2 = 1 << max(n - 1, 0).bit_length()
    if pow2 != n:
        x = torch.nn.functional.pad(x, (0, pow2 - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def weighted_terms(inside, w, sample_a) -> torch.Tensor:
    """[sum w, sum w*a, sum w*a^2] over the last (slot) axis, stacked on a
    new last axis; ``inside`` (..., k, s) bool masks ``w`` (..., k, s)."""
    p = torch.where(inside, w, 0.0)
    pa = p * sample_a
    return torch.stack([tree_sum_last(p), tree_sum_last(pa),
                        tree_sum_last(pa * sample_a)], dim=-1)


def weighted_moments_plain(sample_c, sample_a, sample_valid, w, q_lo, q_hi):
    inside = samples_inside(sample_c, sample_valid, q_lo, q_hi)
    return weighted_terms(inside, w.to(torch.float32)[None],
                          sample_a.to(torch.float32)[None])


def stratified_moments_plain(sample_c, sample_a, sample_valid, q_lo, q_hi):
    pred = samples_inside(sample_c, sample_valid, q_lo, q_hi
                          ).to(torch.float32)
    a = sample_a.to(torch.float32)[None]
    return torch.stack([pred.sum(-1), (pred * a).sum(-1),
                        (pred * a * a).sum(-1)], dim=-1)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = native.library("stratified_moments")
        lib.repro_stratified_moments.argtypes = [ctypes.c_void_p] * 6 + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.repro_stratified_moments.restype = ctypes.c_int
        _lib = lib
    return _lib.repro_stratified_moments


def stratified_moments_cuda(sample_c, sample_a, sample_valid, q_lo, q_hi):
    """Launch the CUDA kernel on the tensors' device and current stream."""
    name = "stratified_moments"
    native.check_tensors(name, sample_c=sample_c, sample_a=sample_a,
                         sample_valid=sample_valid, q_lo=q_lo, q_hi=q_hi)
    native.check_dtype(name, torch.float32, sample_c=sample_c,
                       sample_a=sample_a, q_lo=q_lo, q_hi=q_hi)
    native.check_dtype(name, torch.bool, sample_valid=sample_valid)
    k, s, d = sample_c.shape
    Q = q_lo.shape[0]
    if (sample_a.shape != (k, s) or sample_valid.shape != (k, s)
            or q_lo.shape != (Q, d) or q_hi.shape != (Q, d)):
        raise ValueError(f"{name}: shapes {sample_c.shape} {sample_a.shape} "
                         f"{sample_valid.shape} {q_lo.shape} {q_hi.shape}")
    # Grid: one block per (leaf, tile of 128 queries); the query tiles run
    # along gridDim.y, which holds at most 65535.
    if not (1 <= Q <= 65535 * 128 and 1 <= k < 2 ** 31 and 1 <= d <= 16):
        raise ValueError(f"{name}: needs 1 <= Q <= {65535 * 128}, k >= 1 "
                         f"and 1 <= d <= 16, got Q={Q} k={k} d={d}")
    dev = sample_c.device
    out = torch.empty((Q, k, 3), dtype=torch.float32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        err = fn(sample_c.data_ptr(), sample_a.data_ptr(),
                 sample_valid.data_ptr(), q_lo.data_ptr(), q_hi.data_ptr(),
                 out.data_ptr(), Q, k, s, d,
                 torch.cuda.current_stream(dev).cuda_stream)
    native.check_launch(name, err)
    return out


_wlib = None


def weighted_library():
    global _wlib
    if _wlib is None:
        lib = native.library("weighted_moments")
        lib.repro_stratified_weighted_moments.argtypes = \
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.repro_stratified_weighted_moments.restype = ctypes.c_int
        lib.repro_bootstrap_moments.argtypes = [ctypes.c_void_p] * 7 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.repro_bootstrap_moments.restype = ctypes.c_int
        _wlib = lib
    return _wlib


def check_weighted_args(name, sample_c, sample_a, sample_valid, w, q_lo,
                        q_hi):
    """Device, dtype, contiguity and shape checks of the weighted kernels;
    ``w`` is (k, s) or (R, k, s). Returns (Q, k, s, d)."""
    native.check_tensors(name, sample_c=sample_c, sample_a=sample_a,
                         sample_valid=sample_valid, w=w, q_lo=q_lo,
                         q_hi=q_hi)
    native.check_dtype(name, torch.float32, sample_c=sample_c,
                       sample_a=sample_a, w=w, q_lo=q_lo, q_hi=q_hi)
    native.check_dtype(name, torch.bool, sample_valid=sample_valid)
    k, s, d = sample_c.shape
    Q = q_lo.shape[0]
    if (sample_a.shape != (k, s) or sample_valid.shape != (k, s)
            or w.shape[-2:] != (k, s) or q_lo.shape != (Q, d)
            or q_hi.shape != (Q, d)):
        raise ValueError(f"{name}: shapes {sample_c.shape} {sample_a.shape} "
                         f"{sample_valid.shape} {w.shape} {q_lo.shape} "
                         f"{q_hi.shape}")
    if not (1 <= Q <= 65535 * 128 and 1 <= k < 2 ** 31 and 1 <= d <= 16):
        raise ValueError(f"{name}: needs 1 <= Q <= {65535 * 128}, k >= 1 "
                         f"and 1 <= d <= 16, got Q={Q} k={k} d={d}")
    return Q, k, s, d


def stratified_weighted_moments_cuda(sample_c, sample_a, sample_valid, w,
                                     q_lo, q_hi):
    """Launch the weighted CUDA kernel (one weight row w (k, s)) on the
    tensors' device and current stream."""
    name = "stratified_weighted_moments"
    if w.dim() != 2:
        raise ValueError(f"{name}: w must be (k, s), got {tuple(w.shape)}")
    Q, k, s, d = check_weighted_args(name, sample_c, sample_a, sample_valid,
                                     w, q_lo, q_hi)
    dev = sample_c.device
    out = torch.empty((Q, k, 3), dtype=torch.float32, device=dev)
    fn = weighted_library().repro_stratified_weighted_moments
    with torch.cuda.device(dev):
        err = fn(sample_c.data_ptr(), sample_a.data_ptr(),
                 sample_valid.data_ptr(), w.data_ptr(), q_lo.data_ptr(),
                 q_hi.data_ptr(), out.data_ptr(), Q, k, s, d,
                 torch.cuda.current_stream(dev).cuda_stream)
    native.check_launch(name, err)
    return out


__all__ = ["samples_inside", "tree_sum_last", "weighted_terms",
           "stratified_moments_plain", "stratified_moments_cuda",
           "weighted_moments_plain", "stratified_weighted_moments_cuda",
           "check_weighted_args", "weighted_library"]
