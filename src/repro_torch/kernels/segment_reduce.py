"""Per-segment aggregate reduction: [sum v, sum v^2, count, min, max].

``segment_reduce_cuda`` launches the hand-written kernel of
``csrc/segment_reduce.cu`` (which replaces the Pallas kernel
``repro/kernels/segment_reduce.py::segment_reduce``);
``segment_reduce_plain`` is the scatter formulation of the JAX package's
``JnpBackend.segment_reduce`` (``backends.py``), the version CPU tensors
take and the reference the kernel is held against on the card.

Both take values (N,) float32 and seg_ids (N,) int32 and return (k, 5)
float32. Ids outside [0, k) (-1 marks a dropped row) are skipped; an
empty segment reads [0, 0, 0, POS_BIG, NEG_BIG]. Any N and k are taken
as they are, with no padding to a block size.

The weighted twin ``weighted_segment_reduce_{cuda,plain}`` (the Pallas
kernel ``weighted_segment_reduce``; ``JnpBackend.weighted_segment_reduce``)
takes a weight (N,) float32 per row as well and returns (k, 3) =
[sum w*v, sum w*v^2, sum w]; an empty segment reads [0, 0, 0].
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import minmax
from . import native

# kernels/ref.py POS_BIG / NEG_BIG: the MIN/MAX identity of a segment.
POS_BIG = 3.0e38
NEG_BIG = -3.0e38


def segment_reduce_plain(values, seg_ids, k: int) -> torch.Tensor:
    """Scatter formulation: out-of-range ids drop into a spill slot k that
    is sliced away. MIN/MAX follow the reference's signed-zero rule
    (:mod:`repro_torch.minmax`)."""
    v = values.to(torch.float32)
    ids = torch.where((seg_ids >= 0) & (seg_ids < k), seg_ids.long(), k)
    dev = v.device
    sums = torch.zeros((k + 1, 3), dtype=torch.float32, device=dev)
    sums.index_add_(0, ids, torch.stack([v, v * v, torch.ones_like(v)], 1))
    vmin = torch.full((k + 1,), POS_BIG, dtype=torch.float32, device=dev)
    vmax = torch.full((k + 1,), NEG_BIG, dtype=torch.float32, device=dev)
    minmax.scatter_min_(vmin, ids, v)
    minmax.scatter_max_(vmax, ids, v)
    return torch.cat([sums, vmin[:, None], vmax[:, None]], 1)[:k]


def weighted_segment_reduce_plain(values, weights, seg_ids, k: int
                                  ) -> torch.Tensor:
    """Scatter formulation with the same spill slot as
    :func:`segment_reduce_plain`."""
    v = values.to(torch.float32)
    w = weights.to(torch.float32)
    ids = torch.where((seg_ids >= 0) & (seg_ids < k), seg_ids.long(), k)
    wv = w * v
    sums = torch.zeros((k + 1, 3), dtype=torch.float32, device=v.device)
    sums.index_add_(0, ids, torch.stack([wv, wv * v, w], 1))
    return sums[:k]


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = native.library("segment_reduce")
        lib.repro_segment_reduce.argtypes = [ctypes.c_void_p] * 3 + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.repro_segment_reduce.restype = ctypes.c_int
        lib.repro_weighted_segment_reduce.argtypes = \
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.repro_weighted_segment_reduce.restype = ctypes.c_int
        _lib = lib
    return _lib


# The kernel's chunk rule (csrc/segment_reduce.cu
# repro_segment_reduce_chunk): chunks of at least SEG_MIN_ROWS rows, at most
# SEG_MAX_CHUNKS of them. It depends on N alone, and so does the kernel's
# summation order beside k.
SEG_MIN_ROWS = 256
SEG_MAX_CHUNKS = 264


@functools.lru_cache(maxsize=256)
def segment_plan(n: int) -> tuple[int, int]:
    """(rows per chunk, chunks) of a launch over n rows: the chunk is
    max(SEG_MIN_ROWS, ceil(n / SEG_MAX_CHUNKS)) rows, as the CUDA source
    rules."""
    ch = max(SEG_MIN_ROWS, -(-n // SEG_MAX_CHUNKS))
    return ch, -(-n // ch)


def segment_reduce_cuda(values, seg_ids, k: int) -> torch.Tensor:
    """Launch the CUDA kernel (one cooperative launch) on the tensors'
    device and current stream. The result is the first k rows of the
    launch's one buffer, whose other rows hold the chunks' partials."""
    name = "segment_reduce"
    native.check_tensors(name, values=values, seg_ids=seg_ids)
    native.check_dtype(name, torch.float32, values=values)
    native.check_dtype(name, torch.int32, seg_ids=seg_ids)
    n = values.shape[0]
    if values.dim() != 1 or seg_ids.shape != (n,):
        raise ValueError(f"{name}: shapes {values.shape} {seg_ids.shape}")
    if not (1 <= k < 2 ** 31 and n < 2 ** 31):
        raise ValueError(f"{name}: needs 1 <= k and N < 2**31, got "
                         f"k={k} N={n}")
    ch, chunks = segment_plan(n)
    buf = values.new_empty(((chunks + 1) * k, 5))
    native.launch(name, values.device, _kernel().repro_segment_reduce,
                  values.data_ptr(), seg_ids.data_ptr(), buf.data_ptr(), n,
                  k, ch)
    return buf[:k]


# The weighted kernel's launch plan (csrc/segment_reduce.cu): one block
# per chunk, at most WSEG_MAX_CHUNKS of them, of rows_per_chunk rows (a
# multiple of 32, at least WSEG_MIN_ROWS). It depends on N alone, and so
# does the kernel's summation order beside k.
WSEG_MAX_CHUNKS = 64
WSEG_MIN_ROWS = 256


@functools.lru_cache(maxsize=64)
def weighted_segment_plan(n: int, k: int) -> tuple[int, int, int]:
    """(chunks, rows per chunk, rows of the one (rows, 3) float32 buffer) of
    a weighted launch over n rows and k segments. The buffer holds out
    (k, 3), then the chunks' partials (chunks, k, 3), then their id ranges
    (chunks, 2) int32."""
    ch = max(WSEG_MIN_ROWS, -(-n // WSEG_MAX_CHUNKS))
    ch = -(-ch // 32) * 32
    chunks = max(1, -(-n // ch))
    return chunks, ch, k + chunks * k + -(-2 * chunks // 3)


def weighted_segment_reduce_cuda(values, weights, seg_ids, k: int
                                 ) -> torch.Tensor:
    """Launch the weighted CUDA kernel (one launch) on the tensors' device
    and current stream. The result is the first k rows of the launch's one
    buffer."""
    name = "weighted_segment_reduce"
    dev = values.device
    if weights.device != dev or seg_ids.device != dev:
        raise ValueError(f"{name}: tensors on several devices {dev}, "
                         f"{weights.device}, {seg_ids.device}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors")
    if values.dtype != torch.float32 or weights.dtype != torch.float32 \
            or seg_ids.dtype != torch.int32:
        raise TypeError(f"{name}: needs float32 values and weights and "
                        f"int32 seg_ids, got {values.dtype} {weights.dtype} "
                        f"{seg_ids.dtype}")
    n = values.shape[0]
    if values.dim() != 1 or weights.shape != (n,) or seg_ids.shape != (n,):
        raise ValueError(f"{name}: shapes {values.shape} {weights.shape} "
                         f"{seg_ids.shape}")
    if not (values.is_contiguous() and weights.is_contiguous()
            and seg_ids.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if not (1 <= k < 2 ** 31 and n < 2 ** 31):
        raise ValueError(f"{name}: needs 1 <= k and N < 2**31, got "
                         f"k={k} N={n}")
    chunks, ch, rows = weighted_segment_plan(n, k)
    buf = values.new_empty((rows, 3))
    native.launch(name, dev, _kernel().repro_weighted_segment_reduce,
                  values.data_ptr(), weights.data_ptr(), seg_ids.data_ptr(),
                  buf.data_ptr(), n, k, chunks, ch)
    return buf[:k]


__all__ = ["segment_reduce_plain", "segment_reduce_cuda", "segment_plan",
           "weighted_segment_reduce_plain", "weighted_segment_reduce_cuda",
           "weighted_segment_plan", "SEG_MAX_CHUNKS", "SEG_MIN_ROWS",
           "WSEG_MAX_CHUNKS", "WSEG_MIN_ROWS", "POS_BIG", "NEG_BIG"]
