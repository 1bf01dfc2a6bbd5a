"""Multi-D batch routing: the L1-nearest leaf box of every row.

Streaming ingest routes each row of a d > 1 batch to the leaf box that
contains it (distance 0) or is L1-nearest, the lowest leaf id on ties
(``streaming/ingest.py``). ``route_multid_cuda`` launches the
hand-written kernel of ``csrc/route_multid.cu`` (which replaces the
Pallas kernel ``repro/kernels/route.py::route_multid_pallas``);
``route_multid_plain`` is the JAX package's dense oracle
``route_multid_dense``: the (B, k) distance matrix and its argmin. The
kernel is bit-equal to it: the same leaf and the same distance.

Both take leaf_lo/leaf_hi (k, d) and rows c (B, d), all float32, and
return (leaf (B,) int32, dist (B,) float32). Empty leaves are inverted
boxes (lo = +inf, hi = -inf) whose distance is +inf by itself.
"""
from __future__ import annotations

import ctypes

import torch

from . import native


def dist_matrix(lo, hi, c) -> torch.Tensor:
    """(B, k) L1 box distance, ``max(lo - c, c - hi, 0)`` per dimension
    accumulated in dimension order (``route.py`` ``dist_matrix``)."""
    dist = None
    for j in range(c.shape[1]):
        cj = c[:, j][:, None]
        dj = torch.clamp(torch.maximum(lo[:, j][None] - cj,
                                       cj - hi[:, j][None]), min=0.0)
        dist = dj if dist is None else dist + dj
    return dist


def route_multid_plain(leaf_lo, leaf_hi, c):
    """Dense oracle: argmin over the (B, k) distance matrix, which takes
    the first (lowest) leaf id among equal distances."""
    dist = dist_matrix(leaf_lo, leaf_hi, c)
    leaf = torch.argmin(dist, dim=1)
    return (leaf.to(torch.int32),
            torch.gather(dist, 1, leaf[:, None])[:, 0])


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = native.library("route_multid")
        lib.repro_route_multid.argtypes = [ctypes.c_void_p] * 5 + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.repro_route_multid.restype = ctypes.c_int
        _lib = lib
    return _lib.repro_route_multid


def route_multid_cuda(leaf_lo, leaf_hi, c):
    """Launch the CUDA kernel on the tensors' device and current stream."""
    name = "route_multid"
    native.check_tensors(name, leaf_lo=leaf_lo, leaf_hi=leaf_hi, c=c)
    native.check_dtype(name, torch.float32, leaf_lo=leaf_lo,
                       leaf_hi=leaf_hi, c=c)
    k, d = leaf_lo.shape
    B = c.shape[0]
    if leaf_hi.shape != (k, d) or c.shape != (B, d):
        raise ValueError(f"{name}: shapes {leaf_lo.shape} {leaf_hi.shape} "
                         f"{c.shape}")
    if not (1 <= B < 2 ** 31 and 1 <= k < 2 ** 31 and 1 <= d <= 16):
        raise ValueError(f"{name}: needs B, k >= 1 and 1 <= d <= 16, got "
                         f"B={B} k={k} d={d}")
    dev = c.device
    leaf = torch.empty((B,), dtype=torch.int32, device=dev)
    dist = torch.empty((B,), dtype=torch.float32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        err = fn(leaf_lo.data_ptr(), leaf_hi.data_ptr(), c.data_ptr(),
                 leaf.data_ptr(), dist.data_ptr(), B, k, d,
                 torch.cuda.current_stream(dev).cuda_stream)
    native.check_launch(name, err)
    return leaf, dist


__all__ = ["dist_matrix", "route_multid_plain", "route_multid_cuda"]
