"""Leaf classification + exact covered-aggregate accumulation.

``query_eval_cuda`` launches the hand-written kernel of
``csrc/query_eval.cu`` (which replaces the Pallas kernel
``repro/kernels/query_eval.py::query_eval``); ``query_eval_plain`` is the
broadcast formulation of the JAX package's ``JnpBackend``
(``classify_leaves`` + ``cover @ leaf_agg``), the version CPU tensors take
and the reference the kernel is held against on the card.

Both take leaf_lo/leaf_hi (k, d), leaf_agg (k, A), q_lo/q_hi (Q, d), all
float32, and return (rel (Q, k) int32, exact (Q, A) float32). The MIN/MAX
columns of ``exact`` are not meaningful (the plain version's product makes
them NaN where an empty leaf's +-inf meets a zero; the kernel skips
uncovered leaves) and the executor never reads them.
"""
from __future__ import annotations

import ctypes

import torch

from . import native

REL_NONE, REL_PARTIAL, REL_COVER = 0, 1, 2


def classify_leaves(leaf_lo, leaf_hi, q_lo, q_hi) -> torch.Tensor:
    """(k, d) boxes vs (Q, d) rectangles -> (Q, k) int32 relation codes."""
    nonempty = (leaf_lo <= leaf_hi).all(-1)                   # (k,)
    ql = q_lo[:, None, :]                                     # (Q, 1, d)
    qh = q_hi[:, None, :]
    disjoint = ((qh < leaf_lo[None]).any(-1) | (ql > leaf_hi[None]).any(-1)
                | ~nonempty[None])
    cover = ((ql <= leaf_lo[None]).all(-1) & (leaf_hi[None] <= qh).all(-1)
             & nonempty[None])
    return torch.where(cover, REL_COVER,
                       torch.where(disjoint, REL_NONE, REL_PARTIAL)
                       ).to(torch.int32)


def query_eval_plain(leaf_lo, leaf_hi, leaf_agg, q_lo, q_hi):
    rel = classify_leaves(leaf_lo, leaf_hi, q_lo, q_hi)
    cover = (rel == REL_COVER).to(torch.float32)
    return rel, cover @ leaf_agg.to(torch.float32)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = native.library("query_eval")
        lib.repro_query_eval.argtypes = [ctypes.c_void_p] * 7 + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.repro_query_eval.restype = ctypes.c_int
        _lib = lib
    return _lib.repro_query_eval


# The kernel's launch (csrc/query_eval.cu): blocks of QE_THREADS threads,
# each owning up to QE_MAX_QUERIES whole query rows (one warp lists each
# row's covered leaves) and walking the leaves in tiles of QE_LEAF_TILE;
# A up to 8 and any d < 2**31 (a C int): above 16 columns a wide
# instantiation stages them QE_WIDE_COLS at a time and compares a pair only
# on the columns where its query does not hold the leaf tile's box, its
# registers and shared memory the same at every d.
QE_THREADS = 256
QE_LEAF_TILE = 1024
QE_MAX_QUERIES = 8
QE_WIDE_COLS = 8


def check_query_eval_limits(name, Q, k, d, A):
    """Raise ValueError unless query_eval's kernel takes these sizes:
    sizes that fit a C int, A up to 8 aggregate columns, any d."""
    if not (1 <= Q < 2 ** 31 and 1 <= k < 2 ** 31 and 1 <= d < 2 ** 31
            and 1 <= A <= 8):
        raise ValueError(f"{name}: needs 1 <= Q, k, d < 2**31 and "
                         f"1 <= A <= 8, got Q={Q} k={k} d={d} A={A}")


def query_eval_cuda(leaf_lo, leaf_hi, leaf_agg, q_lo, q_hi):
    """Launch the CUDA kernel on the tensors' device and current stream.
    rel and exact are allocated apart: two allocations cost the host less
    than the slice and dtype views of one buffer."""
    name = "query_eval"
    native.check_tensors(name, leaf_lo=leaf_lo, leaf_hi=leaf_hi,
                         leaf_agg=leaf_agg, q_lo=q_lo, q_hi=q_hi)
    native.check_dtype(name, torch.float32, leaf_lo=leaf_lo, leaf_hi=leaf_hi,
                       leaf_agg=leaf_agg, q_lo=q_lo, q_hi=q_hi)
    k, d = leaf_lo.shape
    Q, A = q_lo.shape[0], leaf_agg.shape[1]
    if (leaf_hi.shape != (k, d) or leaf_agg.shape != (k, A)
            or q_lo.shape != (Q, d) or q_hi.shape != (Q, d)):
        raise ValueError(f"{name}: shapes {leaf_lo.shape} {leaf_hi.shape} "
                         f"{leaf_agg.shape} {q_lo.shape} {q_hi.shape}")
    check_query_eval_limits(name, Q, k, d, A)
    rel = torch.empty((Q, k), dtype=torch.int32, device=q_lo.device)
    exact = torch.empty((Q, A), dtype=torch.float32, device=q_lo.device)
    native.launch(name, q_lo.device, _kernel(), leaf_lo.data_ptr(),
                  leaf_hi.data_ptr(), leaf_agg.data_ptr(), q_lo.data_ptr(),
                  q_hi.data_ptr(), rel.data_ptr(), exact.data_ptr(), Q, k, d,
                  A)
    return rel, exact


__all__ = ["classify_leaves", "query_eval_plain", "query_eval_cuda",
           "REL_NONE", "REL_PARTIAL", "REL_COVER", "QE_THREADS",
           "QE_LEAF_TILE", "QE_MAX_QUERIES", "QE_WIDE_COLS",
           "check_query_eval_limits"]
