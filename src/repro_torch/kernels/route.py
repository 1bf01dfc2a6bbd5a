"""Multi-D batch routing: the L1-nearest leaf box of every row.

Streaming ingest routes each row of a d > 1 batch to the leaf box that
contains it (distance 0) or is L1-nearest, the lowest leaf id on ties
(``streaming/ingest.py``). ``route_multid_cuda`` launches the
hand-written kernel of ``csrc/route_multid.cu`` (which replaces the
Pallas kernel ``repro/kernels/route.py::route_multid_pallas``);
``route_multid_plain`` is the JAX package's dense oracle
``route_multid_dense``: the (B, k) distance matrix and its argmin. On
finite rows the kernel is bit-equal to it: the same leaf and the same
distance. On a row with a NaN or infinite coordinate the two differ (the
kernel's fmaxf drops a NaN that ``torch.maximum`` propagates); the
kernel keeps its first version's bits there.

Both take leaf_lo/leaf_hi (k, d) and rows c (B, d), all float32, and
return (leaf (B,) int32, dist (B,) float32). Empty leaves are inverted
boxes (lo = +inf, hi = -inf) whose distance is +inf by itself.

The kernel splits the leaves across the blocks of a thread-block cluster
and merges their partial winners in group order; ``route_plan`` picks
its shape and ``route_groups`` lists the leaf ranges of the groups.
"""
from __future__ import annotations

import ctypes
import functools

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
    the first (lowest) leaf id among equal distances. The winner's distance
    plus +0.0 is the oracle's: its maximum with 0 never leaves -0.0, which
    ``torch.clamp`` keeps."""
    dist = dist_matrix(leaf_lo, leaf_hi, c)
    leaf = torch.argmin(dist, dim=1)
    return (leaf.to(torch.int32),
            torch.gather(dist, 1, leaf[:, None])[:, 0] + 0.0)


# The kernel's launch shape (csrc/route_multid.cu): blocks of
# ROUTE_THREADS threads, at most ROUTE_MAX_GROUPS of them a cluster (the
# portable cluster size), planned for the multiprocessors of an H100 SXM.
ROUTE_THREADS = 64
ROUTE_MAX_GROUPS = 8
ROUTE_SMS = 132


@functools.lru_cache(maxsize=256)
def route_plan(B: int, k: int) -> tuple[int, int, int]:
    """(rows a thread, leaf groups G, leaves a group) of a launch over B
    rows and k leaves. A tile of ROUTE_THREADS * rows is one cluster of G
    blocks: the most rows a thread (4, 2, 1) that still give at least a
    block per multiprocessor at G = ROUTE_MAX_GROUPS, then the fewest
    groups that give two blocks per multiprocessor (or the most groups)."""
    rt = 4
    while rt > 1 and -(-B // (ROUTE_THREADS * rt)) * ROUTE_MAX_GROUPS \
            < ROUTE_SMS:
        rt //= 2
    tiles = -(-B // (ROUTE_THREADS * rt))
    g = 1
    while g < ROUTE_MAX_GROUPS and tiles * g < 2 * ROUTE_SMS:
        g *= 2
    return rt, g, -(-k // g)


# The wide kernel (d > 16): blocks of ROUTE_WIDE_WARPS warps over a tile
# of 32 rows a lane, each warp an ascending sub-range of the block's
# leaves; ROUTE_WIDE_BLOCKS_SM blocks an SM fill the card.
ROUTE_WIDE_WARPS = 4
ROUTE_WIDE_BLOCKS_SM = 4


@functools.lru_cache(maxsize=256)
def route_wide_plan(B: int, k: int) -> tuple[int, int, int]:
    """(rows a lane, leaf groups G, leaves a group) of the wide kernel's
    launch: 2 rows a lane unless a block per multiprocessor at
    G = ROUTE_MAX_GROUPS then needs 1, then the fewest groups that give
    ROUTE_WIDE_BLOCKS_SM blocks per multiprocessor (or the most groups)."""
    rt = 2
    if -(-B // (32 * rt)) * ROUTE_MAX_GROUPS < ROUTE_SMS:
        rt = 1
    tiles = -(-B // (32 * rt))
    g = 1
    while (g < ROUTE_MAX_GROUPS
           and tiles * g < ROUTE_WIDE_BLOCKS_SM * ROUTE_SMS):
        g *= 2
    return rt, g, -(-k // g)


def route_launch_plan(B: int, k: int, d: int) -> tuple[int, int, int]:
    """The plan the wrapper passes: route_plan up to 16 columns,
    route_wide_plan above."""
    return route_plan(B, k) if d <= 16 else route_wide_plan(B, k)


def route_warp_ranges(k: int, groups: int, per_group: int,
                      warps: int = ROUTE_WIDE_WARPS) -> list[list[range]]:
    """The wide kernel's leaf sub-ranges, by group and warp, as it clips
    them: group g's range (route_groups) split into ``warps`` ascending
    pieces of ceil(per_group / warps) leaves, warp w the w-th, empty past
    the range's end."""
    lw = -(-per_group // warps)
    out = []
    for rg in route_groups(k, groups, per_group):
        starts = [min(rg.stop, rg.start + w * lw) for w in range(warps)]
        out.append([range(a, min(rg.stop, a + lw)) for a in starts])
    return out


def route_groups(k: int, groups: int, per_group: int) -> list[range]:
    """The leaf range of each group, as the kernel clips it to k: group g
    scans [g * per_group, (g + 1) * per_group), empty past k."""
    return [range(min(k, g * per_group), min(k, (g + 1) * per_group))
            for g in range(groups)]


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = native.library("route_multid")
        lib.repro_route_multid.argtypes = [ctypes.c_void_p] * 5 + \
            [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.repro_route_multid.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_route_limits(name, B, k, d):
    """Raise ValueError unless route_multid's kernel takes these sizes:
    sizes that fit a C int, any d (above 16 columns a wide instantiation
    takes them in blocks of 16, its registers the same at every d)."""
    if not (1 <= B < 2 ** 31 and 1 <= k < 2 ** 31 and 1 <= d < 2 ** 31):
        raise ValueError(f"{name}: needs 1 <= B, k, d < 2**31, got "
                         f"B={B} k={k} d={d}")


def route_multid_cuda(leaf_lo, leaf_hi, c):
    """Launch the CUDA kernel (one cluster launch) on the tensors' device
    and current stream."""
    name = "route_multid"
    native.check_tensors(name, leaf_lo=leaf_lo, leaf_hi=leaf_hi, c=c)
    native.check_dtype(name, torch.float32, leaf_lo=leaf_lo,
                       leaf_hi=leaf_hi, c=c)
    k, d = leaf_lo.shape
    B = c.shape[0]
    if leaf_hi.shape != (k, d) or c.shape != (B, d):
        raise ValueError(f"{name}: shapes {leaf_lo.shape} {leaf_hi.shape} "
                         f"{c.shape}")
    check_route_limits(name, B, k, d)
    rt, g, lg = route_launch_plan(B, k, d)
    leaf = torch.empty((B,), dtype=torch.int32, device=c.device)
    dist = c.new_empty((B,))
    native.launch(name, c.device, _kernel().repro_route_multid,
                  leaf_lo.data_ptr(), leaf_hi.data_ptr(), c.data_ptr(),
                  leaf.data_ptr(), dist.data_ptr(), B, k, d, rt, g, lg)
    return leaf, dist


__all__ = ["dist_matrix", "route_multid_plain", "route_multid_cuda",
           "route_plan", "route_wide_plan", "route_launch_plan",
           "route_groups", "route_warp_ranges", "check_route_limits",
           "ROUTE_THREADS", "ROUTE_MAX_GROUPS", "ROUTE_SMS",
           "ROUTE_WIDE_WARPS", "ROUTE_WIDE_BLOCKS_SM"]
