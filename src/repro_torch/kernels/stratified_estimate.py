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
``stratified_weighted_moments_cuda`` launches the kernels of
``csrc/weighted_moments.cu`` with one weight row (they replace the Pallas
kernel ``stratified_weighted_moments``), at any slot count: above
``WEIGHTED_CHUNK`` slots a stratum the launch cuts each stratum into
chunks and folds their partials in chunk order; ``weighted_moments_plain``
is ``backends.weighted_sample_moments``, its slots reduced by the
fixed-order :func:`tree_sum_last`.
"""
from __future__ import annotations

import ctypes
import functools

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


def sample_moments(sample_c, sample_a, sample_valid, q_lo, q_hi):
    """(k_pred, s_sum, s_sumsq), each (Q, k): the plain version's three
    planes, the JAX package's ``backends.sample_moments``."""
    return stratified_moments_plain(sample_c, sample_a, sample_valid, q_lo,
                                    q_hi).unbind(-1)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = native.library("stratified_moments")
        lib.repro_stratified_moments.argtypes = [ctypes.c_void_p] * 7 + \
            [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.repro_stratified_moments.restype = ctypes.c_int
        _lib = lib
    return _lib.repro_stratified_moments


# Rows 2 and 8's order contract (csrc/pair_tiles.cuh SLOT_CHUNK): up to
# PAIR_CHUNK slots a stratum a pair's reduction runs over its slots in slot
# order; above it each chunk of PAIR_CHUNK consecutive slots is reduced on
# its own and the chunks' partials are folded in chunk order, in one
# cooperative launch that keeps them in a scratch buffer.
PAIR_CHUNK = 2048


def pair_scratch_floats(Q, k, s, d, stats) -> int:
    """Floats of the chunked launch's scratch (csrc/pair_tiles.cuh
    make_chunk_plan) for a reduction of ``stats`` floats: the walks'
    partials (chunks, Q, k, stats), then per (leaf, chunk) the box (2d),
    the partial and the NaN flag; 0 for s <= PAIR_CHUNK (one pass)."""
    if s <= PAIR_CHUNK:
        return 0
    n_ch = -(-s // PAIR_CHUNK)
    return n_ch * Q * k * stats + k * n_ch * (2 * d + stats + 1)


def pair_launch(name, fn, sample_c, sample_a, sample_valid, q_lo, q_hi,
                out, stats) -> None:
    """Launch row 2's or row 8's C entry ``fn`` into ``out``, with the
    chunked launch's scratch (allocated here, one float32 buffer; none for
    s <= PAIR_CHUNK)."""
    k, s, d = sample_c.shape
    Q = q_lo.shape[0]
    n = pair_scratch_floats(Q, k, s, d, stats)
    scratch = (torch.empty(n, dtype=torch.float32, device=out.device)
               if n else None)
    native.launch(name, out.device, fn, sample_c.data_ptr(),
                  sample_a.data_ptr(), sample_valid.data_ptr(),
                  q_lo.data_ptr(), q_hi.data_ptr(), out.data_ptr(),
                  scratch.data_ptr() if n else None, n, Q, k, s, d)


# Limits of stratified_moments' launch (csrc/stratified_moments.cu): its
# one-pass blocks (s <= PAIR_CHUNK), (tile of 16 leaves, group of 128-query
# tiles) pairs along gridDim.x, which holds 2**31 - 1, are at most as many
# as the (query tile, leaf tile) pairs; above PAIR_CHUNK the cooperative
# grid is at most the resident blocks, whatever the sizes (its scratch
# grows with ceil(s / PAIR_CHUNK) * Q * k); sizes are C ints; any s; any
# d (above 16 columns the wide kernels take them in blocks of 16, with the
# same shared memory and registers at every d).
MOMENTS_QT, MOMENTS_LT = 128, 16


def check_moments_limits(name, Q, k, s, d):
    """Raise ValueError unless stratified_moments' kernel takes these
    sizes."""
    if not (1 <= Q < 2 ** 31 and 1 <= k < 2 ** 31 and 0 <= s < 2 ** 31
            and 1 <= d < 2 ** 31
            and -(-Q // MOMENTS_QT) * -(-k // MOMENTS_LT) < 2 ** 31):
        raise ValueError(
            f"{name}: needs 1 <= Q, k, d < 2**31, 0 <= s < 2**31 and "
            f"ceil(Q / {MOMENTS_QT}) * ceil(k / {MOMENTS_LT}) < 2**31, "
            f"got Q={Q} k={k} s={s} d={d}")


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
    check_moments_limits(name, Q, k, s, d)
    out = torch.empty((Q, k, 3), dtype=torch.float32,
                      device=sample_c.device)
    pair_launch(name, _kernel(), sample_c, sample_a, sample_valid, q_lo,
                q_hi, out, 3)
    return out


_wlib = None


def weighted_library():
    global _wlib
    if _wlib is None:
        lib = native.library("weighted_moments")
        lib.repro_stratified_weighted_moments.argtypes = \
            [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.repro_stratified_weighted_moments.restype = ctypes.c_int
        lib.repro_bootstrap_moments.argtypes = [ctypes.c_void_p] * 8 + \
            [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.repro_bootstrap_moments.restype = ctypes.c_int
        lib.repro_weighted_plan.argtypes = [ctypes.c_int] * 4 + \
            [ctypes.POINTER(ctypes.c_int)] * 2
        lib.repro_weighted_plan.restype = ctypes.c_int
        lib.repro_weighted_scratch.argtypes = [ctypes.c_int] * 5
        lib.repro_weighted_scratch.restype = ctypes.c_longlong
        lib.repro_weighted_pair_r.restype = ctypes.c_int
        lib.repro_weighted_stage.restype = ctypes.c_int
        _wlib = lib
    return _wlib


# Rows 3 and 4's order contract (csrc/weighted_moments.cu CHUNK), rows 2
# and 8's chunk: up to WEIGHTED_CHUNK slots a stratum a pair's moments are
# one slot-order fold; above it each chunk of WEIGHTED_CHUNK consecutive
# slots gives a partial, folded in chunk order from chunk 0's.
WEIGHTED_CHUNK = PAIR_CHUNK
# The launch's constants that its plan and scratch follow: queries a tile,
# the most segments a tile, replicates a batch of the tile loop, predicate
# columns taken whole (above _WMAX_D the wide kernels take them in blocks of
# _WMAX_D), the tile kernel's shared-memory cap, and the totals kernel's
# segment tiles of 128 and the direct walk's replicate tiles of 16 along
# gridDim.y (at most 65535).
_WQT, _WLT_MAX, _WRB_MAX, _WMAX_D, _WMAX_SMEM = 32, 32, 8, 16, 232448
WEIGHTED_MAX_K = 65535 * 128
WEIGHTED_MAX_R = 65535 * 16
# The walks of the mixed pairs: a segment's pairs of one tile are staged
# when they are _WSTAGE or more, walked directly (one thread a (pair,
# replicate)) below; the staged walk's lanes take pairs up to R =
# WEIGHTED_PAIR_R (row 3's R = 1), replicates above, in units of _WRB =
# 128 replicates, its blocks of _WWALK_T threads staging _WSUB slots at a
# time.
WEIGHTED_PAIR_R, _WSTAGE, _WRB, _WSUB, _WWALK_T = 8, 8, 128, 64, 256
# Above _WMAX_D columns (make_wide_plan): the test kernel's runs of _WTQ
# queries and staged blocks of _WTB columns, and the group walk: groups of
# up to _WGROUP segments; a lane a replicate, units of _WGRB, while a
# group's weights ([slot][_WGRB + 1]) fit _WREPS_STAGE bytes and its mask
# words a warp's lanes; else a lane a query, a unit a replicate, the
# group's terms (16 bytes a slot) within _WQRY_STAGE bytes.
_WGROUP, _WGRB, _WREPS_STAGE, _WQRY_STAGE = 8, 32, 81920, 98304
_WTQ, _WTB = 512, 32


def weighted_walk(R, s, d=1) -> str:
    """How the launch at R replicates, s slots a stratum and d columns
    walks its mixed pairs. Up to _WMAX_D columns, a tile's segments with
    _WSTAGE or more mixed pairs: "direct" (one thread a (pair, replicate),
    as the rest: up to R = WEIGHTED_PAIR_R and one chunk), "pairs" (staged,
    a lane a pair, a warp a (segment, replicate)) or "replicates" (staged,
    a lane 4 replicates, a warp up to 4 pairs, 128 replicates a block).
    Above, every pair: "group replicates" or "group queries"
    (weighted_group)."""
    if d > _WMAX_D:
        return "group " + weighted_group(R, s)[0]
    if R > WEIGHTED_PAIR_R:
        return "replicates"
    return "pairs" if s > WEIGHTED_CHUNK else "direct"


def weighted_group(R, s) -> tuple:
    """(lane layout, segments a group) of the group walk at d > _WMAX_D
    (csrc/weighted_moments.cu make_wide_plan): "replicates" (a lane a
    replicate, units of _WGRB) when R > WEIGHTED_PAIR_R and some group of
    1-8 segments fits, else "queries" (a lane a query, a unit a
    replicate)."""
    ls = max(min(s, WEIGHTED_CHUNK), 1)
    nw = -(-min(s, WEIGHTED_CHUNK) // 32)
    gs = _WGROUP
    while gs > 0 and (gs * ls * (_WGRB + 1) * 4 > _WREPS_STAGE
                      or gs * nw > 32):
        gs //= 2
    if R > WEIGHTED_PAIR_R and gs > 0:
        return "replicates", gs
    gs = _WGROUP
    while gs > 1 and gs * ls * 16 > _WQRY_STAGE:
        gs //= 2
    return "queries", gs


def weighted_chunks(s) -> int:
    """Slot chunks a stratum: the segments of each leaf in the launch."""
    return max(1, -(-s // WEIGHTED_CHUNK))


@functools.lru_cache(maxsize=256)
def weighted_plan(Q, k, s, d):
    """(segments per tile, dynamic shared-memory bytes) of a weighted
    launch, as csrc/weighted_moments.cu make_plan chooses them: the tile's
    (query, slot) mask of ceil(min(s, WEIGHTED_CHUNK) / 32) words per
    (query, segment) has to fit, so the segments a tile halve from 32.
    Above _WMAX_D columns (make_wide_plan) 32 segments a tile and no
    dynamic shared memory."""
    def a16(x):
        return (x + 15) & ~15
    if d > _WMAX_D:
        return _WLT_MAX, 0
    nw = -(-min(s, WEIGHTED_CHUNK) // 32)
    sl = 32
    while sl > 8 and sl * 32 * d * 4 > 2048:
        sl //= 2
    lt = _WLT_MAX
    while lt >= 1:
        off = a16(2 * _WRB_MAX * lt * 12)
        off = a16(off + 8 * lt * d)
        off = a16(off + 8 * min(sl, lt) * 32 * d)
        off = a16(off + 4 * nw * lt * _WQT)
        off = a16(off + _WQT * lt)
        off = a16(off + 4 * (3 * _WLT_MAX + 1))
        if off <= _WMAX_SMEM:
            return lt, off
        lt //= 2
    raise ValueError(f"weighted kernels: no launch plan for Q={Q} k={k} "
                     f"s={s} d={d}")


# Limits of the weighted kernels' launch (csrc/weighted_moments.cu): the
# replicates loop inside each tile block, but the direct walk puts
# replicate tiles of 16 along gridDim.y, which holds 65535, as does the
# totals kernel its tiles of 128 segments (a stratum's slot chunks, k *
# weighted_chunks(s) of them); the tiles of 32 queries x LT segments
# (LT >= 1) run along gridDim.x, which holds 2**31 - 1; the staged walk's
# units count in 64 bits; sizes are C ints; any d.
def check_weighted_limits(name, Q, k, s, d, R=1):
    """Raise ValueError unless the weighted kernels take these sizes."""
    K = k * weighted_chunks(s) if s >= 0 else 0
    if not (1 <= Q < 2 ** 31 and 1 <= k and 0 <= s < 2 ** 31
            and 1 <= K <= WEIGHTED_MAX_K
            and -(-Q // _WQT) * K <= 2 ** 31 - 1
            and 1 <= d < 2 ** 31 and 1 <= R <= WEIGHTED_MAX_R):
        raise ValueError(
            f"{name}: needs Q >= 1, k >= 1, 0 <= s < 2**31, "
            f"k * ceil(s / {WEIGHTED_CHUNK}) <= {WEIGHTED_MAX_K}, "
            f"ceil(Q / {_WQT}) * k * ceil(s / {WEIGHTED_CHUNK}) < 2**31, "
            f"1 <= d < 2**31 and 1 <= R <= {WEIGHTED_MAX_R}, got Q={Q} "
            f"k={k} s={s} d={d} R={R}")


@functools.lru_cache(maxsize=256)
def weighted_scratch_floats(R, Q, k, s, d) -> int:
    """Floats of the weighted kernels' scratch (make_plan's layout): per
    (replicate, segment) totals (R, K, 3), K = k * weighted_chunks(s)
    segments; each segment's box around its valid samples (K, 2, d), its
    valid bits (K, ceil(min(s, WEIGHTED_CHUNK) / 32)) and NaN flag (K,);
    per tile of 32 queries x LT segments its directly walked pairs' count;
    from a multiple of 4 floats the staged walk's two counters (4 floats),
    its items (2 ints a (tile, segment)) and per tile a list of mixed pairs
    with their slot masks; above one chunk the (R, Q, K, 3) partials, from
    a multiple of 4 floats. Above _WMAX_D columns (make_wide_plan): after
    the NaN flags each segment's NaN columns (ceil(d / 32) words), from a
    multiple of 4 floats the walk's counter (4 floats), each (segment,
    query)'s class (a byte) and (segment, word, query)'s slot mask, from a
    multiple of 2 floats each (segment, query)'s cut word (8 bytes), then
    the partials as below."""
    n_ch = weighted_chunks(s)
    K = k * n_ch
    nw = -(-min(s, WEIGHTED_CHUNK) // 32)
    if d > _WMAX_D:
        ctr = -(-(R * K * 3 + K * 2 * d + K * nw + K + K * -(-d // 32))
                // 4) * 4
        mask = ctr + 4 + -(-(K * Q) // 4)
        end = -(-(mask + K * nw * Q) // 2) * 2 + 2 * K * Q
        return -(-end // 4) * 4 + R * Q * K * 3 if n_ch > 1 else end
    lt, _ = weighted_plan(Q, k, s, d)
    n_tiles = -(-Q // _WQT) * -(-K // lt)
    head = -(-(R * K * 3 + K * 2 * d + K * nw + K + n_tiles) // 4) * 4
    floats = (head + 4 + 2 * n_tiles * lt
              + n_tiles * _WQT * lt * (1 + nw))
    # The partials start 16-byte aligned (the tiles' 4-float stores).
    return -(-floats // 4) * 4 + R * Q * K * 3 if n_ch > 1 else floats


def weighted_scratch(R, Q, k, s, d, device) -> torch.Tensor:
    """The weighted kernels' scratch, one float32 buffer of
    :func:`weighted_scratch_floats`."""
    return torch.empty(weighted_scratch_floats(R, Q, k, s, d),
                       dtype=torch.float32, device=device)


def check_weighted_args(name, sample_c, sample_a, sample_valid, w, q_lo,
                        q_hi):
    """Device, dtype, contiguity, shape and size checks of the weighted
    kernels; ``w`` is (k, s) or (R, k, s). Returns (Q, k, s, d)."""
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
    check_weighted_limits(name, Q, k, s, d, w.shape[0] if w.dim() == 3 else 1)
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
    scratch = weighted_scratch(1, Q, k, s, d, dev)
    native.launch(name, dev, weighted_library().repro_stratified_weighted_moments,
                  sample_c.data_ptr(), sample_a.data_ptr(),
                  sample_valid.data_ptr(), w.data_ptr(), q_lo.data_ptr(),
                  q_hi.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                  scratch.numel(), Q, k, s, d)
    return out


__all__ = ["samples_inside", "tree_sum_last", "weighted_terms",
           "stratified_moments_plain", "sample_moments", "stratified_moments_cuda",
           "weighted_moments_plain", "stratified_weighted_moments_cuda",
           "check_moments_limits", "MOMENTS_QT", "MOMENTS_LT", "PAIR_CHUNK",
           "pair_scratch_floats", "pair_launch",
           "check_weighted_args", "check_weighted_limits", "weighted_plan",
           "weighted_scratch", "weighted_scratch_floats", "weighted_chunks",
           "weighted_library", "weighted_walk", "weighted_group",
           "WEIGHTED_CHUNK",
           "WEIGHTED_MAX_K", "WEIGHTED_MAX_R", "WEIGHTED_PAIR_R"]
