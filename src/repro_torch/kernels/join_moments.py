"""The per-(query, cell) statistics of an fk-join answer (row 9).

``join_cell_moments_cuda`` launches the hand-written kernels of
``csrc/join_moments.cu``. The JAX package has no Pallas kernel for this
stage: its join executor computes it in plain jnp
(``repro/joins/executor.py`` ``compute_join_artifacts``, lines 108-171),
materializing (Q, G) predicates and group totals over the G = k * su
universe slots. ``join_cell_moments_plain`` is that formulation in torch
(``index_add_`` and ``scatter_reduce_``, which run in index order on the
CPU), evaluated in query chunks so that its memory stays bounded: the
version CPU tensors take and the reference the kernel is held against on
the card.

The kernel sorts every (query, cell) pair into three classes
(:func:`join_cell_classes`, its rule in torch): empty pairs write +0.0,
covered ones copy the cell's totals walked once with every slot inside,
and only mixed ones walk; each gives the walk's bits. Above ``JM_MAX_D``
columns a mixed pair's walk tests only the columns that can clear a slot's
bit (:func:`cell_nan_columns` and the cell's box say which).

A cell is a (fact leaf, dim partition) pair, id ``leaf * P + part``. Both
versions take a :class:`JoinSlots` (built once per synopsis epoch by
:func:`join_slots`, plain torch) and return a :class:`JoinMoments`: the
eight (Q, k*P) float32 planes ``s_cell``, ``c_cell``, ``v_s``, ``v_c``,
``cov_sc``, ``n_grp``, ``r_s``, ``r_c``, ``exact3`` (Q, 3) = ``cover @
cell_agg[:, :3]`` and ``touched`` (Q,) = ``sampled @ cell_agg[:, COUNT] /
max(total_rows, 1)``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import native

INT32_MAX = 2 ** 31 - 1
# The planes of the kernel's one output buffer, in order.
PLANES = ("s_cell", "c_cell", "v_s", "v_c", "cov_sc", "n_grp", "r_s", "r_c")


@dataclasses.dataclass
class JoinSlots:
    """The universe sample in the two layouts of row 9.

    The reference's (the plain version): ``coords`` (G, D) f32 the slots'
    ``[u_c ‖ u_dattr]`` in slot order, ``a`` (G,) f32, ``flat_gid`` (G,)
    int64 each slot's (leaf, key) group id (-1 on an invalid slot) and
    ``g_cell`` (G,) int64 each group's cell (k*P for a group without a dim
    partition or without rows), :func:`universe_group_ids`.

    The kernel's: each leaf's valid slots with a dim partition, stably
    sorted by (partition, key), so the slots of a group keep their slot
    order and a cell's groups come in ascending key order (the orders of
    the reference's scatters): ``s_coord`` (k, su, D), ``s_a`` (k, su),
    ``s_last`` (k, su) bool (the slot ends its key group: the next slot's
    key differs, or none follows in the leaf's runs); ``cell_start`` (k,
    P + 1) int32, cell (leaf,
    p) being the run ``[cell_start[leaf, p], cell_start[leaf, p + 1])`` of
    its leaf; ``cell_box`` (k*P, 2, D) f32, the box of the run's
    coordinates with NaN left out, unbounded where a slot of the run has a
    non-finite ``a`` (whose product with a zero predicate is NaN).
    """
    coords: torch.Tensor
    a: torch.Tensor
    flat_gid: torch.Tensor
    g_cell: torch.Tensor
    s_coord: torch.Tensor
    s_a: torch.Tensor
    s_last: torch.Tensor
    cell_start: torch.Tensor
    cell_box: torch.Tensor
    num_leaves: int
    capacity: int
    num_partitions: int
    d: int


@dataclasses.dataclass
class JoinMoments:
    """The statistics of :mod:`join_moments` (module doc); every plane is
    (Q, k*P) float32."""
    s_cell: torch.Tensor
    c_cell: torch.Tensor
    v_s: torch.Tensor
    v_c: torch.Tensor
    cov_sc: torch.Tensor
    n_grp: torch.Tensor
    r_s: torch.Tensor
    r_c: torch.Tensor
    exact3: torch.Tensor
    touched: torch.Tensor


def universe_group_ids(u_key, u_part, u_valid, num_partitions: int):
    """Per-slot (leaf, key) group ids, the reference's derivation
    (``executor.py`` ``universe_group_ids``): keys sorted within each leaf
    (stable, invalid slots as INT32_MAX), group starts flagged and summed,
    offset by ``leaf * su``. Returns (flat_gid (k*su,) int64, -1 on invalid
    slots; g_cell (k*su,) int64, group id -> cell id, k*P for a group
    whose key has no dim partition or that holds no slot)."""
    k, su = u_key.shape
    p = num_partitions
    g = k * su
    dev = u_key.device
    keys_eff = torch.where(u_valid, u_key.to(torch.int64), INT32_MAX)
    order = torch.argsort(keys_eff, dim=1, stable=True)
    ks = torch.gather(keys_eff, 1, order)
    newg = torch.ones((k, su), dtype=torch.int64, device=dev)
    newg[:, 1:] = (ks[:, 1:] != ks[:, :-1]).to(torch.int64)
    gid = torch.empty_like(newg).scatter_(1, order, torch.cumsum(newg, 1) - 1)
    base = (torch.arange(k, dtype=torch.int64, device=dev) * su)[:, None]
    flat_gid = torch.where(u_valid, base + gid, -1).reshape(-1)
    # A group's slots share its key, hence its partition: the writes of
    # one group carry equal values. Invalid slots write to the extra slot g.
    safe = torch.where(flat_gid >= 0, flat_gid, g)
    g_part = torch.full((g + 1,), -1, dtype=torch.int64, device=dev)
    g_part[safe] = u_part.reshape(-1).to(torch.int64)
    g_part = g_part[:g]
    g_leaf = torch.arange(g, dtype=torch.int64, device=dev) // su
    g_cell = torch.where(g_part >= 0, g_leaf * p + g_part, k * p)
    return flat_gid, g_cell


def join_slots(u_c, u_dattr, u_a, u_key, u_part, u_valid,
               num_partitions: int) -> JoinSlots:
    """Both layouts of the universe sample (:class:`JoinSlots`), on the
    buffers' device, by plain torch."""
    k, su = u_a.shape
    p = num_partitions
    dev = u_a.device
    coords = torch.cat([u_c.to(torch.float32), u_dattr.to(torch.float32)],
                       -1).contiguous()
    d = coords.shape[-1]
    a = u_a.to(torch.float32).contiguous()
    flat_gid, g_cell = universe_group_ids(u_key, u_part, u_valid, p)

    part = u_part.to(torch.int64)
    live = u_valid & (part >= 0)
    # (partition, key) as one int64, the key offset to sort as unsigned;
    # the rest after every partition.
    skey = torch.where(live, part * 2 ** 32 + (u_key.to(torch.int64)
                                               + 2 ** 31), p * 2 ** 32)
    order = torch.sort(skey, dim=1, stable=True).indices
    s_coord = torch.gather(coords, 1, order[..., None].expand(k, su, d))
    s_a = torch.gather(a, 1, order)
    s_key = torch.gather(u_key.to(torch.int32), 1, order)

    leaf = torch.arange(k, dtype=torch.int64, device=dev)[:, None]
    cid = torch.where(live, leaf * p + part, k * p).reshape(-1)
    counts = torch.zeros(k * p + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, cid, torch.ones_like(cid))
    cell_start = torch.zeros((k, p + 1), dtype=torch.int64, device=dev)
    cell_start[:, 1:] = torch.cumsum(counts[:k * p].reshape(k, p), 1)
    # A group never spans two cells (a key has one partition), so a slot
    # ends its group where the next live slot's key differs.
    pos = torch.arange(su, device=dev)[None]
    n_live = cell_start[:, -1:]
    s_last = torch.ones((k, su), dtype=torch.bool, device=dev)
    s_last[:, :-1] = s_key[:, 1:] != s_key[:, :-1]
    s_last = (s_last | (pos == n_live - 1)) & (pos < n_live)

    flat = coords.reshape(-1, d)
    nan = torch.isnan(flat)
    lo = torch.full((k * p + 1, d), float("inf"), device=dev)
    hi = torch.full((k * p + 1, d), float("-inf"), device=dev)
    idx = cid[:, None].expand(-1, d)
    lo.scatter_reduce_(0, idx, torch.where(nan, float("inf"), flat), "amin")
    hi.scatter_reduce_(0, idx, torch.where(nan, float("-inf"), flat), "amax")
    bad = torch.zeros(k * p + 1, dtype=torch.int64, device=dev)
    bad.index_add_(0, cid, (~torch.isfinite(a.reshape(-1))).to(torch.int64))
    bad = (bad > 0)[:, None]
    lo = torch.where(bad, float("-inf"), lo)[:k * p]
    hi = torch.where(bad, float("inf"), hi)[:k * p]
    return JoinSlots(
        coords=flat, a=a.reshape(-1), flat_gid=flat_gid, g_cell=g_cell,
        s_coord=s_coord.contiguous(), s_a=s_a.contiguous(),
        s_last=s_last.contiguous(),
        cell_start=cell_start.to(torch.int32).contiguous(),
        cell_box=torch.stack([lo, hi], 1).contiguous(), num_leaves=k,
        capacity=su, num_partitions=p, d=d)


def _scales(p_u: float) -> tuple[float, float]:
    """(1 / p_u, 1 - p_u) rounded to float32 as the reference does."""
    return float(np.float32(1.0 / p_u)), float(np.float32(1.0 - p_u))


def plain_chunk_rows(num_slots: int) -> int:
    """Queries of one chunk of the plain version: ~2**26 (query, slot)
    pairs, ~256 MB per (Q, G) float32 temporary."""
    return max(1, (1 << 26) // max(num_slots, 1))


def join_cell_moments_plain(slots: JoinSlots, q_lo, q_hi, cover, sampled,
                            cell_agg, total_rows, p_u: float
                            ) -> JoinMoments:
    """The reference's formulation in torch (module doc). ``cell_agg``
    (k*P, 5) f32, ``total_rows`` a 0-d f32 tensor. The (slot, query)
    temporaries are laid out slot-major, so each scatter adds contiguous
    rows of a chunk's queries; each destination still takes its sources
    in index order."""
    inv_p, one_m_p = _scales(p_u)
    g = slots.coords.shape[0]
    kp = slots.num_leaves * slots.num_partitions
    coords, a = slots.coords, slots.a
    gid_safe = torch.where(slots.flat_gid >= 0, slots.flat_gid, g)
    g_cell = slots.g_cell
    Q = q_lo.shape[0]
    dev = q_lo.device
    planes = torch.empty((len(PLANES), Q, kp), dtype=torch.float32,
                         device=dev)
    step = plain_chunk_rows(g)
    for s in range(0, Q, step):
        lo, hi = q_lo[s:s + step], q_hi[s:s + step]
        n = lo.shape[0]
        pred = ((lo[None] <= coords[:, None, :]).all(-1)
                & (coords[:, None, :] <= hi[None]).all(-1)
                ).to(torch.float32)                            # (G, n)
        row_c = pred * inv_p
        row_s = row_c * a[:, None]
        gslot = torch.zeros((g + 1, n), dtype=torch.float32, device=dev)
        t_c = gslot.index_add(0, gid_safe, row_c)[:g]
        t_s = gslot.index_add(0, gid_safe, row_s)[:g]
        del pred, row_c, row_s
        spill = torch.zeros((kp + 1, n), dtype=torch.float32, device=dev)

        def to_cell(vals):
            return spill.index_add(0, g_cell, vals)[:kp]

        def max_cell(vals):
            return spill.scatter_reduce(0, g_cell[:, None].expand(g, n),
                                        vals, "amax")[:kp]

        out = planes[:, s:s + n]
        out[0] = to_cell(t_s).T
        out[1] = to_cell(t_c).T
        out[2] = (one_m_p * to_cell(t_s * t_s)).T
        out[3] = (one_m_p * to_cell(t_c * t_c)).T
        out[4] = (one_m_p * to_cell(t_s * t_c)).T
        out[5] = to_cell((t_c > 0).to(torch.float32)).T
        out[6] = max_cell(torch.abs(t_s)).T
        out[7] = max_cell(t_c).T
    cell = cell_agg.to(torch.float32)
    exact3 = cover.to(torch.float32) @ cell[:, :3]
    touched = (sampled.to(torch.float32) @ cell[:, 2]) / torch.clamp(
        total_rows.to(torch.float32), min=1.0)
    return JoinMoments(*planes.unbind(0), exact3=exact3, touched=touched)


def slot_cells(slots: JoinSlots) -> torch.Tensor:
    """(k*su,) int64: the cell whose run holds each sorted slot, k*P past
    a leaf's runs."""
    k, su, P = slots.num_leaves, slots.capacity, slots.num_partitions
    dev = slots.s_coord.device
    pos = torch.arange(su, dtype=torch.int32, device=dev).expand(k, su)
    # A slot's partition within its leaf's runs; P past the last run.
    part = torch.searchsorted(slots.cell_start[:, 1:].contiguous(),
                              pos.contiguous(), right=True).to(torch.int64)
    return torch.where(part < P, torch.arange(k, device=dev)[:, None] * P
                       + part, k * P).reshape(-1)


def cell_nan_flags(slots: JoinSlots) -> torch.Tensor:
    """(k*P,) bool: a slot of the cell's run has a NaN coordinate. The
    slot test rejects NaN and the cell's box leaves it out, so such a cell
    is never covered (:func:`join_cell_classes`)."""
    k, P = slots.num_leaves, slots.num_partitions
    dev = slots.s_coord.device
    nan = torch.isnan(slots.s_coord).any(-1).reshape(-1).to(torch.int64)
    flags = torch.zeros(k * P + 1, dtype=torch.int64, device=dev)
    flags.index_add_(0, slot_cells(slots), nan)
    return flags[:k * P] > 0


def cell_nan_columns(slots: JoinSlots) -> torch.Tensor:
    """(k*P, D) bool: a slot of the cell's run has NaN in the column."""
    k, P, D = slots.num_leaves, slots.num_partitions, slots.d
    dev = slots.s_coord.device
    nan = torch.isnan(slots.s_coord).reshape(-1, D).to(torch.int64)
    cols = torch.zeros((k * P + 1, D), dtype=torch.int64, device=dev)
    cols.index_add_(0, slot_cells(slots), nan)
    return cols[:k * P] > 0


# (query, cell) classes of row 9's kernel.
EMPTY, COVERED, MIXED = 0, 1, 2


def join_cell_classes(slots: JoinSlots, q_lo, q_hi,
                      nan_flags=None) -> torch.Tensor:
    """(Q, k*P) int8, the class the kernel gives each (query, cell) pair,
    by the kernel's compares on ``cell_box``: EMPTY where the query box
    misses the cell's box in some column (the walk's own test: no slot is
    inside, every statistic +0.0), COVERED where it holds the box and no
    slot of the run has a NaN coordinate (every slot inside: the cell's
    own totals, the same for every such query), MIXED otherwise (walked)."""
    if nan_flags is None:
        nan_flags = cell_nan_flags(slots)
    lo, hi = slots.cell_box[None, :, 0], slots.cell_box[None, :, 1]
    ql, qh = q_lo[:, None, :], q_hi[:, None, :]
    walk = ~((qh < lo) | (ql > hi)).any(-1)
    covered = walk & ~nan_flags[None] & ((ql <= lo) & (hi <= qh)).all(-1)
    out = torch.full(walk.shape, EMPTY, dtype=torch.int8, device=walk.device)
    out[walk] = MIXED
    out[covered] = COVERED
    return out


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = native.library("join_moments")
        lib.repro_join_cell_moments.argtypes = (
            [ctypes.c_void_p] * 15 + [ctypes.c_longlong]
            + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.repro_join_cell_moments.restype = ctypes.c_int
        _lib = lib
    return _lib.repro_join_cell_moments


# Limits of the launch (csrc/join_moments.cu): tiles of JM_CT cells along
# gridDim.x and JM_QT queries along gridDim.y (at most 65535 tiles), k * P
# cells and sizes that fit a C int, any D: the tile kernel holds up to
# JM_MAX_D predicate columns whole; above, the wide tile kernel takes tiles
# of JM_WIDE_CT cells and JM_QT queries, whose mixed pairs' results go in
# rounds of at most JM_WIDE_RESULTS pairs (the same shared memory and
# registers at every D).
JM_QT, JM_CT, JM_MAX_D = 32, 128, 16
JM_WIDE_CT, JM_WIDE_RESULTS = 64, 1024


def join_scratch_floats(kp: int) -> int:
    """Floats of the launch's scratch: each cell's totals (8, k*P) and its
    NaN flag (k*P,)."""
    return (len(PLANES) + 1) * kp


def check_join_limits(name, Q, k, su, P, D):
    """Raise ValueError unless the join kernel takes these sizes."""
    if not (1 <= Q < 2 ** 31 and -(-Q // JM_QT) <= 65535
            and 1 <= k < 2 ** 31 and 1 <= su < 2 ** 31
            and 1 <= P < 2 ** 31 and k * P < 2 ** 31
            and 1 <= D < 2 ** 31 and k * su * D < 2 ** 62):
        raise ValueError(
            f"{name}: needs 1 <= Q <= {65535 * JM_QT}, 1 <= k, su, P and "
            f"k * P < 2**31, 1 <= D < 2**31, k * su * D < 2**62, got Q={Q} "
            f"k={k} su={su} P={P} D={D}")


def join_cell_moments_cuda(slots: JoinSlots, q_lo, q_hi, cover, sampled,
                           cell_agg, total_rows, p_u: float) -> JoinMoments:
    """Launch the CUDA kernels on the tensors' device and current stream:
    each cell's totals with every slot inside (into a scratch), then the
    planes tile by tile (a covered pair copies its cell's totals, an empty
    one writes +0.0, a mixed one walks the run; :func:`join_cell_classes`),
    then exact3 and touched. The eight planes are the planes of the
    launch's one buffer."""
    name = "join_cell_moments"
    native.check_tensors(
        name, s_coord=slots.s_coord, s_a=slots.s_a, s_last=slots.s_last,
        cell_start=slots.cell_start, cell_box=slots.cell_box, q_lo=q_lo,
        q_hi=q_hi, cover=cover, sampled=sampled, cell_agg=cell_agg,
        total_rows=total_rows)
    native.check_dtype(name, torch.float32, s_coord=slots.s_coord,
                       s_a=slots.s_a, cell_box=slots.cell_box, q_lo=q_lo,
                       q_hi=q_hi, cell_agg=cell_agg, total_rows=total_rows)
    native.check_dtype(name, torch.int32, cell_start=slots.cell_start)
    native.check_dtype(name, torch.bool, s_last=slots.s_last, cover=cover,
                       sampled=sampled)
    k, su, P, D = (slots.num_leaves, slots.capacity, slots.num_partitions,
                   slots.d)
    Q = q_lo.shape[0]
    kp = k * P
    if (slots.s_coord.shape != (k, su, D) or slots.s_a.shape != (k, su)
            or slots.s_last.shape != (k, su)
            or slots.cell_start.shape != (k, P + 1)
            or slots.cell_box.shape != (kp, 2, D)
            or q_lo.shape != (Q, D) or q_hi.shape != (Q, D)
            or cover.shape != (Q, kp) or sampled.shape != (Q, kp)
            or cell_agg.shape != (kp, 5) or total_rows.numel() != 1):
        raise ValueError(
            f"{name}: shapes {slots.s_coord.shape} {slots.cell_start.shape} "
            f"{slots.cell_box.shape} {q_lo.shape} {q_hi.shape} "
            f"{cover.shape} {sampled.shape} {cell_agg.shape}")
    check_join_limits(name, Q, k, su, P, D)
    inv_p, one_m_p = _scales(p_u)
    dev = q_lo.device
    planes = torch.empty((len(PLANES), Q, kp), dtype=torch.float32,
                         device=dev)
    exact3 = torch.empty((Q, 3), dtype=torch.float32, device=dev)
    touched = torch.empty((Q,), dtype=torch.float32, device=dev)
    scratch = torch.empty(join_scratch_floats(kp), dtype=torch.float32,
                          device=dev)
    native.launch(name, dev, _kernel(), slots.s_coord.data_ptr(),
                  slots.s_a.data_ptr(), slots.s_last.data_ptr(),
                  slots.cell_start.data_ptr(), slots.cell_box.data_ptr(),
                  q_lo.data_ptr(), q_hi.data_ptr(), cover.data_ptr(),
                  sampled.data_ptr(), cell_agg.data_ptr(),
                  total_rows.data_ptr(), planes.data_ptr(),
                  exact3.data_ptr(), touched.data_ptr(), scratch.data_ptr(),
                  scratch.numel(), Q, k, su, P, D, inv_p, one_m_p)
    return JoinMoments(*planes.unbind(0), exact3=exact3, touched=touched)


__all__ = ["JoinSlots", "JoinMoments", "join_slots", "universe_group_ids",
           "join_cell_moments_plain", "join_cell_moments_cuda",
           "check_join_limits", "plain_chunk_rows", "join_scratch_floats",
           "cell_nan_flags", "cell_nan_columns", "slot_cells",
           "join_cell_classes", "EMPTY", "COVERED", "MIXED", "JM_QT", "JM_CT",
           "JM_MAX_D", "JM_WIDE_CT", "JM_WIDE_RESULTS", "PLANES"]
