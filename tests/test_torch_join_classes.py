"""Row 9's (query, cell) classes on the CPU: the identities the CUDA kernel
of csrc/join_moments.cu rests on, held bit for bit on the plain version.

The kernel writes +0.0 for a pair whose query box misses the cell's box
(empty), copies the cell's totals, walked once with every slot inside, for
a pair whose query box holds the cell's box and whose run has no NaN
coordinate (covered), and walks only the rest (mixed).
``join_moments.join_cell_classes`` is that rule in torch. Here, on
``join_cell_moments_plain`` (the reference's formulation) and random
universe samples with NaN coordinates and non-finite values:

* every pair the rule marks covered holds the planes of an unbounded
  query (every slot of its run inside), bit for bit;
* every pair whose box the query misses is +0.0 (sign bit clear);
* a cell with a NaN coordinate on a slot of its run is never covered.

The kernel's launch constants are held to the source's.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.join_moments import (
    COVERED, EMPTY, JM_CT, JM_MAX_D, JM_QT, MIXED, PLANES, cell_nan_flags,
    check_join_limits, join_cell_classes, join_cell_moments_plain,
    join_scratch_floats, join_slots)

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "join_moments.cu")
P_U = 0.3


def bits(x):
    """int32 view of float32 values, every NaN as one code."""
    x = np.array(x, np.float32)
    b = x.view(np.int32).copy()
    b[np.isnan(x)] = 0x7FC00000
    return b


def universe(seed, k=7, su=40, P=4, d_f=1, d_d=1, nan=True, inf=True):
    """Random universe slots (the shapes of chip_smoke.py's join cases):
    coordinates N(0, 1), values Gamma(2, 1), keys over 3 * su values,
    partition = key mod P, 70 % valid, one leaf without a valid slot; with
    ``nan`` NaN coordinates on some valid slots, with ``inf`` +inf, -inf
    and NaN values on three valid slots. Returns (JoinSlots, D)."""
    rng = np.random.default_rng(seed)
    u_c = rng.normal(size=(k, su, d_f)).astype(np.float32)
    u_d = rng.normal(size=(k, su, d_d)).astype(np.float32)
    u_a = rng.gamma(2.0, 1.0, size=(k, su)).astype(np.float32)
    u_key = rng.integers(0, 3 * su, size=(k, su)).astype(np.int32)
    u_valid = rng.random((k, su)) < 0.7
    u_valid[k // 2] = False
    if nan:
        u_c[u_valid & (rng.random((k, su)) < 0.03), 0] = np.nan
        u_d[u_valid & (rng.random((k, su)) < 0.02), -1] = np.nan
    if inf:
        on = np.argwhere(u_valid)
        for v, (i, j) in zip((np.inf, -np.inf, np.nan),
                             on[rng.choice(len(on), 3, replace=False)]):
            u_a[i, j] = v
    u_part = (u_key % P).astype(np.int32)
    T = torch.from_numpy
    slots = join_slots(T(u_c), T(u_d), T(u_a), T(u_key), T(u_part),
                       T(u_valid), P)
    return slots, d_f + d_d


def queries(slots, D, seed, Q=14):
    """Random boxes, a box over everything finite, the unbounded box, a
    box that misses everything, boxes that are some cells' boxes exactly
    (edges on slot coordinates), and a box with a NaN bound."""
    rng = np.random.default_rng(seed)
    lo = rng.normal(-0.5, 1.0, size=(Q, D)).astype(np.float32)
    hi = (lo + rng.uniform(0.0, 2.5, size=(Q, D))).astype(np.float32)
    lo[0], hi[0] = -10.0, 10.0
    lo[1], hi[1] = -np.inf, np.inf
    lo[2], hi[2] = 20.0, 30.0
    box = slots.cell_box.numpy()
    finite = np.flatnonzero(np.isfinite(box).all((1, 2)))
    for i, cell in zip(range(3, 6), rng.choice(finite, 3, replace=False)):
        lo[i], hi[i] = box[cell, 0], box[cell, 1]
    lo[6, 0] = np.nan
    return torch.from_numpy(lo), torch.from_numpy(hi)


def plain(slots, lo, hi):
    Q, kp = lo.shape[0], slots.num_leaves * slots.num_partitions
    z = torch.zeros((Q, kp), dtype=torch.bool)
    agg = torch.zeros((kp, 5), dtype=torch.float32)
    m = join_cell_moments_plain(slots, lo, hi, z, z, agg,
                                torch.tensor(1.0), P_U)
    return np.stack([getattr(m, f).numpy() for f in PLANES])  # (8, Q, kP)


def unbounded_cells(slots):
    """(k*P,) bool: the cell's box is (-inf, +inf) in every column, as
    join_slots makes it for a run with a non-finite value."""
    box = slots.cell_box.numpy()
    return (box[:, 0] == -np.inf).all(1) & (box[:, 1] == np.inf).all(1)


def direct_nan_flags(slots):
    """Per cell, any NaN among its run's coordinates, by a loop."""
    k, P = slots.num_leaves, slots.num_partitions
    cs = slots.cell_start.numpy()
    coord = slots.s_coord.numpy()
    out = np.zeros(k * P, bool)
    for leaf in range(k):
        for p in range(P):
            run = coord[leaf, cs[leaf, p]:cs[leaf, p + 1]]
            out[leaf * P + p] = np.isnan(run).any()
    return out


CASES = [(0, 1, 1), (1, 1, 1), (2, 2, 1), (3, 3, 13)]


@pytest.mark.parametrize("seed,d_f,d_d", CASES)
def test_nan_flags_mirror(seed, d_f, d_d):
    slots, _ = universe(seed, d_f=d_f, d_d=d_d)
    got = cell_nan_flags(slots).numpy()
    want = direct_nan_flags(slots)
    assert np.array_equal(got, want)
    assert want.any()


@pytest.mark.parametrize("seed,d_f,d_d", CASES)
def test_covered_pairs_hold_the_unbounded_planes(seed, d_f, d_d):
    slots, D = universe(seed, d_f=d_f, d_d=d_d)
    lo, hi = queries(slots, D, seed + 100)
    cls = join_cell_classes(slots, lo, hi).numpy()
    assert (cls == COVERED).any() and (cls == MIXED).any() \
        and (cls == EMPTY).any()
    got = bits(plain(slots, lo, hi))
    inf = torch.full((1, D), float("inf"))
    every = bits(plain(slots, -inf, inf))[:, 0]                 # (8, kP)
    q, cell = np.nonzero(cls == COVERED)
    assert np.array_equal(got[:, q, cell], every[:, cell])
    # The unbounded query covers exactly the cells without a NaN
    # coordinate; a box over everything finite covers no cell with a
    # non-finite value (its box is unbounded).
    flags = direct_nan_flags(slots)
    assert np.array_equal(cls[1] == COVERED, ~flags)
    assert not (cls[0][unbounded_cells(slots)] == COVERED).any()


@pytest.mark.parametrize("seed,d_f,d_d", CASES)
def test_empty_pairs_are_positive_zero(seed, d_f, d_d):
    slots, D = universe(seed, d_f=d_f, d_d=d_d)
    lo, hi = queries(slots, D, seed + 200)
    cls = join_cell_classes(slots, lo, hi).numpy()
    got = plain(slots, lo, hi).view(np.int32)
    q, cell = np.nonzero(cls == EMPTY)
    assert q.size and (got[:, q, cell] == 0).all()
    # The box that misses every finite slot: every pair empty but those of
    # the cells with a non-finite value, whose boxes are unbounded (their
    # t_s is NaN whatever the predicate), which are walked. The
    # NaN-bounded box covers no cell.
    unbounded = unbounded_cells(slots)
    assert unbounded.any()
    assert (cls[2][~unbounded] == EMPTY).all()
    assert (cls[2][unbounded] == MIXED).all()
    assert not (cls[6] == COVERED).any()


@pytest.mark.parametrize("seed,d_f,d_d", CASES)
def test_nan_cells_never_covered(seed, d_f, d_d):
    slots, D = universe(seed, d_f=d_f, d_d=d_d)
    lo, hi = queries(slots, D, seed + 300)
    cls = join_cell_classes(slots, lo, hi).numpy()
    flags = direct_nan_flags(slots)
    assert flags.any()
    assert not (cls[:, flags] == COVERED).any()
    # Without NaN coordinates the same boxes do cover those cells.
    clean, _ = universe(seed, d_f=d_f, d_d=d_d, nan=False)
    assert not cell_nan_flags(clean).any()
    c_cls = join_cell_classes(clean, *queries(clean, D, seed + 300))
    assert (c_cls[1] == COVERED).all()


def test_launch_constants_match_source():
    """The tiles, the columns the tile kernel holds whole (its block
    width above them: MAX_D is no limit on D) and the scratch, against
    csrc/join_moments.cu."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert (const("QB"), const("CT"), const("MAX_D")) == (JM_QT, JM_CT,
                                                          JM_MAX_D)
    assert const("STATS") == len(PLANES)
    assert join_scratch_floats(16_384) == 9 * 16_384


def test_join_limits_cells_fit_an_int():
    check_join_limits("x", 2048, 1024, 750, 16, 4)
    check_join_limits("x", 1, 2 ** 27, 1, 15, 1)
    with pytest.raises(ValueError, match="needs"):
        check_join_limits("x", 1, 2 ** 27, 1, 16, 1)
