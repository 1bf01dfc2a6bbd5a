"""Rows 2 and 8 above one slot chunk: the chunked decomposition of
csrc/pair_tiles.cuh, replayed in torch, against the plain versions and the
JAX package's jnp backend.

For s > PAIR_CHUNK the kernels cut each stratum's slots into chunks of
PAIR_CHUNK consecutive slots. Each (query, stratum, chunk) triple is
classified from the chunk's own box around its valid samples (NaN
coordinates skipped, and a flag for a NaN coordinate on a valid slot): a
covered triple takes the chunk's own reduction over its valid slots, an
empty one the reduction of no relevant slot, a mixed one walks the chunk's
slots. The partials are folded in chunk order. The CUDA kernels run only on
the card (chip_smoke.py holds them against their plain versions there);
here the decomposition is replayed and held to the kernels' bars: row 2's
counts exact and sums within rtol=3e-5, atol=1e-3 (fp32 sums in another
order than the plain version's), row 8 bit for bit with every NaN as one
code (its fold is order-free).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.kernels import backends as _jax_backends  # noqa: F401 (registers)
from repro.kernels.backends import sample_moments as jax_sample_moments
from repro.kernels.registry import get_backend
from repro_torch import minmax
from repro_torch.kernels.sample_extremes import (BIG, EXTREMES_LT,
                                                 EXTREMES_QT,
                                                 sample_extremes_plain)
from repro_torch.kernels.stratified_estimate import (
    MOMENTS_LT, MOMENTS_QT, PAIR_CHUNK, pair_scratch_floats,
    samples_inside, stratified_moments_plain)

C = PAIR_CHUNK
RTOL, ATOL = 3e-5, 1e-3
F32_MAX = np.float32(3.4028235e38)
HEADER = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "pair_tiles.cuh")


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def bits(x):
    """int32 view of float32 values, every NaN as one code."""
    x = np.array(x, np.float32)
    b = x.view(np.int32).copy()
    b[np.isnan(x)] = 0x7FC00000
    return b


def chunk_boxes(c, valid, s0, s1):
    """The box of the valid samples of slots [s0, s1) of every stratum
    (fminf / fmaxf: NaN coordinates skipped; +inf / -inf where none) and
    the flag of a NaN coordinate on a valid slot: (k, d), (k, d), (k,)."""
    cv, vv = c[:, s0:s1], valid[:, s0:s1]
    on = vv[..., None] & ~torch.isnan(cv)
    blo = torch.where(on, cv, float("inf")).amin(1)
    bhi = torch.where(on, cv, float("-inf")).amax(1)
    flag = (vv[..., None] & torch.isnan(cv)).any(-1).any(-1)
    return blo, bhi, flag


def chunk_classes(blo, bhi, flag, q_lo, q_hi):
    """(Q, k) covered and apart masks by the slot test's compares."""
    ql, qh = q_lo[:, None, :], q_hi[:, None, :]
    covered = (~flag[None]
               & ((ql <= blo[None]) & (bhi[None] <= qh)).all(-1))
    apart = ((qh < blo[None]) | (bhi[None] < ql)).any(-1)
    return covered, apart


def slot_order_moments(a, inside):
    """[cnt, sum, sq] of the relevant slots in slot order from +0.0 (the
    kernel's add_slot: cnt + 1, sum + a, fma(a, a, sq), the fma taken in
    float64 and rounded once), over the last axis of ``inside``."""
    shape = inside.shape[:-1]
    cnt = torch.zeros(shape, dtype=torch.float32)
    sm = torch.zeros(shape, dtype=torch.float32)
    sq = torch.zeros(shape, dtype=torch.float32)
    for i in range(inside.shape[-1]):
        m = inside[..., i]
        x = torch.where(m, a[..., i], 0.0)
        cnt = cnt + m.to(torch.float32)
        sm = sm + x
        sq = (sq.double() + x.double() * x.double()).float()
    return torch.stack([cnt, sm, sq], -1)


def replay_chunked(c, a, valid, q_lo, q_hi, row):
    """Row 2 ((Q, k, 3) moments) or row 8 ((min, max), each (Q, k)) as the
    kernels compute it: one pass for s <= C (the chunk is the whole slot
    axis), chunks of C slots above it, each triple by its class, the
    partials folded in chunk order. Returns (result, per-chunk class
    counts)."""
    k, s, _ = c.shape
    Q = q_lo.shape[0]
    inside = samples_inside(c, valid, q_lo, q_hi)             # (Q, k, s)
    if row == 2:
        acc = torch.zeros((Q, k, 3), dtype=torch.float32)
    else:
        acc = (torch.full((Q, k), float("inf")),
               torch.full((Q, k), float("-inf")))
    counts = []
    for s0 in range(0, max(s, 1), C):
        s1 = min(s, s0 + C)
        blo, bhi, flag = chunk_boxes(c, valid, s0, s1)
        covered, apart = chunk_classes(blo, bhi, flag, q_lo, q_hi)
        mixed = ~covered & ~apart
        counts.append({"covered": int(covered.sum()),
                       "empty": int((apart & ~covered).sum()),
                       "mixed": int(mixed.sum())})
        ins, av, vv = inside[..., s0:s1], a[:, s0:s1], valid[:, s0:s1]
        if row == 2:
            own = slot_order_moments(av, vv)                   # (k, 3)
            walk = slot_order_moments(av[None].expand(Q, -1, -1), ins)
            part = torch.where(covered[..., None], own[None],
                               torch.where(mixed[..., None], walk, 0.0))
            acc = acc + part
        else:
            own_mn = minmax.masked_min(av, vv, BIG, -1)
            own_mx = minmax.masked_max(av, vv, -BIG, -1)
            walk_mn = minmax.masked_min(av[None], ins, BIG, -1)
            walk_mx = minmax.masked_max(av[None], ins, -BIG, -1)
            mn = torch.where(covered, own_mn[None],
                             torch.where(mixed, walk_mn, BIG))
            mx = torch.where(covered, own_mx[None],
                             torch.where(mixed, walk_mx, -BIG))
            acc = (minmax.minimum(acc[0], mn), minmax.maximum(acc[1], mx))
    return acc, counts


def chunk_case(seed, Q, k, s, d, nan=False, special=False):
    """Each stratum's samples in its own cell of a grid over [0, 1)^d, its
    chunk j of C slots in the j-th of n_ch bands of the cell in column 0,
    so that a query edge can cover some chunks of a stratum, miss others and
    cut the rest; ragged validity, stratum k // 2 without a valid slot when
    k > 2. Query 0 covers every sample, 1 misses everything, 2 is inverted,
    3 spans the first chunk's band of stratum 0's cell; the rest span a few
    cells with random band edges. ``nan`` puts a NaN coordinate on one valid
    slot of the last chunk of the last stratum and NaN in column 0 of every
    slot of stratum 1's first chunk; ``special`` NaN, +-inf, values beyond
    +-BIG and +-0.0 into the values (row 8 only: the plain row 2 turns an
    irrelevant +-inf into NaN by multiplying it with 0)."""
    rng = np.random.default_rng(seed)
    n_ch = -(-s // C)
    cells = max(2, int(np.ceil(k ** (1 / d))))
    cell = np.stack(np.unravel_index(np.arange(k) % cells ** d,
                                     (cells,) * d), -1).astype(np.float32)
    u = rng.uniform(0.05, 0.95, (k, s, d))
    band = (np.arange(s) // C)[None, :]
    u[..., 0] = (band + rng.uniform(0.05, 0.95, (k, s))) / n_ch
    c = ((cell[:, None, :] + u) / cells).astype(np.float32)
    a = rng.normal(0, 3, (k, s)).astype(np.float32)
    valid = rng.random((k, s)) < 0.8
    if k > 2:
        valid[k // 2] = False
    if special:
        w = rng.random((k, s))
        for lo, hi, x in ((0.0, 0.04, np.nan), (0.04, 0.07, np.inf),
                          (0.07, 0.10, -np.inf), (0.10, 0.13, F32_MAX),
                          (0.13, 0.16, -F32_MAX), (0.16, 0.22, -0.0),
                          (0.22, 0.28, 0.0)):
            a[(w >= lo) & (w < hi)] = x
    starts = rng.integers(0, cells, (Q, d)).astype(np.float32)
    spans = rng.integers(1, 3, (Q, d)).astype(np.float32)
    edge_lo = rng.integers(0, n_ch + 1, (Q, d)) / n_ch
    edge_hi = rng.integers(0, n_ch + 1, (Q, d)) / n_ch
    q_lo = ((starts + edge_lo * 0.9) / cells).astype(np.float32)
    q_hi = ((starts + spans - 1 + 0.05 + edge_hi * 0.9) / cells
            ).astype(np.float32)
    q_lo[0], q_hi[0] = -1.0, 2.0
    q_lo[1], q_hi[1] = 5.0, 6.0
    q_lo[2], q_hi[2] = 0.6, 0.4
    q_lo[3], q_hi[3] = 0.0, 1.0 / cells
    q_hi[3, 0] = (1.0 / n_ch) / cells
    if nan:
        last = k - 1
        on = np.flatnonzero(valid[last, (n_ch - 1) * C:]) + (n_ch - 1) * C
        if on.size:
            c[last, on[0], d - 1] = np.nan
        if k > 1:
            c[1, :C, 0] = np.nan
    return c, a, valid, q_lo, q_hi


S_EDGES = (C - 1, C, C + 1, 2 * C + 7)
CASES = [(s, k, d) for s in S_EDGES for k in (1, 3, 17) for d in (1, 3, 16)]
Q = 12


def _case(s, k, d, row):
    seed = s * 7 + k * 131 + d * 17 + row
    return chunk_case(seed, Q, k, s, d, nan=(k + d) % 2 == 0,
                      special=row == 8)


def _assert_moments(got, want, msg):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got[..., 0], want[..., 0],
                                  err_msg=f"{msg}: counts")
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=RTOL,
                               atol=ATOL, err_msg=f"{msg}: sums")


def _assert_bits(got, want, msg):
    g, w = bits(got), bits(want)
    assert g.shape == w.shape, (msg, g.shape, w.shape)
    if not np.array_equal(g, w):
        i = tuple(np.argwhere(g != w)[0])
        raise AssertionError(f"{msg}: {int((g != w).sum())} values differ "
                             f"in their bits, first at {i}")


@pytest.mark.parametrize("s,k,d", CASES)
def test_chunked_moments_replay(s, k, d):
    """Row 2's chunked decomposition equals the plain version and the JAX
    package's sample_moments: counts exact, sums within the kernels' bar."""
    args = _t(*_case(s, k, d, 2))
    got, counts = replay_chunked(*args, row=2)
    assert len(counts) == -(-s // C)
    _assert_moments(got, stratified_moments_plain(*args), "plain")
    want_j = np.stack([np.asarray(x) for x in jax_sample_moments(
        *map(jnp.asarray, (x.numpy() for x in args)))], -1)
    _assert_moments(got, want_j, "jnp backend")


@pytest.mark.parametrize("s,k,d", CASES)
def test_chunked_extremes_replay(s, k, d):
    """Row 8's chunked decomposition gives the plain version's bits and the
    JAX package's sample_extremes' (NaN as NaN), on values with NaN, +-inf,
    +-F32_MAX and +-0.0."""
    args = _t(*_case(s, k, d, 8))
    (mn, mx), counts = replay_chunked(*args, row=8)
    assert len(counts) == -(-s // C)
    pmn, pmx = sample_extremes_plain(*args)
    _assert_bits(mn, pmn, "min vs plain")
    _assert_bits(mx, pmx, "max vs plain")
    jmn, jmx = get_backend("jnp").sample_extremes(
        *map(jnp.asarray, (x.numpy() for x in args)))
    _assert_bits(mn, np.asarray(jmn), "min vs jnp backend")
    _assert_bits(mx, np.asarray(jmx), "max vs jnp backend")


@pytest.mark.parametrize("row", [2, 8])
@pytest.mark.parametrize("s", [C + 1, 2 * C + 7])
def test_chunk_classes_all_occur(row, s):
    """The chunk cases hold a chunk where covered, empty and mixed triples
    all occur (the first chunk at k = 17, d = 1), and a stratum covered in
    one chunk and mixed or empty in another."""
    args = _t(*chunk_case(5 + s, 40, 17, s, 1))
    _, counts = replay_chunked(*args, row=row)
    assert any(min(x.values()) > 0 for x in counts), counts
    c, _, valid, q_lo, q_hi = args
    b0 = chunk_boxes(c, valid, 0, C)
    b1 = chunk_boxes(c, valid, C, min(s, 2 * C))
    cov0, _ = chunk_classes(*b0, q_lo, q_hi)
    cov1, _ = chunk_classes(*b1, q_lo, q_hi)
    assert bool((cov0 & ~cov1).any() or (cov1 & ~cov0).any())


def test_nan_coordinate_chunks_are_never_covered():
    """A chunk with a NaN coordinate on a valid slot is flagged, so no
    query covers it (the slot test rejects NaN); the other chunks of the
    same stratum keep their own classes."""
    s = 2 * C + 7
    c, a, valid, q_lo, q_hi = _t(*chunk_case(3, Q, 4, s, 2, nan=True))
    flags = []
    for s0 in range(0, s, C):
        blo, bhi, flag = chunk_boxes(c, valid, s0, min(s, s0 + C))
        covered, _ = chunk_classes(blo, bhi, flag, q_lo, q_hi)
        assert not bool(covered[:, flag].any())
        flags.append(flag.tolist())
    assert flags == [[False, True, False, False], [False] * 4,
                     [False, False, False, True]]


def test_pair_constants_match_the_header():
    """The Python mirrors of pair_tiles.cuh's constants: the slot chunk of
    the order contract (at least 1,203, so that every one-pass shape the
    port serves, BSS2x's s = 1,203 included, keeps its bits) and the
    one-pass tiles both wrappers describe."""
    src = HEADER.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("SLOT_CHUNK") == PAIR_CHUNK == 2048
    assert PAIR_CHUNK >= 1203
    assert const("QT") == MOMENTS_QT == EXTREMES_QT
    assert const("LT") == MOMENTS_LT == EXTREMES_LT


@pytest.mark.parametrize("stats", [3, 2])
def test_pair_scratch_floats(stats):
    """The chunked launch's scratch: none up to one chunk; above it the
    walks' partials (chunks, Q, k, stats) and per (leaf, chunk) a box of 2d
    floats, the partial and the NaN flag (make_chunk_plan's carve-up)."""
    assert pair_scratch_floats(2048, 1024, 75, 3, stats) == 0
    assert pair_scratch_floats(7, 5, C, 16, stats) == 0
    assert pair_scratch_floats(2048, 1, 38_500, 1, stats) == (
        19 * 2048 * stats + 19 * (2 + stats + 1))
    assert pair_scratch_floats(3, 4, C + 1, 2, stats) == (
        2 * 3 * 4 * stats + 4 * 2 * (4 + stats + 1))
