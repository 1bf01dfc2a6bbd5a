"""Rows 1 and 7 above 16 predicate columns (csrc/query_eval.cu's
``query_eval_kernel<-1, VEC>`` and csrc/route_multid.cu's
``route_multid_wide_kernel``) replayed in numpy, against the plain
versions, the previous layout and the JAX package.

Row 1. A block takes a leaf tile of LK leaves and stages its boxes WC
columns at a time, a leaf's columns in a row of WC floats whose halves
swap in every other group of four leaves; thread t reads back leaves t +
NT * u, ANDs their non-empty bits and folds the tile's box (fminf of lo
and of -hi: a NaN drops out). A query's cut columns in a block are those
where it does not hold the tile's box; a (query, leaf) pair is compared on
those only. The cut set is a mask of the block's WC columns, so it holds
every column: a query that cuts them all (and more than WC in all) takes
no other path.

Row 7. A lane holds its rows of a tile of 32 * RT (up to WCOLS columns;
above, the tile is staged at the odd stride d | 1); the cluster's G
blocks take route_wide_plan's leaf ranges and a block's WW warps
ascending sub-ranges of them (route_warp_ranges). A warp stages WTK
leaves (WTKA above WCOLS columns) x WCOLS columns of lo and of hi at
[warp][leaf][column], sums each distance in column order from column 0's
term (whole up to WCOLS columns, over 4 * ceil(d / 4) of them, the pad
columns' terms +0.0; carried across the column blocks above), and keeps
its best on a strict `<`; the warps merge in order, then the blocks.

The CUDA kernels run only on the card (chip_smoke.py phases 7, 29 and 30
hold them to plain and to the previous kernels' bits there). Here the
replays write the staged data at the kernels' offsets into buffers that
hold stale values between uses and compute from what they read back, so a
layout whose writes and reads disagree changes the bits. Held: row 1's
rel equal to classify_leaves; row 7's leaf and distance bit-equal to
route_multid_plain on finite rows and, on rows with NaN or +-inf
coordinates, to the earlier column-block layout (test_torch_wide's replay)
under the same per-term maximum and to a dense fmaxf oracle under the
kernel's; one case each against the JAX package; the layout constants the
sources'.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.kernels.registry import get_backend
from repro.kernels.route import route_multid_dense
from repro_torch.kernels.query_eval import (QE_LEAF_TILE, QE_MAX_QUERIES,
                                            QE_THREADS, QE_WIDE_COLS,
                                            classify_leaves, query_eval_plain)
from repro_torch.kernels.route import (ROUTE_MAX_GROUPS, ROUTE_WIDE_WARPS,
                                       route_groups, route_multid_plain,
                                       route_warp_ranges, route_wide_plan)
from test_torch_wide import _replay_route

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
f32 = np.float32
INF = f32(np.inf)


def constants(name):
    """{NAME: value} of a source's namespace-scope ``constexpr int`` lines,
    each expression evaluated over the names before it."""
    out = {}
    text = (CSRC / name).read_text()
    for m in re.finditer(r"^constexpr int (\w+) = ([^;]+);", text, re.M):
        out[m.group(1)] = int(eval(m.group(2), {}, dict(out)))
    return out


QE = constants("query_eval.cu")
RT_ = constants("route_multid.cu")
# Row 1's layout and row 7's, held to the sources by
# test_layout_constants_match_the_sources.
NT, LPT, LK, WC = 256, 4, 1024, 8
WW, WCOLS, WTK, WTKA = 4, 32, 32, 8


def test_layout_constants_match_the_sources():
    assert (QE["NT"], QE["LPT"], QE["LK"], QE["WC"]) == (NT, LPT, LK, WC)
    assert (QE_THREADS, QE_LEAF_TILE, QE_WIDE_COLS) == (NT, LK, WC)
    assert QE["MAX_QB"] == QE_MAX_QUERIES and QE["MAX_D"] == 16
    # A leaf's WC columns are two 16-byte copies; the aggregates fit the
    # staged columns' room.
    assert WC == 8 and NT * LPT == LK
    assert QE["WIDE_BYTES"] == 2 * LK * WC * 4 >= (LK + 1) * 8 * 4
    assert (RT_["WW"], RT_["WCOLS"], RT_["WTK"], RT_["WTKA"]) == (
        WW, WCOLS, WTK, WTKA)
    assert RT_["WNT"] == 32 * WW and RT_["MAX_D"] == 16
    assert ROUTE_WIDE_WARPS == WW and RT_["MAX_G"] == ROUTE_MAX_GROUPS
    # a leaf's staged row: whole 16-byte groups; the smaller tile fits
    assert WCOLS % 4 == 0 and WTKA <= WTK


# ---------------------------------------------------------------------------
# Row 1
# ---------------------------------------------------------------------------

def staged_at(l, j):
    """Where the staging puts column j of a tile's leaf l: a row of WC
    floats a leaf, its two 4-column halves swapped in every other group of
    four leaves."""
    return l * WC + 4 * ((j >> 2) ^ ((l >> 2) & 1)) + (j & 3)


def replay_query_eval(leaf_lo, leaf_hi, q_lo, q_hi, rng):
    """rel (Q, k) as the wide kernel forms it, and per (tile, column
    block) the (Q, nj) cut masks it compares on."""
    Q, d = q_lo.shape
    k = leaf_lo.shape[0]
    rel = np.empty((Q, k), np.int32)
    masks = []
    s_blo = rng.normal(0, 9, LK * WC).astype(f32)    # stale between uses
    s_bhi = rng.normal(0, 9, LK * WC).astype(f32)
    leaf = np.arange(LK)                  # thread t's leaves: t + NT * u
    sw = 4 * ((leaf >> 2) & 1)
    for k0 in range(0, k, LK):
        n = min(LK, k - k0)
        ne = np.ones(LK, bool)
        cov = np.ones((Q, LK), bool)
        dis = np.zeros((Q, LK), bool)
        for j0 in range(0, d, WC):
            nj = min(WC, d - j0)
            at = staged_at(np.arange(n)[:, None], np.arange(nj)[None])
            s_blo[at] = leaf_lo[k0:k0 + n, j0:j0 + nj]      # cp.async
            s_bhi[at] = leaf_hi[k0:k0 + n, j0:j0 + nj]
            half = lambda buf, off: buf[(leaf * WC + off)[:, None]
                                        + np.arange(4)[None]]
            la = np.concatenate([half(s_blo, sw), half(s_blo, 4 - sw)], 1)
            ha = np.concatenate([half(s_bhi, sw), half(s_bhi, 4 - sw)], 1)
            on = (k0 + leaf < k)[:, None] & (np.arange(WC) < nj)[None]
            lo = np.where(on, la, INF).astype(f32)[:, :nj]
            hi = np.where(on, ha, -INF).astype(f32)[:, :nj]
            ne &= (lo <= hi).all(1)
            # fminf of lo and of -hi over the leaves (any order folds alike)
            tl = np.fmin.reduce(lo, axis=0)
            th = -np.fmin.reduce(-hi, axis=0)
            ql, qh = q_lo[:, j0:j0 + nj], q_hi[:, j0:j0 + nj]
            cut = ~((ql <= tl) & (th <= qh))                 # (Q, nj)
            masks.append(cut)
            cover = (ql[:, None] <= lo[None]) & (hi[None] <= qh[:, None])
            apart = (qh[:, None] < lo[None]) | (ql[:, None] > hi[None])
            cov &= (cover | ~cut[:, None]).all(-1)
            dis |= (apart & cut[:, None]).any(-1)
        code = np.where(ne & cov, 2, np.where(~ne | dis, 0, 1))
        rel[:, k0:k0 + n] = code[:, :n]
    return rel, masks


def test_query_eval_staging_and_cover_words():
    """The staged rows fill each leaf's WC floats once, and a quarter-warp's
    16-byte reads (8 neighbouring leaves, either half) meet 32 banks; the
    ballot of thread t's leaf t + NT * u is cover word t // 32 + 8u, bit
    t % 32: the leaf's own word."""
    l, j = np.meshgrid(np.arange(LK), np.arange(WC), indexing="ij")
    at = staged_at(l, j)
    assert sorted(at.ravel()) == list(range(LK * WC))
    for first in range(0, LK, 8):
        for c in (0, 1):
            start = [staged_at(x, 4 * c) for x in range(first, first + 8)]
            banks = {(a + i) % 32 for a in start for i in range(4)}
            assert len(banks) == 32
    t = np.arange(NT)
    for u in range(LPT):
        leaf = t + NT * u
        np.testing.assert_array_equal(leaf // 32, t // 32 + (NT // 32) * u)
        np.testing.assert_array_equal(leaf % 32, t % 32)


def qe_case(seed, Q, k, d, mode="mixed"):
    """Leaf boxes in (-1, 1.5): leaf k // 2 inverted in the last column,
    leaf 1 NaN in a middle column, one leaf +-inf (empty); queries bound
    2-4 columns ("mixed"), or 9-12 so that whole column blocks are cut
    ("many", and query 4 every column); the rest at (-2, 2), which holds
    every leaf; query 1 apart
    from every leaf in the last column, query 2 a NaN bound in column 0,
    query 3 holds everything."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-1, 0.5, (k, d)).astype(f32)
    hi = (lo + rng.uniform(0, 1, (k, d))).astype(f32)
    lo[k // 2, d - 1], hi[k // 2, d - 1] = 1.0, 0.0
    lo[1, d // 2] = np.nan
    lo[k - 1], hi[k - 1] = INF, -INF
    agg = rng.normal(0, 1, (k, 5)).astype(f32)
    q_lo = np.full((Q, d), -2.0, f32)
    q_hi = np.full((Q, d), 2.0, f32)
    span = (2, 5) if mode == "mixed" else (9, 13)
    for i in range(4, Q):
        cols = rng.choice(d, int(rng.integers(*span)), replace=False)
        q_lo[i, cols] = rng.uniform(-1, 0.3, cols.size)
        q_hi[i, cols] = q_lo[i, cols] + rng.uniform(0.2, 1.2, cols.size)
    if mode == "many":                    # query 4 cuts every column
        q_lo[4] = rng.uniform(-1, 0.3, d)
        q_hi[4] = q_lo[4] + rng.uniform(0.2, 1.2, d)
    q_lo[1, d - 1], q_hi[1, d - 1] = 5.0, 6.0
    q_lo[2, 0] = np.nan
    return lo, hi, agg, q_lo, q_hi


@pytest.mark.parametrize("d, Q, k, mode", [
    (17, 37, 300, "mixed"), (24, 21, 1030, "mixed"), (33, 13, 77, "mixed"),
    (24, 19, 200, "many"), (33, 11, 64, "many")])
def test_query_eval_replay_equals_classify_leaves(d, Q, k, mode):
    """Classes on the cut columns only give the all-column formula's rel;
    k off the leaf tile and past it, Q past a block of 8 queries."""
    lo, hi, agg, q_lo, q_hi = qe_case(3200 + d + k, Q, k, d, mode)
    rel, masks = replay_query_eval(lo, hi, q_lo, q_hi,
                                   np.random.default_rng(d))
    want = classify_leaves(*map(torch.from_numpy, (lo, hi, q_lo,
                                                   q_hi))).numpy()
    np.testing.assert_array_equal(rel, want)
    assert {0, 1, 2} <= set(np.unique(rel).tolist())
    assert (rel[:, [1, k // 2, k - 1]] == 0).all()
    cut = np.concatenate(masks[:-(-d // WC)], 1)        # the first tile's
    assert cut[2, 0] and cut[1, d - 1] and not cut[3].any()
    if mode == "many":
        # queries whose cut columns fill a block and pass WC in all: the
        # mask holds them all, no other path
        assert (cut.sum(1) > WC).any()
        assert any(m.all(1).any() for m in masks)


def test_query_eval_cut_columns_are_the_bounded_ones():
    """At the wide queries' rule (unbounded columns at the data's [min,
    max], which holds the whole tile's box) a query's cut columns are its
    bounded ones that do not hold the tile's extent there."""
    rng = np.random.default_rng(5)
    k, d, Q = 1024, 24, 64
    lo = rng.uniform(0, 1, (k, d)).astype(f32)
    hi = (lo + rng.uniform(0, 0.1, (k, d))).astype(f32)
    q_lo = np.tile(lo.min(0), (Q, 1))
    q_hi = np.tile(hi.max(0), (Q, 1))
    bound = np.zeros((Q, d), bool)
    for i in range(Q):
        cols = rng.choice(d, int(rng.integers(2, 5)), replace=False)
        bound[i, cols] = True
        q_lo[i, cols] = rng.uniform(0.1, 0.4, cols.size)
        q_hi[i, cols] = q_lo[i, cols] + 0.3
    rel, masks = replay_query_eval(lo, hi, q_lo, q_hi, rng)
    np.testing.assert_array_equal(np.concatenate(masks, 1), bound)
    np.testing.assert_array_equal(rel, classify_leaves(
        *map(torch.from_numpy, (lo, hi, q_lo, q_hi))).numpy())


def test_query_eval_replay_matches_jax():
    """One case against the JAX package's jnp query_eval."""
    d = 24
    lo, hi, agg, q_lo, q_hi = qe_case(77, 23, 300, d)
    rel, _ = replay_query_eval(lo, hi, q_lo, q_hi, np.random.default_rng(1))
    rel_j, exact_j = get_backend("jnp").query_eval(
        *map(jnp.asarray, (lo, hi, agg, q_lo, q_hi)))
    np.testing.assert_array_equal(rel, np.asarray(rel_j))
    _, exact_t = query_eval_plain(*map(torch.from_numpy,
                                       (lo, hi, agg, q_lo, q_hi)))
    np.testing.assert_allclose(exact_t.numpy()[:, :3],
                               np.asarray(exact_j)[:, :3], rtol=3e-5,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# Row 7
# ---------------------------------------------------------------------------

def fmax_term(lo, hi, x):
    """fmaxf(fmaxf(lo - x, x - hi), 0): a NaN operand drops out."""
    return np.fmax(np.fmax(lo - x, x - hi), f32(0)).astype(f32)


def max_term(lo, hi, x):
    """The same term under a NaN-propagating maximum (test_torch_wide's
    replay of the column-block layout uses it)."""
    return np.maximum(np.maximum(lo - x, x - hi), f32(0)).astype(f32)


def replay_route(leaf_lo, leaf_hi, c, term=fmax_term, plan=None, seed=0):
    """(leaf, dist) as the wide kernel forms them under ``plan`` (rows a
    lane, G, leaves a group; route_wide_plan's by default)."""
    B, d = c.shape
    k = leaf_lo.shape[0]
    rt, G, lg = plan or route_wide_plan(B, k)
    rows = 32 * rt
    xs = d | 1
    reg = d <= WCOLS
    tk = WTK if reg else WTKA
    rng = np.random.default_rng(seed)
    s_rows = rng.normal(0, 9, rows * xs).astype(f32)       # stale
    s_lo = rng.normal(0, 9, (WW, WTK, WCOLS)).astype(f32)
    s_hi = rng.normal(0, 9, (WW, WTK, WCOLS)).astype(f32)
    out_leaf = np.empty(B, np.int32)
    out_dist = np.empty(B, f32)
    warps = route_warp_ranges(k, G, lg, WW)
    for row0 in range(0, B, rows):
        nrows = min(rows, B - row0)
        r = np.arange(rows)
        if reg:                       # a lane's rows (past B: row B - 1)
            x = c[np.minimum(row0 + r, B - 1)]
        else:                         # the staged tile (past B: zeros)
            for j in range(d):
                s_rows[r * xs + j] = np.where(
                    r < nrows, c[np.minimum(row0 + r, B - 1), j], 0)
            x = s_rows.reshape(rows, xs)[:, :d]             # read back
        block = np.full((G, rows), INF)
        block_i = np.zeros((G, rows), np.int64)
        for g in range(G):
            wb = np.full((WW, rows), INF)
            wi = np.zeros((WW, rows), np.int64)
            for w, rg in enumerate(warps[g]):
                wi[w] = rg.start
                for base in range(rg.start, rg.stop, tk):
                    n = min(tk, rg.stop - base)
                    dist = np.zeros((rows, n), f32)
                    for j0 in range(0, d, WCOLS):
                        nj = min(WCOLS, d - j0)
                        s_lo[w, :n, :nj] = leaf_lo[base:base + n, j0:j0 + nj]
                        s_hi[w, :n, :nj] = leaf_hi[base:base + n, j0:j0 + nj]
                        # up to WCOLS columns 4 * ceil(d / 4) of them, the
                        # rows' and the boxes' columns past d +0.0
                        cols = -(-nj // 4) * 4 if reg else nj
                        s_lo[w, :, nj:cols] = 0
                        s_hi[w, :, nj:cols] = 0
                        xb = np.zeros((rows, cols), f32)
                        xb[:, :nj] = x[:, j0:j0 + nj]
                        for j in range(cols):
                            t = term(s_lo[w, None, :n, j], s_hi[w, None, :n, j],
                                     xb[:, j, None])
                            dist = t if j0 + j == 0 else (dist + t).astype(f32)
                    for l in range(n):
                        win = dist[:, l] < wb[w]
                        wb[w] = np.where(win, dist[:, l], wb[w])
                        wi[w] = np.where(win, base + l, wi[w])
            bd, bl = np.full(rows, INF), np.zeros(rows, np.int64)
            for w in range(WW):                 # the warps, in order
                win = wb[w] < bd
                bd, bl = np.where(win, wb[w], bd), np.where(win, wi[w], bl)
            block[g], block_i[g] = bd, bl
        bd, bl = np.full(rows, INF), np.zeros(rows, np.int64)
        for g in range(G):                      # the cluster, in rank order
            win = block[g] < bd
            bd, bl = np.where(win, block[g], bd), np.where(win, block_i[g], bl)
        out_leaf[row0:row0 + nrows] = bl[:nrows]
        out_dist[row0:row0 + nrows] = (bd[:nrows] + f32(0)).astype(f32)
    return out_leaf, out_dist


def route_case(seed, B, k, d, ties=True):
    """Boxes on a coarse grid (touching faces, rows on them) and an
    inverted +-inf box; with ``ties`` copies of box k // 3 on both sides
    of every warp and group edge of route_wide_plan(B, k) and a third of
    the rows inside it, whose least distance (0) then sits in several
    sub-ranges and ranks. Returns the boxes, the rows and the lowest id of
    that box's copies."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 6, (k, d)).astype(f32)
    hi = lo + rng.integers(0, 3, (k, d)).astype(f32)
    c = np.where(rng.random((B, d)) < 0.5, rng.integers(-2, 9, (B, d)),
                 rng.uniform(-2, 9, (B, d))).astype(f32)
    lo[k // 2], hi[k // 2] = INF, -INF
    x = k // 3
    first = x
    if ties:
        _, G, lg = route_wide_plan(B, k)
        for ranges in route_warp_ranges(k, G, lg, WW):
            for rg in ranges:
                for at in (rg.start - 1, rg.start, rg.stop - 1, rg.stop):
                    if 0 <= at < k and at != k // 2:
                        lo[at], hi[at] = lo[x], hi[x]
                        first = min(first, at)
        c[: B // 3] = lo[x] + 0.5 * (hi[x] - lo[x])
    return lo, hi, c, first


def bits(x):
    return np.asarray(x, f32).view(np.int32)


@pytest.mark.parametrize("d, B, k", [(17, 100, 257), (24, 130, 1024),
                                     (33, 70, 37), (24, 4096, 19)])
def test_route_replay_bit_equal_to_plain(d, B, k):
    """Finite rows: the plain version's leaf and distance bits; ties on
    both sides of every warp and group edge (the lowest id wins), B and k
    off the tiles, d = 33 through the carried column blocks."""
    lo, hi, c, first = route_case(4100 + d + B + k, B, k, d)
    leaf, dist = replay_route(lo, hi, c)
    want_leaf, want_dist = route_multid_plain(*map(torch.from_numpy,
                                                   (lo, hi, c)))
    np.testing.assert_array_equal(leaf, want_leaf.numpy())
    np.testing.assert_array_equal(bits(dist), bits(want_dist.numpy()))
    assert (leaf[: B // 3] == first).all() and (dist[: B // 3] == 0).all()


def test_route_plan_splits_leaves_into_ascending_sub_ranges():
    for B, k in ((4096, 1024), (65536, 1024), (1000, 257), (1, 1),
                 (4096, 7), (300, 2049)):
        rt, G, lg = route_wide_plan(B, k)
        assert rt in (1, 2) and G in (1, 2, 4, 8) and G * lg >= k
        flat = [leaf for ranges in route_warp_ranges(k, G, lg, WW)
                for rg in ranges for leaf in rg]
        assert flat == list(range(k))
        for g, ranges in enumerate(route_warp_ranges(k, G, lg, WW)):
            assert ranges[0].start == route_groups(k, G, lg)[g].start
    # B = 4096: 512 blocks of 4 warps, 16 warps an SM of 132
    assert route_wide_plan(4096, 1024) == (2, 8, 128)


@pytest.mark.parametrize("d", [17, 24, 33])
def test_route_replay_nonfinite_rows(d):
    """Rows with NaN and +-inf coordinates: under the kernel's fmaxf term
    the replay equals a dense fmaxf oracle (a term is never NaN, so every
    distance is a number or +inf); under a NaN-propagating maximum it
    equals the column-block layout (test_torch_wide._replay_route)
    bit for bit."""
    B, k = 96, 53
    lo, hi, c, _ = route_case(900 + d, B, k, d, ties=False)
    u = np.random.default_rng(d).random((B, d))
    c[u < 0.05] = np.nan
    c[(u >= 0.05) & (u < 0.1)] = np.inf
    c[(u >= 0.1) & (u < 0.15)] = -np.inf
    assert not np.isfinite(c).all(1).all()
    leaf, dist = replay_route(lo, hi, c)
    full = np.zeros((B, k), f32)
    for j in range(d):
        t = fmax_term(lo[None, :, j], hi[None, :, j], c[:, j, None])
        full = t if j == 0 else (full + t).astype(f32)
    assert not np.isnan(full).any()
    want = np.argmin(full, 1)
    np.testing.assert_array_equal(leaf, want)
    np.testing.assert_array_equal(
        bits(dist), bits(full[np.arange(B), want] + f32(0)))
    old_leaf, old_dist = _replay_route(lo, hi, c)
    new_leaf, new_dist = replay_route(lo, hi, c, term=max_term)
    np.testing.assert_array_equal(new_leaf, old_leaf)
    np.testing.assert_array_equal(bits(new_dist), bits(old_dist))


def test_route_replay_matches_jax():
    """One case against the JAX package's dense oracle."""
    lo, hi, c, _ = route_case(24, 200, 150, 24)
    leaf, dist = replay_route(lo, hi, c)
    j_leaf, j_dist = route_multid_dense(*map(jnp.asarray, (lo, hi, c)))
    np.testing.assert_array_equal(leaf, np.asarray(j_leaf))
    np.testing.assert_array_equal(bits(dist), bits(np.asarray(j_dist)))
