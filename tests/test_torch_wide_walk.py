"""The walk of rows 2 and 8's mixed pairs above 16 columns
(csrc/pair_tiles.cuh walk_wide, called by pair_tile_wide_kernel and
pair_chunk_wide_kernel) replayed in torch, against the plain versions and
the JAX package's jnp backend.

While the wide kernels classify a (query, leaf) pair (above one slot chunk
a (query, leaf, chunk) triple) from the box around the leaf's valid slots,
they note the columns that cut it: the query does not hold the box there,
or a valid slot has a NaN coordinate there (csrc/wide_cols.cuh). The one
pass keeps, for each query of a tile, the columns that cut any of its
pairs with the tile's leaves; the chunk tiles keep each triple's own. Up
to CUT_MAX of them go in a cut word; with more, the pair tests every
column. The walks go in rounds of WALK_T pairs, listed leaf by leaf: the
block stages the round's leaves' values, valid bits and the columns its
pairs need (the union of their cut columns, or every column when one pair
tests every column) for as many windows of WALK_WIN slots as the room
holds, else one window at a time with the columns in stages of `room`,
and each pair ANDs its valid bits with the bits of its own cut columns,
then adds the window's slots in order. The chunk's own partial cuts only
its NaN columns, under the unbounded box.
The CUDA kernels run only on the card (chip_smoke.py phases 29-30 hold them
to the plain versions and to the previous kernels' bits there); here that
walk is replayed with its round and room as parameters (the kernels' and
smaller ones): each round writes its values, valid bits and needed
columns into staged buffers at the kernel's offsets (the needed columns'
prefix counts, [leaf][column][window][slot] rows, stages written over the
last) and tests and adds what it reads back from there, so a layout whose
writes and reads disagree changes the bits or the values. Held:

* each mixed pair's added slots equal the plain version's predicate
  (samples_inside) bit for bit, and the values read back are the slots';
* row 2: the slot-order fold of those values from +0.0 (add_slot; chunks of
  PAIR_CHUNK folded in order) bit for bit, its counts equal to
  stratified_moments_plain's and its sums within rtol=3e-5, atol=1e-3 of
  it (plain sums in torch's order, another order than the kernel's);
  plain within the same bar of the jnp backend's sample_moments;
* row 8: bit for bit (NaN as one code) to sample_extremes_plain, and plain
  to the jnp backend's sample_extremes.
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
from repro_torch.kernels.sample_extremes import BIG, sample_extremes_plain
from repro_torch.kernels.stratified_estimate import (
    PAIR_CHUNK, samples_inside, stratified_moments_plain)
from test_torch_pair_chunks import bits, slot_order_moments

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
RTOL, ATOL = 3e-5, 1e-3
# The layout of csrc/pair_tiles.cuh and csrc/wide_cols.cuh, held to the
# sources by test_layout_constants_match_the_sources.
CUT_MAX, CUT_COLS = 4, 1024
WALK_WIN, WALK_ROW, WALK_T, LT, WALK_ROWS = 32, 36, 256, 16, 16
# The staged rows' room (floats): WALK_X_BYTES, over which the one pass's
# tile (moments: 3 floats a pair; extremes: 2 planes of one) and a column
# block's query bounds (2 x 128 x 16 floats) lie; the chunk tiles' own.
WALK_X_FLOATS = 32768 // 4
ROOM_FLOATS = {2: max(3 * 128 * 16, 2 * 128 * 16, WALK_X_FLOATS),
               8: max(2 * 128 * 16, 2 * 128 * 16, WALK_X_FLOATS)}
CHUNK_ROOM_FLOATS = WALK_X_FLOATS
NONE16, ALL16 = 0xFFFF, 0xFFFE
MASK64 = (1 << 64) - 1
ALL = int.from_bytes(bytes.fromhex("fffefffefffefffe"), "big")


def cut_word(cols):
    """The kernels' cut word of a pair whose cut columns are ``cols``
    (appended in column order, add_cut): the last CUT_MAX in 16-bit
    fields, the newest lowest, 0xffff where none; CUT_ALL once a column is
    appended to a full word."""
    cw, over = MASK64, False
    for j in cols:
        over |= (cw >> 48) != NONE16
        cw = (cw << 16 | j) & MASK64
    return ALL if over else cw


def word_cols(cw):
    """The columns a cut word tests (cut_col), or None for every column."""
    if cw == ALL:
        return None
    return [f for f in ((cw >> (16 * t)) & 0xFFFF for t in range(CUT_MAX))
            if f < CUT_COLS]


def boxes(c, valid):
    """The box of each leaf's valid slots (fminf / fmaxf: NaN skipped,
    +inf / -inf where none) and the per-column flag of a NaN coordinate on
    a valid slot: (k, d) each."""
    on = valid[..., None] & ~torch.isnan(c)
    blo = torch.where(on, c, float("inf")).amin(1)
    bhi = torch.where(on, c, float("-inf")).amax(1)
    cnan = (valid[..., None] & torch.isnan(c)).any(1)
    return blo, bhi, cnan


def classes_and_cuts(blo, bhi, cnan, q_lo, q_hi):
    """(Q, k) covered, apart and (Q, k, d) cut masks by the slot test's
    compares: a column cuts a pair where the query does not hold the box
    or a valid slot has NaN."""
    ql, qh = q_lo[:, None, :], q_hi[:, None, :]
    holds = (ql <= blo[None]) & (bhi[None] <= qh)
    covered = ~cnan.any(-1)[None] & holds.all(-1)
    apart = ((qh < blo[None]) | (bhi[None] < ql)).any(-1)
    return covered, apart, ~holds | cnan[None]


def need_layout(words, d):
    """The round's needed columns as walk_wide lays them out: the need
    words (bit j % 32 of word j // 32 for a column some pair's cut word
    holds), their exclusive prefix counts ``pre``, the staged column list
    ``col`` (word by word, bit by bit) and ``nu`` staged columns (every
    column, with ``col`` unused, once a pair tests every column). Returns
    (all, need, pre, col, nu)."""
    every = any(w == ALL for w in words)
    need = [0] * (CUT_COLS // 32)
    if not every:
        for w in words:
            for j in word_cols(w):
                need[j >> 5] |= 1 << (j & 31)
    pre, col, at = [], [], 0
    for wd, word in enumerate(need):
        pre.append(at)
        at += bin(word).count("1")
        col += [wd * 32 + b for b in range(32) if word >> b & 1]
    return every, need, pre, col, (d if every else len(col))


def staged_pos(cw, every, need, pre):
    """The staged position of each of a cut word's CUT_MAX fields (-1 past
    its columns and for a word that tests every column): the column itself
    when every column is staged, else its word's prefix count plus the
    need bits below it."""
    out = []
    for f in range(CUT_MAX):
        j = (cw >> (16 * f)) & 0xFFFF
        if cw == ALL or j >= CUT_COLS:
            out.append(-1)
        elif every:
            out.append(j)
        else:
            out.append(pre[j >> 5]
                       + bin(need[j >> 5] & ((1 << (j & 31)) - 1)).count("1"))
    return out


def walk_round(room, flat, d, o, ls, nlr, ns, lrs, qs, words, q_lo, q_hi,
               room_cols=None):
    """One round of walk_wide over flat = (c, a, valid) flattened: its
    pairs' leaf rows ``lrs`` (slots i < ns of row lr at o + lr * ls + i),
    queries ``qs`` (-1: the unbounded box) and cut words. The round's
    values, valid bits and needed columns are written into the staged
    buffers ``room`` = (x, a) at the kernel's offsets ([leaf][column]
    [window][slot] rows of WALK_ROW floats; (leaf, window) rows of the
    values) and every test and add reads them back from there at the
    kernel's offsets, so a layout whose writes and reads disagree shows.
    ``room_cols``: stages of that many columns in place of the room's.
    Returns the (P, ns) slots added and the (P, ns) values added (0.0
    where none)."""
    x, ra = room
    cf, af, vf = flat
    every, need, pre, col, nu = need_layout(words, d)
    P = len(words)
    lr = torch.tensor(lrs)
    is_all = torch.tensor([w == ALL for w in words])
    pos = torch.tensor([staged_pos(w, every, need, pre) for w in words])
    lo = torch.full((P, CUT_MAX), float("-inf"))
    hi = torch.full((P, CUT_MAX), float("inf"))
    for e, (q, w) in enumerate(zip(qs, words)):
        for f in range(CUT_MAX):
            j = (w >> (16 * f)) & 0xFFFF
            if q >= 0 and w != ALL and j < CUT_COLS:
                lo[e, f], hi[e, f] = q_lo[q, j], q_hi[q, j]
    qlo = torch.stack([q_lo[q] if q >= 0 else torch.full((d,), float(
        "-inf")) for q in qs])
    qhi = torch.stack([q_hi[q] if q >= 0 else torch.full((d,), float(
        "inf")) for q in qs])
    cap = x.numel() // WALK_ROW
    rm = room_cols or min(WALK_T, cap // nlr)
    wps = 1
    if nu <= rm:
        rm = max(nu, 1)
        wps = max(1, min(WALK_ROWS // nlr, cap // (nlr * rm)))
    added = torch.zeros((P, ns), dtype=torch.bool)
    vals = torch.zeros((P, ns), dtype=torch.float32)
    b = torch.arange(WALK_WIN)
    kw = torch.arange(wps * WALK_WIN)
    col_t = torch.tensor(col, dtype=torch.long)
    for i0 in range(0, ns, wps * WALK_WIN):
        nw = min(wps, -(-(ns - i0) // WALK_WIN))
        rows = nlr * nw * WALK_WIN
        assert rows <= ra.numel()
        tt = torch.arange(rows)
        i = i0 + tt % (nw * WALK_WIN)
        at = o + tt // (nw * WALK_WIN) * ls + i
        inn = i < ns
        ra[tt[inn]] = af[at[inn]]
        vbits = (inn & vf[at.clamp(max=vf.numel() - 1)]).reshape(-1, WALK_WIN)
        wi = torch.arange(nw)
        row = lr[:, None] * nw + wi                      # (P, nw)
        m = None
        for u0 in range(0, max(nu, 1), rm):
            nuc = min(rm, nu - u0)
            if nuc > 0:
                assert nlr * nuc * nw * WALK_ROW <= x.numel()
                ll, uu, kk = torch.meshgrid(torch.arange(nlr),
                                            torch.arange(nuc), kw[:nw * WALK_WIN],
                                            indexing="ij")
                keep = i0 + kk < ns
                cu = uu + u0 if every else col_t[uu + u0]
                dest = ((ll * nuc + uu) * nw + kk // WALK_WIN) * WALK_ROW \
                    + kk % WALK_WIN
                x[dest[keep]] = cf[((o + ll * ls + i0 + kk) * d + cu)[keep]]
            last = u0 + rm >= nu
            # Every window of the stage at once: (P, nw, 32) bits.
            mw = m if u0 > 0 else vbits[row]
            if nuc > 0:
                xl = (lr[:, None] * nuc * nw + wi) * WALK_ROW    # (P, nw)
                if bool(is_all.any()):
                    u = torch.arange(nuc)
                    xs = x[xl[..., None, None] + (u * nw * WALK_ROW)[
                        :, None] + b]                      # (P, nw, nuc, 32)
                    ins = ((qlo[:, None, u0:u0 + nuc, None] <= xs)
                           & (xs <= qhi[:, None, u0:u0 + nuc, None])).all(2)
                    mw = torch.where(is_all[:, None, None], mw & ins, mw)
                # The pair's own columns, every field at once.
                u = pos - u0                                     # (P, CUT_MAX)
                use = (pos >= 0) & (u >= 0) & (u < nuc)
                xs = x[(xl[:, None] + (u.clamp(0, nuc - 1) * nw * WALK_ROW)[
                    ..., None])[..., None] + b]      # (P, CUT_MAX, nw, 32)
                ins = (lo[..., None, None] <= xs) & (xs <= hi[..., None, None])
                mw = mw & (ins | ~use[..., None, None]).all(1)
            m = mw
            if last:
                n = min(nw * WALK_WIN, ns - i0)
                added[:, i0:i0 + n] = mw.reshape(P, -1)[:, :n]
                got = ra[(row * WALK_WIN)[..., None] + b]
                vals[:, i0:i0 + n] = torch.where(mw, got, 0.0).reshape(
                    P, -1)[:, :n]
    return added, vals


def walk_lists(pairs, k, round_t, per_leaf):
    """The walks' rounds of ``round_t`` listed pairs, as lists of indices
    into ``pairs`` ((q, leaf)): the one pass lists each LT-leaf tile's
    mixed pairs leaf by leaf (a bucket a leaf), a chunk item (per_leaf)
    its leaf's chunk's own partial (q = -1) then its mixed queries."""
    order = sorted(range(len(pairs)), key=lambda e: (pairs[e][1],
                                                     pairs[e][0] >= 0))
    span = 1 if per_leaf else LT
    rounds = []
    for t0 in range(0, k, span):
        mine = [e for e in order if t0 <= pairs[e][1] < t0 + span]
        rounds += [mine[r0:r0 + round_t]
                   for r0 in range(0, len(mine), round_t)]
    return rounds


def query_words(cut, k):
    """The one pass's cut word of each (query, leaf): its query's columns
    that cut any pair with a leaf of the same LT-leaf tile, in column
    order."""
    out = {}
    for t0 in range(0, k, LT):
        union = cut[:, t0:t0 + LT].any(1)                  # (Q, d)
        for q in range(cut.shape[0]):
            w = cut_word(torch.nonzero(union[q]).flatten().tolist())
            out.update({(q, lf): w for lf in range(t0, min(k, t0 + LT))})
    return out


def replay(c, a, valid, q_lo, q_hi, round_t=WALK_T, room_cols=None,
           row=2):
    """Row 2's (Q, k, 3) moments or row 8's (min, max) as the wide kernels
    compute them: one pass up to PAIR_CHUNK slots, each mixed pair walked
    with its query's cut word over the leaf tile (query_words); chunks
    above it, each mixed triple walked with its own cut word, the chunk's
    own partial under the unbounded box with its NaN columns cut, the
    partials folded in chunk order. The walks go in rounds (walk_lists)
    through walk_round's staged buffers, and their folds take the values
    read back from there. Also returns whether every mixed pair's added
    slots are plain's predicate's and their values the slots' own, and
    the number of columns each walked pair's word held (CUT_MAX + 1 for
    every column)."""
    k, s, d = c.shape
    Q = q_lo.shape[0]
    inside = samples_inside(c, valid, q_lo, q_hi)
    one_pass = s <= PAIR_CHUNK
    x_floats = ROOM_FLOATS[row] if one_pass else CHUNK_ROOM_FLOATS
    # The staged rows and values, stale between rounds as shared memory.
    room = (torch.full((x_floats,), float("nan")),
            torch.full((WALK_ROWS * WALK_WIN,), float("nan")))
    flat = (c.reshape(-1), a.reshape(-1), valid.reshape(-1))
    if row == 2:
        acc = torch.zeros((Q, k, 3), dtype=torch.float32)
    else:
        acc = (torch.full((Q, k), float("inf")),
               torch.full((Q, k), float("-inf")))
    counts, agree = [], True
    step = PAIR_CHUNK if not one_pass else max(s, 1)
    for s0 in range(0, max(s, 1), step):
        s1 = min(s, s0 + step)
        ns = s1 - s0
        av, vv = a[:, s0:s1], valid[:, s0:s1]
        blo, bhi, cnan = boxes(c[:, s0:s1], vv)
        covered, apart, cut = classes_and_cuts(blo, bhi, cnan, q_lo, q_hi)
        mixed = ~covered & ~apart
        pairs = [(int(q), int(lf)) for q, lf in mixed.nonzero().tolist()]
        if one_pass:
            by_query = query_words(cut, k)
            words = [by_query[pr] for pr in pairs]
        else:
            words = [cut_word(torch.nonzero(cut[q, lf]).flatten().tolist())
                     for q, lf in pairs]
        counts += [CUT_MAX + 1 if word_cols(w) is None else len(word_cols(w))
                   for w in words]
        if not one_pass:  # the chunks' own partials: NaN columns cut
            pairs += [(-1, lf) for lf in range(k)]
            words += [cut_word(torch.nonzero(cnan[lf]).flatten().tolist())
                      for lf in range(k)]
        walk = torch.zeros((Q, k, ns), dtype=torch.bool)
        wval = torch.zeros((Q, k, ns), dtype=torch.float32)
        own, oval = vv, av
        if not one_pass:
            own = torch.zeros((k, ns), dtype=torch.bool)
            oval = torch.zeros((k, ns), dtype=torch.float32)
        for rnd in walk_lists(pairs, k, round_t, per_leaf=not one_pass):
            la, lb = pairs[rnd[0]][1], pairs[rnd[-1]][1]
            o, ls = (la * s, s) if one_pass else (la * s + s0, 0)
            added, vals = walk_round(
                room, flat, d, o, ls, lb - la + 1, ns,
                [pairs[e][1] - la for e in rnd], [pairs[e][0] for e in rnd],
                [words[e] for e in rnd], q_lo, q_hi, room_cols)
            for e, m, v in zip(rnd, added, vals):
                q, lf = pairs[e]
                agree &= bits(v[m]).tolist() == bits(av[lf][m]).tolist()
                if q < 0:
                    own[lf], oval[lf] = m, v
                else:
                    walk[q, lf], wval[q, lf] = m, v
                    agree &= bool(torch.equal(m, inside[q, lf, s0:s1]))
        if row == 2:
            part = torch.where(
                covered[..., None], slot_order_moments(oval, own)[None],
                torch.where(mixed[..., None],
                            slot_order_moments(wval, walk), 0.0))
            acc = acc + part
        else:
            mn = torch.where(covered,
                             minmax.masked_min(oval, own, BIG, -1)[None],
                             torch.where(mixed, minmax.masked_min(
                                 wval, walk, BIG, -1), BIG))
            mx = torch.where(covered,
                             minmax.masked_max(oval, own, -BIG, -1)[None],
                             torch.where(mixed, minmax.masked_max(
                                 wval, walk, -BIG, -1), -BIG))
            acc = (minmax.minimum(acc[0], mn), minmax.maximum(acc[1], mx))
    return acc, agree, counts


def slot_order_reference(c, a, valid, q_lo, q_hi):
    """Row 2's order contract on plain's predicate: each chunk of
    PAIR_CHUNK slots folded in slot order from +0.0, the chunks' partials
    added in order from +0.0 (one chunk up to PAIR_CHUNK slots)."""
    inside = samples_inside(c, valid, q_lo, q_hi)
    k, s, _ = c.shape
    acc = torch.zeros((q_lo.shape[0], k, 3), dtype=torch.float32)
    for s0 in range(0, max(s, 1), PAIR_CHUNK):
        acc = acc + slot_order_moments(
            a[None, :, s0:s0 + PAIR_CHUNK].expand(q_lo.shape[0], -1, -1),
            inside[..., s0:s0 + PAIR_CHUNK])
    return acc


def walk_case(seed, s, d, Q=18, k=LT + 1):
    """k leaves of s slots over d columns: leaf i's slots in band i of
    column 0, the others in (0.1, 0.9); ragged validity, invalid slots
    outside every query (5.0), leaf 3 without a valid slot; leaf 2's
    column 1 holds -0.0 and +0.0 as its smallest values; a NaN coordinate
    on a valid slot of leaf k - 1 (alone in the second leaf tile) in the
    last column, which no query bounds. Queries 0-15 hold column 0 whole
    (0-7) or span one or two leaf bands there (8-15) and bound n = 0, 1,
    CUT_MAX and CUT_MAX + 1 other columns inside the slots' extent (each of
    those cuts every leaf; the rest hold them); query 16 has leaf 4's
    extent in every column but the last (inclusive ends), 17 bounds column
    1 from -0.0 at leaf 2's zeros."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.1, 0.9, (k, s, d)).astype(np.float32)
    c[..., 0] = ((np.arange(k)[:, None] + rng.uniform(0.1, 0.9, (k, s)))
                 / k).astype(np.float32)
    a = rng.normal(0, 3, (k, s)).astype(np.float32)
    valid = rng.random((k, s)) < 0.8
    valid[:, 0] = valid[2, -1] = True
    valid[3] = False
    c[~valid] = 5.0
    c[2, :, 1] = np.abs(c[2, :, 1])
    c[2, 0, 1], c[2, -1, 1] = -0.0, 0.0
    c[k - 1, 0, d - 1] = np.nan
    q_lo = np.zeros((Q, d), np.float32)
    q_hi = np.ones((Q, d), np.float32)
    for i in range(16):
        if i >= 8:
            lf = int(rng.integers(0, k - 1))
            q_lo[i, 0], q_hi[i, 0] = lf / k, (lf + 1.5) / k
        n = (0, 1, CUT_MAX, CUT_MAX + 1)[i % 4]
        cols = 1 + rng.choice(d - 2, n, replace=False)
        q_lo[i, cols] = rng.uniform(0.2, 0.4, n)
        q_hi[i, cols] = rng.uniform(0.6, 0.8, n)
    q_lo[16] = c[4][valid[4]].min(0)
    q_hi[16] = c[4][valid[4]].max(0)
    q_lo[16, d - 1], q_hi[16, d - 1] = 0.0, 1.0
    q_lo[17, 0], q_hi[17, 0] = 2 / k, 3 / k
    q_lo[17, 1], q_hi[17, 1] = -0.0, 0.5
    return [torch.from_numpy(np.ascontiguousarray(x))
            for x in (c, a, valid, q_lo, q_hi)]


def _assert_moments(got, want, msg):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got[..., 0], want[..., 0],
                                  err_msg=f"{msg}: counts")
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=RTOL,
                               atol=ATOL, err_msg=f"{msg}: sums")


def _assert_bits(got, want, msg):
    g, w = bits(got), bits(want)
    assert g.shape == w.shape, (msg, g.shape, w.shape)
    assert np.array_equal(g, w), (
        f"{msg}: {int((g != w).sum())} values differ in their bits")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The replays' many small torch ops on one thread. Under several test
    workers torch's pool of a thread a core oversubscribes the machine and
    every op waits on it: test_wide_walk_replay[17-2049] took ~1.8 s alone
    and ~100 s in each of six processes at once on 8 cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WIDTHS = (17, 24, 33, 64)
SLOTS = (1, 31, 32, 33, 75, PAIR_CHUNK + 1)
JAX_SLOTS = (33, PAIR_CHUNK + 1)


@pytest.mark.parametrize("s", SLOTS)
@pytest.mark.parametrize("d", WIDTHS)
def test_wide_walk_replay(d, s):
    """Rows 2 and 8 replayed with the kernels' round and room: every mixed
    pair's slot bits are plain's, row 2 is the order contract's fold of
    them bit for bit and meets plain, row 8 is plain's bits; plain meets
    the jnp backend (at s = 33 and 2049). Pairs whose cut words hold 1 and CUT_MAX columns, and
    pairs past CUT_MAX (every column), are walked."""
    args = walk_case(1000 * d + s, s, d)
    got, agree, counts = replay(*args, row=2)
    assert agree
    assert {1, CUT_MAX, CUT_MAX + 1} <= set(counts) or s == 1, counts
    _assert_bits(got, slot_order_reference(*args), "row 2 vs the fold")
    want = stratified_moments_plain(*args)
    _assert_moments(got, want, "row 2 vs plain")
    (mn, mx), agree, _ = replay(*args, row=8)
    assert agree
    pmn, pmx = sample_extremes_plain(*args)
    _assert_bits(mn, pmn, "row 8 min vs plain")
    _assert_bits(mx, pmx, "row 8 max vs plain")
    if s in JAX_SLOTS:  # one compile a shape: two widths of slots
        jx = [jnp.asarray(x.numpy()) for x in args]
        _assert_moments(want, np.stack([np.asarray(x) for x in
                                        jax_sample_moments(*jx)], -1),
                        "plain vs jnp backend")
        jmn, jmx = get_backend("jnp").sample_extremes(*jx)
        _assert_bits(pmn, np.asarray(jmn), "plain min vs jnp backend")
        _assert_bits(pmx, np.asarray(jmx), "plain max vs jnp backend")


@pytest.mark.parametrize("round_t,room_cols", [(5, 1), (7, 2)])
@pytest.mark.parametrize("s", [75, PAIR_CHUNK + 1])
def test_small_rounds_and_rooms(s, round_t, room_cols):
    """Rounds of a few pairs (several leaves a round, several rounds a
    leaf) and stages of one or two columns, each stage's rows written
    over the last's: the added slots, their values read back from the
    staged rows and the folds are the same. Above one chunk 5 leaves (each
    chunk item walks its own leaf, one window a stage): walk_case's
    smallest table that keeps all its cases."""
    args = walk_case(7 + s, s, 24, k=LT + 1 if s <= PAIR_CHUNK else 5)
    got, agree, _ = replay(*args, round_t=round_t, room_cols=room_cols)
    assert agree
    _assert_bits(got, slot_order_reference(*args), "row 2 vs the fold")


def test_cut_words():
    """add_cut's word: up to CUT_MAX columns, the newest lowest, the rest
    0xffff; one more makes CUT_ALL; no column keeps CUT_NONE (the own
    partial of a chunk without NaN tests only the valid bits)."""
    assert word_cols(cut_word([])) == [] and cut_word([]) == MASK64
    assert word_cols(cut_word([3])) == [3]
    assert cut_word([3, 9]) == (MASK64 << 32 | 3 << 16 | 9) & MASK64
    cols = list(range(20, 20 + CUT_MAX))
    assert sorted(word_cols(cut_word(cols))) == cols
    assert cut_word(cols + [99]) == ALL and word_cols(ALL) is None
    assert ALL >> 48 == ALL16 and CUT_COLS < ALL16


def test_nan_column_is_cut_and_forces_its_test():
    """A NaN on a valid slot flags its column: the leaf is never covered,
    and every pair on it cuts that column, though no query bounds it, so
    the walk drops the slot as the plain test does."""
    c, a, valid, q_lo, q_hi = walk_case(5, 75, 24)
    last = c.shape[0] - 1
    blo, bhi, cnan = boxes(c, valid)
    assert bool(cnan[last, 23]) and int(cnan.sum()) == 1
    covered, apart, cut = classes_and_cuts(blo, bhi, cnan, q_lo, q_hi)
    assert not bool(covered[:, last].any())
    assert bool(cut[:, last, 23].all()) and not bool(cut[:, 0, 23].any())
    assert bool(((q_lo[:, 23] == 0) & (q_hi[:, 23] == 1)).all())
    mixed = (~covered & ~apart)[:, last]
    assert bool(mixed.any())
    got, agree, _ = replay(c, a, valid, q_lo, q_hi)
    assert agree
    assert bool((got[mixed, last, 0] < valid[last].sum()).all())


def test_edges_hold_where_they_should():
    """Bounds equal to the extent hold (inclusive ends), +0.0 holds -0.0,
    invalid slots far outside the query change no box, and a leaf without
    a valid slot is covered by every query (its box is empty)."""
    c, a, valid, q_lo, q_hi = walk_case(9, 33, 17)
    blo, bhi, cnan = boxes(c, valid)
    covered, _, cut = classes_and_cuts(blo, bhi, cnan, q_lo, q_hi)
    assert not bool(cut[16, 4].any())
    assert not bool(cut[0, 2, 1]) and bool(cut[17, 2, 1])
    assert float(blo[2, 1]) == 0.0 and float(bhi[0, 1]) < 1.0
    assert bool((bhi[:, 1:][valid.any(1)] < 5.0).all())
    assert not bool(valid[3].any()) and bool(covered[:, 3].all())


def has(src, text):
    """Whether ``src`` holds ``text``'s tokens in order, whatever the white
    space between them (line breaks and indentation may change)."""
    return re.search(r"\s*".join(map(re.escape, text.split())),
                     src) is not None


def test_layout_constants_match_the_sources():
    """The replay's layout is the sources': CUT_MAX, CUT_COLS (wide_cols.
    cuh), the window, its staged row, the block, the leaf tile and a
    stage's rows of values, the rooms (pair_tiles.cuh: WALK_X_BYTES, over
    which the one pass's tile and a column block's bounds lie), the staged
    rows' and values' offsets and the cut words' codes."""
    wide = (CSRC / "wide_cols.cuh").read_text()
    tiles = (CSRC / "pair_tiles.cuh").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;",
                             src).group(1))

    assert const(wide, "CUT_MAX") == CUT_MAX
    assert const(wide, "CUT_COLS") == CUT_COLS
    assert const(tiles, "WALK_WIN") == WALK_WIN
    assert const(tiles, "WALK_ROW") == WALK_ROW
    assert const(tiles, "NT") == WALK_T and const(tiles, "LT") == LT
    assert const(tiles, "SLOT_CHUNK") == PAIR_CHUNK
    assert const(tiles, "WALK_X_BYTES") == WALK_X_FLOATS * 4
    assert has(tiles, "constexpr int WALK_ROWS = LT;")
    assert has(tiles, "float* s_q = (float*)smem;")
    assert has(tiles, "walk_room(smem + L::walk, (float*)smem, L::box / 4);")
    assert has(tiles, "walk_room(smem + tail.walk, (float*)(smem + tail.x), "
                      "WALK_X_BYTES / 4);")
    assert has(tiles, "static constexpr int room = tile > 8 * QT * WIDE_COLS "
                      "? tile : 8 * QT * WIDE_COLS; static constexpr int box "
                      "= al16(room > WALK_X_BYTES ? room : WALK_X_BYTES);")
    # walk_round's offsets: the values and valid bits, the staged rows (and
    # their source), the window's rows and values read back.
    assert has(tiles, "const size_t at = t / (nw * WALK_WIN) * ls + i;")
    assert has(tiles, "cp_async4(r.a + t, a0 + at);")
    assert has(tiles, "cp_async4(r.x + ((l * nuc + u) * nw + k / WALK_WIN) * "
                      "WALK_ROW + k % WALK_WIN, src + (l * ls + i0 + k) * "
                      "(size_t)d);")
    assert has(tiles, "const float* xl = r.x + (lr * nuc * nw + wi) * "
                      "WALK_ROW;")
    assert has(tiles, "const float* row = xl + u * nw * WALK_ROW;")
    assert has(tiles, "const float* ar = r.a + (lr * nw + wi) * WALK_WIN;")
    assert has(tiles, ": r.pre[j >> 5] + __popc(need[j >> 5] & ((1u << (j & "
                      "31)) - 1u));")
    assert has(wide, "CUT_ALL = 0xfffefffefffefffeull")
    assert ALL == 0xFFFEFFFEFFFEFFFE
