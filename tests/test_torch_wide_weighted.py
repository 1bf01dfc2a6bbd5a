"""Rows 3 and 4 above 16 columns (csrc/weighted_moments.cu: the wide box,
tile and group-walk kernels) replayed in torch, against the slot-order
folds of ``test_torch_weighted_chunks.replay``, the plain versions and
the JAX package's jnp backend.

The box kernel writes each segment's box around its valid slots, its
valid bits and its NaN columns (a valid slot with a NaN coordinate
there). The class kernel classifies each (query, segment) pair a column
block of 16 at a time, notes the columns that cut it (the query does not
hold the box there, or a NaN column: wide_cols.cuh) and writes each
pair's class and a MAYBE pair's cut word. The test kernel tests a MAYBE
pair only on those (every column past CUT_MAX of them), a run of _WTQ
queries of a segment at a time, from the segment's 32-slot words staged
_WTB columns at a time for the blocks any pair of the run needs, and
writes the slot masks. The group walk then writes every float of the output,
a group of up to 8 segments at a time: a lane a replicate (units of 32,
the group's weights staged [slot][replicate]) or a lane a query (a unit a
replicate, the group's terms staged), T for a covered pair, +0.0 for an
empty one, the slot-order fold of the mask's slots for a MAYBE one.
The CUDA kernels run only on the card (chip_smoke.py phases 29-30 hold
them to plain and to the previous kernels' bits there); here the staged
words are written and read back at the kernel's offsets (unstaged floats
hold NaN, so a read of one clears bits), and so are the walk's staged
weights, terms and store rows. Held:

* the classes, the cut words (their CUT_ALL fallback included) and every
  MAYBE pair's masks, bit for bit those of samples_inside;
* every (pair, replicate) of the walk's output bit for bit the slot-order
  fold of plain's relevant slots (chunks of WEIGHTED_CHUNK folded in
  order), at R on both sides of WEIGHTED_PAIR_R;
* weighted_moments_plain / bootstrap_moments_plain within rtol=3e-5,
  atol=1e-3 of that fold and of the jnp backend;
* the launch's constants and layout against the source.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import backends as _jax_backends  # noqa: F401 (registers)
from repro.kernels.registry import get_backend
from repro_torch.kernels.bootstrap import bootstrap_moments_plain
from repro_torch.kernels.stratified_estimate import (
    WEIGHTED_CHUNK, WEIGHTED_PAIR_R, _WGRB, _WGROUP, _WLT_MAX, _WMAX_D,
    _WQRY_STAGE, _WREPS_STAGE, _WTB, _WTQ, samples_inside,
    weighted_chunks, weighted_group, weighted_moments_plain, weighted_plan,
    weighted_scratch_floats, weighted_walk)
from test_torch_weighted_chunks import replay, slot_fold
from test_torch_wide_walk import ALL, CUT_COLS, CUT_MAX, cut_word, word_cols

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
C = WEIGHTED_CHUNK
COLS = _WMAX_D  # columns a block of the class kernel
XP = _WTB + 1  # floats a staged slot row of the test kernel
WG = 4  # words a stage of the test kernel
EMPTY, COVERED, MAYBE = 0, 1, 2
RTOL, ATOL = 3e-5, 1e-3
NAN = float("nan")


def wide_inputs(Q, k, s, d, R, seed, many=False, nan=False, bad=True):
    """Stratum i's slots in band i of column 0 (chunk j of them in the
    j-th part of the band), the other columns uniform in (0.05, 0.95);
    ragged validity, stratum k // 2 without a valid slot; Poisson and
    non-integer weights, with ``bad`` NaN and +-inf in ``a`` and W on
    invalid slots (which the plain versions' products do not skip).
    Query 0 holds everything, 1 misses everything; the others cut column 0
    at band edges and bound 2-4 other columns (5-8 with ``many``: pairs
    past CUT_MAX cut columns). ``nan``: NaN coordinates on valid slots, in
    the last column of stratum k - 1's last chunk and in column 17 % d of
    stratum 1's first 40 slots."""
    rng = np.random.default_rng(seed)
    n_ch = weighted_chunks(s)
    c = rng.uniform(0.05, 0.95, (k, s, d)).astype(np.float32)
    band = np.minimum(np.arange(s) // C, n_ch - 1)[None]
    c[..., 0] = ((np.arange(k)[:, None] + (band + rng.uniform(
        0.05, 0.95, (k, s))) / n_ch) / k).astype(np.float32)
    a = rng.normal(0, 3, (k, s)).astype(np.float32)
    valid = rng.random((k, s)) < 0.8
    valid[k // 2] = False
    W = rng.poisson(1.0, (R, k, s)).astype(np.float32)
    W[:, :, ::3] = rng.uniform(0, 2.5, W[:, :, ::3].shape)
    if bad:
        x = np.array([np.nan, np.inf, -np.inf], np.float32)
        off = ~valid
        a[off] = x[np.arange(int(off.sum())) % 3]
        W[:, off] = x[(np.arange(R)[:, None] + np.arange(int(off.sum())))
                      % 3]
    q_lo = np.full((Q, d), -1.0, np.float32)
    q_hi = np.full((Q, d), 2.0, np.float32)
    lo_n, hi_n = (5, 9) if many else (2, 5)
    for i in range(2, Q):
        cols = 1 + rng.choice(d - 1, int(rng.integers(lo_n, hi_n)),
                              replace=False)
        q_lo[i, cols] = rng.uniform(0.0, 0.5, cols.size)
        q_hi[i, cols] = q_lo[i, cols] + rng.uniform(0.3, 0.7, cols.size)
        start, span = rng.integers(0, k), rng.integers(1, 3)
        q_lo[i, 0] = (start + rng.integers(0, n_ch + 1) / n_ch * 0.9) / k
        q_hi[i, 0] = (start + span - 1 + 0.05
                      + rng.integers(0, n_ch + 1) / n_ch * 0.9) / k
    q_lo[1], q_hi[1] = 5.0, 6.0
    if nan:
        on = np.flatnonzero(valid[k - 1, (n_ch - 1) * C:])
        if on.size:
            c[k - 1, (n_ch - 1) * C + on[0], d - 1] = np.nan
        c[1, :40, 17 % d] = np.nan
    return [torch.from_numpy(np.ascontiguousarray(x))
            for x in (c, a, valid, W, q_lo, q_hi)]


def segments(k, s):
    """(leaf, first slot, length) of each segment g = leaf * n_ch + ch."""
    n_ch = weighted_chunks(s)
    return [(g // n_ch, (g % n_ch) * C, min(C, s - (g % n_ch) * C))
            for g in range(k * n_ch)]


def box_pass(c, valid, segs):
    """weighted_box_wide_kernel: (K, d) box (fminf / fmaxf: NaN skipped,
    +inf / -inf where no valid slot), (K, d) NaN columns, (K, nw) valid
    bits as ints."""
    d = c.shape[2]
    nw = -(-min(c.shape[1], C) // 32)
    lo, hi, cnan, vb = [], [], [], []
    for leaf, s0, n in segs:
        cv, vv = c[leaf, s0:s0 + n], valid[leaf, s0:s0 + n]
        on = vv[:, None] & ~torch.isnan(cv)
        lo.append(torch.where(on, cv, float("inf")).amin(0) if n else
                  torch.full((d,), float("inf")))
        hi.append(torch.where(on, cv, float("-inf")).amax(0) if n else
                  torch.full((d,), float("-inf")))
        cnan.append((vv[:, None] & torch.isnan(cv)).any(0))
        vb.append([sum(1 << b for b in range(32)
                       if w * 32 + b < n and bool(vv[w * 32 + b]))
                   for w in range(nw)])
    return torch.stack(lo), torch.stack(hi), torch.stack(cnan), vb


def class_pass(lo, hi, cnan, q_lo, q_hi):
    """weighted_class_wide_kernel: (K, Q) classes, and each MAYBE pair's
    cut word (its columns in ascending order through add_cut, CUT_ALL past
    CUT_COLS columns). The kernel compares only the columns where the
    query does not hold its tile's box (the tile's LT_MAX segments' boxes
    folded): the classes of the all-column compares, but for a pair whose
    segment's valid slots are all NaN in a column (its box inverted
    there), which that column alone would call empty and which the kernel
    may call MAYBE; its slot tests then find no slot."""
    ql, qh = q_lo[None], q_hi[None]                       # (1, Q, d)
    holds = (ql <= lo[:, None]) & (hi[:, None] <= qh)     # (K, Q, d)
    covered = ~cnan.any(-1)[:, None] & holds.all(-1)
    apart = ((qh < lo[:, None]) | (hi[:, None] < ql)).any(-1)
    test = torch.zeros_like(holds)
    K, d = lo.shape
    for g0 in range(0, K, _WLT_MAX):
        tlo = lo[g0:g0 + _WLT_MAX].amin(0)
        thi = hi[g0:g0 + _WLT_MAX].amax(0)
        test[g0:g0 + _WLT_MAX] = ~((q_lo <= tlo) & (thi <= q_hi))[None]
    h = holds | ~test
    cov = ~cnan.any(-1)[:, None] & h.all(-1)
    ap = (((qh < lo[:, None]) | (hi[:, None] < ql)) & test).any(-1)
    assert torch.equal(cov, covered)
    assert not (ap & ~apart).any()
    assert (apart & ~ap & ~cov <= (lo > hi).any(-1)[:, None]).all()
    cls = torch.where(cov, COVERED, torch.where(ap, EMPTY, MAYBE))
    cut = ~h | cnan[:, None]
    words = {}
    for g, q in (cls == MAYBE).nonzero().tolist():
        words[g, q] = (ALL if d > CUT_COLS else
                       cut_word(torch.nonzero(cut[g, q]).flatten().tolist()))
    return cls, words


def ballot_bits(buf, cc, lo, hi):
    """The ballot of the warp's 32 lanes, lane b on slot b's row of a
    staged word ([32][XP]): bit b iff lo <= row b's column cc <= hi,
    for (pairs,) columns and bounds: (pairs,) ints."""
    x = buf[:, cc].T                                       # (pairs, 32)
    ok = (lo[:, None] <= x) & (x <= hi[:, None])
    return (ok.long() << torch.arange(32)).sum(-1)


def mask_pass(c, segs, cls, words, vb, q_lo, q_hi):
    """weighted_test_wide_kernel, a (segment, run of _WTQ queries) at a
    time: the column blocks of _WTB its MAYBE pairs' cut words name (every
    block when one pair has CUT_ALL), staged a (group of WG words, block)
    at a time into a buffer of WG * 32 rows of XP NaN at the kernel's
    offsets, each pair ANDing each word's valid bits with the ballots of
    its own columns there. Returns {(g, q): [mask words]}."""
    k, s, d = c.shape
    flat = c.reshape(-1)
    nblk = -(-d // _WTB)
    K, Q = cls.shape
    tid = torch.arange(WG * 32 * _WTB)
    out = {}
    for q0 in range(0, Q, _WTQ):
        for g in range(K):
            qs = [q for q in range(q0, min(Q, q0 + _WTQ))
                  if cls[g, q] == MAYBE]
            if not qs:
                continue
            leaf, s0, n = segs[g]
            cols = {q: word_cols(words[g, q]) for q in qs}
            every = [q for q in qs if cols[q] is None]
            need = sorted({j // _WTB for q in qs if cols[q] is not None
                           for j in cols[q]})
            blocks = list(range(nblk)) if every or nblk > 64 else need
            nwd = -(-n // 32)
            masks = {q: [] for q in qs}
            for w0 in range(0, nwd, WG):
                nwg = min(WG, nwd - w0)
                bits = {q: [vb[g][w0 + i] for i in range(nwg)] for q in qs}
                for jb in blocks:
                    jc, nj = jb * _WTB, min(_WTB, d - jb * _WTB)
                    buf = torch.full((WG * 32 * XP,), NAN)
                    r, cc = tid // _WTB, tid % _WTB
                    on = (r < min(WG * 32, n - w0 * 32)) & (cc < nj)
                    src = (leaf * s + s0 + w0 * 32 + r) * d + jc + cc
                    buf[(r * XP + cc)[on]] = flat[src[on]]
                    buf = buf.view(WG, 32, XP)
                    for q in qs:
                        use = (list(range(jc, jc + nj)) if cols[q] is None
                               else [j for j in cols[q]
                                     if jc <= j < jc + nj])
                        if not use:
                            continue
                        j = torch.tensor(use)
                        for i in range(nwg):
                            got = ballot_bits(buf[i], j - jc, q_lo[q, j],
                                              q_hi[q, j])
                            for x in got.tolist():
                                bits[q][i] &= x
                for q in qs:
                    masks[q] += bits[q]
            out.update({(g, q): masks[q] for q in qs})
    return out


def totals(W, a, valid, segs):
    """T (R, K, 3): each segment's valid slots folded in slot order."""
    return torch.stack([slot_fold(W[:, leaf, s0:s0 + n], a[leaf, s0:s0 + n],
                                  valid[leaf, s0:s0 + n].expand(
                                      W.shape[0], n))
                        for leaf, s0, n in segs], 1)


def group_walk(a, W, segs, cls, masks, T, Q, s):
    """The group walk's (R, Q, K, 3): each unit's weights, a and totals
    (lane = replicate) or terms and totals (lane = query) staged at the
    kernel's offsets, each (query, segment) T, +0.0 or the fold of its
    mask's staged slots in slot order, each row of the group's gs x 3
    floats written at its flat offset."""
    R = W.shape[0]
    K = len(segs)
    k = a.shape[0]
    L = min(s, C)
    layout, gs_plan = weighted_group(R, s)
    out = torch.full((R * Q * K * 3,), NAN)
    wf, af = W.reshape(-1), a.reshape(-1)
    bits = torch.zeros((K, Q, max(L, 1)), dtype=torch.bool)
    for (g, q), words in masks.items():
        for w, x in enumerate(words):
            for b in range(32):
                if x >> b & 1:
                    bits[g, q, w * 32 + b] = True
    step = _WGRB if layout == "replicates" else 1
    for g0 in range(0, K, gs_plan):
        gs = min(gs_plan, K - g0)
        for r0 in range(0, R, step):
            nr = min(step, R - r0)
            m = torch.zeros((nr, Q, gs, 3))
            if layout == "replicates":
                s_w = torch.full((gs * L * (_WGRB + 1),), NAN)
                s_a = torch.full((gs * L,), NAN)
                i = torch.arange(gs * L * nr)
                rr, e = i // (gs * L), i % (gs * L)
                gl, j = e // L, e % L
                base = torch.tensor([segs[g0 + x][0] * s + segs[g0 + x][1]
                                     for x in range(gs)])
                ln = torch.tensor([segs[g0 + x][2] for x in range(gs)])
                on = j < ln[gl]
                o = base[gl] + j
                s_w[(e * (_WGRB + 1) + rr)[on]] = wf[((r0 + rr) * k * s
                                                      + o)[on]]
                s_a[e[on & (rr == 0)]] = af[o[on & (rr == 0)]]
                lanes = torch.arange(nr)
                for gl_ in range(gs):
                    for j in range(segs[g0 + gl_][2]):
                        oo = gl_ * L + j
                        wv = s_w[oo * (_WGRB + 1) + lanes][:, None]
                        av = s_a[oo]
                        wa = wv * av
                        hit = bits[g0 + gl_, :, j][None].expand(nr, Q)
                        for cidx, tv in enumerate((wv, wa, wa * av)):
                            m[:, :, gl_, cidx] = torch.where(
                                hit, m[:, :, gl_, cidx] + tv,
                                m[:, :, gl_, cidx])
            else:
                s_v = torch.full((gs * L, 4), NAN)
                for gl_ in range(gs):
                    leaf, s0, n = segs[g0 + gl_]
                    wv = W[r0, leaf, s0:s0 + n]
                    av = a[leaf, s0:s0 + n]
                    s_v[gl_ * L:gl_ * L + n, 0] = wv
                    s_v[gl_ * L:gl_ * L + n, 1] = wv * av
                    s_v[gl_ * L:gl_ * L + n, 2] = (wv * av) * av
                for gl_ in range(gs):
                    for j in range(segs[g0 + gl_][2]):
                        t = s_v[gl_ * L + j]
                        hit = bits[g0 + gl_, :, j][None]
                        for cidx in range(3):
                            m[:, :, gl_, cidx] = torch.where(
                                hit, m[:, :, gl_, cidx] + t[cidx],
                                m[:, :, gl_, cidx])
            code = cls[g0:g0 + gs].T[None, :, :, None]     # (1, Q, gs, 1)
            tt = T[r0:r0 + nr, g0:g0 + gs][:, None]        # (nr, 1, gs, 3)
            m = torch.where(code == COVERED, tt.expand_as(m),
                            torch.where(code == EMPTY, 0.0, m))
            # The store buffer's rows, then each row's nf floats at its
            # flat offset.
            nf = gs * 3
            for rr in range(nr):
                row = m[rr].reshape(Q, nf)
                idx = (((r0 + rr) * Q + torch.arange(Q))[:, None] * K
                       + g0) * 3 + torch.arange(nf)[None]
                out[idx.reshape(-1)] = row.reshape(-1)
    out = out.view(R, Q, K, 3)
    n_ch = weighted_chunks(s)
    if n_ch == 1:
        return out
    part = out.view(R, Q, k, n_ch, 3)
    acc = part[:, :, :, 0]
    for ch in range(1, n_ch):
        acc = acc + part[:, :, :, ch]
    return acc


def wide_launch(c, a, valid, W, q_lo, q_hi):
    """The whole launch replayed: (R, Q, k, 3), the classes, cut words
    and masks."""
    k, s, d = c.shape
    segs = segments(k, s)
    lo, hi, cnan, vb = box_pass(c, valid, segs)
    cls, words = class_pass(lo, hi, cnan, q_lo, q_hi)
    masks = mask_pass(c, segs, cls, words, vb, q_lo, q_hi)
    out = group_walk(a, W, segs, cls, masks,
                     totals(W, a, valid, segs), q_lo.shape[0], s)
    return out, cls, words, masks


CASES = [  # Q, k, s, d, R, many, nan
    (40, 17, 75, 24, 1, False, True),
    (40, 17, 75, 17, 9, True, False),
    (37, 9, 75, 40, 33, False, True),
    (33, 3, 2049, 24, 1, True, True),
    (33, 3, 2049, 17, 9, False, False),
]


@pytest.mark.parametrize("Q,k,s,d,R,many,nan", CASES)
def test_wide_launch_replay(Q, k, s, d, R, many, nan):
    """Classes, cut words, masks and the group walk's output against
    samples_inside and the slot-order folds, bit for bit."""
    c, a, valid, W, q_lo, q_hi = wide_inputs(Q, k, s, d, R,
                                             seed=Q * 7 + k + s + d + R,
                                             many=many, nan=nan)
    out, cls, words, masks = wide_launch(c, a, valid, W, q_lo, q_hi)
    segs = segments(k, s)
    inside = samples_inside(c, valid, q_lo, q_hi)           # (Q, k, s)
    n_mixed = 0
    for (g, q), ws in masks.items():
        leaf, s0, n = segs[g]
        want = inside[q, leaf, s0:s0 + n]
        got = torch.tensor([bool(ws[b // 32] >> (b % 32) & 1)
                            for b in range(n)], dtype=torch.bool)
        assert torch.equal(got, want), (g, q)
        n_mixed += bool(want.any())
    for g, (leaf, s0, n) in enumerate(segs):
        held = inside[:, leaf, s0:s0 + n].sum(-1)
        nv = int(valid[leaf, s0:s0 + n].sum())
        cg = cls[g]
        assert bool(((held == nv) | (cg != COVERED)).all())
        assert bool(((held == 0) | (cg != EMPTY)).all())
    # Mixed pairs occur, and with ``many`` some pair has more cut columns
    # than a word keeps (the CUT_ALL fallback).
    assert n_mixed > 0
    if many:
        assert any(w == ALL for w in words.values())
    want, _ = replay(c, a, valid, W, q_lo, q_hi)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("s,d,R", [(75, 17, 1), (75, 24, 33), (2049, 24, 9),
                                   (2049, 17, 1)])
def test_plain_matches_fold_and_jax(s, d, R):
    """weighted_moments_plain and bootstrap_moments_plain within rtol 3e-5
    / atol 1e-3 of the slot-order fold (the kernels' bits) and of the jnp
    backend at d > 16."""
    c, a, valid, W, q_lo, q_hi = wide_inputs(9, 5, s, d, R, seed=s + d + R,
                                             nan=True, bad=False)
    fold, _ = replay(c, a, valid, W, q_lo, q_hi)
    got_b = bootstrap_moments_plain(c, a, valid, W, q_lo, q_hi)
    got_w = weighted_moments_plain(c, a, valid, W[0], q_lo, q_hi)
    np.testing.assert_allclose(got_b.numpy(), fold.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(got_w, got_b[0])
    be = get_backend("jnp")
    args = [jnp.asarray(x.numpy()) for x in (c, a, valid, W, q_lo, q_hi)]
    want_b = np.asarray(jax.jit(be.bootstrap_moments)(*args))
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=RTOL, atol=ATOL)
    want_w = jax.jit(be.weighted_moments)(*args[:3], args[3][0], *args[4:])
    for i in range(3):
        np.testing.assert_allclose(got_w[..., i].numpy(),
                                   np.asarray(want_w[i]), rtol=RTOL,
                                   atol=ATOL)


def test_layout_matches_source():
    """The wide launch's constants, plan, walk choice and scratch against
    csrc/weighted_moments.cu and csrc/wide_cols.cuh."""
    src = (CSRC / "weighted_moments.cu").read_text()
    cols = (CSRC / "wide_cols.cuh").read_text()

    def const(name, text=src):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             text).group(1))
    assert (const("GROUP"), const("WRB"), const("REPS_STAGE"),
            const("QRY_STAGE"), const("GW_T")) == (
        _WGROUP, _WGRB, _WREPS_STAGE, _WQRY_STAGE, 256)
    assert (const("WIDE_COLS", cols), const("CUT_MAX", cols),
            const("CUT_COLS", cols)) == (COLS, CUT_MAX, CUT_COLS)
    assert re.search(r"constexpr int ROW_PITCH = 3 \* GROUP \+ 4;", src)
    # The test kernel: runs of TQ queries, blocks of TB columns.
    assert (const("TQ"), const("TB")) == (_WTQ, _WTB)
    assert re.search(r"constexpr int XP = TB \+ 1;", src)
    assert const("WG") == WG
    for s, d in ((75, 17), (75, 24), (2049, 300), (40_000, 24)):
        assert weighted_plan(2048, 1024, s, d) == (_WLT_MAX, 0)
    # A lane a replicate while the group's weights fit, else a lane a
    # query.
    assert weighted_group(200, 75) == ("replicates", 8)
    assert weighted_group(9, 300) == ("replicates", 2)
    assert weighted_group(WEIGHTED_PAIR_R, 75) == ("queries", 8)
    assert weighted_group(200, 2049) == ("queries", 2)
    assert weighted_walk(200, 75, 24) == "group replicates"
    assert weighted_walk(1, 75, 24) == "group queries"
    assert weighted_walk(1, 75, 16) == "direct"
    # Phase 30's shape: totals, boxes, valid bits, NaN flags and columns,
    # the counter from a multiple of 4 floats, the classes (bytes) and the
    # masks; above one chunk the partials from a multiple of 4.
    R, Q, k, s, d = 200, 2048, 1024, 75, 24
    ctr = R * k * 3 + k * 2 * d + k * 3 + k + k
    assert ctr % 4 == 0
    cut = ctr + 4 + k * Q // 4 + k * 3 * Q
    assert cut % 2 == 0
    assert weighted_scratch_floats(R, Q, k, s, d) == cut + 2 * k * Q
    K = 3 * 20
    head = -(-(9 * K * 3 + K * 2 * 300 + K * 64 + K + K * 10) // 4) * 4
    cut = head + 4 + -(-(K * 33) // 4) + K * 64 * 33
    end = -(-cut // 2) * 2 + 2 * K * 33
    assert weighted_scratch_floats(9, 33, 3, 40_000, 300) == (
        -(-end // 4) * 4 + 9 * 33 * K * 3)
