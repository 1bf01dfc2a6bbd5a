"""Row 9's tile kernel above 16 predicate columns (csrc/join_moments.cu
join_tile_wide_kernel) replayed in numpy, against the all-column slot
test, the slot-order fold, the plain version and the JAX package.

A block takes WCT cells and QB queries. While it classifies a (query,
cell) pair, a column block of CCOLS at a time, a query compares only the
columns where its bounds do not hold the tile's box (fminf / fmaxf of its
cells' boxes), and those columns are its cut list: the first JCUT of them
with their bounds. Any other column passes every slot of every cell of the
tile, and of the list, a pair tests only the columns that do not hold its
cell's box (a byte a pair), or every column where the query cuts more
than JCUT or the cell has a NaN coordinate. The mixed pairs go in rounds
of queries whose results fit W_RES; a warp walks a cell at a time: for
each SWIN-slot window it stages the rows (one contiguous run where D is
odd and at most SCOLS, aligned with the source for 16-byte copies; else
row by row at D + 1, or SCOLS columns at a time above SCOLS), tests every
(query, column) item of the cell's mixed pairs on the window's slots (a
lane an item, a query's items ANDed), then each query's lane folds its
relevant slots (inside, or with a non-finite value) in slot order,
folding a group at the first end flag after its last relevant slot. The
results go to a round's room at each cell's offset, and every (query,
plane) row piece is written from the cell's totals (covered), that room
(mixed) or +0.0.

The CUDA kernel runs only on the card (chip_smoke.py phases 29 and 30 hold
it to the plain version and to the previous kernel's bits there). Here the
replay writes the staged rows and the round's results at the kernel's
offsets into buffers that hold stale values between uses, and tests and
stores what it reads back, so a layout whose writes and reads disagree
changes the bits. Held:

* every mixed pair's slot bits equal the all-column test (NaN never
  inside), and the planes equal the slot-order fold of every pair (the
  bits of the walk over every slot of the run, which the previous kernel
  gave) bit for bit (NaN as one code);
* the planes meet join_cell_moments_plain within rtol=3e-5, atol=1e-3
  (NaN at the same entries), and in one case the JAX package's
  compute_join_artifacts;
* the layout constants and the offsets are the source's.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.core.types import QueryBatch as JQB
from repro.joins.executor import compute_join_artifacts as jartifacts
from repro_torch.joins.executor import join_slots as synopsis_slots
from repro_torch.kernels import join_moments as jm
from test_torch_joins import build_both, tables

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "join_moments.cu")
RTOL, ATOL = 3e-5, 1e-3
P_U = 0.3
# The wide tile kernel's layout, held to the source by
# test_layout_constants_match_the_source.
WCT, QB, W_RES, JCUT = 64, 32, 1024, 8
SWIN, SCOLS, CCOLS = 32, 31, 32
XBUF = SWIN * SCOLS + 4
STATS = 8
f32 = np.float32


def bits(x):
    """int32 view of float32 values, every NaN as one code."""
    x = np.array(x, np.float32)
    b = x.view(np.int32).copy()
    b[np.isnan(x)] = 0x7FC00000
    return b


def case(seed, D, k, su, P, Q, mode="mixed"):
    """chip_smoke.py's wide_join_case: D - 1 fact columns N(0, 1) and one
    dimension attribute, values Gamma(2, 1), keys over 3 * su values,
    partition = key mod P, 70 % valid; query 0 bounds nothing (-10, 10),
    the others 2-5 columns ("one": 1, "many": 9-12, past JCUT) to
    (-2, 2)-wide random boxes. "nan": NaN coordinates on valid slots;
    "inf": +inf, -inf and NaN values on three valid slots; "covered":
    query 1 unbounded and queries 2-4 three cells' boxes exactly. Returns
    (JoinSlots, q_lo, q_hi) as CPU tensors."""
    rng = np.random.default_rng(seed)
    d_f = D - 1
    u_c = rng.normal(size=(k, su, d_f)).astype(np.float32)
    u_d = rng.normal(size=(k, su, 1)).astype(np.float32)
    u_a = rng.gamma(2.0, 1.0, size=(k, su)).astype(np.float32)
    u_key = rng.integers(0, 3 * su, size=(k, su)).astype(np.int32)
    u_valid = rng.random((k, su)) < 0.7
    if mode == "nan":
        u_c[u_valid & (rng.random((k, su)) < 0.2), d_f - 1] = np.nan
        u_d[u_valid & (rng.random((k, su)) < 0.1), -1] = np.nan
    if mode == "inf":
        on = np.argwhere(u_valid)
        for v, (i, j) in zip((np.inf, -np.inf, np.nan),
                             on[rng.choice(len(on), 3, replace=False)]):
            u_a[i, j] = v
    u_part = (u_key % P).astype(np.int32)
    q_lo, q_hi = queries(rng, Q, D, {"one": (1, 2),
                                     "many": (9, 13)}.get(mode, (2, 6)))
    T = torch.from_numpy
    slots = jm.join_slots(T(u_c), T(u_d), T(u_a), T(u_key), T(u_part),
                          T(u_valid), P)
    if mode == "covered":
        box = slots.cell_box.numpy()
        q_lo[1], q_hi[1] = -np.inf, np.inf
        finite = np.flatnonzero(np.isfinite(box).all((1, 2)))
        for i, cell in zip(range(2, 5), rng.choice(finite, 3)):
            q_lo[i], q_hi[i] = box[cell, 0], box[cell, 1]
    return slots, T(q_lo), T(q_hi)


def queries(rng, Q, D, span=(2, 6)):
    """Query 0 bounds nothing (-10, 10); the others bound ``span`` (a
    range) columns to random boxes of (-2, 0.8) to (-0.8, 2.8)."""
    q_lo = np.full((Q, D), -10.0, np.float32)
    q_hi = np.full((Q, D), 10.0, np.float32)
    for i in range(1, Q):
        cols = rng.choice(D, int(rng.integers(*span)), replace=False)
        q_lo[i, cols] = rng.uniform(-2.0, 0.0, cols.size)
        q_hi[i, cols] = q_lo[i, cols] + rng.uniform(1.2, 2.8, cols.size)
    return q_lo, q_hi


class Sums:
    """CellSums: the eight sums of one (query, cell) and the open group's
    totals, float32 with each operation rounded once."""

    def __init__(self):
        self.v = [f32(0.0)] * 8
        self.ts = self.tc = f32(0.0)

    def add(self, inside, a, inv_p):
        row_c = inv_p if inside else f32(0.0)
        self.tc = f32(self.tc + row_c)
        with np.errstate(invalid="ignore"):  # 0 * inf is NaN, as on the card
            self.ts = f32(self.ts + f32(row_c * a))

    def fold(self):
        v, ts, tc = self.v, self.ts, self.tc
        v[0] = f32(v[0] + ts)
        v[1] = f32(v[1] + tc)
        v[2] = f32(v[2] + f32(ts * ts))
        v[3] = f32(v[3] + f32(tc * tc))
        v[4] = f32(v[4] + f32(ts * tc))
        v[5] = f32(v[5] + f32(1.0 if tc > 0 else 0.0))
        v[6] = max_nan(v[6], abs(ts))
        v[7] = max_nan(v[7], tc)
        self.ts = self.tc = f32(0.0)

    def saved(self, one_m_p):
        v = list(self.v)
        for s in (2, 3, 4):
            v[s] = f32(one_m_p * v[s])
        return v


def max_nan(acc, x):
    """The kernel's max_nan: x where x > acc or x is NaN."""
    return x if (x > acc or x != x) else acc


def scales(p_u):
    return f32(1.0 / p_u), f32(1.0 - p_u)


def runs(slots):
    """(coord (k, su, D), a, last, cell_start, box, NaN flag per cell) as
    numpy."""
    return (slots.s_coord.numpy(), slots.s_a.numpy(), slots.s_last.numpy(),
            slots.cell_start.numpy(), slots.cell_box.numpy(),
            jm.cell_nan_flags(slots).numpy())


def run_of(cell_start, P, cell):
    leaf, p = divmod(cell, P)
    return leaf, int(cell_start[leaf, p]), int(cell_start[leaf, p + 1])


def slot_order(slots, q_lo, q_hi, p_u):
    """The slot-order fold of every (query, cell) pair over every slot of
    its run, inside by the all-column test (NaN never inside), each group
    folded at its end flag: (8, Q, kP)."""
    coord, a, last, start, _, _ = runs(slots)
    inv_p, one_m_p = scales(p_u)
    lo, hi = q_lo.numpy(), q_hi.numpy()
    Q, P = lo.shape[0], slots.num_partitions
    kp = slots.num_leaves * P
    out = np.zeros((STATS, Q, kp), np.float32)
    for cell in range(kp):
        leaf, s0, s1 = run_of(start, P, cell)
        acc = [Sums() for _ in range(Q)]
        for i in range(s0, s1):
            x = coord[leaf, i]
            inside = ((lo <= x) & (x <= hi)).all(1)
            for q in range(Q):
                acc[q].add(bool(inside[q]), a[leaf, i], inv_p)
                if last[leaf, i]:
                    acc[q].fold()
        for q in range(Q):
            out[:, q, cell] = acc[q].saved(one_m_p)
    return out


def fold_window(acc, rel, my, ends, xa, inv_p, pend):
    """The kernel's fold_window: the relevant slots of a window in slot
    order, each open group folded at the first end flag at or after its
    last relevant slot. Returns pend."""
    frm = 0
    for b in range(32):
        if not rel >> b & 1:
            continue
        if pend and ends & ((1 << b) - 1) & ~((1 << frm) - 1):
            acc.fold()
        acc.add(bool(my >> b & 1), xa[b], inv_p)
        pend, frm = True, b
    if pend and ends >> frm:
        acc.fold()
        pend = False
    return pend


def popc(x):
    return bin(x).count("1")


def stage_rows(x, flat, src, n, D, ncol, srow):
    """The kernel's stage_rows into x from flat (the coordinates, slot-major,
    starting at a 16-byte boundary) at element src: n slots' rows of ncol
    columns. Where they are one contiguous run (ncol = srow = D) element e
    lands at x0 + e, x0 = (4 - head) & 3 where head is the run's floats
    before a 16-byte boundary (so its 16-byte copies are aligned in both);
    else row b at b * srow. Returns x0."""
    if ncol == D and srow == D:
        total = n * D
        head = min(total, (4 - src % 4) % 4)
        x0 = (4 - head) & 3
        x[x0:x0 + total] = flat[src:src + total]
        return x0
    for b in range(n):
        x[b * srow:b * srow + ncol] = flat[src + b * D:src + b * D + ncol]
    return 0


def replay(slots, q_lo, q_hi, p_u, w_res=W_RES):
    """The wide tile kernel's planes (8, Q, kP) in numpy (module doc), with
    its results room of ``w_res`` pairs. Also returns whether every mixed
    pair's slot bits are the all-column test's, and each walked (query,
    tile)'s number of cut columns (JCUT + 1 for every column)."""
    coord, a, last, start, box, flag = runs(slots)
    inv_p, one_m_p = scales(p_u)
    lo, hi = q_lo.numpy(), q_hi.numpy()
    Q, D = lo.shape
    P = slots.num_partitions
    kp = slots.num_leaves * P
    out = np.full((STATS, Q, kp), np.nan, np.float32)
    # The cells kernel's totals: every slot inside.
    tot = np.zeros((STATS, kp), np.float32)
    for cell in range(kp):
        leaf, s0, s1 = run_of(start, P, cell)
        acc = Sums()
        for i in range(s0, s1):
            acc.add(True, a[leaf, i], inv_p)
            if last[leaf, i]:
                acc.fold()
        tot[:, cell] = acc.saved(one_m_p)
    # Stale shared memory: the warp's staged rows and values, the round's
    # results.
    x = np.full(XBUF, np.nan, np.float32)
    xa = np.full(SWIN, np.nan, np.float32)
    res = np.full(STATS * w_res, np.nan, np.float32)
    agree, tested = True, []
    flat = coord.reshape(-1)
    su = coord.shape[1]
    # Rows of D floats where D is odd, else D + 1; above SCOLS, SCOLS.
    srow = SCOLS if D > SCOLS else D | 1
    for cell0 in range(0, kp, WCT):
        nc = min(WCT, kp - cell0)
        cb = box[cell0:cell0 + nc]
        tlo, thi = cb[:, 0].min(0), cb[:, 1].max(0)
        for q0 in range(0, Q, QB):
            nq = min(QB, Q - q0)
            ql, qh = lo[q0:q0 + nq], hi[q0:q0 + nq]
            hold = (ql <= tlo) & (thi <= qh)                   # (nq, D)
            cut = [np.flatnonzero(~hold[lq]) for lq in range(nq)]
            # Classes on the columns the query does not hold; a list
            # column cuts a pair where it does not hold the cell's box.
            cmp = ~hold[:, None, :]
            apart = (cmp & ((qh[:, None] < cb[None, :, 0])
                            | (ql[:, None] > cb[None, :, 1]))).any(-1)
            holds = ((ql[:, None] <= cb[None, :, 0])
                     & (cb[None, :, 1] <= qh[:, None]))    # (nq, nc, D)
            walk = ~apart
            cov = (walk & ~(cmp & ~holds).any(-1)
                   & ~flag[None, cell0:cell0 + nc])
            mix = walk & ~cov
            pcut = [[sum(1 << t for t, j in enumerate(cut[lq][:JCUT])
                         if not holds[lq, ce, j]) for ce in range(nc)]
                    for lq in range(nq)]
            mixw = [sum(1 << lq for lq in range(nq) if mix[lq, ce])
                    for ce in range(nc)]
            covw = [sum(1 << lq for lq in range(nq) if cov[lq, ce])
                    for ce in range(nc)]
            cnt = mix.sum(1)
            qa = 0
            while qa < nq:
                qb, n = qa, 0
                while qb < nq and n + cnt[qb] <= w_res:
                    n += cnt[qb]
                    qb += 1
                gm = ((1 << qb) - 1) & ~((1 << qa) - 1)
                off, at = [], 0
                for ce in range(nc):
                    off.append(at)
                    at += popc(mixw[ce] & gm)
                for ce in range(nc):
                    M = mixw[ce] & gm
                    if not M:
                        continue
                    leaf, s0, s1 = run_of(start, P, cell0 + ce)
                    members = [lq for lq in range(nq) if M >> lq & 1]
                    every = {lq: bool(flag[cell0 + ce]) or cut[lq].size > JCUT
                             for lq in members}
                    own = {lq: [j for t, j in enumerate(cut[lq][:JCUT])
                                if pcut[lq][ce] >> t & 1] for lq in members}
                    acc = {lq: Sums() for lq in members}
                    pend = dict.fromkeys(members, False)
                    walked = {lq: [] for lq in members}
                    for i0 in range(s0, s1, SWIN):
                        n = min(SWIN, s1 - i0)
                        valid = (1 << n) - 1
                        av = np.zeros(SWIN, np.float32)
                        av[:n] = a[leaf, i0:i0 + n]
                        ends = sum(1 << b for b in range(n)
                                   if last[leaf, i0 + b])
                        nonfin = sum(1 << b for b in range(n)
                                     if not np.isfinite(av[b]))
                        my = dict.fromkeys(members, valid)
                        for c0 in range(0, D, SCOLS):
                            ncol = min(SCOLS, D - c0)
                            if c0 > 0 and not any(
                                    every[lq] or any(c0 <= j < c0 + ncol
                                                     for j in own[lq])
                                    for lq in members):
                                continue
                            src = (leaf * su + i0) * D + c0
                            x0 = stage_rows(x, flat, src, n, D, ncol, srow)
                            if c0 == 0:
                                xa[:] = av
                            slot = x0 + np.arange(n) * srow
                            for lq in members:
                                m = my[lq]
                                if every[lq]:
                                    cols = [(u, lo[q0 + lq, c0 + u],
                                             hi[q0 + lq, c0 + u])
                                            for u in range(ncol)]
                                else:
                                    cols = [(j - c0, lo[q0 + lq, j],
                                             hi[q0 + lq, j])
                                            for j in own[lq]
                                            if c0 <= j < c0 + ncol]
                                for u, cl, ch in cols:
                                    if not m:
                                        break
                                    v = x[slot + u]
                                    m &= int(sum(1 << int(b) for b in
                                                 np.flatnonzero((cl <= v)
                                                                & (v <= ch))))
                                my[lq] = m
                        for lq in members:
                            walked[lq] += [bool(my[lq] >> b & 1)
                                           for b in range(n)]
                            pend[lq] = fold_window(
                                acc[lq], (my[lq] | nonfin) & valid, my[lq],
                                ends, xa, inv_p, pend[lq])
                    for lq in members:
                        xs = coord[leaf, s0:s1]
                        want = ((lo[q0 + lq] <= xs)
                                & (xs <= hi[q0 + lq])).all(1)
                        agree &= walked[lq] == want.tolist()
                        at = off[ce] + popc(M & ((1 << lq) - 1))
                        res[np.arange(STATS) * w_res + at] = acc[lq].saved(
                            one_m_p)
                for lq in range(qa, qb):
                    if cnt[lq]:
                        tested.append(JCUT + 1 if cut[lq].size > JCUT
                                      else cut[lq].size)
                    bit = 1 << lq
                    for ce in range(nc):
                        for st in range(STATS):
                            mx = mixw[ce] & gm
                            out[st, q0 + lq, cell0 + ce] = (
                                tot[st, cell0 + ce] if covw[ce] & bit
                                else res[st * w_res + off[ce]
                                         + popc(mx & (bit - 1))]
                                if mx & bit else f32(0.0))
                qa = qb
    return out, agree, tested


def plain_planes(slots, q_lo, q_hi, p_u=P_U):
    kp = slots.num_leaves * slots.num_partitions
    Q = q_lo.shape[0]
    m = jm.join_cell_moments_plain(
        slots, q_lo, q_hi, torch.zeros((Q, kp), dtype=torch.bool),
        torch.zeros((Q, kp), dtype=torch.bool), torch.zeros((kp, 5)),
        torch.tensor(1.0), p_u)
    return np.stack([getattr(m, f).numpy() for f in jm.PLANES])


def assert_planes_close(got, want, what):
    assert np.array_equal(np.isnan(got), np.isnan(want)), (
        f"{what}: NaN at other entries")
    np.testing.assert_allclose(np.nan_to_num(got).astype(np.float64),
                               np.nan_to_num(want).astype(np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=what)


# (D, mode, k, su, P, Q): 17, 24, 25 and 33 columns (rows staged as one run,
# row by row, and in chunks of SCOLS columns); k * P off multiples of 4
# (27, 15) and of the 64-cell tile, more
# than one tile (130, 160 cells); leaves of 3000 slots (runs of ~420 slots
# crossing 32-slot windows); Q past one block of 32 queries.
CASES = [(17, "mixed", 13, 40, 4, 37),
         (25, "nan", 9, 30, 3, 20),
         (33, "inf", 26, 12, 5, 14),
         (24, "covered", 10, 13, 13, 12),
         (33, "one", 40, 10, 4, 12),
         (17, "many", 13, 40, 4, 16),
         (25, "mixed", 1, 3000, 5, 6)]


@pytest.mark.parametrize("D,mode,k,su,P,Q", CASES)
def test_wide_join_replay(D, mode, k, su, P, Q):
    """The replay's slot bits are the all-column test's, its planes the
    slot-order fold's bits, and they meet plain."""
    slots, q_lo, q_hi = case(D * 31 + k, D, k, su, P, Q, mode)
    got, agree, tested = replay(slots, q_lo, q_hi, P_U)
    assert agree
    want = slot_order(slots, q_lo, q_hi, P_U)
    assert np.array_equal(bits(got), bits(want)), (
        f"{int((bits(got) != bits(want)).sum())} values differ in bits")
    assert_planes_close(got, plain_planes(slots, q_lo, q_hi), "vs plain")
    if mode == "one":
        assert 1 in tested
    if mode == "many":
        assert JCUT + 1 in tested
    if mode == "mixed" and D == 17:
        assert 5 in tested
    if mode in ("nan", "inf", "covered"):
        classes = jm.join_cell_classes(slots, q_lo, q_hi)
        assert int((classes == jm.MIXED).sum())
        if mode == "covered":
            assert int((classes == jm.COVERED).sum())


def test_rounds_of_results():
    """A results room of WCT pairs, the least the kernel's rounds allow (a
    query has at most WCT mixed cells in a tile): the block's queries go
    in several rounds, each its offsets and stores; the bits stay."""
    slots, q_lo, q_hi = case(5, 25, 13, 40, 4, 37)
    got, agree, _ = replay(slots, q_lo, q_hi, P_U, w_res=WCT)
    assert agree
    want, _, _ = replay(slots, q_lo, q_hi, P_U)
    assert np.array_equal(bits(got), bits(want))


def test_fold_window_groups_across_windows():
    """Groups that cross a window, end flags on skipped slots, a group
    with no relevant slot: the lazy fold gives the fold at every end."""
    rng = np.random.default_rng(3)
    inv_p = f32(2.0)
    for _ in range(200):
        n = int(rng.integers(1, 100))
        a = rng.normal(size=n).astype(np.float32)
        ends = rng.random(n) < 0.3
        ends[-1] = True
        inside = rng.random(n) < 0.4
        want = Sums()
        for i in range(n):
            want.add(bool(inside[i]), a[i], inv_p)
            if ends[i]:
                want.fold()
        got, pend = Sums(), False
        for i0 in range(0, n, SWIN):
            w = min(SWIN, n - i0)
            my = sum(1 << b for b in range(w) if inside[i0 + b])
            e = sum(1 << b for b in range(w) if ends[i0 + b])
            xa = np.zeros(SWIN, np.float32)
            xa[:w] = a[i0:i0 + w]
            pend = fold_window(got, my, my, e, xa, inv_p, pend)
        assert bits(got.saved(f32(0.5))).tolist() == bits(
            want.saved(f32(0.5))).tolist()


def test_jax_compute_join_artifacts():
    """The replay on a built join synopsis (17 fact columns, k = 6, P = 4,
    "kd") meets the JAX package's compute_join_artifacts."""
    tab = tables(n=1200, nd=40, seed=17, d_fact=17, missing=0.02)
    jsyn, tsyn, _, _ = build_both(tab, num_partitions=4, k=6, p_u=0.4,
                                  seed=3, method="kd", opt_samples=256)
    lo, hi = queries(np.random.default_rng(11), 30, 18)
    ja = jartifacts(jsyn, JQB(jnp.asarray(lo), jnp.asarray(hi)))
    q_lo, q_hi = torch.from_numpy(lo), torch.from_numpy(hi)
    slots = synopsis_slots(tsyn)
    got, agree, _ = replay(slots, q_lo, q_hi, tsyn.p_u)
    assert agree
    assert int((jm.join_cell_classes(slots, q_lo, q_hi) == jm.MIXED).sum())
    for i, f in enumerate(jm.PLANES):
        assert_planes_close(got[i], np.asarray(getattr(ja, f)), f)


def has(src, text):
    """Whether ``src`` holds ``text``'s tokens in order, whatever the white
    space between them."""
    return re.search(r"\s*".join(map(re.escape, text.split())),
                     src) is not None


def test_layout_constants_match_the_source():
    """The replay's tile, rooms, capacity, windows and staged rows are the
    source's, and so are the offsets it writes and reads at."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;",
                             src).group(1))

    assert const("WCT") == WCT == jm.JM_WIDE_CT
    assert const("W_RES") == W_RES == jm.JM_WIDE_RESULTS
    assert const("QB") == QB == jm.JM_QT
    assert const("MAX_D") == jm.JM_MAX_D
    assert const("JCUT") == JCUT and const("CCOLS") == CCOLS
    assert const("SWIN") == SWIN and const("SCOLS") == SCOLS
    assert const("STATS") == STATS
    # Staged rows, values, tests, results and stores at these offsets.
    assert has(src, "static constexpr int xbuf = SWIN * SCOLS + 4;")
    assert has(src, "const int srow = D > SCOLS ? SCOLS : D | 1;")
    assert has(src, "if (ncol == D && srow == D) {")
    assert has(src, "float* x0 = x + ((4 - head) & 3);")
    assert has(src, "const int head = min(total, (int)((16u - ((uintptr_t)"
                    "src & 15u)) & 15u) / 4);")
    assert has(src, "cp_async16(x0 + head + 4 * k, src + head + 4 * k);")
    assert has(src, "cp_async4(x + b * srow + u, src + (size_t)b * D + u);")
    assert has(src, "x = stage_rows(xw, coord + (w.leaf0 + w.i0) * D, "
                    "min(SWIN, w.end - w.i0), D, min(SCOLS, D), srow, lane);")
    assert has(src, "x = stage_rows(xw, coord + (cur.leaf0 + cur.i0) * D + "
                    "c0, n, D, ncol, srow, lane);")
    assert has(src, "float* xa = xw + WideSmem::xbuf;")
    assert has(src, "xa[lane] = av;")
    assert has(src, "const float* col = x + j;")
    assert has(src, "const float v = col[b * srow];")
    assert has(src, "my = test_items(my, mine, every, pc, r, x, srow, n, "
                    "q_lo, q_hi, q0, D, c0, ncol, lane);")
    assert has(src, "const uint32_t pc = mine ? r.pcut[lane * WCT + cur.c] : "
                    "0u;")
    assert has(src, "const float4 cv = r.cutv[l * JCUT + nth_bit(pl, k)];")
    assert has(src, "if (t < JCUT) pc |= 1u << t;")
    assert has(src, "acc.save(r.res + r.off[cur.c] + __popc(M & ((1u << "
                    "lane) - 1u)), W_RES, one_m_p);")
    assert has(src, "r.res[st * W_RES + r.off[ce] + __popc(mx & (bit - "
                    "1u))]")
    assert has(src, "&& r.qb[l * QROW + j] <= r.tb[j] && r.tb[CCOLS + j] <= "
                    "r.qb[(QB + l) * QROW + j];")
    assert has(src, "const bool every = nan_cell || r.ncut[lane] > JCUT;")
    assert has(src, "fold_window(acc, (my | nonfin) & valid, my, ends, xa, "
                    "inv_p, pend);")
