"""The walk of rows 3 and 4's mixed pairs (csrc/weighted_moments.cu, the
tile kernel's step 3 and weighted_walk_reps_kernel /
weighted_walk_pairs_kernel) replayed in torch and held bit for bit to the
slot-order folds of ``test_torch_weighted_chunks`` (``slot_fold`` per
chunk of WEIGHTED_CHUNK slots, ``replay``).

The tile kernel lists each tile's mixed (query, segment) pairs grouped by
segment with their slot masks: the segments with fewer than _WSTAGE of
them first (walked directly, a thread a (pair, replicate)), then the
others, each an item (tile, segment | first entry << 5 | pairs << 15) of
the staged walk. Its units take an item: with lanes on replicates (R >
WEIGHTED_PAIR_R), a block of _WRB replicates whose weights arrive in
sub-chunks of _WSUB slots, the item's pairs spread over the block's
warps; with lanes on pairs, one replicate, each lane adding the selected
terms of its pair slot by slot (+0.0 where the pair does not hold the
slot). Every (pair, replicate) stays the
slot-order fold from +0.0 of its relevant slots, so the bits are the
parent's at every s; the kernels run only on the card (chip_smoke.py
phase 11 holds them to the parent's kernel there), and here the
decomposition is replayed: the direct entries, items, sub-chunks
(unstaged slots hold NaN, so a read of one would show), replicate blocks,
pair groups and both lane layouts, on inputs with NaN and +-inf in ``a``
and W on the invalid slots, which no query holds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.stratified_estimate import (
    WEIGHTED_CHUNK, WEIGHTED_PAIR_R, _WQT, _WRB, _WSTAGE, _WSUB, _WWALK_T,
    weighted_chunks, weighted_plan, weighted_walk)
from test_torch_weighted_chunks import chunk_inputs, replay, slot_fold

C = WEIGHTED_CHUNK
WARPS = _WWALK_T // 32
PPW = _WQT // WARPS
NAN = float("nan")


def walk_inputs(Q, k, s, d, R, seed):
    """chunk_inputs with each stratum's slots shuffled (every chunk spans
    the stratum, so a box query cuts most chunks: a tile of 32 queries
    stages them, the 5 queries of the last tile at Q = 37 walk them
    directly) and NaN, +inf and -inf in ``a`` and W on every invalid slot
    (no query holds one)."""
    c, a, valid, W, q_lo, q_hi = chunk_inputs(Q, k, s, d, R, seed)
    perm = np.random.default_rng(seed).permutation(s)
    c, a, valid, W = c[:, perm], a[:, perm], valid[:, perm], W[:, :, perm]
    bad = np.array([np.nan, np.inf, -np.inf], np.float32)
    off = ~valid
    a[off] = bad[np.arange(int(off.sum())) % 3]
    W[:, off] = bad[(np.arange(R)[:, None] + np.arange(int(off.sum())))
                    % 3]
    return [torch.from_numpy(np.ascontiguousarray(x))
            for x in (c, a, valid, W, q_lo, q_hi)]


def segments(k, s):
    """(first slot in the flat (k * s) arrays, length) of each segment g =
    leaf * n_ch + ch, as the launch's Segs cuts them."""
    n_ch = weighted_chunks(s)
    base, length = [], []
    for leaf in range(k):
        for ch in range(n_ch):
            base.append(leaf * s + ch * C)
            length.append(min(C, s - ch * C))
    return torch.tensor(base), torch.tensor(length)


def classes_and_masks(c, valid, q_lo, q_hi):
    """Per (query, segment): covered and mixed as the tile kernel decides
    them (box of the valid non-NaN samples, NaN flag, then the slot test),
    and the mixed pairs' masks, ceil(min(s, C) / 32) words of 32 slots."""
    k, s, d = c.shape
    base, length = segments(k, s)
    nw = -(-min(s, C) // 32)
    j = torch.arange(nw * 32)
    inseg = j[None] < length[:, None]
    idx = torch.where(inseg, base[:, None] + j[None], 0)
    cf = c.reshape(k * s, d)[idx]                             # (K, L, d)
    vf = valid.reshape(-1)[idx] & inseg
    on = vf[..., None] & ~torch.isnan(cf)
    blo = torch.where(on, cf, float("inf")).amin(1)
    bhi = torch.where(on, cf, float("-inf")).amax(1)
    flag = (vf[..., None] & torch.isnan(cf)).any(-1).any(-1)
    ql, qh = q_lo[:, None], q_hi[:, None]
    covered = ~flag[None] & ((ql <= blo[None]) & (bhi[None] <= qh)).all(-1)
    apart = ((qh < blo[None]) | (bhi[None] < ql)).any(-1)
    inside = (((q_lo[:, None, None] <= cf[None])
               & (cf[None] <= q_hi[:, None, None])).all(-1) & vf[None])
    mixed = ~covered & ~apart & inside.any(-1)
    words = (inside.view(*inside.shape[:2], nw, 32).long()
             << torch.arange(32)).sum(-1)                     # (Q, K, nw)
    return covered, mixed, words, base, length


def stage_min(R, s):
    """The plan's stage_min: the fewest mixed pairs of a segment in a tile
    that the staged walk takes (none up to R = WEIGHTED_PAIR_R within one
    chunk)."""
    return _WSTAGE if R > WEIGHTED_PAIR_R or s > C else _WQT + 1


def walk_items(Q, k, s, d, mixed, words, least=_WSTAGE):
    """The tile kernel's step 3: per tile of 32 queries x LT segments (the
    plan's LT), its entries (q - q0 << 16 | segment, mask words): those of
    segments with fewer than ``least`` mixed pairs first (their count: the
    tile's direct entries), then the others, each kind by segment and in
    query order within one, and an item per such segment, packed as the
    kernel packs it."""
    lt, _ = weighted_plan(Q, k, s, d)
    K = mixed.shape[1]
    n_qt = -(-Q // _WQT)
    n_tiles = n_qt * -(-K // lt)
    lists, items, direct = {}, [], {}
    for tile in range(n_tiles):
        q0, g0 = tile % n_qt * _WQT, tile // n_qt * lt
        groups = [(seg, [q for q in range(q0, min(Q, q0 + _WQT))
                         if mixed[q, g0 + seg]])
                  for seg in range(min(lt, K - g0))]
        small = {seg for seg, qs in groups if len(qs) < least}
        ent = [((q - q0) << 16 | seg, words[q, g0 + seg])
               for seg, qs in groups if seg in small for q in qs]
        direct[tile] = len(ent)
        for seg, qs in groups:
            if len(qs) >= least:
                items.append((tile, seg | len(ent) << 5 | len(qs) << 15))
                ent += [((q - q0) << 16 | seg, words[q, g0 + seg])
                        for q in qs]
        lists[tile] = ent
    return lt, n_qt, lists, items, direct


def unpack(lt, n_qt, lists, items):
    """What a walk unit reads of each item: its segment, first query, and
    its pairs' queries and masks (padded to 32 pairs with empty masks)."""
    out = []
    for tile, y in items:
        seg, first, n = y & 31, (y >> 5) & 1023, y >> 15
        q0, g = tile % n_qt * _WQT, tile // n_qt * lt + seg
        ent = lists[tile][first:first + n]
        assert all(h & 0xFFFF == seg for h, _ in ent)
        qs = [q0 + (h >> 16) for h, _ in ent]
        masks = torch.stack([m for _, m in ent])
        masks = torch.cat([masks, masks.new_zeros(_WQT - n, masks.shape[1])])
        out.append((g, qs, masks))
    return out


def walk_direct(lt, n_qt, lists, direct, a, W, base, length):
    """weighted_mixed_kernel: each tile's first direct[tile] entries, a
    thread per (pair, replicate) adding the pair's set bits in ascending
    slot order. Returns {(g, q): (R, 3)}."""
    R = W.shape[0]
    Wf, af = W.reshape(R, -1), a.reshape(-1)
    ents = [(tile // n_qt * lt + (h & 0xFFFF), tile % n_qt * _WQT + (h >> 16),
             mask) for tile, ent in lists.items()
            for h, mask in ent[:direct[tile]]]
    if not ents:
        return {}
    g = torch.tensor([e[0] for e in ents])
    o, L = base[g], length[g]
    masks = torch.stack([e[2] for e in ents])                 # (P, nw)
    m = torch.zeros((len(ents), R, 3))
    for j in range(int(L.max())):
        held = ((masks[:, j // 32] >> (j % 32)) & 1).bool()[:, None, None]
        idx = torch.where(j < L, o + j, 0)
        m = torch.where(held, m + terms(Wf[:, idx].T, af[idx, None]), m)
    return {(gi, q): m[i] for i, (gi, q, _) in enumerate(ents)}


def terms(w, a):
    wa = w * a
    return torch.stack([w, wa, wa * a], -1)


def walk_replicates(units, a, W, base, length):
    """weighted_walk_reps_kernel: per unit (item, block of _WRB replicates)
    the segment's sub-chunks of _WSUB slots staged as [slot][replicate]
    (NaN where nothing is staged), a warp per pair (pairs w, w + WARPS, ...
    of the item in accumulators (WARPS, PPW)), a lane per replicate, set
    bits in ascending slot order. Returns {(g, q): (R, 3)}."""
    R = W.shape[0]
    n_rb = -(-R // _WRB)
    Wf, af = W.reshape(R, -1), a.reshape(-1)
    I = len(units)
    g = torch.tensor([x[0] for x in units])
    o, L = base[g], length[g]
    masks = torch.stack([x[2] for x in units])                # (I, 32, nw)
    lane_r = torch.arange(n_rb * _WRB).view(n_rb, _WRB)
    m = torch.zeros((I, n_rb, WARPS, PPW, _WRB, 3))
    for t in range(-(-int(L.max()) // _WSUB)):
        jj = t * _WSUB + torch.arange(_WSUB)
        staged = jj[None] < L[:, None]                        # (I, SUB)
        sidx = torch.where(staged, o[:, None] + jj[None], 0)
        sa = torch.where(staged, af[sidx], NAN)
        ok = staged[:, None, :, None] & (lane_r < R)[None, :, None, :]
        sw = torch.where(ok, Wf[lane_r.clamp(max=R - 1)[None, :, None, :],
                                sidx[:, None, :, None]], NAN)
        for wd in range(_WSUB // 32):
            if t * _WSUB // 32 + wd >= masks.shape[2]:
                break
            bits = masks[:, :, t * _WSUB // 32 + wd]          # (I, 32)
            # Pair e is warp e % WARPS's (e // WARPS)-th.
            bits = bits.view(I, PPW, WARPS).transpose(1, 2)
            for b in range(32):
                held = ((bits >> b) & 1).bool()[:, None, :, :, None, None]
                jl = wd * 32 + b
                x = terms(sw[:, :, jl, :], sa[:, jl, None, None])
                m = torch.where(held, m + x[:, :, None, None], m)
    m = m.transpose(2, 3).reshape(I, n_rb, _WQT, _WRB, 3)
    out = {}
    for i, (gi, qs, _) in enumerate(units):
        for e, q in enumerate(qs):
            out[gi, q] = m[i, :, e].reshape(n_rb * _WRB, 3)[:R]
    return out


def walk_pairs(units, a, W, base, length):
    """weighted_walk_pairs_kernel: per unit (item, replicate) a lane a pair;
    per word of 32 slots the terms of the word's slots (+0.0 past the
    segment), then slot by slot each lane adds its pair's selected terms,
    +0.0 where its mask bit is clear. Returns {(g, q): (R, 3)}."""
    R = W.shape[0]
    Wf, af = W.reshape(R, -1), a.reshape(-1)
    I = len(units)
    g = torch.tensor([x[0] for x in units])
    o, L = base[g], length[g]
    masks = torch.stack([x[2] for x in units])                # (I, 32, nw)
    m = torch.zeros((I, R, _WQT, 3))
    for wd in range(masks.shape[2]):
        j = wd * 32 + torch.arange(32)
        here = j[None] < L[:, None]                           # (I, 32)
        idx = torch.where(here, o[:, None] + j[None], 0)
        x = torch.where(here[:, None, :, None],
                        terms(Wf[:, idx].permute(1, 0, 2), af[idx][:, None]),
                        0.0)                                  # (I, R, 32, 3)
        bits = masks[:, :, wd]                                # (I, 32 lanes)
        for b in range(32):
            held = ((bits >> b) & 1).bool()[:, None, :, None]
            m = m + torch.where(held, x[:, :, b, None], 0.0)
    out = {}
    for i, (gi, qs, _) in enumerate(units):
        for e, q in enumerate(qs):
            out[gi, q] = m[i, :, e]
    return out


def launch_replay(c, a, valid, W, q_lo, q_hi, layout, least):
    """(R, Q, k, 3) as the launch computes it with the staged walk in
    ``layout`` taking segments of ``least`` or more mixed pairs a tile: the
    tile kernel's +0.0 / the segment's totals, the walks' values over the
    mixed pairs, the chunk partials folded in chunk order."""
    k, s, d = c.shape
    Q, R = q_lo.shape[0], W.shape[0]
    covered, mixed, words, base, length = classes_and_masks(c, valid, q_lo,
                                                            q_hi)
    n_ch = weighted_chunks(s)
    lt, n_qt, lists, items, direct = walk_items(Q, k, s, d, mixed, words,
                                                least)
    assert len(items) == len({(t, y & 31) for t, y in items})
    units = unpack(lt, n_qt, lists, items)
    # Totals of each segment's valid slots, the covered pairs' values.
    j = torch.arange(int(length.max()))
    inseg = j[None] < length[:, None]
    idx = torch.where(inseg, base[:, None] + j[None], 0)
    vf = valid.reshape(-1)[idx] & inseg                       # (K, L)
    tot = slot_fold(W.reshape(R, -1)[:, idx], a.reshape(-1)[idx][None],
                    vf[None].expand(R, -1, -1))               # (R, K, 3)
    part = torch.where(covered[None, ..., None], tot[:, None], 0.0)
    walk = walk_replicates if layout == "replicates" else walk_pairs
    walked = walk_direct(lt, n_qt, lists, direct, a, W, base, length)
    if units:
        walked.update(walk(units, a, W, base, length))
    for (gi, q), v in walked.items():
        part[:, q, gi] = v
    assert len(walked) == int(mixed.sum())
    part = part.view(R, Q, k, n_ch, 3)
    out = part[:, :, :, 0]
    for ch in range(1, n_ch):
        out = out + part[:, :, :, ch]
    return out


def chunk_folds(c, a, valid, W, q_lo, q_hi):
    """The order contract's reference: per (replicate, query, stratum,
    chunk of C slots) the slot-order fold from +0.0 of the relevant slots
    (slot_fold), the partials left-folded in chunk order."""
    from repro_torch.kernels.stratified_estimate import samples_inside
    k, s, _ = c.shape
    n_ch = weighted_chunks(s)
    width = C if s > C else s
    pad = n_ch * width - s
    inside = torch.nn.functional.pad(samples_inside(c, valid, q_lo, q_hi),
                                     (0, pad))
    Wp = torch.nn.functional.pad(W, (0, pad))
    ap = torch.nn.functional.pad(a, (0, pad))
    part = slot_fold(Wp.view(-1, 1, k, n_ch, width),
                     ap.view(1, 1, k, n_ch, width),
                     inside.view(1, -1, k, n_ch, width))
    out = part[..., 0, :]
    for ch in range(1, n_ch):
        out = out + part[..., ch, :]
    return out


def same_bits(x, y):
    return x.shape == y.shape and torch.equal(x.view(torch.int32),
                                              y.view(torch.int32))


@pytest.mark.parametrize("R", [1, 31, 33])
@pytest.mark.parametrize("k,s,d", [(3, 75, 2), (1, C, 1), (3, C + 1, 1),
                                   (1, 40_000, 1)])
def test_walk_replay_matches_slot_fold(k, s, d, R):
    """The direct walk and both lane layouts of the staged one, at every s,
    bit-equal to the chunked slot-order folds (and, up to C + 1 slots, to
    test_torch_weighted_chunks.replay): the launch's own split (R = 1
    takes the pair layout above one chunk and the direct walk alone
    within one, 31 and 33 the replicate layout, a unit of 128 replicates
    with 31 or 33 of them real) and the staged split at _WSTAGE pairs."""
    c, a, valid, W, q_lo, q_hi = walk_inputs(37, k, s, d, R,
                                             seed=s + 7 * k + R)
    _, mixed, words, _, _ = classes_and_masks(c, valid, q_lo, q_hi)
    _, _, lists, items, direct = walk_items(37, k, s, d, mixed, words)
    # Both walks run: some tiles' segments hold _WSTAGE or more mixed
    # pairs, others fewer.
    assert items and sum(direct.values()) > 0
    want = chunk_folds(c, a, valid, W, q_lo, q_hi)
    assert torch.isfinite(want).all()
    if s <= C + 1:
        assert same_bits(replay(c, a, valid, W, q_lo, q_hi)[0], want)
    assert weighted_walk(R, s) == (
        "replicates" if R > WEIGHTED_PAIR_R
        else "pairs" if s > C else "direct")
    for least in sorted({stage_min(R, s), _WSTAGE}):
        for layout in ("pairs", "replicates"):
            got = launch_replay(c, a, valid, W, q_lo, q_hi, layout, least)
            assert same_bits(got, want), (layout, least)


def test_walk_items_pack():
    """An item's fields survive the kernel's packing at their extremes (a
    segment up to 31, a first entry up to 1023, up to 32 pairs), and the
    tile kernel's lists hold each tile's mixed pairs once, by segment."""
    for seg, first, n in ((0, 0, 1), (31, 1023 - 31, 32), (17, 5, 32),
                          (31, 1023, 1)):
        y = seg | first << 5 | n << 15
        assert (y & 31, (y >> 5) & 1023, y >> 15) == (seg, first, n)
        assert 0 <= y < 2 ** 31
    c, a, valid, W, q_lo, q_hi = walk_inputs(70, 3, 300, 1, 2, seed=3)
    _, mixed, words, _, _ = classes_and_masks(c, valid, q_lo, q_hi)
    lt, n_qt, lists, items, direct = walk_items(70, 3, 300, 1, mixed,
                                                words)
    assert lt == 32 and n_qt == 3
    for tile, ent in lists.items():
        # The direct entries, then the staged ones, each in segment order.
        for part in (ent[:direct[tile]], ent[direct[tile]:]):
            segs = [h & 0xFFFF for h, _ in part]
            assert segs == sorted(segs)
    got = sorted((tile // n_qt * lt + (y & 31), tile % n_qt, y >> 15)
                 for tile, y in items)
    counts = [(g, qt, int(mixed[qt * 32:qt * 32 + 32, g].sum()))
              for g in range(mixed.shape[1]) for qt in range(n_qt)]
    assert got == sorted(x for x in counts if x[2] >= _WSTAGE)
    assert sum(direct.values()) == sum(x[2] for x in counts
                                       if x[2] < _WSTAGE)
    assert got and sum(direct.values())
