"""Rows 3 and 4 (the bootstrap's weighted moments) above one slot chunk:
the plain versions and the CPU bootstrap answer against the JAX package's
jnp path, and the chunked decomposition of csrc/weighted_moments.cu
replayed in torch.

Above WEIGHTED_CHUNK slots a stratum the CUDA launch cuts each stratum's
slots into chunks of WEIGHTED_CHUNK consecutive slots ("segments"). Each
(query, stratum, chunk) triple is classified from the chunk's own box
around its valid samples (NaN coordinates skipped, and a flag for a NaN
coordinate on a valid slot): a covered triple takes the chunk's totals
over its valid slots, an empty one +0.0, a mixed one walks the chunk's
relevant slots; each of these is a slot-order fold from +0.0 through the
pinned update [w, w*a, (w*a)*a], and a pair's moments are the left fold
of its chunk partials in chunk order. The kernels run only on the card
(chip_smoke.py holds them against their plain versions there); here the
decomposition is replayed and held to the kernels' bar, rtol=3e-5,
atol=1e-3 (fp32 sums in another order than the plain version's pairwise
tree), and the launch's plan and scratch are held to the source's
constants.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.api import (PassEngine as JEngine, ServingConfig as JServing,
                       CIConfig as JCI)
from repro.core.baselines import uniform_synopsis as juniform
from repro.core.query import random_queries as jrandom_queries
from repro.kernels import backends as _jax_backends  # noqa: F401 (registers)
from repro.kernels.registry import get_backend
from repro_torch.api import PassEngine, ServingConfig, CIConfig
from repro_torch.kernels import ops
from repro_torch.kernels.bootstrap import bootstrap_moments_plain
from repro_torch.kernels.stratified_estimate import (
    WEIGHTED_CHUNK, WEIGHTED_PAIR_R, _WLT_MAX, _WMAX_D, _WMAX_SMEM, _WQT,
    _WRB, _WRB_MAX, _WSTAGE, _WSUB, _WWALK_T, samples_inside,
    weighted_chunks,
    weighted_moments_plain, weighted_plan, weighted_scratch_floats,
    weighted_walk)
from test_torch_engine import (assert_results_close, carry, carry_queries)

C = WEIGHTED_CHUNK
RTOL, ATOL = 3e-5, 1e-3
BOOT = ("sum", "count", "avg")
SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "weighted_moments.cu")


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def chunk_inputs(Q, k, s, d, R, seed, nan=False):
    """Samples of k strata whose chunks fall into bands of the unit cube
    (chunk ch of a stratum in [ch / n_ch, (ch + 1) / n_ch) along column 0),
    ragged validity (stratum k // 2 without a valid slot when k > 1),
    Poisson and non-integer weights (on invalid slots too), and queries
    that cover everything (0), miss everything (1), hold one chunk's band
    exactly (2), and random bands (the rest), so covered, empty and mixed
    (query, stratum, chunk) triples all occur. With ``nan``, column d - 1
    of one valid slot of every stratum's first chunk is NaN."""
    rng = np.random.default_rng(seed)
    n_ch = weighted_chunks(s)
    ch = np.minimum(np.arange(s) // C, n_ch - 1)
    c = rng.uniform(0, 1, (k, s, d)).astype(np.float32)
    c[..., 0] = ((ch[None] + rng.uniform(0.05, 0.95, (k, s))) / n_ch
                 ).astype(np.float32)
    a = rng.gamma(2.0, 1.0, (k, s)).astype(np.float32)
    valid = rng.random((k, s)) < 0.8
    if k > 1:
        valid[k // 2] = False
    W = rng.poisson(1.0, (R, k, s)).astype(np.float32)
    W[:, :, ::5] = rng.uniform(0, 2.5, W[:, :, ::5].shape)
    q_lo = rng.uniform(0, 0.6, (Q, d)).astype(np.float32)
    q_hi = (q_lo + rng.uniform(0.05, 0.6, (Q, d))).astype(np.float32)
    q_lo[0], q_hi[0] = -1.0, 2.0
    q_lo[1], q_hi[1] = 3.0, 4.0
    q_lo[2], q_hi[2] = -1.0, 2.0
    q_lo[2, 0], q_hi[2, 0] = 0.0, np.float32(1.0 / n_ch)
    if nan:
        for leaf in range(k):
            on = np.flatnonzero(valid[leaf, :min(s, C)])
            if on.size:
                c[leaf, on[0], d - 1] = np.nan
    return c, a, valid, W, q_lo, q_hi


def slot_fold(w, a, inside):
    """[sum w, sum w*a, sum (w*a)*a] over the last axis in slot order from
    +0.0, float32 throughout (the kernel's weighted_terms / weighted_add:
    each product and sum rounded once)."""
    shape = torch.broadcast_shapes(w.shape, inside.shape)[:-1]
    m = torch.zeros(shape + (3,), dtype=torch.float32)
    for i in range(inside.shape[-1]):
        p = torch.where(inside[..., i], w[..., i], 0.0)
        pa = p * a[..., i]
        on = inside[..., i]
        # A slot outside the box adds nothing (not even a +0.0).
        m[..., 0] = torch.where(on, m[..., 0] + p, m[..., 0])
        m[..., 1] = torch.where(on, m[..., 1] + pa, m[..., 1])
        m[..., 2] = torch.where(on, m[..., 2] + pa * a[..., i], m[..., 2])
    return m


def replay(c, a, valid, W, q_lo, q_hi):
    """(R, Q, k, 3) as the launch computes it, and per-chunk class counts."""
    k, s, d = c.shape
    inside = samples_inside(c, valid, q_lo, q_hi)[None]        # (1, Q, k, s)
    Wq = W[:, None]                                             # (R, 1, k, s)
    parts, counts = [], []
    for s0 in range(0, max(s, 1), C):
        s1 = min(s, s0 + C)
        cv, vv = c[:, s0:s1], valid[:, s0:s1]
        on = vv[..., None] & ~torch.isnan(cv)
        blo = torch.where(on, cv, float("inf")).amin(1)
        bhi = torch.where(on, cv, float("-inf")).amax(1)
        flag = (vv[..., None] & torch.isnan(cv)).any(-1).any(-1)
        ql, qh = q_lo[:, None], q_hi[:, None]
        covered = ~flag[None] & ((ql <= blo[None]) & (bhi[None] <= qh)).all(-1)
        apart = ((qh < blo[None]) | (bhi[None] < ql)).any(-1)
        mixed = ~covered & ~apart
        counts.append({"covered": int(covered.sum()),
                       "empty": int((apart & ~covered).sum()),
                       "mixed": int(mixed.sum())})
        ins = inside[..., s0:s1]
        walk = slot_fold(Wq[..., s0:s1], a[None, None, :, s0:s1], ins)
        totals = slot_fold(W[..., s0:s1], a[None, :, s0:s1],
                           vv[None].expand(W.shape[0], k, s1 - s0))
        # Covered: the chunk's totals are the walk's bits; empty: +0.0.
        cov = covered[None, ..., None].expand_as(walk)
        assert torch.equal(walk[cov], totals[:, None].expand_as(walk)[cov])
        emp = (apart & ~covered)[None, ..., None].expand_as(walk)
        assert (walk[emp].view(torch.int32) == 0).all()
        parts.append(walk)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out, counts


# ---------------------------------------------------------------------------
# The launch's constants, plan and scratch against the source
# ---------------------------------------------------------------------------

def test_constants_match_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("CHUNK") == WEIGHTED_CHUNK == 2048
    assert (const("QT"), const("LT_MAX"), const("RB_MAX"), const("MAX_D"),
            const("MAX_SMEM")) == (_WQT, _WLT_MAX, _WRB_MAX, _WMAX_D,
                                   _WMAX_SMEM)
    # The walks: a tile's pairs of a segment are staged from N_STAGE of
    # them; the staged walk's lanes take pairs up to R = PAIR_R, else RL
    # replicates a lane (units of RB = 32 * RL) staging SUB slots at a
    # time, in blocks of WALK_T threads.
    assert (const("PAIR_R"), const("N_STAGE"), const("RL"), const("SUB"),
            const("WALK_T")) == (WEIGHTED_PAIR_R, _WSTAGE, _WRB // 32,
                                 _WSUB, _WWALK_T) == (8, 8, 4, 64, 256)
    assert re.search(r"constexpr int RB = 32 \* RL;", src)
    assert [weighted_walk(R, C + 1) for R in (1, 8, 9, 200)] == \
        ["pairs", "pairs", "replicates", "replicates"]
    assert [weighted_walk(R, C) for R in (1, 8, 9)] == \
        ["direct", "direct", "replicates"]


@pytest.mark.parametrize("s,d,lt", [(75, 1, 32), (75, 16, 32), (300, 3, 32),
                                    (1025, 3, 32), (C, 1, 16), (C + 1, 1, 16),
                                    (19_250, 1, 16), (40_000, 16, 16),
                                    (2 ** 31 - 1, 3, 16)])
def test_plan_segments_per_tile(s, d, lt):
    """The tile's (query, slot) mask is sized by one chunk at most, so the
    plan keeps 16 segments a tile at any s."""
    got, nbytes = weighted_plan(2048, 1, s, d)
    assert got == lt and nbytes <= _WMAX_SMEM


def test_scratch_above_one_chunk():
    """The scratch grows with the segments and, above one chunk, holds the
    (R, Q, k * n_ch, 3) partials; it is sized for the plan's own tiles, not
    for the narrowest one (PR 14 sized 32 * (k + 31) list entries a query
    tile). The walk's two counters start at a multiple of 4 floats (a
    64-bit one first) and hold an item (2 ints) per (tile, segment)."""
    assert C == 2048
    assert weighted_chunks(0) == weighted_chunks(C) == 1
    assert weighted_chunks(C + 1) == 2 and weighted_chunks(3 * C + 1) == 4
    # Table 1's US shape: 19 segments of one stratum, 16 a tile.
    us = weighted_scratch_floats(200, 2048, 1, 38_500, 1)
    K, tiles = 19, 64 * 2
    head = 200 * K * 3 + K * 2 + K * 64 + K + tiles
    assert head % 4
    head = (-(-head // 4) * 4 + 4 + 2 * tiles * 16
            + tiles * 32 * 16 * 65)
    # The partials start at a multiple of 4 floats (16-byte stores).
    assert us == -(-head // 4) * 4 + 200 * 2048 * K * 3
    assert us * 4 < 128 * 2 ** 20
    one = weighted_scratch_floats(200, 2048, 1, C, 1)
    assert one == (-(-(200 * 3 + 2 + 64 + 1 + 64) // 4) * 4 + 4
                   + 2 * 64 * 16 + 64 * 32 * 16 * 65)


# ---------------------------------------------------------------------------
# The plain versions against the JAX package's jnp path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("s", [C + 1, 40_000])
def test_plain_matches_jax_above_one_chunk(k, s):
    c, a, valid, W, q_lo, q_hi = chunk_inputs(5, k, s, 2, 3, seed=s + k)
    be = get_backend("jnp")
    want_w = jax.jit(be.weighted_moments)(
        *map(jnp.asarray, (c, a, valid, W[0], q_lo, q_hi)))
    want_b = np.asarray(jax.jit(be.bootstrap_moments)(
        *map(jnp.asarray, (c, a, valid, W, q_lo, q_hi))))
    tc, ta, tv, tW, tl, th = _t(c, a, valid, W, q_lo, q_hi)
    got_w = weighted_moments_plain(tc, ta, tv, tW[0], tl, th)
    got_b = bootstrap_moments_plain(tc, ta, tv, tW, tl, th)
    for i in range(3):
        np.testing.assert_allclose(got_w[..., i].numpy(),
                                   np.asarray(want_w[i]), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=RTOL, atol=ATOL)
    # The ops dispatch of CPU tensors is the plain version, and each
    # replicate of the block is the one-row version (DESIGN.md §10).
    assert torch.equal(ops.bootstrap_moments(tc, ta, tv, tW, tl, th), got_b)
    for r in range(W.shape[0]):
        assert torch.equal(got_b[r], weighted_moments_plain(tc, ta, tv, tW[r],
                                                            tl, th))


# ---------------------------------------------------------------------------
# The chunked decomposition, replayed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,s,d,nan", [(1, C + 1, 1, False),
                                       (3, 40_000, 2, False),
                                       (3, 40_000, 2, True)])
def test_chunked_replay_matches_plain(k, s, d, nan):
    c, a, valid, W, q_lo, q_hi = _t(*chunk_inputs(6, k, s, d, 2,
                                                  seed=7 * s + k, nan=nan))
    got, counts = replay(c, a, valid, W, q_lo, q_hi)
    assert len(counts) == weighted_chunks(s)
    for cls in ("covered", "empty", "mixed"):
        assert sum(x[cls] for x in counts) > 0, (cls, counts)
    if nan:
        # A chunk with a NaN coordinate on a valid slot is never covered:
        # query 0 holds every other sample of every stratum's first chunk.
        # Only stratum k // 2, without a valid slot, is covered (its
        # totals are +0.0) under each of the 6 queries.
        assert counts[0]["covered"] == 6 * int(k > 1)
    want = bootstrap_moments_plain(c, a, valid, W, q_lo, q_hi)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# The bootstrap answer above one chunk (ROADMAP Queue 3 item 1's input)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def us_input():
    """200,000 rows, c ~ U(0, 1), a ~ Gamma(2, 1) from default_rng(0),
    uniform_synopsis(sample_budget=40,000): one stratum of 40,000 slots;
    16 random queries (seed 0)."""
    rng = np.random.default_rng(0)
    c = rng.uniform(0, 1, 200_000).astype(np.float32)
    a = rng.gamma(2.0, 1.0, 200_000).astype(np.float32)
    jsyn, _ = juniform(c, a, sample_budget=40_000, seed=0)
    assert jsyn.sample_a.shape == (1, 40_000)
    jq = jrandom_queries(c, 16, seed=0)
    return jsyn, carry(jsyn), jq, carry_queries(jq)


def test_bootstrap_answer_above_one_chunk_matches_jax(us_input):
    """PassEngine(CIConfig(method="bootstrap", n_boot=8, key=1)) at k = 1,
    s = 40,000 on the CPU against the JAX package (its query 0: SUM
    77142.74, ci_half 2193.64), within the engine tests' tolerances; fused
    and scan bit-equal."""
    jsyn, tsyn, jq, tq = us_input
    kw = dict(method="bootstrap", n_boot=8, key=1)
    jres = JEngine(jsyn, JServing(kinds=BOOT), ci=JCI(**kw)).answer(jq)
    np.testing.assert_allclose(float(jres["sum"].estimate[0]), 77142.74,
                               rtol=1e-6)
    np.testing.assert_allclose(float(jres["sum"].ci_half[0]), 2193.64,
                               rtol=1e-5)
    fused = PassEngine(tsyn, ServingConfig(kinds=BOOT), ci=CIConfig(**kw),
                       device="cpu").answer(tq)
    assert_results_close(jres, fused, BOOT)
    scan = PassEngine(tsyn, ServingConfig(kinds=BOOT),
                      ci=CIConfig(boot_fused=False, **kw),
                      device="cpu").answer(tq)
    for kind in BOOT:
        for field in ("estimate", "ci_lo", "ci_hi"):
            assert torch.equal(getattr(fused[kind], field),
                               getattr(scan[kind], field)), (kind, field)
