"""Signed zeros in the port's MIN/MAX (aggregates, extremes, boxes and
the serving epilogue's bounds, clips and zero clamps), and the CPU replays
of the sample_extremes and query_eval kernels, against the JAX package.

XLA's min and max, under the JAX package's aggregates, extremes and boxes,
order -0.0 below +0.0; the port follows that rule through
``repro_torch.minmax``. These tests compare bits (int32 views, every NaN
as one code): numpy's equality takes -0.0 == +0.0 and would not see a
difference. The CUDA kernels run only on the card (chip_smoke.py holds
them against their plain versions there); here their decompositions are
replayed in torch and held against the plain versions bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.api import (PassEngine as JEngine, ServingConfig as JServing,
                       CIConfig as JCI)
from repro.core import query as jquery
from repro.core.synopsis import build_synopsis as jbuild
from repro.kernels import backends as _jax_backends  # noqa: F401 (registers)
from repro.kernels.ref import segment_reduce_ref
from repro.kernels.registry import get_backend
from repro.streaming import StreamingIngestor as JIngestor
from repro_torch import minmax
from repro_torch.api import PassEngine, ServingConfig, CIConfig
from repro_torch.engine.executor import slice_sample_slots
from repro_torch.kernels import ops
from repro_torch.kernels.query_eval import (QE_LEAF_TILE, QE_MAX_QUERIES,
                                            QE_THREADS, classify_leaves,
                                            query_eval_plain)
from repro_torch.kernels.sample_extremes import (
    BIG, EXTREMES_LT, EXTREMES_QT, check_extremes_limits,
    sample_extremes_plain)
from repro_torch.kernels.segment_reduce import segment_reduce_plain
from repro_torch.kernels.stratified_estimate import samples_inside
from repro_torch.streaming import StreamingIngestor
from test_torch_engine import carry, carry_queries

F32_MAX = np.float32(3.4028235e38)
SPECIAL = np.float32([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, BIG,
                      -BIG, F32_MAX, -F32_MAX])


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def bits(x):
    """int32 view of float32 values, every NaN as one code."""
    x = np.array(x, np.float32)
    b = x.view(np.int32).copy()
    b[np.isnan(x)] = 0x7FC00000
    return b


def assert_bits_equal(got, want, msg=""):
    g, w = bits(got), bits(want)
    assert g.shape == w.shape, (msg, g.shape, w.shape)
    if not np.array_equal(g, w):
        i = tuple(np.argwhere(g != w)[0])
        raise AssertionError(
            f"{msg}: {int((g != w).sum())} values differ in their bits, "
            f"first at {i}: {np.asarray(got)[i]!r} vs {np.asarray(want)[i]!r}")


# ---------------------------------------------------------------------------
# The helper against XLA's min and max
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["minimum", "maximum"])
def test_elementwise_matches_jnp(op):
    """Every pair of +-0.0, +-1, +-inf, NaN, +-BIG and +-FLT_MAX."""
    a = np.repeat(SPECIAL, SPECIAL.size)
    b = np.tile(SPECIAL, SPECIAL.size)
    got = getattr(minmax, op)(*_t(a, b))
    assert_bits_equal(got, getattr(jnp, op)(a, b), op)


@pytest.mark.parametrize("dim", [0, 1, -1])
@pytest.mark.parametrize("op", ["min", "max"])
def test_masked_matches_jnp(op, dim):
    """Masked reductions over values drawn mostly from +-0.0, with NaN,
    +-inf and values beyond +-BIG, each axis, fills +-BIG and +-inf."""
    rng = np.random.default_rng(7 + dim)
    x = rng.choice(SPECIAL, (9, 13, 6), p=[0.3, 0.3] + [0.4 / 9] * 9)
    x[rng.random(x.shape) < 0.02] = np.nan
    mask = rng.random(x.shape) < 0.6
    fn = minmax.masked_min if op == "min" else minmax.masked_max
    ref = jnp.min if op == "min" else jnp.max
    for fill in ((BIG, np.inf) if op == "min" else (-BIG, -np.inf)):
        got = fn(*_t(x, mask), fill, dim)
        assert_bits_equal(got, ref(jnp.where(mask, x, np.float32(fill)),
                                   axis=dim), f"{op} dim={dim} fill={fill}")


@pytest.mark.parametrize("op", ["min", "max"])
def test_scatter_matches_jax(op):
    """Scatter into values that hold +-0.0 themselves (the output takes
    part), ids with repeats, NaN and +-inf sources."""
    rng = np.random.default_rng(3)
    out = rng.choice(SPECIAL[:6], 40)
    src = rng.choice(SPECIAL, 300, p=[0.35, 0.35] + [0.3 / 9] * 9)
    idx = rng.integers(0, 40, 300)
    got = torch.from_numpy(out.copy())
    fn = minmax.scatter_min_ if op == "min" else minmax.scatter_max_
    fn(got, torch.from_numpy(idx), torch.from_numpy(src))
    want = getattr(jnp.asarray(out).at[idx], op)(src)
    assert_bits_equal(got, want, op)


# ---------------------------------------------------------------------------
# The three sites the signed-zero rule repairs
# ---------------------------------------------------------------------------

def _zero_extremes_case():
    """One query over two strata whose sample values are [+0.0, -0.0] and
    [-0.0, +0.0], every slot valid and inside."""
    c = np.float32([[[0.25], [0.5]], [[0.25], [0.5]]])
    a = np.float32([[0.0, -0.0], [-0.0, 0.0]])
    valid = np.ones((2, 2), bool)
    return c, a, valid, np.float32([[0.0]]), np.float32([[1.0]])


def _random_zero_extremes(seed, Q=17, k=23, s=9, d=2):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (k, s, d)).astype(np.float32)
    a = rng.choice(np.float32([0.0, -0.0, 2.0, -3.0]), (k, s),
                   p=[0.4, 0.4, 0.1, 0.1])
    valid = rng.random((k, s)) < 0.8
    q_lo = rng.uniform(0, 0.5, (Q, d)).astype(np.float32)
    q_hi = q_lo + rng.uniform(0, 0.7, (Q, d)).astype(np.float32)
    return c, a, valid, q_lo, q_hi


@pytest.mark.parametrize("case", ["two-strata", "random"])
def test_sample_extremes_signed_zero_matches_jax(case):
    """The port's sample_extremes gives the jnp backend's bits where
    strata hold +0.0 and -0.0 in either order."""
    args = (_zero_extremes_case() if case == "two-strata"
            else _random_zero_extremes(11))
    mn, mx = ops.sample_extremes(*_t(*args))
    jmn, jmx = jax.jit(get_backend("jnp").sample_extremes)(
        *map(jnp.asarray, args))
    assert_bits_equal(mn, jmn, "samp_min")
    assert_bits_equal(mx, jmx, "samp_max")
    if case == "two-strata":
        assert np.signbit(mn.numpy()).all() and not np.signbit(
            mx.numpy()).any()


@pytest.mark.parametrize("case", ["two-segments", "random"])
def test_segment_reduce_signed_zero_matches_jax(case):
    """segment_reduce_plain's MIN/MAX columns give segment_reduce_ref's
    bits, and so do its count and sums here (sums of zeros)."""
    if case == "two-segments":
        v = np.float32([0.0, -0.0, -0.0, 0.0])
        ids = np.int32([0, 0, 1, 1])
        k = 2
    else:
        rng = np.random.default_rng(5)
        v = rng.choice(np.float32([0.0, -0.0, 1.0, -2.0]), 400,
                       p=[0.45, 0.45, 0.05, 0.05])
        ids = rng.integers(-1, 40, 400).astype(np.int32)
        k = 37
    got = segment_reduce_plain(*_t(v, ids), k)
    want = segment_reduce_ref(jnp.asarray(v), jnp.asarray(ids), k)
    assert_bits_equal(got[:, 2:], np.asarray(want)[:, 2:], case)
    if case == "two-segments":
        assert np.signbit(got[:, 3].numpy()).all()
        assert not np.signbit(got[:, 4].numpy()).any()


@pytest.mark.parametrize("d", [1, 3])
def test_merge_synopsis_signed_zero_matches_jax(d):
    """A base whose data holds +-0.0 values and +0.0 coordinates, then
    three batches of +-0.0 values at coordinates >= -0.0 (so that the
    boxes keep their +0.0 faces and meet -0.0 rows) through both
    ingestors: the state's boxes and delta MIN/MAX, and merge_synopsis's
    leaf and node MIN/MAX and boxes (JAX: repro.streaming.delta.
    merge_synopsis, through as_synopsis), give the reference's bits."""
    rng = np.random.default_rng(40 + d)
    n, k = 4000, 16
    c = rng.uniform(0, 100, (n, d))
    if d == 1:
        c = np.sort(c[:, 0])
        c[:300] = 0.0
    else:
        c[rng.random((n, d)) < 0.1] = 0.0
    a = rng.choice([0.0, -0.0, 1.0, -1.0], n, p=[0.4, 0.4, 0.1, 0.1])
    jsyn, _ = jbuild(c, a, k=k, sample_budget=4 * k,
                     method="eq" if d == 1 else "kd", seed=0)
    jing = JIngestor(jsyn, seed=5)
    ting = StreamingIngestor(carry(jsyn), seed=5, device="cpu")
    for _ in range(3):
        cb = rng.uniform(0, 110, (256, d)).astype(np.float32)
        cb[rng.random((256, d)) < 0.3] = -0.0
        cb[rng.random((256, d)) < 0.2] = 0.0
        ab = rng.choice(np.float32([0.0, -0.0, 2.0]), 256, p=[0.45, 0.45,
                                                                0.1])
        jing.ingest(cb, ab)
        ting.ingest(cb, ab)
    for f in ("leaf_lo", "leaf_hi"):
        assert_bits_equal(getattr(ting.state, f), getattr(jing.state, f),
                          f"state.{f}")
    assert_bits_equal(ting.state.delta_agg[:, 2:], jing.state.delta_agg[:, 2:],
                      "state.delta_agg MIN/MAX")
    tm, jm = ting.as_synopsis(), jing.as_synopsis()
    assert_bits_equal(tm.leaf_agg[:, 3:], jm.leaf_agg[:, 3:], "leaf MIN/MAX")
    assert_bits_equal(tm.tree.agg[:, 3:], jm.tree.agg[:, 3:], "node MIN/MAX")
    for f in ("lo", "hi"):
        assert_bits_equal(getattr(tm.tree, f), getattr(jm.tree, f),
                          f"tree.{f}")


@pytest.mark.parametrize("op", ["max0", "min0"])
def test_zero_clamps_match_jnp(op):
    """max0 / min0 against jnp.maximum(x, 0.0) / jnp.minimum(x, 0.0) on
    every special value, in vectorized lanes and the scalar tail."""
    x = np.tile(SPECIAL, 5)
    got = getattr(minmax, op)(torch.from_numpy(x))
    ref = jnp.maximum if op == "max0" else jnp.minimum
    assert_bits_equal(got, ref(x, np.float32(0.0)), op)


def test_clip_matches_jnp():
    """minmax.clip against jnp.clip on every triple of special values
    (bounds broadcast over a leading axis, as the interval clips have
    them)."""
    x = np.repeat(SPECIAL, SPECIAL.size ** 2)
    lo = np.tile(np.repeat(SPECIAL, SPECIAL.size), SPECIAL.size)
    hi = np.tile(SPECIAL, SPECIAL.size ** 2)
    got = minmax.clip(torch.from_numpy(np.stack([x, -x])),
                      *_t(lo, hi))
    assert_bits_equal(got, jnp.clip(np.stack([x, -x]), lo, hi), "clip")


def _zero_valued(d, seed, n=3000, k=16):
    """Every value +0.0 or -0.0, so that every sum is exact: strata whose
    extremes are -0.0, +0.0 or both."""
    rng = np.random.default_rng(seed)
    c = (np.sort(rng.uniform(0, 100, n)) if d == 1
         else rng.uniform(0, 100, (n, d)))
    a = rng.choice([0.0, -0.0], n)
    if d == 1:
        a[: n // 4] = -0.0          # whole strata of -0.0 only
    jsyn, _ = jbuild(c, a, k=k, sample_rate=0.05,
                     method="eq" if d == 1 else "kd", seed=0)
    jq = jquery.random_queries(c, 40, seed=seed + 1, min_frac=0.01,
                               max_frac=0.5)
    return jsyn, jq


ZERO_KINDS = ("sum", "avg", "min", "max")


@pytest.mark.parametrize("ci", ["none", "clt", "bootstrap"])
@pytest.mark.parametrize("d", [1, 3])
def test_engine_on_zero_valued_strata_matches_jax_bits(d, ci):
    """The JAX engine and the port's serve zero-valued strata; every field
    of SUM, AVG, MIN and MAX (all exact here) has the reference's bits,
    sign included: the AVG hard bounds' masked extremes and their MIN/MAX
    with the covered mean, and the interval clips of the CLT and the
    bootstrap. (COUNT is left out: its values are row counts, not zeros,
    and its float ratios are held to tolerance in test_torch_engine.py.)"""
    jsyn, jq = _zero_valued(d, seed=10 + d)
    kinds = ZERO_KINDS if ci != "bootstrap" else ("sum", "avg")
    jci = {"none": None, "clt": JCI(level=0.95),
           "bootstrap": JCI(method="bootstrap", n_boot=16, key=3)}[ci]
    tci = {"none": None, "clt": CIConfig(level=0.95),
           "bootstrap": CIConfig(method="bootstrap", n_boot=16, key=3)}[ci]
    jres = JEngine(jsyn, JServing(kinds=kinds), ci=jci).answer(jq)
    tres = PassEngine(carry(jsyn), ServingConfig(kinds=kinds), ci=tci,
                      device="cpu").answer(carry_queries(jq))
    signs = 0
    for kind in kinds:
        for f in ("estimate", "ci_half", "lower", "upper",
                  "frac_rows_touched", "ci_lo", "ci_hi"):
            g, w = getattr(tres[kind], f), getattr(jres[kind], f)
            if w is None:
                assert g is None, (kind, f)
                continue
            assert_bits_equal(g, w, f"{kind}.{f}")
            signs += int(np.signbit(np.asarray(w)).sum())
    assert signs > 0                   # some -0.0 among the answers


@pytest.mark.parametrize("ci", ["none", "clt"])
@pytest.mark.parametrize("d_fact", [1, 2])
def test_join_answer_on_zero_values_matches_jax_bits(d_fact, ci):
    """Fact values all +0.0 or -0.0 (whole cells of -0.0 among them): every
    field of the join SUM and AVG answers has the reference's bits, sign
    included: the cell bounds' max0 / min0 and their MIN / MAX, the AVG
    bounds' masked extremes and their MIN / MAX with the covered mean, the
    Bernstein-against-range MIN / MAX and the interval clips. (COUNT's
    values are row counts; tests/test_torch_joins.py holds it.)"""
    from repro.joins import build_dim_table as jdim
    from repro.joins import build_join_synopsis as jjbuild
    from repro.core.types import QueryBatch as JQB
    from repro_torch.core.types import QueryBatch
    from repro_torch.joins import build_dim_table, build_join_synopsis
    rng = np.random.default_rng(30 + d_fact)
    n, nd = 2500, 60
    c = (rng.normal(size=n) if d_fact == 1
         else rng.normal(size=(n, d_fact))).astype(np.float32)
    a = rng.choice([0.0, -0.0], n).astype(np.float32)
    keys = rng.integers(0, nd, n).astype(np.int32)
    a[keys < nd // 4] = -0.0            # whole dim partitions of -0.0
    dattr = rng.normal(size=nd).astype(np.float32)
    kw = dict(k=8, p_u=0.4, seed=1, method="adp" if d_fact == 1 else "kd",
              opt_samples=512)
    jsyn, _ = jjbuild(c, a, keys, jdim(np.arange(nd), dattr,
                                       num_partitions=4), **kw)
    tsyn, _ = build_join_synopsis(
        c, a, keys, build_dim_table(np.arange(nd), dattr, num_partitions=4,
                                    device="cpu"), device="cpu", **kw)
    pairs = np.sort(rng.normal(0, 1.2, (40, d_fact + 1, 2)), -1)
    lo, hi = (pairs[..., i].astype(np.float32) for i in (0, 1))
    kinds = ("sum", "avg")
    jres = JEngine(jsyn, ci=None if ci == "none" else JCI(level=0.95)
                   ).answer_join(JQB(jnp.asarray(lo), jnp.asarray(hi)),
                                 kinds=kinds)
    tres = PassEngine(tsyn, ci=None if ci == "none" else 0.95,
                      device="cpu").answer_join(
        QueryBatch(torch.from_numpy(lo), torch.from_numpy(hi)), kinds=kinds)
    signs = 0
    for kind in kinds:
        for f in ("estimate", "ci_half", "lower", "upper",
                  "frac_rows_touched", "ci_lo", "ci_hi"):
            g, w = getattr(tres[kind], f), getattr(jres[kind], f)
            if w is None:
                assert g is None, (kind, f)
                continue
            assert_bits_equal(g, w, f"{kind}.{f}")
            signs += int(np.signbit(np.asarray(w)).sum())
    assert signs > 0                   # some -0.0 among the answers


# ---------------------------------------------------------------------------
# The sample_extremes kernel's decomposition, replayed
# ---------------------------------------------------------------------------

def replay_extremes(c, a, valid, q_lo, q_hi):
    """sample_extremes as csrc/sample_extremes.cu computes it: each leaf's
    fold of valid ? a : +-BIG over all its slots; its box around the valid
    samples with NaN coordinates skipped (fminf / fmaxf) and a flag for a
    NaN coordinate on a valid slot; a pair covered (box inside the query,
    no flag) takes the fold, one apart from the box in some column takes
    +-BIG, and the rest walk their slots. Returns (min, max, classes)."""
    inf = float("inf")
    on = valid[..., None] & ~torch.isnan(c)                   # (k, s, d)
    blo = torch.where(on, c, inf).amin(1)                     # (k, d)
    bhi = torch.where(on, c, -inf).amax(1)
    flag = (valid[..., None] & torch.isnan(c)).any(-1).any(-1)  # (k,)
    fmin = minmax.masked_min(a, valid, BIG, -1)               # (k,)
    fmax = minmax.masked_max(a, valid, -BIG, -1)
    ql, qh = q_lo[:, None, :], q_hi[:, None, :]               # (Q, 1, d)
    covered = (~flag[None] & ((ql <= blo[None]) & (bhi[None] <= qh)).all(-1))
    apart = ((qh < blo[None]) | (bhi[None] < ql)).any(-1)
    mixed = ~covered & ~apart
    inside = samples_inside(c, valid, q_lo, q_hi)             # (Q, k, s)
    walk_min = minmax.masked_min(a[None], inside, BIG, -1)
    walk_max = minmax.masked_max(a[None], inside, -BIG, -1)
    mn = torch.where(covered, fmin[None], torch.where(mixed, walk_min, BIG))
    mx = torch.where(covered, fmax[None], torch.where(mixed, walk_max, -BIG))
    classes = {"covered": int(covered.sum()), "empty": int(
        (apart & ~covered).sum()), "mixed": int(mixed.sum())}
    return mn, mx, classes


def extremes_case(seed, Q, k, s, d, nan=False, special=False):
    """Each stratum's samples in its own cell of a grid over [0, 1)^d,
    ragged validity, strata 0 and k // 2 without a valid slot. Query 0
    covers every sample, 1 misses everything, 2 is inverted, 3's edges are
    stratum 1's extremes; the rest span a few cells. ``special`` puts NaN,
    +-inf, values beyond +-BIG and +-0.0 on valid and invalid slots, and
    two strata of +0.0 and -0.0 in either order; ``nan`` NaN coordinates
    on a valid slot of stratum 1 and on column 0 of every slot of 2."""
    rng = np.random.default_rng(seed)
    cells = max(2, int(np.ceil(k ** (1 / d))))
    cell = np.stack(np.unravel_index(np.arange(k) % cells ** d,
                                     (cells,) * d), -1).astype(np.float32)
    c = ((cell[:, None, :] + rng.uniform(0.1, 0.9, (k, s, d))) / cells
         ).astype(np.float32)
    a = rng.normal(0, 3, (k, s)).astype(np.float32)
    valid = rng.random((k, s)) < 0.8
    valid[0] = False
    valid[k // 2] = False
    if special:
        u = rng.random((k, s))
        a[u < 0.04] = np.nan
        a[(u >= 0.04) & (u < 0.07)] = np.inf
        a[(u >= 0.07) & (u < 0.10)] = -np.inf
        a[(u >= 0.10) & (u < 0.13)] = F32_MAX
        a[(u >= 0.13) & (u < 0.16)] = -F32_MAX
        a[(u >= 0.16) & (u < 0.22)] = -0.0
        a[(u >= 0.22) & (u < 0.28)] = 0.0
        for leaf, vals in ((k - 1, (0.0, -0.0)), (k - 2, (-0.0, 0.0))):
            if leaf > k // 2:
                valid[leaf] = True
                a[leaf] = np.resize(np.float32(vals), s)
    if nan:
        valid[1, :2] = True
    q_lo = np.zeros((Q, d), np.float32)
    q_hi = np.zeros((Q, d), np.float32)
    starts = rng.integers(0, cells, (Q, d))
    spans = rng.integers(1, 3, (Q, d))
    q_lo[:] = starts / cells + rng.uniform(-0.05, 0.05, (Q, d))
    q_hi[:] = (starts + spans) / cells + rng.uniform(-0.05, 0.05, (Q, d))
    q_lo[0], q_hi[0] = -1.0, 2.0
    if Q > 1:
        q_lo[1], q_hi[1] = 5.0, 6.0
    if Q > 2:
        q_lo[2], q_hi[2] = 0.6, 0.4
    if Q > 3 and valid[1].any():
        q_lo[3] = c[1][valid[1]].min(0)
        q_hi[3] = c[1][valid[1]].max(0)
    if nan:
        c[1, 0, 0] = np.nan
        c[2, :, 0] = np.nan
    return c, a, valid, q_lo.astype(np.float32), q_hi.astype(np.float32)


EXTREMES_CASES = [  # (seed, Q, k, s, d, nan, special)
    (1, 130, 53, 7, 3, False, False), (2, 1, 1, 1, 1, False, False),
    (3, 40, 64, 75, 1, False, True), (4, 33, 53, 300, 2, True, True),
    (5, 9, 20, 3, 16, True, False), (6, 129, 17, 1, 2, False, True),
]


@pytest.mark.parametrize("seed,Q,k,s,d,nan,special", EXTREMES_CASES)
def test_extremes_replay_equals_plain(seed, Q, k, s, d, nan, special):
    """The kernel's pair classes, replayed in torch, give the plain
    version's bits (NaN as NaN) on the edge sets, and the class cases hold
    all three classes."""
    args = _t(*extremes_case(seed, Q, k, s, d, nan, special))
    mn, mx, classes = replay_extremes(*args)
    pmn, pmx = sample_extremes_plain(*args)
    assert_bits_equal(mn, pmn, "min")
    assert_bits_equal(mx, pmx, "max")
    if Q > 3 and k > 3 and s > 1:
        assert min(classes.values()) > 0, classes
    if nan:
        c = args[0]
        n0 = samples_inside(c, args[2], args[3][:1], args[4][:1])[0].sum(-1)
        # the NaN strata are never covered: 1 is mixed and 2 empty under
        # query 0, which covers every other valid sample
        assert 0 < int(n0[1]) < int(args[2][1].sum()) and int(n0[2]) == 0


def test_extremes_replay_on_a_sliced_view():
    """A slice_sample_slots view (the refinement ladder's) of a synopsis
    goes through ops.sample_extremes as its contiguous copy."""
    from test_torch_engine import _data
    c, a = _data(1, 4000, seed=2)
    jsyn, _ = jbuild(c, a, k=16, sample_rate=0.05, method="adp", seed=0)
    syn = slice_sample_slots(carry(jsyn), 3)
    q_lo = torch.tensor([[0.1], [0.3]], dtype=torch.float32)
    q_hi = torch.tensor([[0.6], [0.35]], dtype=torch.float32)
    args = (syn.sample_c, syn.sample_a, syn.sample_valid, q_lo * 100,
            q_hi * 100)
    mn, mx, _ = replay_extremes(*args)
    got = ops.sample_extremes(*args)
    assert_bits_equal(got[0], mn, "min")
    assert_bits_equal(got[1], mx, "max")


def test_extremes_kernel_limits():
    """The sizes the CUDA wrapper takes: row 2's tiles, s >= 1, any d
    that fits a C int (above 16 the wide kernels)."""
    assert (EXTREMES_QT, EXTREMES_LT) == (128, 16)
    check_extremes_limits("e", 2048, 1024, 75, 3)
    check_extremes_limits("e", 1, 1, 1, 16)
    check_extremes_limits("e", 1, 1, 1, 17)
    check_extremes_limits("e", 2048, 1024, 75, 300)
    for bad in (dict(Q=0), dict(k=0), dict(s=0), dict(d=0),
                dict(d=2 ** 31), dict(Q=2 ** 31),
                dict(Q=2 ** 31 - 1, k=2048)):
        args = dict(Q=8, k=16, s=4, d=2)
        args.update(bad)
        with pytest.raises(ValueError, match="needs"):
            check_extremes_limits("e", **args)


# ---------------------------------------------------------------------------
# The query_eval kernel's walk, replayed
# ---------------------------------------------------------------------------

def replay_query_eval(lo, hi, agg, q_lo, q_hi, lanes_per_word=8):
    """exact as csrc/query_eval.cu sums it: cover bits of four leaves a
    lane, OR-ed over eight lanes into one word per 32 leaves; each query's
    list of covered leaves from the words' bit counts (an exclusive scan
    gives each word its offset) and their set bits in ascending order; per
    (query, column) the list in batches of eight, a read past its end
    adding +0.0, in float32 from +0.0. Returns (rel, exact, words)."""
    rel = classify_leaves(lo, hi, q_lo, q_hi)
    cover = (rel == 2).numpy()
    Q, k = cover.shape
    nwords = -(-k // 32)
    padded = np.zeros((Q, nwords * 32), bool)
    padded[:, :k] = cover
    lanes = padded.reshape(Q, nwords, lanes_per_word, 4)
    words = np.zeros((Q, nwords), np.uint64)
    for lane in range(lanes_per_word):
        nib = (lanes[:, :, lane] * (1 << np.arange(4))).sum(-1)
        words |= nib.astype(np.uint64) << np.uint64(4 * lane)
    agg = agg.numpy()
    A = agg.shape[1]
    exact = np.zeros((Q, A), np.float32)
    for q in range(Q):
        counts = [bin(int(w)).count("1") for w in words[q]]
        offsets = np.concatenate([[0], np.cumsum(counts)])
        listed = np.zeros(offsets[-1], np.int64)
        for w in range(nwords):
            m, i = int(words[q, w]), offsets[w]
            while m:
                listed[i] = w * 32 + (m & -m).bit_length() - 1
                m, i = m & (m - 1), i + 1
        acc = np.zeros(A, np.float32)
        for i in range(0, len(listed), 8):
            for e in range(i, i + 8):
                x = agg[listed[e]] if e < len(listed) else np.zeros(
                    A, np.float32)
                acc = (acc + x).astype(np.float32)
        exact[q] = acc
    return rel, exact, words


def _first_version_exact(rel, agg):
    """The first kernel's order: from +0.0, covered leaves ascending."""
    cover = (rel == 2).numpy()
    agg = agg.numpy()
    out = np.zeros((cover.shape[0], agg.shape[1]), np.float32)
    for q in range(cover.shape[0]):
        acc = np.zeros(agg.shape[1], np.float32)
        for j in np.flatnonzero(cover[q]):
            acc = (acc + agg[j]).astype(np.float32)
        out[q] = acc
    return out


@pytest.mark.parametrize("Q,k,d,A", [(1, 1, 1, 1), (7, 97, 3, 5),
                                     (5, 1031, 2, 8), (3, 64, 16, 3)])
def test_query_eval_walk_equals_first_version(Q, k, d, A):
    """Words hold each query's cover bits; the eight-wide walk of the
    covered leaves' list gives the first kernel's bits (ascending covered
    leaves from +0.0, -0.0, +-inf and NaN aggregates included), and its
    first three columns meet the plain product within rtol=3e-5,
    atol=1e-3."""
    rng = np.random.default_rng(Q * 31 + k)
    lo = rng.uniform(-1, 0.5, (k, d)).astype(np.float32)
    hi = lo + rng.uniform(0, 1, (k, d)).astype(np.float32)
    agg = rng.normal(0, 1, (k, A)).astype(np.float32)
    agg[rng.random((k, A)) < 0.2] = -0.0
    if k > 2:
        lo[k // 2], hi[k // 2] = np.inf, -np.inf
        agg[k // 2] = np.inf
        hi[1] = lo[1] - 0.5
        agg[2, 0] = np.nan
    q_lo = rng.uniform(-1.2, 0, (Q, d)).astype(np.float32)
    q_hi = q_lo + rng.uniform(0, 2.5, (Q, d)).astype(np.float32)
    if Q > 1:
        q_lo[0], q_hi[0] = -9.0, 9.0             # covers every leaf
    t = _t(lo, hi, agg, q_lo, q_hi)
    rel, exact, words = replay_query_eval(*t)
    cover = (rel == 2).numpy()
    for q in range(Q):
        want = sum(1 << int(j) for j in np.flatnonzero(cover[q]))
        got = sum(int(w) << (32 * i) for i, w in enumerate(words[q]))
        assert got == want
    assert_bits_equal(exact, _first_version_exact(rel, t[2]), "exact")
    rel_p, exact_p = query_eval_plain(*t)
    assert torch.equal(rel, rel_p)
    finite = np.isfinite(exact_p[:, :3].numpy()).all(1)
    np.testing.assert_allclose(exact[finite, :3], exact_p[finite, :3].numpy(),
                               rtol=3e-5, atol=1e-3)


def test_query_eval_launch_constants():
    """The launch the wrapper describes: 256 threads, four leaves a thread,
    a tile of 1024 leaves (32 cover words, one a lane), at most one query a
    warp so that each row's list has its warp, and the (query, column)
    walkers (A <= 8) fit the block."""
    assert QE_THREADS * 4 == QE_LEAF_TILE == 1024
    assert QE_MAX_QUERIES == QE_THREADS // 32
    assert QE_MAX_QUERIES * 8 <= QE_THREADS
