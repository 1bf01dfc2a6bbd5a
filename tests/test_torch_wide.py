"""The port above 16 predicate columns against the JAX package.

On the card every kernel whose work depends on d takes any d: up to 16
columns its d <= 16 instantiations, above them wide ones that take the
columns in blocks of 16 (csrc/wide_cols.cuh); chip_smoke.py phases 29 and
30 hold them to the plain versions there. Here, on the CPU, the plain
versions (what CPU tensors run and what the kernels are held to) meet the
JAX package at d = 17, 24 and 33, the slice as a whole meets it at
d = 24, the wrappers' limit checks take any d, and numpy replays of the
column-block order (the flags ANDed / ORed over blocks of 16, the route
distance carried across them) give the plain versions' bits.

Same numpy inputs, made from a seed, go to both packages. Tolerances:
relation codes, counts, leaf ids, route distances and sample extremes are
exact; float sums meet rtol=3e-5, atol=1e-3 (tests/test_kernels.py's bar
for Pallas: fp32 sums in another order); the engines meet
test_torch_engine's assert_results_close.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.api import (PassEngine as JEngine, ServingConfig as JServing,
                       CIConfig as JCI)
from repro.core.synopsis import build_synopsis as jbuild
from repro.core.types import QueryBatch as JQB
from repro.joins.executor import compute_join_artifacts as jartifacts
from repro.kernels import backends as _jax_backends  # noqa: F401 (registers)
from repro.kernels.registry import get_backend
from repro.kernels.route import route_multid_dense
from repro.streaming import StreamingIngestor as JIngestor
from repro_torch.api import CIConfig, PassEngine, ServingConfig
from repro_torch.core.types import QueryBatch
from repro_torch.joins.executor import compute_join_artifacts
from repro_torch.kernels import join_moments as jm
from repro_torch.kernels.bootstrap import bootstrap_moments_plain
from repro_torch.kernels.query_eval import (check_query_eval_limits,
                                            classify_leaves, query_eval_plain)
from repro_torch.kernels.route import (check_route_limits, dist_matrix,
                                       route_multid_plain)
from repro_torch.kernels.sample_extremes import (check_extremes_limits,
                                                 sample_extremes_plain)
from repro_torch.kernels.stratified_estimate import (
    check_moments_limits, check_weighted_limits,
    stratified_moments_plain, weighted_moments_plain, weighted_plan,
    weighted_scratch_floats)
from repro_torch.streaming import StreamingIngestor
from test_torch_engine import KINDS, assert_results_close, carry
from test_torch_joins import (ART_FIELDS, assert_close, build_both, tables,
                              with_buffers, edge_buffers)
from test_torch_streaming import assert_state_matches

RTOL, ATOL = 3e-5, 1e-3
WIDE = [17, 24, 33]
BLOCK = 16  # the wide kernels' column block (csrc/wide_cols.cuh)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _bounded(rng, Q, d, lo, hi, first=1):
    """(Q, d) bounds at (lo, hi) in every column but 2-4 random ones from
    ``first`` on, which get a random interval of (0, 1); query 0 keeps
    (lo, hi) everywhere."""
    q_lo = np.full((Q, d), lo, np.float32)
    q_hi = np.full((Q, d), hi, np.float32)
    for i in range(1, Q):
        cols = first + rng.choice(d - first, int(rng.integers(2, 5)),
                                  replace=False)
        q_lo[i, cols] = rng.uniform(0.0, 0.5, cols.size)
        q_hi[i, cols] = q_lo[i, cols] + rng.uniform(0.3, 0.7, cols.size)
    return q_lo, q_hi


def _leaves(rng, k, d):
    """Leaf boxes in (0, 1.5), an empty leaf as the build writes it, a
    leaf inverted and one NaN in the last column (past the first block)."""
    lo = rng.uniform(0, 0.5, (k, d)).astype(np.float32)
    hi = (lo + rng.uniform(0, 1, (k, d))).astype(np.float32)
    agg = rng.normal(0, 1, (k, 5)).astype(np.float32)
    agg[:, 2] = rng.integers(1, 50, k)
    lo[k // 2], hi[k // 2] = np.inf, -np.inf
    agg[k // 2] = [0, 0, 0, np.inf, -np.inf]
    lo[1, d - 1], hi[1, d - 1] = 1.0, 0.5
    lo[2, d - 1] = np.nan
    return lo, hi, agg


def _samples(rng, Q, k, s, d, R=1):
    """Stratum i's samples in band i of column 0, the rest uniform in
    (0.05, 0.95); ragged validity, stratum 0 without a valid slot, a NaN
    coordinate on valid slots of stratum 1 in the last column; weights
    zero, Poisson and non-integer (on invalid slots too); queries that
    cut column 0 at band edges and bound 2-4 other columns, so covered,
    empty and mixed pairs occur."""
    c = rng.uniform(0.05, 0.95, (k, s, d)).astype(np.float32)
    c[..., 0] = (np.arange(k)[:, None] + rng.uniform(0.05, 0.95, (k, s))) / k
    a = rng.normal(0, 3, (k, s)).astype(np.float32)
    valid = rng.random((k, s)) < 0.7
    valid[0] = False
    c[1, :3, d - 1] = np.nan
    W = rng.poisson(1.0, (R, k, s)).astype(np.float32)
    W[:, :, ::3] = rng.uniform(0, 2.5, W[:, :, ::3].shape)
    q_lo, q_hi = _bounded(rng, Q, d, -1.0, 2.0)
    start = rng.integers(0, k, Q)
    q_lo[1:, 0] = (start[1:] + rng.uniform(0, 0.5, Q - 1)) / k
    q_hi[1:, 0] = (start[1:] + rng.uniform(0.5, 3.0, Q - 1)) / k
    return c, a, valid, W, q_lo, q_hi


def _classes(c, valid, q_lo, q_hi):
    inside = ((q_lo[:, None, None] <= c[None]).all(-1)
              & (c[None] <= q_hi[:, None, None]).all(-1) & valid[None])
    n = inside.sum(-1)
    empty = n == 0
    covered = ~empty & (n == valid.sum(-1)[None])
    return covered, empty, ~empty & ~covered


# ---------------------------------------------------------------------------
# The kernels' plain versions against the JAX package at d > 16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("d", WIDE)
def test_query_eval_plain_matches_jax_wide(d, backend):
    rng = np.random.default_rng(100 + d)
    lo, hi, agg = _leaves(rng, 37, d)
    q_lo, q_hi = _bounded(rng, 20, d, -1.0, 2.0, first=0)
    q_lo[1, d - 1], q_hi[1, d - 1] = 5.0, 6.0
    rel_j, exact_j = jax.jit(get_backend(backend).query_eval)(
        *map(jnp.asarray, (lo, hi, agg, q_lo, q_hi)))
    rel_t, exact_t = query_eval_plain(*_t(lo, hi, agg, q_lo, q_hi))
    np.testing.assert_array_equal(rel_t.numpy(), np.asarray(rel_j))
    assert (rel_t == 2).any() and (rel_t == 1).any() and (rel_t == 0).any()
    assert (rel_t[:, [1, 2, 37 // 2]] == 0).all()
    np.testing.assert_allclose(exact_t.numpy()[:, :3],
                               np.asarray(exact_j)[:, :3], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("d", WIDE)
def test_stratified_moments_plain_matches_jax_wide(d, backend):
    c, a, valid, _, q_lo, q_hi = _samples(np.random.default_rng(200 + d),
                                          14, 9, 20, d)
    covered, empty, mixed = _classes(c, valid, q_lo, q_hi)
    assert covered.any() and empty.any() and mixed.any()
    want = jax.jit(get_backend(backend).stratified_moments)(
        *map(jnp.asarray, (c, a, valid, q_lo, q_hi)))
    out = stratified_moments_plain(*_t(c, a, valid, q_lo, q_hi))
    np.testing.assert_array_equal(out[..., 0].numpy(), np.asarray(want[0]))
    for i in (1, 2):
        np.testing.assert_allclose(out[..., i].numpy(), np.asarray(want[i]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", WIDE)
def test_sample_extremes_plain_bit_equal_to_jax_wide(d):
    """The JAX package's sample_extremes (one jnp broadcast every backend
    shares): min and max round nothing, so the bits are equal."""
    c, a, valid, _, q_lo, q_hi = _samples(np.random.default_rng(300 + d),
                                          14, 9, 20, d)
    want = get_backend("jnp").sample_extremes(
        *map(jnp.asarray, (c, a, valid, q_lo, q_hi)))
    got = sample_extremes_plain(*_t(c, a, valid, q_lo, q_hi))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32))


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("d", WIDE)
def test_weighted_moments_plain_matches_jax_wide(d, backend):
    c, a, valid, W, q_lo, q_hi = _samples(np.random.default_rng(400 + d),
                                          14, 9, 20, d)
    want = jax.jit(get_backend(backend).weighted_moments)(
        *map(jnp.asarray, (c, a, valid, W[0], q_lo, q_hi)))
    got = weighted_moments_plain(*_t(c, a, valid, W[0], q_lo, q_hi))
    for i in range(3):
        np.testing.assert_allclose(got[..., i].numpy(), np.asarray(want[i]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("d", WIDE)
def test_bootstrap_moments_plain_matches_jax_wide(d, backend):
    c, a, valid, W, q_lo, q_hi = _samples(np.random.default_rng(500 + d),
                                          10, 7, 20, d, R=3)
    want = np.asarray(jax.jit(get_backend(backend).bootstrap_moments)(
        *map(jnp.asarray, (c, a, valid, W, q_lo, q_hi))))
    got = bootstrap_moments_plain(*_t(c, a, valid, W, q_lo, q_hi))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def _route_case(rng, B, k, d):
    """Grid boxes, a copy of box 0 at the last leaf (ties), an inverted
    +-inf box; rows on integer faces and between them."""
    lo = rng.integers(0, 8, (k, d)).astype(np.float32)
    hi = lo + rng.integers(0, 3, (k, d)).astype(np.float32)
    lo[k - 1], hi[k - 1] = lo[0], hi[0]
    lo[k // 2], hi[k // 2] = np.inf, -np.inf
    c = np.where(rng.random((B, d)) < 0.5, rng.integers(-2, 12, (B, d)),
                 rng.uniform(-2, 12, (B, d))).astype(np.float32)
    c[:4] = lo[0]                      # inside boxes 0 and k - 1: a tie
    return lo, hi, c


@pytest.mark.parametrize("d", WIDE)
def test_route_multid_plain_bit_equal_to_dense_wide(d):
    lo, hi, c = _route_case(np.random.default_rng(600 + d), 70, 29, d)
    leaf, dist = route_multid_plain(*_t(lo, hi, c))
    refs = [route_multid_dense(*map(jnp.asarray, (lo, hi, c)))]
    if d == 17:
        refs.append(get_backend("pallas").route_multid(
            *map(jnp.asarray, (lo, hi, c))))
    for jleaf, jdist in refs:
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
        np.testing.assert_array_equal(dist.numpy().view(np.int32),
                                      np.asarray(jdist).view(np.int32))
    assert (leaf[:4] == 0).all()


@pytest.fixture(scope="module")
def wide_join():
    """(JAX join synopsis, port synopsis) at 17 fact columns, k = 6,
    P = 4 ("kd")."""
    tab = tables(n=1200, nd=40, seed=17, d_fact=17, missing=0.02)
    jsyn, tsyn, _, _ = build_both(tab, num_partitions=4, k=6, p_u=0.4,
                                  seed=3, method="kd", opt_samples=256)
    return jsyn, tsyn


@pytest.mark.parametrize("case", ["built", "nan"])
def test_join_artifacts_match_jax_17_fact_columns(wide_join, case):
    """The join stage (compute_join_artifacts: row 1 twice, then row 9's
    plain version) at 18 predicate columns; the queries bound 2-4 fact
    columns and the dimension pair."""
    jsyn, tsyn = wide_join
    if case != "built":
        jsyn, tsyn = with_buffers(jsyn, tsyn, **edge_buffers(tsyn, case))
    rng = np.random.default_rng(7)
    q_lo, q_hi = _bounded(rng, 30, 18, -10.0, 10.0, first=0)
    q_lo = np.where(q_lo > -10, q_lo * 4 - 2, q_lo).astype(np.float32)
    q_hi = np.where(q_hi < 10, q_hi * 4 - 2, q_hi).astype(np.float32)
    jq = JQB(jnp.asarray(q_lo), jnp.asarray(q_hi))
    tq = QueryBatch(*_t(q_lo, q_hi))
    ja = jartifacts(jsyn, jq)
    ta = compute_join_artifacts(tsyn, tq)
    np.testing.assert_array_equal(ta.cover.numpy(), np.asarray(ja.cover))
    np.testing.assert_array_equal(ta.sampled.numpy(), np.asarray(ja.sampled))
    assert ta.sampled.any()
    for f in ART_FIELDS:
        assert_close(getattr(ta, f), getattr(ja, f), f)


# ---------------------------------------------------------------------------
# The slice as a whole at d = 24
# ---------------------------------------------------------------------------

D24 = 24


def _wide_rows(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 100, (n, D24))
    a = rng.lognormal(0, 1, n) * (1 + np.sin(c[:, 0] / 5))
    return c, a


def _wide_queries(c, num, seed):
    """chip_smoke.py's wide query rule: each rectangle bounds 2-4 columns
    by random_queries' rule on them, every other column at [min, max]."""
    rng = np.random.default_rng(seed)
    n, d = c.shape
    q_lo = np.tile(c.min(0), (num, 1)).astype(np.float32)
    q_hi = np.tile(c.max(0), (num, 1)).astype(np.float32)
    for i in range(num):
        for j in rng.choice(d, int(rng.integers(2, 5)), replace=False):
            vals = np.sort(c[:, j])
            w = rng.uniform(0.05, 0.6)
            s0 = rng.uniform(0, 1 - w)
            q_lo[i, j] = vals[int(s0 * (n - 1))]
            q_hi[i, j] = vals[min(int((s0 + w) * (n - 1)), n - 1)]
    return q_lo, q_hi


@pytest.fixture(scope="module")
def served24():
    """(JAX synopsis, port synopsis, JAX queries, port queries): a kd
    synopsis of 16,000 rows over 24 columns, k = 24, 2 % samples."""
    c, a = _wide_rows(16_000, seed=24)
    jsyn, _ = jbuild(c, a, k=24, sample_rate=0.02, method="kd", seed=0,
                     opt_samples=2048)
    q_lo, q_hi = _wide_queries(c, 40, seed=5)
    jq = JQB(jnp.asarray(q_lo), jnp.asarray(q_hi))
    return jsyn, carry(jsyn), jq, QueryBatch(*_t(q_lo, q_hi))


@pytest.mark.parametrize("ci", [None, 0.95])
def test_engine_matches_jax_wide24(served24, ci):
    jsyn, tsyn, jq, tq = served24
    assert tsyn.d == D24
    jres = JEngine(jsyn, JServing(kinds=KINDS), ci=ci).answer(jq)
    tres = PassEngine(tsyn, ServingConfig(kinds=KINDS), ci=ci,
                      device="cpu").answer(tq)
    assert_results_close(jres, tres, KINDS)
    count = tres["count"].estimate
    assert (count > 0).sum() >= 20 and (count == 0).sum() < 20


@pytest.mark.parametrize("fused", [True, False])
def test_engine_bootstrap_matches_jax_wide24(served24, fused):
    jsyn, tsyn, jq, tq = served24
    jk = jax.random.PRNGKey(24)
    kinds = ("sum", "count", "avg")
    kw = dict(level=0.95, method="bootstrap", n_boot=20, boot_fused=fused)
    jres = JEngine(jsyn, JServing(kinds=kinds),
                   ci=JCI(key=jk, **kw)).answer(jq)
    tres = PassEngine(tsyn, ServingConfig(kinds=kinds),
                      ci=CIConfig(key=np.asarray(jk, np.uint32), **kw),
                      device="cpu").answer(tq)
    assert_results_close(jres, tres, kinds)


def test_ingest_matches_jax_wide24(served24):
    """Three 512-row batches (integer values, rows past the boxes) through
    both StreamingIngestors: every state field exact, and the merged
    synopsis served alike."""
    jsyn, tsyn, jq, tq = served24
    jing = JIngestor(jsyn, seed=6)
    ting = StreamingIngestor(tsyn, seed=6, device="cpu")
    rng = np.random.default_rng(66)
    for _ in range(3):
        c = rng.uniform(-5, 105, (512, D24)).astype(np.float32)
        a = rng.integers(1, 64, 512).astype(np.float32)
        jing.ingest(c, a)
        ting.ingest(c, a)
    assert_state_matches(ting.state, jing.state)
    assert ting.n_oob == jing.n_oob > 0
    jres = JEngine(jing, JServing(kinds=KINDS), ci=0.95).answer(jq)
    tres = PassEngine(ting, ServingConfig(kinds=KINDS), ci=0.95,
                      device="cpu").answer(tq)
    assert_results_close(jres, tres, KINDS)


# ---------------------------------------------------------------------------
# The wrappers' limits, and the column-block order replayed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [17, 300])
def test_wrapper_limits_take_any_d(d):
    """Every d-dependent wrapper takes d above 16 (pure Python, the checks
    a CUDA tensor meets before its launch); the plan of rows 3 and 4 there
    holds a column block, not d columns, so its bytes stop growing."""
    check_query_eval_limits("q", 2048, 1024, d, 5)
    check_moments_limits("m", 2048, 1024, 75, d)
    check_extremes_limits("e", 2048, 1024, 75, d)
    check_weighted_limits("w", 2048, 1024, 75, d, 200)
    check_route_limits("r", 4096, 1024, d)
    jm.check_join_limits("j", 2048, 1024, 750, 16, d)
    assert jm.JM_MAX_D == BLOCK
    assert weighted_plan(2048, 1024, 75, d) == weighted_plan(2048, 1024, 75,
                                                             2 * d)
    assert weighted_scratch_floats(200, 2048, 1024, 75, d) > 0


def _replay_classes(leaf_lo, leaf_hi, q_lo, q_hi):
    """Row 1's wide classification (csrc/query_eval.cu, D = -1): cover,
    disjoint and non-empty bits ANDed / ORed over blocks of 16 columns."""
    Q, k, d = q_lo.shape[0], leaf_lo.shape[0], leaf_lo.shape[1]
    cov = np.ones((Q, k), bool)
    dis = np.zeros((Q, k), bool)
    ne = np.ones(k, bool)
    for j0 in range(0, d, BLOCK):
        sl = slice(j0, min(d, j0 + BLOCK))
        lo, hi = leaf_lo[:, sl], leaf_hi[:, sl]
        ql, qh = q_lo[:, None, sl], q_hi[:, None, sl]
        ne &= (lo <= hi).all(-1)
        cov &= ((ql <= lo[None]) & (hi[None] <= qh)).all(-1)
        dis |= ((qh < lo[None]) | (ql > hi[None])).any(-1)
    cover = ne[None] & cov
    return np.where(cover, 2, np.where(~ne[None] | dis, 0, 1))


@pytest.mark.parametrize("d", WIDE)
def test_column_block_classes_replay_plain(d):
    rng = np.random.default_rng(700 + d)
    lo, hi, _ = _leaves(rng, 41, d)
    q_lo, q_hi = _bounded(rng, 25, d, -1.0, 2.0, first=0)
    q_lo[3, 20 % d] = np.nan
    got = _replay_classes(lo, hi, q_lo, q_hi)
    want = classify_leaves(*_t(lo, hi, q_lo, q_hi)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 2).any() and (got == 1).any()


def _replay_route(leaf_lo, leaf_hi, c, tile=8, groups=4):
    """Row 7's wide kernel (csrc/route_multid.cu, route_multid_wide_
    kernel): each group scans its leaf range in tiles of 8, each (row,
    leaf) distance one float32 sum carried across the blocks of 16
    columns in column order from column 0's term, a strict `<`; then the
    groups' winners merged in group order on a strict `<`; the winner's
    distance plus +0.0."""
    k, d = leaf_lo.shape
    B = c.shape[0]
    lg = -(-k // groups)
    best = np.full((groups, B), np.inf, np.float32)
    best_i = np.zeros((groups, B), np.int64)
    for g in range(groups):
        l0, l1 = min(k, g * lg), min(k, g * lg + lg)
        best_i[g] = l0
        for k0 in range(l0, l1, tile):
            n = min(tile, l1 - k0)
            dist = np.zeros((B, n), np.float32)
            for j0 in range(0, d, BLOCK):
                for j in range(j0, min(d, j0 + BLOCK)):
                    lo = leaf_lo[k0:k0 + n, j][None]
                    hi = leaf_hi[k0:k0 + n, j][None]
                    x = c[:, j][:, None]
                    t = np.maximum(np.maximum(lo - x, x - hi),
                                   np.float32(0))
                    dist = t if j == 0 else (dist + t).astype(np.float32)
            for l in range(n):
                win = dist[:, l] < best[g]
                best[g] = np.where(win, dist[:, l], best[g])
                best_i[g] = np.where(win, k0 + l, best_i[g])
    out_d = np.full(B, np.inf, np.float32)
    out_i = np.zeros(B, np.int64)
    for g in range(groups):
        win = best[g] < out_d
        out_d = np.where(win, best[g], out_d)
        out_i = np.where(win, best_i[g], out_i)
    return out_i.astype(np.int32), (out_d + np.float32(0)).astype(np.float32)


@pytest.mark.parametrize("d", WIDE)
def test_route_column_blocks_replay_bit_equal_to_plain(d):
    lo, hi, c = _route_case(np.random.default_rng(800 + d), 90, 37, d)
    leaf, dist = _replay_route(lo, hi, c)
    want_leaf, want_dist = route_multid_plain(*_t(lo, hi, c))
    np.testing.assert_array_equal(leaf, want_leaf.numpy())
    np.testing.assert_array_equal(dist.view(np.int32),
                                  want_dist.numpy().view(np.int32))
    # The carried sum is the plain matrix's; partial sums per block added
    # at the end would be another rounding.
    full = dist_matrix(*_t(lo, hi, c)).numpy()
    np.testing.assert_array_equal(
        full[np.arange(c.shape[0]), leaf].view(np.int32),
        dist.view(np.int32))
