"""The port's streaming path against the JAX package's, on the CPU.

Same numpy inputs, made from a seed, go to both packages. The JAX package
runs as its own tests run it: the Pallas kernels through
``get_backend("pallas")`` (interpret mode) and everything else under the
``jnp`` backend that ``conftest.py`` sets. Tolerances:

* routing, boxes, reservoir arrays, counts, ``seen``, ``oob``,
  ``quarantined`` and every MIN/MAX: exact;
* the float sums of ``segment_reduce`` and ``delta_agg``: rtol=3e-5,
  atol=1e-3 (fp32 sums taken in another order); on integer-valued data
  they are exact too, as the JAX package's own bit-match tests have it;
* merged serving: ``tests/test_torch_engine.py``'s tolerances;
* ``reoptimize``: cuts equal on integer-valued data; on float data the DP
  objective within rtol=1e-5 (the float32 prefix sums are summed in
  another order) and thresholds equal wherever the cuts are.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core import dp as jdp
from repro.core import query as jquery
from repro.core.synopsis import build_synopsis as jbuild
from repro.api import PassEngine as JEngine, ServingConfig as JServing
from repro.kernels import backends as _jax_backends  # noqa: F401 (registers)
from repro.kernels.registry import get_backend
from repro.kernels.route import route_multid_dense
from repro.streaming import StreamingIngestor as JIngestor
from repro.streaming import ingest as jingest
from repro.streaming.delta import reservoir_moments as j_reservoir_moments
from repro.streaming.policy import reoptimize as jreoptimize
from repro_torch import random as trandom
from repro_torch.api import PassEngine, ServingConfig
from repro_torch.core import dp as tdp
from repro_torch.kernels import ops
from repro_torch.kernels.route import (ROUTE_MAX_GROUPS, ROUTE_SMS,
                                       ROUTE_THREADS, dist_matrix,
                                       route_groups, route_multid_plain,
                                       route_plan)
from repro_torch.kernels.segment_reduce import (SEG_MAX_CHUNKS, SEG_MIN_ROWS,
                                                segment_plan,
                                                segment_reduce_plain)
from repro_torch.streaming import (DriftPolicy, StreamingIngestor,
                                   ingest_batch_reference, reoptimize,
                                   reoptimize_cuts, reservoir_moments,
                                   stream_state_from_numpy)
from repro_torch.streaming import ingest as tingest
from test_torch_engine import (KINDS, assert_results_close, batch_scale,
                               carry, carry_queries, PLACEHOLDER)

RTOL, ATOL = 3e-5, 1e-3
FIELDS = ("leaf_lo", "leaf_hi", "delta_agg", "sample_c", "sample_a",
          "sample_valid", "k_per_leaf", "seen", "oob", "quarantined")
EXACT = tuple(f for f in FIELDS if f != "delta_agg")


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def assert_state_matches(tstate, jstate, exact_sums=True):
    """Every field exact; delta_agg's sums (columns 0-1) exact or within
    the stated tolerance, its counts and extremes exact."""
    for f in EXACT:
        np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                      np.asarray(getattr(jstate, f)),
                                      err_msg=f)
    td = tstate.delta_agg.numpy()
    jd = np.asarray(jstate.delta_agg)
    np.testing.assert_array_equal(td[:, 2:], jd[:, 2:])
    if exact_sums:
        np.testing.assert_array_equal(td[:, :2], jd[:, :2])
    else:
        np.testing.assert_allclose(td[:, :2], jd[:, :2], rtol=RTOL,
                                   atol=ATOL)


def _base(d, n=6000, k=16, seed=0, int_vals=True, method=None,
          sample_budget=None, val_hi=64):
    rng = np.random.default_rng(seed)
    if d == 1:
        c = np.sort(rng.uniform(0, 100, n))
    else:
        c = rng.uniform(0, 100, (n, d))
    a = (rng.integers(1, val_hi, n).astype(np.float64) if int_vals
         else rng.lognormal(0, 1, n))
    jsyn, _ = jbuild(c, a, k=k, sample_budget=sample_budget or 4 * k,
                     method=method or ("eq" if d == 1 else "kd"), seed=0)
    return jsyn, c, a


def _batch(rng, d, B, int_vals=True, lo=-10.0, hi=110.0, val_hi=64):
    c = rng.uniform(lo, hi, (B, d)).astype(np.float32)
    a = (rng.integers(1, val_hi, B) if int_vals
         else rng.lognormal(0, 1, B)).astype(np.float32)
    return c, a


# ---------------------------------------------------------------------------
# The two kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,backend", [
    (1, 1, "pallas"), (17, 53, "pallas"), (512, 64, "pallas"),
    (512, 64, "jnp"), (300, 5, "pallas")])
def test_segment_reduce_plain_matches_jax(n, k, backend):
    """Ids in [-1, k + 2) (dropped rows and out-of-range ids), empty
    segments; one case with every row in one segment."""
    rng = np.random.default_rng(n * 7 + k)
    v = rng.normal(0, 3, n).astype(np.float32)
    ids = rng.integers(-1, k + 2, n).astype(np.int32)
    ids[ids == 1] = -1                              # segment 1 stays empty
    if n == 300:
        ids[:] = k - 1
    want = np.asarray(get_backend(backend).segment_reduce(
        jnp.asarray(v), jnp.asarray(ids), k, bn=None))
    got = segment_reduce_plain(*_t(v, ids), k)
    assert got.dtype == torch.float32 and got.shape == (k, 5)
    got = got.numpy()
    np.testing.assert_array_equal(got[:, 2:], want[:, 2:])
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=RTOL, atol=ATOL)
    if k > 2:
        np.testing.assert_array_equal(got[1], np.float32([0, 0, 0, 3e38,
                                                          -3e38]))


def _route_case(rng, B, k, d, case="grid"):
    """Boxes on a coarse grid (touching, rows on shared faces), a duplicate
    of box 0 (ties) and an inverted +-inf box. ``signed-zero``: box faces
    and row coordinates of +-0.0 as well, box 0 = [-0.0, 1]^d, so that
    every term of a row at +0.0 is max(-0.0, -1) (a clamp keeps -0.0, the
    oracle's maximum with 0 gives +0.0). ``group-ties``: copies of box 0
    on the first leaf of every leaf group of route_plan(B, k), so that
    equal distances span group boundaries."""
    lo = rng.integers(0, 8, (k, d)).astype(np.float32)
    hi = lo + rng.integers(0, 3, (k, d)).astype(np.float32)
    if k > 2:
        lo[k - 1], hi[k - 1] = lo[0], hi[0]          # duplicate box: ties
        lo[k // 2], hi[k // 2] = np.inf, -np.inf     # empty leaf
    c = np.where(rng.random((B, d)) < 0.5, rng.integers(-2, 12, (B, d)),
                 rng.uniform(-2, 12, (B, d))).astype(np.float32)
    if case == "signed-zero":
        lo[rng.random((k, d)) < 0.3] = -0.0
        hi[rng.random((k, d)) < 0.1] = 0.0
        hi = np.maximum(hi, lo)
        lo[0], hi[0] = -0.0, 1.0
        c[rng.random((B, d)) < 0.3] = -0.0
        c[rng.random((B, d)) < 0.3] = 0.0
        c[: B // 4] = 0.0
        if k > 2:
            lo[k // 2], hi[k // 2] = np.inf, -np.inf
    elif case == "group-ties":
        _, g, lg = route_plan(B, k)
        for rg in route_groups(k, g, lg)[1:]:
            if len(rg):
                lo[rg.start], hi[rg.start] = lo[0], hi[0]
    return lo, hi, c


@pytest.mark.parametrize("B,k,d,pallas,case", [
    pytest.param(1, 1, 2, False, "grid", id="1-1-2-False"),
    pytest.param(300, 40, 3, True, "grid", id="300-40-3-True"),
    pytest.param(64, 129, 16, False, "grid", id="64-129-16-False"),
    pytest.param(300, 40, 3, True, "signed-zero", id="signed-zero-d3"),
    pytest.param(257, 53, 16, False, "signed-zero", id="signed-zero-d16"),
    pytest.param(300, 41, 3, True, "group-ties", id="group-ties-d3"),
    pytest.param(129, 1025, 2, False, "group-ties", id="group-ties-d2")])
def test_route_multid_plain_bit_equal_to_dense_and_pallas(B, k, d, pallas,
                                                          case):
    """Touching grid boxes, rows on shared faces (inside several boxes),
    a duplicate box and an inverted +-inf box; +-0.0 faces and rows; equal
    boxes on both sides of every leaf-group boundary: leaf and distance
    bits equal to the dense oracle and (some shapes, for time) to the
    Pallas kernel."""
    rng = np.random.default_rng(B + k + d)
    lo, hi, c = _route_case(rng, B, k, d, case)
    leaf, dist = route_multid_plain(*_t(lo, hi, c))
    assert leaf.dtype == torch.int32 and dist.dtype == torch.float32
    refs = [route_multid_dense(*map(jnp.asarray, (lo, hi, c)))]
    if pallas:
        refs.append(get_backend("pallas").route_multid(
            *map(jnp.asarray, (lo, hi, c))))
    for jleaf, jdist in refs:
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
        np.testing.assert_array_equal(dist.numpy().view(np.int32),
                                      np.asarray(jdist).view(np.int32))
    dl, dd = ops.route_multid(*_t(lo, hi, c))
    assert torch.equal(dl, leaf) and torch.equal(dd, dist)
    if case == "signed-zero":
        # the -0.0 sums were there to be canonicalised
        assert torch.signbit(dist_matrix(*_t(lo, hi, c))).any()
        assert not torch.signbit(dist).any()


# (B, k) of the route plan's cases: k below the group count, a multiple
# of it and one past, at the batch sizes of G = 8 (B = 300 and one ingest
# batch, 4096) and of G = 2 (B = 65536).
ROUTE_PLAN_CASES = [(300, 5), (300, 64), (300, 65), (4096, 7), (4096, 1024),
                    (4096, 1025), (65536, 1), (65536, 64), (65536, 65)]


@pytest.mark.parametrize("B,k", ROUTE_PLAN_CASES)
def test_route_plan_groups_cover_leaves(B, k):
    """The kernel's plan: rows a thread in {1, 2, 4}, a power-of-two group
    count up to the portable cluster size, and groups that cover [0, k)
    in ascending order with no overlap (the ones past k empty); an ingest
    batch (B = 4096) gets a block per multiprocessor at least."""
    rt, g, lg = route_plan(B, k)
    assert rt in (1, 2, 4) and g in (1, 2, 4, 8) and g <= ROUTE_MAX_GROUPS
    assert g * lg >= k and lg >= 1
    groups = route_groups(k, g, lg)
    assert len(groups) == g
    assert [i for rg in groups for i in rg] == list(range(k))
    assert all(rg.start <= rg.stop for rg in groups)
    tiles = -(-B // (ROUTE_THREADS * rt))
    if B == 4096:
        assert g == ROUTE_MAX_GROUPS and g * tiles >= ROUTE_SMS
    if B == 65536:
        assert g <= 2 and g * tiles >= ROUTE_SMS
    if k < g:
        assert sum(len(rg) == 0 for rg in groups) == g - k


def _grouped_route(lo, hi, c):
    """The kernel's algorithm in plain torch: each group of route_plan
    scans its leaves in ascending id from (+inf, its first id), replacing
    on a strict <; the partials merge in group order from (+inf, 0), again
    on a strict <; the winner's distance goes out plus +0.0."""
    B, k = c.shape[0], lo.shape[0]
    _, g, lg = route_plan(B, k)
    dist = dist_matrix(lo, hi, c)
    inf = torch.full((B,), float("inf"))
    best, best_i = inf, torch.zeros(B, dtype=torch.int64)
    for rg in route_groups(k, g, lg):
        gd, gi = inf, torch.full((B,), rg.start, dtype=torch.int64)
        for leaf in rg:
            take = dist[:, leaf] < gd
            gd = torch.where(take, dist[:, leaf], gd)
            gi = torch.where(take, leaf, gi)
        take = gd < best
        best, best_i = torch.where(take, gd, best), torch.where(take, gi,
                                                                best_i)
    return best_i.to(torch.int32), best + 0.0


@pytest.mark.parametrize("B,k", ROUTE_PLAN_CASES)
def test_route_grouped_merge_bit_equal_to_plain(B, k):
    """The grouped, ordered merge equals the dense oracle's argmin bit for
    bit (the lowest id on ties, (+inf, 0) for a row whose boxes are all
    empty), with equal boxes across group boundaries and +-0.0 faces."""
    d = 3
    rng = np.random.default_rng(B * 3 + k)
    lo, hi, c = _route_case(rng, B, k, d, "group-ties")
    lo[rng.random((k, d)) < 0.2] = -0.0
    hi = np.maximum(hi, lo)
    c[rng.random((B, d)) < 0.2] = 0.0
    if k > 4:
        lo[1:4], hi[1:4] = np.inf, -np.inf
    lo_t, hi_t, c_t = _t(lo, hi, c)
    leaf, dist = _grouped_route(lo_t, hi_t, c_t)
    want_leaf, want_dist = route_multid_plain(lo_t, hi_t, c_t)
    assert torch.equal(leaf, want_leaf)
    assert torch.equal(dist.view(torch.int32), want_dist.view(torch.int32))
    # every box empty: (+inf, 0), whatever group holds the first leaf
    empty = np.full((k, d), np.inf, np.float32)
    leaf, dist = _grouped_route(*_t(empty, -empty, c[:8]))
    want_leaf, want_dist = route_multid_plain(*_t(empty, -empty, c[:8]))
    assert torch.equal(leaf, want_leaf) and (leaf == 0).all()
    assert torch.equal(dist, want_dist) and torch.isinf(dist).all()


@pytest.mark.parametrize("n", [0, 1, 255, 4096, 65536, 69696, 10 ** 6])
def test_segment_plan_matches_c_chunk_rule(n):
    """segment_reduce's chunk plan, which fixes its summation order, is the
    CUDA source's rule max(256, ceil(N / 264)), at most 264 chunks."""
    ch, chunks = segment_plan(n)
    assert (SEG_MIN_ROWS, SEG_MAX_CHUNKS) == (256, 264)
    assert ch == max(256, -(-n // 264))
    assert chunks == -(-n // ch) and chunks <= 264
    assert (chunks - 1) * ch < n <= chunks * ch or n == chunks == 0


@pytest.mark.parametrize("method,seed,values", [
    ("eq", 0, "continuous"), ("adp", 1, "continuous"),
    ("eq", 2, "duplicates"), ("eq", 3, "heavy-dup")])
def test_route_1d_matches_dense_argmin(method, seed, values):
    """The binary-search 1-D route equals the dense argmin, leaf and
    distance bits, with touching boxes (hi[i] == lo[i+1]), degenerate
    [v, v] boxes, empty leaves and rows on shared boundaries."""
    rng = np.random.default_rng(seed)
    if values == "continuous":
        c0 = np.round(rng.uniform(0, 10, 4000), 1)
    elif values == "duplicates":
        c0 = rng.integers(0, 20, 4000).astype(np.float64)
    else:
        c0 = np.where(rng.random(4000) < 0.6, 5.0,
                      rng.integers(0, 20, 4000).astype(np.float64))
    jsyn, _ = jbuild(c0, rng.lognormal(0, 1, 4000),
                     k=8 if values != "continuous" else 32,
                     sample_budget=128, method=method)
    lo = np.asarray(jsyn.leaf_lo, np.float32)
    hi = np.asarray(jsyn.leaf_hi, np.float32)
    probes = np.concatenate([rng.uniform(-2, 22, 256),
                             rng.choice(np.unique(c0), 256)])
    c = probes[:, None].astype(np.float32)
    leaf, dist = tingest._route_1d(*_t(lo, hi, c))
    jleaf, jdist = route_multid_dense(*map(jnp.asarray, (lo, hi, c)))
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
    np.testing.assert_array_equal(dist.numpy().view(np.int32),
                                  np.asarray(jdist).view(np.int32))


def test_route_1d_fuzz_degenerate_interval_sets():
    """Synthetic disjoint-or-touching interval sets with degenerate boxes
    and a trailing empty leaf, against the dense argmin."""
    rng = np.random.default_rng(11)
    for _ in range(20):
        k = int(rng.integers(2, 12))
        bounds = np.sort(rng.integers(0, 15, 2 * k).astype(np.float32))
        lo, hi = bounds[0::2].copy(), bounds[1::2].copy()
        if rng.integers(0, 2):
            lo[-1], hi[-1] = np.inf, -np.inf
        c = np.concatenate([rng.uniform(-3, 18, 64), bounds,
                            bounds + 0.5]).astype(np.float32)[:, None]
        leaf, dist = tingest._route_1d(*_t(lo[:, None], hi[:, None], c))
        # the dense formulation (``_route_dist``) in float32 numpy
        dense = np.maximum(np.maximum(lo[None] - c, c - hi[None]),
                           np.float32(0.0))
        np.testing.assert_array_equal(leaf.numpy(), dense.argmin(1))
        np.testing.assert_array_equal(dist.numpy(), dense.min(1))


# ---------------------------------------------------------------------------
# Ingest state against the JAX package's StreamingIngestor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,keyed", [(1, True), (1, False), (3, True)],
                         ids=["1d-keyed", "1d-explicit_u", "3d-keyed"])
def test_ingest_state_matches_jax(d, keyed):
    """Four batches through both ingestors: a batch with NaN rows (value
    and coordinate), rows outside the quarantine box, out-of-range rows
    that grow the boxes, and enough rows to fill the reservoirs and
    replace. Integer values: every field is exact, and so is the merged
    synopsis."""
    jsyn, _, _ = _base(d)
    qbox = (np.full(d, -5.0), np.full(d, 105.0))
    jing = JIngestor(jsyn, seed=5, quarantine_box=qbox)
    ting = StreamingIngestor(carry(jsyn), seed=5, quarantine_box=qbox,
                             device="cpu")
    rng = np.random.default_rng(10 + d)
    for step in range(4):
        c, a = _batch(rng, d, 256)
        if step == 1:
            a[3] = np.nan
            c[7, 0] = np.nan
            c[9, -1] = np.inf
        u = None if keyed else rng.random(256, dtype=np.float32)
        jing.ingest(c, a, u=u)
        ting.ingest(c, a, u=u)
        assert ting.epoch == jing.epoch == step + 1
    assert_state_matches(ting.state, jing.state)
    assert ting.n_quarantined == jing.n_quarantined > 3
    assert ting.n_oob == jing.n_oob > 0
    assert ting.total_rows == jing.total_rows
    assert ting.staleness() == jing.staleness()
    assert ting.oob_frac() == jing.oob_frac()
    assert int(ting.state.k_per_leaf.max()) == 4    # reservoirs full
    # merge_synopsis: exact on integer values
    jm, tm = jing.as_synopsis(), ting.as_synopsis()
    assert tm is ting.as_synopsis()                  # cached until ingest
    for f in ("leaf_lo", "leaf_hi", "leaf_agg", "n_rows", "total_rows",
              "sample_c", "sample_a", "sample_valid", "k_per_leaf"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    for f in ("agg", "lo", "hi"):
        np.testing.assert_array_equal(getattr(tm.tree, f).numpy(),
                                      np.asarray(getattr(jm.tree, f)),
                                      err_msg=f"tree.{f}")


def test_ingest_float_values_sums_within_tolerance():
    """Float values: the delta sums within tolerance, all else exact."""
    jsyn, _, _ = _base(1, int_vals=False)
    jing = JIngestor(jsyn, seed=1)
    ting = StreamingIngestor(carry(jsyn), seed=1, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(3):
        c, a = _batch(rng, 1, 256, int_vals=False)
        jing.ingest(c, a)
        ting.ingest(c, a)
    assert_state_matches(ting.state, jing.state, exact_sums=False)


@pytest.mark.parametrize("d", [1, 3])
def test_per_row_reference_matches_jax_and_batched(d):
    """The port's host oracle equals the JAX package's oracle, and the
    port's batched step equals its oracle (integer values: exact)."""
    jsyn, _, _ = _base(d)
    jstate = jingest.init_state(jsyn)
    ting = StreamingIngestor(carry(jsyn), device="cpu")
    tstate = ting.state
    rng = np.random.default_rng(20 + d)
    for _ in range(2):
        c, a = _batch(rng, d, 200)
        u = rng.random(200, dtype=np.float32)
        jstate = jingest.ingest_batch_reference(jstate, c, a, u)
        tstate = ingest_batch_reference(tstate, c, a, u)
        ting.ingest(c, a, u=u)
    assert_state_matches(tstate, jstate)
    assert_state_matches(ting.state, jstate)


def test_step_from_carried_full_reservoirs_matches_jax():
    """A JAX state with full reservoirs (every row a replacement draw),
    carried across with stream_state_from_numpy together with its key
    (a missing ``quarantined`` reads 0), then one keyed step in each
    package from that state."""
    T, cap, n_ins = 16, 4, 16
    lo = np.arange(T, dtype=np.float32)[:, None]
    jstate = jingest.StreamState(
        leaf_lo=jnp.asarray(lo), leaf_hi=jnp.asarray(lo + 0.9),
        delta_agg=jingest.empty_delta_agg(T),
        sample_c=jnp.zeros((T, cap, 1), jnp.float32),
        sample_a=jnp.full((T, cap), -1.0, jnp.float32),
        sample_valid=jnp.ones((T, cap), bool),
        k_per_leaf=jnp.full(T, cap, jnp.int32),
        seen=jnp.full(T, cap, jnp.int32), oob=jnp.zeros((), jnp.int32),
        quarantined=jnp.zeros((), jnp.int32))
    jkey = jax.random.PRNGKey(42)
    fields = {f: np.asarray(getattr(jstate, f)) for f in FIELDS}
    fields["quarantined"] = None
    tstate, tkey = stream_state_from_numpy(fields, np.asarray(jkey),
                                           device="cpu")
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey))
    c = (np.repeat(np.arange(T, dtype=np.float32), n_ins) + 0.5)[:, None]
    a = np.tile(np.arange(n_ins, dtype=np.float32), T)
    jnew = jingest._ingest_step_keyed(jstate, jnp.asarray(c), jnp.asarray(a),
                                      jkey, "jnp", None, None)
    tnew = tingest._ingest_core(tstate, *_t(c, a),
                                trandom.uniform(tkey, (T * n_ins,)))
    assert_state_matches(tnew, jnew)
    np.testing.assert_array_equal(tnew.seen.numpy(), cap + n_ins)
    np.testing.assert_allclose(reservoir_moments(tnew).numpy(),
                               np.asarray(j_reservoir_moments(jnew)),
                               rtol=1e-6, atol=1e-6)


def test_seeded_ingestors_are_deterministic_and_seed_dependent():
    jsyn, _, _ = _base(1, n=4000, k=8)
    syn = carry(jsyn)
    rng = np.random.default_rng(21)
    batches = [_batch(rng, 1, 256, lo=0, hi=100) for _ in range(3)]
    ings = [StreamingIngestor(syn, seed=7, device="cpu"),
            StreamingIngestor(syn, key=np.asarray(jax.random.PRNGKey(7)),
                              device="cpu"),
            StreamingIngestor(syn, seed=8, device="cpu")]
    for c, a in batches:
        for ing in ings:
            ing.ingest(c, a)
    for f in FIELDS:
        assert torch.equal(getattr(ings[0].state, f),
                           getattr(ings[1].state, f)), f
    assert not torch.equal(ings[0].state.sample_a, ings[2].state.sample_a)
    assert torch.equal(ings[0].state.delta_agg, ings[2].state.delta_agg)


# ---------------------------------------------------------------------------
# Delta-merge serving
# ---------------------------------------------------------------------------

def test_serving_the_ingestor_matches_jax():
    """PassEngine(ingestor).answer(ci=0.95) against the JAX engine within
    test_torch_engine's tolerances (MIN/MAX held to a real scale), through
    a prepared handle that re-pins the merge after each ingest and counts
    one invalidation each, as the JAX engine does; the handle's answer
    equals a fresh engine's on the merged synopsis."""
    jsyn, c0, _ = _base(1, k=24, sample_budget=480, int_vals=False)
    jing = JIngestor(jsyn, seed=2)
    ting = StreamingIngestor(carry(jsyn), seed=2, device="cpu")
    jq = jquery.random_queries(c0, 40, seed=4, min_frac=0.01, max_frac=0.5)
    tq = carry_queries(jq)
    jeng = JEngine(jing, JServing(kinds=KINDS), ci=0.95)
    teng = PassEngine(ting, ServingConfig(kinds=KINDS), ci=0.95,
                      device="cpu")
    jh, th = jeng.prepare(jq), teng.prepare(tq)
    rng = np.random.default_rng(31)
    for _ in range(2):
        c, a = _batch(rng, 1, 256, int_vals=False, lo=-5, hi=105)
        jing.ingest(c, a)
        ting.ingest(c, a)
        jres, tres = jh(jq), th(tq)
    assert_results_close(jres, tres, KINDS)
    for kind in ("min", "max"):
        est = np.abs(np.asarray(jres[kind].estimate, np.float64))
        assert np.mean(est < PLACEHOLDER) >= 0.5, kind
        assert batch_scale(est) < 1e6, kind
    keys = ("hits", "misses", "evictions", "invalidations", "entries",
            "epoch")
    assert {k: teng.stats()[k] for k in keys} == \
        {k: jeng.stats()[k] for k in keys}
    assert teng.stats()["invalidations"] == 2 and teng.epoch == 2
    fresh = PassEngine(ting.as_synopsis(), ServingConfig(kinds=KINDS),
                       ci=0.95, device="cpu").answer(tq)
    for kind in KINDS:
        assert torch.equal(fresh[kind].estimate, tres[kind].estimate)


# ---------------------------------------------------------------------------
# Drift re-optimization
# ---------------------------------------------------------------------------

def _drifted(int_vals):
    """A 1-D base plus a stream drifting into new territory, ingested by
    both packages with the same seed. Integer values stay below 16, so
    every float32 product and sum of the DP is exact."""
    jsyn, c0, a0 = _base(1, int_vals=int_vals, val_hi=16)
    jing = JIngestor(jsyn, seed=3)
    ting = StreamingIngestor(carry(jsyn), seed=3, device="cpu")
    rng = np.random.default_rng(13)
    cs, as_ = [], []
    for _ in range(3):
        c, a = _batch(rng, 1, 256, int_vals=int_vals, lo=80, hi=180,
                      val_hi=16)
        jing.ingest(c, a)
        ting.ingest(c, a)
        cs.append(c[:, 0])
        as_.append(a)
    return (jing, ting, np.concatenate([c0] + cs),
            np.concatenate([a0] + as_))


def test_reoptimize_matches_jax_on_integer_values():
    """Integer values: the DP's thresholds and objective are equal, and
    the rebuilt synopses (both allocations) are equal."""
    jing, ting, c_all, a_all = _drifted(True)
    pol = DriftPolicy(staleness_threshold=0.1, min_stream_rows=512)
    assert pol.should_reoptimize(ting)
    for alloc in ("neyman", "equal"):
        jnew, jrep = jreoptimize(jing, c_all, a_all, seed=7,
                                 allocation=alloc)
        tnew, trep = pol.maybe_reoptimize(ting, c_all, a_all, seed=7,
                                          allocation=alloc)
        assert trep["k"] == jrep["k"] == 16
        np.testing.assert_array_equal(trep["thresholds"], jrep["thresholds"])
        assert trep["sample_max_variance"] == jrep["sample_max_variance"]
        for f in ("leaf_lo", "leaf_hi", "leaf_agg", "sample_a",
                  "k_per_leaf"):
            np.testing.assert_array_equal(
                getattr(tnew.base, f).numpy(),
                np.asarray(getattr(jnew.base, f)), err_msg=f"{alloc} {f}")
        assert tnew.n_stream == 0 and tnew.device.type == "cpu"
    with pytest.raises(ValueError, match="allocation"):
        reoptimize(ting, c_all, a_all, allocation="bogus")


def test_reoptimize_on_float_values_within_tolerance():
    """Float values: the DP objective within rtol=1e-5, and thresholds
    equal wherever the cuts are equal."""
    _, ting, _, _ = _drifted(False)
    state = ting.state
    valid = state.sample_valid.reshape(-1)
    order = torch.argsort(torch.where(valid, state.sample_c.reshape(-1),
                                      float("inf")), stable=True)
    order = order[:int(valid.sum())]
    vals = state.sample_a.reshape(-1)[order]
    cs = state.sample_c.reshape(-1)[order]
    tcuts, tv = tdp.dp_monotone_device(vals, 16)
    jcuts, jv = jdp.dp_monotone_jnp(jnp.asarray(vals.numpy()), 16)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    same = tcuts.numpy() == np.asarray(jcuts)
    assert same.mean() > 0.5
    tthr = tdp.cuts_to_thresholds_device(cs, tcuts).numpy()
    jthr = np.asarray(jdp.cuts_to_thresholds_jnp(jnp.asarray(cs.numpy()),
                                                 jcuts))
    inner = same[1:-1]
    np.testing.assert_array_equal(tthr[inner], jthr[inner])
    thr, v = reoptimize_cuts(ting)
    assert v == float(tv)
    assert torch.equal(thr, tdp.cuts_to_thresholds_device(cs, tcuts))


def test_device_dp_rejects_degenerate_inputs():
    with pytest.raises(ValueError, match="empty value vector"):
        tdp.dp_monotone_device(torch.zeros(0), 2)
    with pytest.raises(ValueError, match="k <= m"):
        tdp.dp_monotone_device(torch.ones(3), 4)
    cuts, v = tdp.dp_monotone_device(torch.arange(5.0), 1)
    assert cuts.tolist() == [0, 5] and float(v) > 0
    with pytest.raises(ValueError, match="at least"):
        tdp.cuts_to_thresholds_device(torch.arange(3.0),
                                      torch.zeros(1, dtype=torch.int32))
    jsyn, _, _ = _base(3)
    with pytest.raises(ValueError, match="1-D"):
        reoptimize_cuts(StreamingIngestor(carry(jsyn), device="cpu"))


def test_streaming_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers of the two streaming kernels launch or raise;
    they never fall back to the plain version. The ops take the plain
    version for CPU tensors only."""
    from repro_torch.kernels.route import route_multid_cuda
    from repro_torch.kernels.segment_reduce import segment_reduce_cuda
    v, ids = _t(np.ones(4, np.float32), np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        segment_reduce_cuda(v, ids, 2)
    lo, hi, c = _t(np.zeros((2, 2), np.float32), np.ones((2, 2), np.float32),
                   np.zeros((3, 2), np.float32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        route_multid_cuda(lo, hi, c)
    with pytest.raises(ValueError, match="several devices"):
        ops.segment_reduce(v, torch.empty(4, dtype=torch.int32,
                                          device="meta"), 2)
    assert torch.equal(ops.segment_reduce(v, ids, 2),
                       segment_reduce_plain(v, ids, 2))
