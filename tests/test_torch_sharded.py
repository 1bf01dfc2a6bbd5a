"""The port's sharded synopsis layer (``repro_torch.sharded``) against the
JAX package's, on the CPU.

The reference's sharded steps run under ``shard_map``, whose call the JAX
package writes for an older jax, so they do not run on this tree. These
tests hold the port against the reference's own per-shard pieces composed
by hand in shard order instead: ``split_rows``, ``init_sharded_state``,
``jax.random.split(key, D + 1)`` uniforms, ``_ingest_core`` /
``_apply_routed`` (the ``jnp`` backend) and ``merge_synopsis`` over the
shard-gathered state. Data are integer-valued wherever float sums are
compared, so every field is exact (float32 sums of integers below 2**24
do not depend on their order); merged serving is held to
``tests/test_torch_engine.py``'s tolerances. Inside the port: one shard is
byte-equal to ``StreamingIngestor``, and the reference's invariance
configuration gives the same BUILD / STREAM / SERVE / GLOBAL / REOPT
digests at D = 1, 2 and 4 (DESIGN.md §11).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.api import PassEngine as JEngine, ServingConfig as JServing
from repro.core.synopsis import build_synopsis as jbuild
from repro.kernels.registry import get_backend
from repro.partitions import partition_stats as jpartition_stats
from repro.serve import checkpoint as jcheckpoint
from repro.sharded import build as jsbuild
from repro.sharded.ingest import (ShardedIngestor as JSharded,
                                  init_sharded_state as jinit)
from repro.sharded.mesh import split_rows as jsplit_rows
from repro.streaming import ingest as jingest
from repro.streaming.delta import merge_synopsis as jmerge
from repro.streaming.delta import subtree_leaf_matrix as jsubtree
from repro_torch.api import PassEngine, ServingConfig
from repro_torch.core.types import QueryBatch
from repro_torch.partitions import build_catalog
from repro_torch.sharded import (ShardedIngestor, build_synopsis_sharded,
                                 catalog_delta_sharded, cut_skeleton_1d,
                                 cut_skeleton_kd, data_mesh,
                                 init_sharded_state, make_mesh,
                                 maybe_reoptimize_sharded, merge_sharded,
                                 reoptimize_sharded, skeleton_synopsis,
                                 split_rows, thresholds_to_boxes)
from repro_torch.sharded import ingest as tsh_ingest
from repro_torch.streaming import (DriftPolicy, StreamingIngestor,
                                   stream_state_from_numpy)
from repro_torch.testing import FaultPlan, inject
from test_torch_engine import (SYN_FIELDS, TREE_FIELDS,
                               assert_results_close, carry, carry_queries)

STATE_FIELDS = ("leaf_lo", "leaf_hi", "delta_agg", "sample_c", "sample_a",
                "sample_valid", "k_per_leaf", "seen", "oob", "quarantined")
KINDS = ("sum", "count", "avg", "min", "max")


def _bits(x) -> np.ndarray:
    """Raw bytes of a tensor or array, for byte-for-byte comparisons."""
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x).view(np.uint8)


def assert_state_equal(tstate, jstate):
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                      np.asarray(getattr(jstate, f)),
                                      err_msg=f)


def assert_syn_equal(tsyn, jsyn):
    for f in SYN_FIELDS:
        np.testing.assert_array_equal(getattr(tsyn, f).numpy(),
                                      np.asarray(getattr(jsyn, f)),
                                      err_msg=f)
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(tsyn.tree, f).numpy(),
                                      np.asarray(getattr(jsyn.tree, f)),
                                      err_msg=f"tree.{f}")


def _base(d=1, n=4000, k=8, budget=80, seed=0, int_vals=True):
    """A JAX synopsis over integer-valued (or lognormal) measures; budget
    80 at k = 8 gives 10 slots a stratum, not a multiple of 4."""
    rng = np.random.default_rng(seed)
    c = (np.sort(rng.uniform(0, 100, n)) if d == 1
         else rng.uniform(0, 100, (n, d)))
    a = (rng.integers(1, 40, n).astype(np.float64) if int_vals
         else rng.lognormal(0, 1, n))
    jsyn, _ = jbuild(c, a, k=k, sample_budget=budget,
                     method="eq" if d == 1 else "kd", seed=0)
    return jsyn


def _batch(rng, d, b, poison=True, int_vals=True):
    """Integer-valued (or lognormal) rows, some outside every box; with
    ``poison`` a NaN coordinate, an inf measure and rows outside the
    quarantine box."""
    c = rng.uniform(-10, 110, (b, d)).astype(np.float32)
    a = (rng.integers(1, 40, b) if int_vals
         else rng.lognormal(0, 1, b)).astype(np.float32)
    if poison:
        c[3, 0] = np.nan
        a[5] = np.inf
        c[7, :] = 150.0
    return c, a


def _qbox(d):
    return (np.full(d, -5.0, np.float32), np.full(d, 120.0, np.float32))


@functools.partial(jax.jit, static_argnames=("build",))
def _jshard(st, cb, ab, u, mb, qlo, qhi, rlo, rhi, build):
    """One shard of the reference's step (sharded/ingest.py shard_fn)."""
    if not build:
        return jingest._ingest_core(st, cb, ab, u, "jnp", mask=mb, qlo=qlo,
                                    qhi=qhi)
    bad = jingest.quarantine_mask(cb, ab, qlo, qhi)
    n_quar = jnp.sum(bad & mb).astype(jnp.int32)
    mb = mb & ~bad
    cb = jnp.where(bad[:, None], 0.0, cb)
    if cb.shape[1] == 1:
        leaf = jnp.searchsorted(rlo[1:, 0], cb[:, 0], side="right"
                                ).astype(jnp.int32)
        dsel = jnp.zeros(cb.shape[0], jnp.float32)
    else:
        leaf, dsel = get_backend("jnp").route_multid(rlo, rhi, cb)
    return jingest._apply_routed(st, cb, ab, u, leaf, dsel, "jnp", mb,
                                 n_quar=n_quar)


def jref_step(jstate, c, a, key, D, qbox, route=None):
    """One batch through the reference's per-shard pieces, composed by hand
    in shard order: split_rows, split(key, D + 1), then _ingest_core (live
    boxes) or the build step's static routing and _apply_routed per shard.
    Returns (stacked new state, the key kept for the next batch)."""
    c = jnp.asarray(c, jnp.float32).reshape(a.shape[0], -1)
    csh, ash, mask = jsplit_rows(c, jnp.asarray(a, jnp.float32), D)
    keys = jax.random.split(key, D + 1)
    qlo, qhi = (jnp.asarray(x, jnp.float32) for x in qbox)
    rlo, rhi = ((jnp.asarray(x, jnp.float32) for x in route)
                if route is not None else (None, None))
    outs = []
    for i in range(D):
        st = jax.tree_util.tree_map(lambda x, i=i: x[i], jstate)
        u = jax.random.uniform(keys[i + 1], (ash.shape[1],), jnp.float32)
        outs.append(_jshard(st, csh[i], ash[i], u, mask[i], qlo, qhi, rlo,
                            rhi, build=route is not None))
    return (jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *outs),
            keys[0])


def np_gather(jstate):
    """The reference's psum / pmin / pmax / tiled all_gather of a stacked
    state, in numpy (sums folded in shard order)."""
    s = {f: np.asarray(getattr(jstate, f)) for f in STATE_FIELDS}
    D, k, ss = s["sample_a"].shape
    delta = s["delta_agg"]
    sums = delta[0, :, 0:3].copy()
    for i in range(1, D):
        sums = sums + delta[i, :, 0:3]

    def tile(x):
        return np.moveaxis(x, 0, 1).reshape(k, D * ss, *x.shape[3:])

    return jingest.StreamState(
        leaf_lo=jnp.asarray(s["leaf_lo"].min(0)),
        leaf_hi=jnp.asarray(s["leaf_hi"].max(0)),
        delta_agg=jnp.asarray(np.concatenate(
            [sums, delta[:, :, 3:4].min(0), delta[:, :, 4:5].max(0)], 1)),
        sample_c=jnp.asarray(tile(s["sample_c"])),
        sample_a=jnp.asarray(tile(s["sample_a"])),
        sample_valid=jnp.asarray(tile(s["sample_valid"])),
        k_per_leaf=jnp.asarray(s["k_per_leaf"].sum(0)),
        seen=jnp.asarray(s["seen"].sum(0)),
        oob=jnp.asarray(s["oob"].sum(0)))


def _mesh(D):
    return data_mesh(D, device="cpu")


# ---------------------------------------------------------------------------
# 1. Row split and state split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [1, 2, 4])
def test_split_rows_and_init_state_match_reference(D):
    """Ragged batches (7, 9 and 13 rows) and a base of 10 slots a stratum,
    which D = 4 pads to 12."""
    rng = np.random.default_rng(D)
    for b in (7, 9, 13):
        c = rng.normal(size=(b, 2)).astype(np.float32)
        a = rng.normal(size=b).astype(np.float32)
        want = jsplit_rows(jnp.asarray(c), jnp.asarray(a), D)
        got = split_rows(torch.from_numpy(c), torch.from_numpy(a), D)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jsyn = _base()
    assert jsyn.sample_a.shape[1] == 10
    st = init_sharded_state(carry(jsyn), D)
    assert_state_equal(st, jinit(jsyn, D))
    assert st.sample_a.shape == (D, 8, -(-10 // D))
    assert torch.all(st.seen >= st.k_per_leaf)


# ---------------------------------------------------------------------------
# 2. One ingest step and one build step against the hand-composed reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,D", [(1, 1), (1, 4), (2, 2), (3, 4)])
def test_ingest_step_matches_reference(d, D):
    """Live-box streaming: two batches (one ragged across D), quarantined
    rows in each; state, key and counters exact."""
    jsyn = _base(d=d, seed=d)
    rng = np.random.default_rng(10 + D)
    key = jax.random.PRNGKey(17)
    ing = ShardedIngestor(carry(jsyn), mesh=_mesh(D),
                          key=np.asarray(key), quarantine_box=_qbox(d))
    jstate = jinit(jsyn, D)
    for b in (257, 300):
        c, a = _batch(rng, d, b)
        jstate, key = jref_step(jstate, c, a, key, D, _qbox(d))
        ing.ingest(c, a)
        assert_state_equal(ing.state, jstate)
        np.testing.assert_array_equal(ing._key.numpy(),
                                      np.asarray(key).astype(np.int64))
    assert ing.n_quarantined == int(np.asarray(jstate.quarantined).sum())
    assert ing.n_quarantined >= 6
    assert ing.n_stream == 557 and ing.epoch == 2


@pytest.mark.parametrize("d,D", [(1, 2), (1, 4), (2, 1), (2, 4)])
def test_build_step_matches_reference(d, D):
    """Static-skeleton routing into an empty skeleton synopsis (1-D
    thresholds by searchsorted, 2-D stretched KD boxes by row 7's plain
    version), quarantined rows in the batch; then commit's merged base."""
    rng = np.random.default_rng(20 + d)
    c0 = rng.uniform(0, 100, (2000, d)).astype(np.float32)
    a0 = rng.integers(1, 40, 2000).astype(np.float32)
    k, s_cap = 8, 4 * D
    if d == 1:
        route = jsbuild.cut_skeleton_1d(c0, a0, k, method="eq",
                                        opt_samples=512, seed=1)
    else:
        route = jsbuild.cut_skeleton_kd(c0, a0, k, opt_samples=512, seed=1)
    jbase = jsbuild.skeleton_synopsis(k, d, s_cap)
    key = jax.random.PRNGKey(3)
    ing = ShardedIngestor(skeleton_synopsis(k, d, s_cap, device="cpu"),
                          mesh=_mesh(D), key=np.asarray(key),
                          route_boxes=route, quarantine_box=_qbox(d))
    jstate = jinit(jbase, D)
    for b in (701, 512):
        c, a = _batch(rng, d, b)
        jstate, key = jref_step(jstate, c, a, key, D, _qbox(d), route=route)
        ing.ingest(c, a)
        assert_state_equal(ing.state, jstate)
    total = ing.total_rows
    merged = ing.commit()
    jmerged = jmerge(jbase, np_gather(jstate), jsubtree(jbase.tree, k),
                     total_rows=total)
    assert_syn_equal(merged, jmerged)
    assert ing._route is None and ing.epoch == 2


# ---------------------------------------------------------------------------
# 3. The merge, and serving the merged synopsis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,D", [(1, 4), (3, 2)])
def test_merge_sharded_matches_reference(d, D):
    """merge_sharded = the reference's merge_synopsis over the
    numpy-gathered reference state, every field exact on integer-valued
    measures."""
    jsyn = _base(d=d, seed=5)
    rng = np.random.default_rng(30)
    key = jax.random.PRNGKey(9)
    ing = ShardedIngestor(carry(jsyn), mesh=_mesh(D), key=np.asarray(key))
    jstate = jinit(jsyn, D)
    inf = (np.full(d, -np.inf, np.float32), np.full(d, np.inf, np.float32))
    for b in (400, 333, 129):
        c, a = _batch(rng, d, b, poison=False)
        jstate, key = jref_step(jstate, c, a, key, D, inf)
        ing.ingest(c, a)
    total = int(jsyn.total_rows) + 862
    jmerged = jmerge(jsyn, np_gather(jstate),
                     jsubtree(jsyn.tree, jsyn.num_leaves), total_rows=total)
    merged = ing.as_synopsis()
    assert_syn_equal(merged, jmerged)
    assert merged is ing.as_synopsis()                  # cached
    again = merge_sharded(ing.base, ing.state, ing._subtree,
                          total_rows=total, mesh=ing.mesh)
    assert_syn_equal(again, jmerged)
    with pytest.raises(ValueError, match="shards"):
        merge_sharded(ing.base, ing.state, ing._subtree, total_rows=total,
                      mesh=_mesh(D + 1))


@pytest.mark.parametrize("d,D", [(1, 2), (3, 4)])
def test_merged_serving_matches_reference(d, D):
    """On lognormal measures (float sums in another order): the merged
    synopsis within rtol=3e-5 / atol=1e-3 on its sums and exact elsewhere,
    and both engines' answers of all five kinds, ci=0.95, within the
    engine tolerances."""
    jsyn = _base(d=d, seed=6, int_vals=False)
    rng = np.random.default_rng(31)
    key = jax.random.PRNGKey(4)
    ing = ShardedIngestor(carry(jsyn), mesh=_mesh(D), key=np.asarray(key))
    jstate = jinit(jsyn, D)
    inf = (np.full(d, -np.inf, np.float32), np.full(d, np.inf, np.float32))
    for b in (500, 211):
        c, a = _batch(rng, d, b, poison=False, int_vals=False)
        jstate, key = jref_step(jstate, c, a, key, D, inf)
        ing.ingest(c, a)
    jmerged = jmerge(jsyn, np_gather(jstate),
                     jsubtree(jsyn.tree, jsyn.num_leaves),
                     total_rows=int(jsyn.total_rows) + 711)
    merged = ing.as_synopsis()
    for f in SYN_FIELDS:
        want, got = np.asarray(getattr(jmerged, f)), getattr(merged, f)
        if f == "leaf_agg":
            np.testing.assert_array_equal(got[:, 2:].numpy(), want[:, 2:])
            np.testing.assert_allclose(got[:, :2].numpy(), want[:, :2],
                                       rtol=3e-5, atol=1e-3)
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    from repro.core import query as jquery
    cq = rng.uniform(0, 100, (500, d)) if d > 1 else np.linspace(0, 100, 500)
    jq = jquery.random_queries(cq, 40, seed=2, min_frac=0.02, max_frac=0.6)
    jres = JEngine(jmerged, JServing(kinds=KINDS), ci=0.95).answer(jq)
    tres = PassEngine(ing, ServingConfig(kinds=KINDS), ci=0.95,
                      device="cpu").answer(carry_queries(jq))
    assert_results_close(jres, tres, KINDS)


# ---------------------------------------------------------------------------
# 4. One shard is the single-device streaming ingest, byte for byte
# ---------------------------------------------------------------------------

def test_sharded_matches_streaming_on_one_device():
    """D = 1 against StreamingIngestor on the same base and seed, float
    data: same routing, same threefry draws, same reservoir, same merged
    synopsis and answers, bit for bit."""
    rng = np.random.default_rng(7)
    n = 8192
    c = rng.normal(size=n).astype(np.float32)
    a = rng.lognormal(0, 1, size=n).astype(np.float32)
    jsyn, _ = jbuild(c, a, k=16, sample_budget=128)
    ref = StreamingIngestor(carry(jsyn), seed=9, device="cpu")
    sh = ShardedIngestor(carry(jsyn), seed=9, device="cpu")
    assert sh.n_shards == 1
    for i in range(3):
        cb = rng.normal(loc=0.2 * i, size=1024).astype(np.float32)
        ab = rng.lognormal(0, 1, size=1024).astype(np.float32)
        ref.ingest(cb, ab)
        sh.ingest(cb, ab)
    s_ref, s_sh = ref.as_synopsis(), sh.as_synopsis()
    for f in SYN_FIELDS:
        assert np.array_equal(_bits(getattr(s_ref, f)),
                              _bits(getattr(s_sh, f))), f
    for f in TREE_FIELDS:
        assert np.array_equal(_bits(getattr(s_ref.tree, f)),
                              _bits(getattr(s_sh.tree, f))), f
    assert ref.n_oob == sh.n_oob and ref.total_rows == sh.total_rows
    q = QueryBatch(torch.tensor([[-0.5], [-3.0], [0.1]]),
                   torch.tensor([[0.7], [3.0], [0.1]]))
    want = PassEngine(ref, ServingConfig(kinds=KINDS), ci=0.95,
                      device="cpu").answer(q)
    got = PassEngine(sh, ServingConfig(kinds=KINDS), ci=0.95,
                     device="cpu").answer(q)
    for kind in KINDS:
        for f in ("estimate", "ci_half", "lower", "upper", "ci_lo", "ci_hi"):
            assert np.array_equal(_bits(getattr(want[kind], f)),
                                  _bits(getattr(got[kind], f))), (kind, f)


# ---------------------------------------------------------------------------
# 5. Invariance across the shard count
# ---------------------------------------------------------------------------

def _digest(*arrays) -> str:
    return b"".join(_bits(x).tobytes() for x in arrays).hex()


def _invariance_digests(d, D):
    """The reference's invariance script (tests/test_sharded.py) on the
    port, at D shards on the CPU."""
    rng = np.random.default_rng(0)
    n = 16384
    c = rng.normal(size=(n, d)).astype(np.float32)
    a = rng.integers(0, 100, size=n).astype(np.float32)
    out = {}
    ing, rep = build_synopsis_sharded(c, a, k=8, sample_budget=64, seed=3,
                                      mesh=_mesh(D))
    assert rep["n_shards"] == D
    syn = ing.as_synopsis()
    out["BUILD"] = _digest(syn.leaf_agg, syn.leaf_lo, syn.leaf_hi,
                           syn.tree.agg, syn.tree.lo, syn.tree.hi,
                           syn.n_rows)
    c2 = rng.normal(loc=0.25, size=(2048, d)).astype(np.float32)
    a2 = rng.integers(0, 100, size=2048).astype(np.float32)
    ing.ingest(c2, a2)
    syn2 = ing.as_synopsis()
    out["STREAM"] = _digest(syn2.leaf_agg, syn2.tree.agg)
    eng = PassEngine(ing, device="cpu")
    q = QueryBatch(torch.full((1, d), -50.0), torch.full((1, d), 50.0))
    res = eng.answer(q)["sum"]
    out["SERVE"] = _digest(res.estimate, res.lower, res.upper)
    for i in range(3):
        lo = 0.5 * (i + 1)
        cb = rng.normal(loc=lo, size=(1024, d)).astype(np.float32)
        ab = rng.integers(0, 100, size=1024).astype(np.float32)
        ing.ingest(cb, ab)
    syn3 = ing.as_synopsis()
    out["GLOBAL"] = _digest(syn3.tree.agg[0], syn3.total_rows)
    if d == 1:
        call = np.concatenate([c[:, 0], c2[:, 0]])
        aall = np.concatenate([a, a2])
        ing4, rep4 = reoptimize_sharded(ing, call, aall, seed=11)
        assert rep4["n_shards"] == D and ing4.mesh == ing.mesh
        s4 = ing4.as_synopsis()
        root = s4.tree.agg[0]
        out["REOPT"] = _digest(root[[0, 2, 3, 4]], s4.total_rows) + str(
            s4.num_leaves)
    return out


@pytest.mark.parametrize("d", [1, 2])
def test_device_count_invariance(d):
    """Build, stream, serve (and the 1-D re-optimization) give the same
    digests at D = 1, 2 and 4."""
    outs = {D: _invariance_digests(d, D) for D in (1, 2, 4)}
    tags = ("BUILD", "STREAM", "SERVE", "GLOBAL") + (("REOPT",)
                                                     if d == 1 else ())
    for tag in tags:
        assert outs[1][tag] == outs[2][tag] == outs[4][tag], (tag, d)


# ---------------------------------------------------------------------------
# 6. Skeletons and the sharded build
# ---------------------------------------------------------------------------

def test_skeletons_match_reference():
    """Equal-depth 1-D cuts, the stretched KD boxes (2-D, 3-D),
    thresholds_to_boxes and the empty skeleton synopsis: exact."""
    rng = np.random.default_rng(4)
    c = rng.normal(size=(3000, 3)).astype(np.float32)
    a = rng.lognormal(0, 1, 3000).astype(np.float32)
    for k, m, seed in ((8, 512, 0), (13, 3000, 2), (16, 5000, 1)):
        got = cut_skeleton_1d(c[:, 0], a, k, method="eq", opt_samples=m,
                              seed=seed)
        want = jsbuild.cut_skeleton_1d(c[:, 0], a, k, method="eq",
                                       opt_samples=m, seed=seed)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for d, k in ((2, 8), (3, 11)):
        got = cut_skeleton_kd(c[:, :d], a, k, opt_samples=1024, seed=3)
        want = jsbuild.cut_skeleton_kd(c[:, :d], a, k, opt_samples=1024,
                                       seed=3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    thr = np.sort(rng.normal(size=9)).astype(np.float32)
    for g, w in zip(thresholds_to_boxes(thr),
                    jsbuild.thresholds_to_boxes(thr)):
        np.testing.assert_array_equal(g, w)
    for k, d, s in ((8, 1, 4), (5, 3, 6)):
        assert_syn_equal(skeleton_synopsis(k, d, s, device="cpu"),
                         jsbuild.skeleton_synopsis(k, d, s))
    with pytest.raises(ValueError, match="unknown skeleton method"):
        cut_skeleton_1d(c[:, 0], a, 8, method="zebra")


def test_adp_skeleton_matches_reference_on_integer_values():
    """method='adp': the float32 DP of the reference (dp_monotone_jnp) and
    the port's (dp_monotone_device) sum their prefix sums in another order
    (ROADMAP Queue 3), so the cuts are held on measures whose prefix sums
    stay exact in float32; there they are equal."""
    rng = np.random.default_rng(6)
    c = rng.normal(size=6000).astype(np.float32)
    a = rng.integers(1, 16, 6000).astype(np.float32)
    for k, m in ((8, 1024), (32, 2048)):
        got = cut_skeleton_1d(c, a, k, method="adp", opt_samples=m, seed=5)
        want = jsbuild.cut_skeleton_1d(c, a, k, method="adp",
                                       opt_samples=m, seed=5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("D", [1, 2])
def test_build_sharded_exact_one_device(D):
    """The sharded build: exact aggregates, exact boxes, full reservoirs,
    cross-checked against numpy; leaf counts those of the skeleton's
    thresholds over every row."""
    rng = np.random.default_rng(5)
    n = 6000
    c = rng.normal(size=n).astype(np.float32)
    a = rng.lognormal(0, 1, size=n).astype(np.float32)
    ing, rep = build_synopsis_sharded(c, a, k=8, sample_budget=64, seed=1,
                                      batch_rows=2048, mesh=_mesh(D))
    syn = ing.as_synopsis()
    assert rep["s_cap"] == 8 and rep["n_shards"] == D
    assert float(syn.total_rows) == n
    np.testing.assert_allclose(float(syn.leaf_agg[:, 2].sum()), n)
    np.testing.assert_allclose(float(syn.leaf_agg[:, 0].sum()), a.sum(),
                               rtol=1e-6)
    assert float(syn.tree.agg[0, 3]) == a.min()
    assert float(syn.tree.agg[0, 4]) == a.max()
    lo, hi = syn.leaf_lo[:, 0].numpy(), syn.leaf_hi[:, 0].numpy()
    assert np.all(lo <= hi)
    assert lo.min() == c.min() and hi.max() == c.max()
    assert torch.all(syn.k_per_leaf == rep["s_cap"])
    assert torch.equal(syn.sample_valid.sum(1).to(torch.int32),
                       syn.k_per_leaf)
    route_lo, _ = cut_skeleton_1d(c, a, 8, seed=1)
    assign = np.searchsorted(route_lo[1:, 0], c, side="right")
    np.testing.assert_array_equal(syn.leaf_agg[:, 2].numpy(),
                                  np.bincount(assign, minlength=8))


# ---------------------------------------------------------------------------
# 7. Dispatch faults
# ---------------------------------------------------------------------------

def _fault_base(seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 100, 4000)
    a = np.floor(rng.uniform(0, 500, 4000))
    return carry(jbuild(c, a, k=16, sample_budget=128, method="eq")[0])


def _fault_batches(seed, count, b):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 100, b), np.floor(rng.uniform(0, 500, b)))
            for _ in range(count)]


def test_transient_shard_failures_retry_bit_identical(monkeypatch):
    """Two of four dispatches fail twice each, then succeed: four retries,
    nothing dropped, and the state and answers a clean run's, bit for
    bit (the key splits before dispatch)."""
    monkeypatch.setattr(tsh_ingest, "DISPATCH_BACKOFF_S", 1e-5)
    syn = _fault_base(8)
    batches = _fault_batches(10, 4, 128)
    clean = ShardedIngestor(syn, seed=21, mesh=_mesh(2))
    chaotic = ShardedIngestor(syn, seed=21, mesh=_mesh(2))
    for c, a in batches:
        clean.ingest(c, a)
    with inject(FaultPlan(shard_fail_every=2, shard_fail_persist=2)):
        for c, a in batches:
            chaotic.ingest(c, a)
    stats = chaotic.fault_stats()
    assert stats["dispatch_retries"] == 4
    assert stats["dropped_batches"] == 0
    for f in STATE_FIELDS:
        assert torch.equal(getattr(clean.state, f),
                           getattr(chaotic.state, f)), f
    q = QueryBatch(torch.tensor([[10.0], [0.0]]), torch.tensor([[60.0],
                                                                [100.0]]))
    want = PassEngine(clean, ServingConfig(kinds=("sum", "avg")),
                      device="cpu").answer(q)
    got = PassEngine(chaotic, ServingConfig(kinds=("sum", "avg")),
                     device="cpu").answer(q)
    for kind in want:
        assert torch.equal(want[kind].estimate, got[kind].estimate)


def test_persistent_shard_failure_drops_batch_and_counts(monkeypatch):
    """A dispatch that fails every attempt: the batch is dropped after
    DISPATCH_RETRIES retries and counted, and the engine reports it."""
    monkeypatch.setattr(tsh_ingest, "DISPATCH_BACKOFF_S", 1e-5)
    ing = ShardedIngestor(_fault_base(11), seed=23, mesh=_mesh(4))
    with inject(FaultPlan(shard_fail_every=2, shard_fail_persist=-1)):
        for c, a in _fault_batches(12, 2, 64):
            ing.ingest(c, a)
    assert ing.fault_stats() == {"dispatch_retries": tsh_ingest.
                                 DISPATCH_RETRIES, "dropped_batches": 1,
                                 "poisoned_batches": 0}
    assert ing.n_stream == 64 and ing.epoch == 1
    faults = PassEngine(ing, device="cpu").stats()["faults"]
    assert faults["dropped_batches"] == 1
    assert faults["dispatch_retries"] == 4


def test_poisoned_sharded_batch_is_quarantined_and_counted():
    ing = ShardedIngestor(_fault_base(13), seed=2, mesh=_mesh(2))
    with inject(FaultPlan(poison_every=2)):
        for c, a in _fault_batches(14, 4, 50):
            ing.ingest(c, a)
    faults = PassEngine(ing, device="cpu").stats()["faults"]
    assert faults["poisoned_batches"] == 2
    assert faults["quarantined_rows"] == 100
    assert ing.total_rows == 4000 + 100


# ---------------------------------------------------------------------------
# 8. PassEngine.from_sharded
# ---------------------------------------------------------------------------

def test_engine_from_sharded():
    """The reference's engine script at D = 4 on the CPU: the state keeps
    its leading shard axis, a covering query is exact, an ingest bumps the
    epoch and re-pins the prepared handle, the drift policy trips and the
    sharded re-optimization serves exactly after replace_source."""
    rng = np.random.default_rng(1)
    n = 16384
    c = rng.normal(size=n).astype(np.float32)
    a = rng.integers(0, 50, size=n).astype(np.float32)
    eng = PassEngine.from_sharded(c, a, k=16, sample_budget=128, seed=2,
                                  mesh=_mesh(4))
    ing = eng.source
    assert eng.device == torch.device("cpu")
    for f in ("sample_a", "sample_c", "delta_agg", "leaf_lo"):
        assert getattr(ing.state, f).shape[0] == 4, f
    q = QueryBatch(torch.tensor([[-50.0]]), torch.tensor([[50.0]]))
    prepared = eng.prepare(q)
    assert float(prepared(q)["sum"].estimate[0]) == float(a.sum())
    c2 = rng.normal(loc=1.0, size=4096).astype(np.float32)
    a2 = rng.integers(0, 50, size=4096).astype(np.float32)
    e0 = eng.epoch
    ing.ingest(c2, a2)
    assert eng.epoch == e0 + 1
    assert float(prepared(q)["sum"].estimate[0]) == float(a.sum()
                                                         + a2.sum())
    assert eng.stats()["invalidations"] >= 1
    pol = DriftPolicy(staleness_threshold=0.05, min_stream_rows=1)
    assert pol.should_reoptimize(ing)
    call, aall = np.concatenate([c, c2]), np.concatenate([a, a2])
    ing3, rep = maybe_reoptimize_sharded(pol, ing, call, aall, seed=5)
    assert rep["n_shards"] == 4 and ing3 is not ing
    eng.replace_source(ing3)
    assert float(eng.answer(q)["sum"].estimate[0]) == float(aall.sum())
    same, none = maybe_reoptimize_sharded(DriftPolicy(), ing3, call, aall)
    assert same is ing3 and none is None


def test_reoptimize_rejects_kd_and_small_pools():
    rng = np.random.default_rng(2)
    c = rng.normal(size=(2000, 2)).astype(np.float32)
    a = rng.integers(0, 9, 2000).astype(np.float32)
    ing, _ = build_synopsis_sharded(c, a, k=8, sample_budget=64,
                                    mesh=_mesh(2))
    with pytest.raises(ValueError, match="1-D synopses"):
        reoptimize_sharded(ing, c, a)
    ing1, _ = build_synopsis_sharded(c[:, 0], a, k=8, sample_budget=64,
                                     mesh=_mesh(2))
    with pytest.raises(ValueError, match="too small"):
        reoptimize_sharded(ing1, c[:, 0], a, k=64)


# ---------------------------------------------------------------------------
# 9. Sharded checkpoints
# ---------------------------------------------------------------------------

def test_sharded_roundtrip(tmp_path):
    """Save, restore (same D by default), identical answers and state; the
    restored ingestor goes on ingesting as the original does. A build in
    progress round-trips its route skeleton."""
    ing = ShardedIngestor(_fault_base(9), seed=13, mesh=_mesh(4))
    rng = np.random.default_rng(10)
    ing.ingest(rng.uniform(0, 100, 256), np.floor(rng.uniform(0, 500, 256)))
    eng = PassEngine(ing, ServingConfig(kinds=("sum", "avg")), device="cpu")
    q = QueryBatch(torch.tensor([[5.0], [40.0]]), torch.tensor([[50.0],
                                                                [41.0]]))
    want = eng.answer(q)
    meta = eng.checkpoint(tmp_path / "ck.npz")
    assert meta["source"] == "sharded" and meta["n_shards"] == 4
    eng2 = PassEngine.restore(tmp_path / "ck.npz", device="cpu")
    src = eng2.source
    assert src.n_shards == 4 and src.epoch == ing.epoch
    for f in STATE_FIELDS:
        assert torch.equal(getattr(src.state, f), getattr(ing.state, f)), f
    for kind in want:
        assert torch.equal(eng2.answer(q)[kind].estimate,
                           want[kind].estimate)
    batch = (rng.uniform(0, 100, 128), np.floor(rng.uniform(0, 500, 128)))
    ing.ingest(*batch)
    src.ingest(*batch)
    for kind in want:
        assert torch.equal(eng2.answer(q)[kind].estimate,
                           eng.answer(q)[kind].estimate)
    # mid-build: the skeleton and the (+-inf) quarantine box come back
    route = thresholds_to_boxes(np.linspace(10, 90, 7))
    b = ShardedIngestor(skeleton_synopsis(8, 1, 4, device="cpu"),
                        mesh=_mesh(2), seed=1, route_boxes=route)
    b.ingest(*batch)
    PassEngine(b, device="cpu").checkpoint(tmp_path / "b.npz")
    b2 = PassEngine.restore(tmp_path / "b.npz", device="cpu").source
    assert torch.equal(b2._route[0], b._route[0])
    assert torch.equal(b2._qhi, b._qhi) and torch.isinf(b2._qhi).all()
    b.ingest(*batch)
    b2.ingest(*batch)
    assert torch.equal(b.commit().leaf_agg, b2.commit().leaf_agg)


def test_restore_onto_another_shard_count_raises(tmp_path):
    ing = ShardedIngestor(_fault_base(3), seed=1, mesh=_mesh(4))
    PassEngine(ing, device="cpu").checkpoint(tmp_path / "ck.npz")
    with pytest.raises(ValueError, match="taken with 4 shards but the "
                                         "restore mesh has 2"):
        PassEngine.restore(tmp_path / "ck.npz", mesh=_mesh(2),
                           device="cpu")
    eng = PassEngine.restore(tmp_path / "ck.npz", mesh=_mesh(4),
                             device="cpu")
    assert eng.source.mesh == _mesh(4)
    with pytest.raises(TypeError, match="ShardMesh"):
        PassEngine.restore(tmp_path / "ck.npz", mesh=4, device="cpu")


def test_reference_layout_sharded_file_loads(tmp_path):
    """A file in the JAX package's sharded layout restores into the port:
    at D = 1 written by the reference's own save_engine (its
    ShardedIngestor builds on this tree; only its steps do not), at D = 2
    written with its _put_dc / _put_key helpers around a state composed
    by hand. The restored engine serves the reference's merged synopsis
    within the engine tolerances, and keeps ingesting as the reference's
    pieces do."""
    import json
    jsyn = _base(seed=8)
    rng = np.random.default_rng(12)
    c, a = _batch(rng, 1, 300, poison=False)
    inf = (np.full(1, -np.inf, np.float32), np.full(1, np.inf, np.float32))
    from repro.core import query as jquery
    jq = jquery.random_queries(np.linspace(0, 100, 400), 32, seed=4)
    for D in (1, 2):
        key = jax.random.PRNGKey(5)
        jstate, key = jref_step(jinit(jsyn, D), c, a, key, D, inf)
        path = tmp_path / f"ref{D}.npz"
        if D == 1:
            jing = JSharded(jsyn, key=key)
            jing.state, jing.n_stream, jing._epoch = jstate, 300, 1
            JEngine(jing, JServing(kinds=KINDS)).checkpoint(path)
        else:
            arrays = {}
            meta = {"version": 1, "epoch": 1, "source": "sharded",
                    "backend": "jnp", "n_shards": D,
                    "serving": jcheckpoint._config_meta(
                        JServing(kinds=KINDS)), "ci": None,
                    "base": jcheckpoint._put_dc(arrays, "base", jsyn),
                    "state": jcheckpoint._put_dc(arrays, "state", jstate),
                    "n_stream": 300, "has_qbox": True,
                    "fault_stats": {"dispatch_retries": 3,
                                    "dropped_batches": 0,
                                    "poisoned_batches": 0}}
            jcheckpoint._put_key(arrays, "ing/key", key)
            arrays["qbox/lo"], arrays["qbox/hi"] = inf
            arrays["__meta__"] = np.asarray(json.dumps(meta))
            np.savez(path, **arrays)
        eng = PassEngine.restore(path, device="cpu")
        src = eng.source
        assert src.n_shards == D and src.epoch == 1
        assert_state_equal(src.state, jstate)
        jmerged = jmerge(jsyn, np_gather(jstate),
                         jsubtree(jsyn.tree, jsyn.num_leaves),
                         total_rows=int(jsyn.total_rows) + 300)
        assert_syn_equal(src.as_synopsis(), jmerged)
        assert_results_close(JEngine(jmerged, JServing(kinds=KINDS))
                             .answer(jq), eng.answer(carry_queries(jq)),
                             KINDS)
        if D == 2:
            assert eng.stats()["faults"]["dispatch_retries"] == 3
        c2, a2 = _batch(rng, 1, 99, poison=False)
        jstate, _ = jref_step(jstate, c2, a2, key, D, inf)
        src.ingest(c2, a2)
        assert_state_equal(src.state, jstate)


def test_stream_state_from_numpy_carries_a_sharded_state():
    jsyn = _base(seed=2)
    jstate = jinit(jsyn, 4)
    fields = {f: np.asarray(getattr(jstate, f)) for f in STATE_FIELDS}
    fields["quarantined"] = None
    st, key = stream_state_from_numpy(fields, np.asarray(
        jax.random.PRNGKey(3)), device="cpu")
    assert st.quarantined.shape == (4,) and st.oob.shape == (4,)
    assert key.tolist() == [0, 3]
    for f in STATE_FIELDS[:-1]:
        np.testing.assert_array_equal(getattr(st, f).numpy(), fields[f])


# ---------------------------------------------------------------------------
# 10. The sharded catalog delta
# ---------------------------------------------------------------------------

CAT_FIELDS = ("n", "col_lo", "col_hi", "col_sum", "col_sumsq", "hist",
              "m_agg")


def _cat_rows(seed=1, n=3001, P=8, d=2):
    """Integer-valued rows (exact float32 sums), partition 6 empty."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 100, size=(n, d)).astype(np.float32)
    a = rng.integers(0, 50, size=n).astype(np.float32)
    pid = rng.integers(0, P, size=n).astype(np.int32)
    pid[pid == 6] = 7
    return c, a, pid


@pytest.mark.parametrize("D", [1, 2, 4])
def test_catalog_delta_sharded_matches_build_catalog(D):
    """Counts, histograms, boxes and MIN/MAX exactly build_catalog's over
    the same partitions; the sums too on these integer values."""
    c, a, pid = _cat_rows()
    P, bins = 8, 16
    blo, bhi = np.zeros(2, np.float32), np.full(2, 100, np.float32)
    got = catalog_delta_sharded(c, a, pid, P, bins=bins, bin_lo=blo,
                                bin_hi=bhi, mesh=_mesh(D))
    parts = [(c[pid == p], a[pid == p]) for p in range(P)]
    want = build_catalog(parts, bins=bins, bin_lo=blo, bin_hi=bhi,
                         device="cpu")
    for f in CAT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f).numpy(), err_msg=f)
    assert np.isinf(got.col_lo[6].numpy()).all()
    half = c.shape[0] // 2
    from repro_torch.partitions import combine_catalogs
    d1 = catalog_delta_sharded(c[:half], a[:half], pid[:half], P,
                               bins=bins, bin_lo=blo, bin_hi=bhi,
                               mesh=_mesh(D))
    d2 = catalog_delta_sharded(c[half:], a[half:], pid[half:], P,
                               bins=bins, bin_lo=blo, bin_hi=bhi,
                               mesh=_mesh(D))
    both = combine_catalogs(d1, d2)
    for f in CAT_FIELDS:
        np.testing.assert_array_equal(getattr(both, f).numpy(),
                                      getattr(want, f).numpy(), err_msg=f)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_catalog_delta_sharded_matches_reference_blocks(D):
    """Equal, field for field, to the reference's partition_stats run on
    each of the D masked row blocks and merged in numpy (sums folded in
    block order, MIN/MAX combined)."""
    c, a, pid = _cat_rows(seed=D, n=2999, d=1)
    P, bins = 8, 8
    blo, bhi = np.zeros(1, np.float32), np.full(1, 100, np.float32)
    got = catalog_delta_sharded(c, a, pid, P, bins=bins, bin_lo=blo,
                                bin_hi=bhi, mesh=_mesh(D))
    b = a.shape[0]
    bs = -(-b // D)
    idx = np.minimum(np.arange(D * bs), b - 1)
    mask = np.arange(D * bs) < b
    blocks = []
    for i in range(D):
        sl = slice(i * bs, (i + 1) * bs)
        blocks.append(jpartition_stats(
            jnp.asarray(c[idx[sl]]), jnp.asarray(a[idx[sl]]),
            jnp.asarray(pid[idx[sl]]), P, bins=bins, bin_lo=blo,
            bin_hi=bhi, mask=jnp.asarray(mask[sl])))
    for f in CAT_FIELDS:
        xs = [np.asarray(getattr(x, f)) for x in blocks]
        if f in ("col_lo",):
            want = np.min(xs, 0)
        elif f in ("col_hi",):
            want = np.max(xs, 0)
        else:
            want = xs[0].copy()
            for x in xs[1:]:
                want = want + x
            if f == "m_agg":
                want[:, 3] = np.min([x[:, 3] for x in xs], 0)
                want[:, 4] = np.max([x[:, 4] for x in xs], 0)
        np.testing.assert_array_equal(getattr(got, f).numpy(), want,
                                      err_msg=f)


def test_catalog_delta_sharded_on_an_empty_batch():
    cat = catalog_delta_sharded(np.zeros((0, 2)), np.zeros(0),
                                np.zeros(0, np.int32), 3, bins=4,
                                bin_lo=[0.0, 0.0], bin_hi=[1.0, 1.0],
                                mesh=_mesh(2))
    assert cat.total_rows == 0.0 and cat.hist.shape == (3, 2, 4)


def test_mesh_helpers():
    m = make_mesh((4, 2), ("data", "model"), device="cpu")
    assert m.shape == {"data": 4, "model": 2} and m.size == 8
    assert data_mesh(device="cpu").shape == {"shards": 1}
    with pytest.raises(ValueError, match=">= 1"):
        make_mesh((0,), ("shards",), device="cpu")
    with pytest.raises(ValueError, match="axis names"):
        make_mesh((2, 2), ("data",), device="cpu")
    st = init_sharded_state(carry(_base()), 2)
    from repro_torch.sharded import shard_leading
    assert shard_leading(_mesh(2), st).seen.device.type == "cpu"
