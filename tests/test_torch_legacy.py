"""The port's legacy and deprecated surface against the JAX package's, on
the CPU: the warn-once shims over ``PassEngine``, ``ess`` / ``skip_rate``,
the delta codec, the kernel-convention oracles (``kernels/ref.py``), the
flat-sample moment ops and the token loader.

Tolerances:

* each shim against the port's own ``PassEngine``: bit for bit (the shims
  are the engine underneath, so this holds the argument plumbing);
* each shim against the reference's shim: ``tests/test_torch_engine.py``'s
  tolerances (the bootstrap draws the same weights in both packages);
* ``ess`` / ``skip_rate``, ``delta_encode`` / ``delta_decode``: bit-equal
  (integer sums and elementwise float32 operations);
* ``kernels/ref.py`` and the flat ops against the reference and the
  port's plain versions: relation codes, counts and MIN/MAX exact, float
  sums rtol=3e-5, atol=1e-3 (fp32 sums in another order);
* ``TokenLoader``: every batch equal.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro import engine as jengine, uncertainty as juncertainty
from repro.core import estimators as jE
from repro.core import query as jquery
from repro.core.synopsis import build_synopsis as jbuild
from repro.core.synopsis import delta_decode as jdecode
from repro.core.synopsis import delta_encode as jencode
from repro.data.loader import TokenLoader as JLoader
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import engine, uncertainty
from repro_torch.api import (PassEngine, ServingConfig, CIConfig,
                             reset_deprecation_warnings)
from repro_torch.core import (build_synopsis, delta_decode, delta_encode,
                              ground_truth, random_queries, relative_error)
from repro_torch.core import estimators as E
from repro_torch.core import query as core_query
from repro_torch.data.loader import TokenLoader
from repro_torch.engine.executor import compute_artifacts
from repro_torch.kernels import ops, ref
from repro_torch.kernels.query_eval import query_eval_plain
from repro_torch.kernels.segment_reduce import (segment_reduce_plain,
                                                weighted_segment_reduce_plain)
from test_torch_engine import (KINDS, SYN_FIELDS, assert_results_close,
                               carry, carry_queries)

FIELDS = ("estimate", "ci_half", "lower", "upper", "frac_rows_touched",
          "ci_lo", "ci_hi")
RTOL, ATOL = 3e-5, 1e-3


def _legacy(fn, *args, **kw):
    """Run a deprecated entry point with its warning suppressed."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kw)


def assert_same(got, want):
    assert set(got) == set(want)
    for kind in want:
        for f in FIELDS:
            g, w = getattr(got[kind], f), getattr(want[kind], f)
            if g is None or w is None:
                assert g is None and w is None, (kind, f)
                continue
            assert torch.equal(g, w), (kind, f)


@pytest.fixture(scope="module")
def served():
    """(jax synopsis, port synopsis, jax queries, port queries, c, a)."""
    rng = np.random.default_rng(0)
    c = np.sort(rng.uniform(0, 100, 20000))
    a = rng.lognormal(0, 1, 20000) * (1 + np.sin(c / 5))
    jsyn, _ = jbuild(c, a, k=16, sample_rate=0.02, method="eq", seed=0)
    jq = jquery.random_queries(c, 24, seed=2)
    return jsyn, carry(jsyn), jq, carry_queries(jq), c, a


def _shims(lib, syn, qs, **dev):
    """(name, call, engine serving kwargs, engine ci) of each shim, as the
    reference's tests/test_api.py lists them."""
    if lib == "torch":
        eng_mod, unc, est_mod, q_mod = engine, uncertainty, E, core_query
    else:
        eng_mod, unc, est_mod, q_mod = jengine, juncertainty, jE, jquery
    return [
        ("engine.answer",
         lambda: eng_mod.answer(syn, qs, kinds=KINDS, **dev),
         dict(kinds=KINDS), None),
        ("core.answer",
         lambda: {"avg": q_mod.answer(syn, qs, kind="avg",
                                      use_aggregates=False, **dev)},
         dict(kinds=("avg",), use_aggregates=False), None),
        ("core.answer kinds",
         lambda: q_mod.answer(syn, qs, kinds=("sum", "max"), ci=0.9, **dev),
         dict(kinds=("sum", "max")), CIConfig(level=0.9)),
        ("core.estimators.estimate",
         lambda: {"count": est_mod.estimate(syn, qs, kind="count", **dev)},
         dict(kinds=("count",)), None),
        ("uncertainty.answer_with_ci",
         lambda: unc.answer_with_ci(syn, qs, ("sum", "avg"), level=0.95,
                                    **dev),
         dict(kinds=("sum", "avg")), CIConfig(level=0.95)),
        ("uncertainty.poisson_bootstrap",
         lambda: unc.poisson_bootstrap(syn, qs, ("sum", "avg"), n_boot=16,
                                       seed=3, **dev),
         dict(kinds=("sum", "avg")),
         CIConfig(method="bootstrap", n_boot=16, key=3)),
    ]


def test_shims_equal_passengine_and_reference(served):
    """Every shim returns its PassEngine answer bit for bit, and meets the
    reference's shim of the same name within the engine's tolerances."""
    jsyn, tsyn, jq, tq, _, _ = served
    jcalls = _shims("jax", jsyn, jq)
    for (_name, call, sv, ci), (_, jcall, _, _) in zip(
            _shims("torch", tsyn, tq, device="cpu"), jcalls):
        got = _legacy(call)
        want = PassEngine(tsyn, ServingConfig(**sv), ci=ci,
                          device="cpu").answer(tq)
        assert_same(got, want)
        assert_results_close(_legacy(jcall), got, tuple(got))


def test_artifacts_entry_matches_compute_artifacts_and_jax(served):
    jsyn, tsyn, jq, tq, _, _ = served
    from repro_torch.engine import executor
    executor.reset_op_counts()
    art = engine.artifacts(tsyn, tq, ("sum", "min"))
    assert executor.OP_COUNTS == {"classify": 1, "moments": 1,
                                  "extremes": 1}
    want = compute_artifacts(tsyn, tq, ("sum", "min"))
    jart = jengine.artifacts(jsyn, jq, ("sum", "min"))
    for f in ("rel", "cover", "partial", "exact", "k_pred", "s_sum",
              "s_sumsq", "samp_min", "samp_max", "touched"):
        assert torch.equal(getattr(art, f), getattr(want, f)), f
        j = np.asarray(getattr(jart, f))
        t = getattr(art, f).numpy()
        if f in ("rel", "cover", "partial", "k_pred", "samp_min",
                 "samp_max"):
            np.testing.assert_array_equal(t, j, err_msg=f)
        else:
            np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL,
                                       err_msg=f)
    with pytest.raises(ValueError, match="backend must be None"):
        engine.artifacts(tsyn, tq, ("sum",), backend="jnp")


def test_deprecation_warns_once_per_entrypoint_with_replacement(served):
    """Every legacy entry point fires exactly ONE DeprecationWarning per
    process naming the repro_torch PassEngine replacement; later calls are
    silent (the reference's tests/test_api.py cases)."""
    _, tsyn, _, tq, _, _ = served
    names = {"engine.answer": "repro_torch.engine.answer",
             "core.answer": "repro_torch.core.answer",
             "core.estimators.estimate":
                 "repro_torch.core.estimators.estimate",
             "uncertainty.answer_with_ci":
                 "repro_torch.uncertainty.answer_with_ci",
             "uncertainty.poisson_bootstrap":
                 "repro_torch.uncertainty.poisson_bootstrap"}
    for short, call, _, _ in _shims("torch", tsyn, tq, device="cpu"):
        if short == "core.answer kinds":
            continue
        name = names[short]
        reset_deprecation_warnings()
        with pytest.warns(DeprecationWarning,
                          match=r"use repro_torch\.api\.PassEngine") as rec:
            call()
        ours = [w for w in rec if name in str(w.message)]
        assert len(ours) == 1, (name, [str(w.message) for w in rec])
        with warnings.catch_warnings(record=True) as again:
            warnings.simplefilter("always")
            call()
        assert not [w for w in again
                    if issubclass(w.category, DeprecationWarning)], name


def test_shims_default_to_the_card(served, monkeypatch):
    _, tsyn, _, tq, _, _ = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for _, call, _, _ in _shims("torch", tsyn, tq):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _legacy(call)


@pytest.mark.parametrize("d", [1, 3])
def test_ess_and_skip_rate_match_jax(d):
    rng = np.random.default_rng(d)
    c = (np.sort(rng.uniform(0, 100, 8000)) if d == 1
         else rng.uniform(0, 100, (8000, d)))
    a = rng.lognormal(0, 1, 8000)
    jsyn, _ = jbuild(c, a, k=24, sample_rate=0.03,
                     method="adp" if d == 1 else "kd", seed=0)
    jq = jquery.random_queries(c, 40, seed=5)
    tsyn, tq = carry(jsyn), carry_queries(jq)
    for tfn, jfn in ((E.ess, jE.ess), (E.skip_rate, jE.skip_rate)):
        got, want = tfn(tsyn, tq), np.asarray(jfn(jsyn, jq))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_delta_codec_bit_equal_to_jax():
    """delta_encode / delta_decode and their statistics equal the
    reference's bits (invalid slots and -0.0 values included); the round
    trip restores each value within the reference test's atol=1e-2."""
    rng = np.random.default_rng(5)
    c = np.sort(rng.uniform(0, 10, 2000))
    a = 1000.0 + np.sin(c) * 3 + rng.normal(0, 0.5, 2000)
    a[:30] = -0.0
    # 62-63 rows a stratum, 80 slots: every stratum has invalid slots
    jsyn, _ = jbuild(c, a, k=32, sample_budget=32 * 80, method="eq")
    tsyn = carry(jsyn)
    assert not tsyn.sample_valid.all(dim=1).any()
    jenc, jstats = jencode(jsyn)
    tenc, tstats = delta_encode(tsyn)
    assert tstats == jstats
    np.testing.assert_array_equal(tenc.sample_a.numpy().view(np.int32),
                                  np.asarray(jenc.sample_a).view(np.int32))
    jdec, tdec = jdecode(jenc), delta_decode(tenc)
    np.testing.assert_array_equal(tdec.sample_a.numpy().view(np.int32),
                                  np.asarray(jdec.sample_a).view(np.int32))
    for f in SYN_FIELDS:
        if f != "sample_a":
            assert torch.equal(getattr(tdec, f), getattr(tsyn, f)), f
    valid = tsyn.sample_valid.numpy()
    np.testing.assert_allclose(tdec.sample_a.numpy()[valid],
                               tsyn.sample_a.numpy()[valid], atol=1e-2)


def _oracle_inputs(rng, S=300, Q=17, k=9, d=3, d_pad=8):
    c = rng.uniform(0, 1, (S, d)).astype(np.float32)
    a = rng.normal(0, 2, S).astype(np.float32)
    a[::7] = -0.0
    leaf = rng.integers(-1, k, S).astype(np.int32)
    w = rng.poisson(1.0, S).astype(np.float32) * (leaf >= 0)
    qlo = rng.uniform(0, 0.6, (Q, d)).astype(np.float32)
    qhi = (qlo + rng.uniform(0.1, 0.6, (Q, d))).astype(np.float32)

    def tr(x, fill):
        out = np.full((d_pad, x.shape[0]), fill, np.float32)
        out[:d] = x.T
        return out
    return dict(c=c, a=a, leaf=leaf, w=w, qlo=qlo, qhi=qhi, k=k, d=d,
                c_t=tr(c, 0.0), qlo_t=tr(qlo, 1.0), qhi_t=tr(qhi, -1.0))


def _close(t, j, exact_cols=()):
    t, j = t.numpy(), np.asarray(j)
    for col in exact_cols:
        np.testing.assert_array_equal(t[..., col].view(np.int32),
                                      j[..., col].view(np.int32))
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_ref_oracles_match_jax_and_plain_versions():
    """kernels/ref.py in the Pallas calling convention against the JAX
    package's ref.py (same inputs) and against the port's plain versions
    (the synopsis layouts)."""
    x = _oracle_inputs(np.random.default_rng(3))
    T = {key: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for key, v in x.items()}
    k, d = x["k"], x["d"]
    # segment reduce: counts and MIN/MAX (+-0.0 included) bit-equal
    seg = ref.segment_reduce_ref(T["a"], T["leaf"], k)
    _close(seg, jref.segment_reduce_ref(jnp.asarray(x["a"]),
                                        jnp.asarray(x["leaf"]), k),
           exact_cols=(2, 3, 4))
    _close(seg, segment_reduce_plain(T["a"], T["leaf"], k),
           exact_cols=(2, 3, 4))
    wseg = ref.weighted_segment_reduce_ref(T["a"], T["w"], T["leaf"], k)
    _close(wseg, jref.weighted_segment_reduce_ref(
        jnp.asarray(x["a"]), jnp.asarray(x["w"]), jnp.asarray(x["leaf"]), k))
    _close(wseg, weighted_segment_reduce_plain(T["a"], T["w"], T["leaf"], k))
    # moments, plain and weighted
    mom = ref.stratified_moments_ref(T["c_t"], T["a"], T["leaf"],
                                     T["qlo_t"], T["qhi_t"], k, d)
    _close(mom, jref.stratified_moments_ref(
        *(jnp.asarray(x[n]) for n in ("c_t", "a", "leaf", "qlo_t",
                                      "qhi_t")), k, d), exact_cols=(0,))
    _close(mom, ops.stratified_moments_flat(T["c"], T["a"], T["leaf"],
                                            T["qlo"], T["qhi"], k),
           exact_cols=(0,))
    wmom = ref.stratified_weighted_moments_ref(
        T["c_t"], T["a"], T["leaf"], T["w"], T["qlo_t"], T["qhi_t"], k, d)
    _close(wmom, jref.stratified_weighted_moments_ref(
        *(jnp.asarray(x[n]) for n in ("c_t", "a", "leaf", "w", "qlo_t",
                                      "qhi_t")), k, d))
    _close(wmom, ops.weighted_moments_flat(T["c"], T["a"], T["leaf"],
                                           T["w"], T["qlo"], T["qhi"], k))
    # query_eval: leaf boxes (one inverted = empty), 8 aggregate columns
    rng = np.random.default_rng(4)
    lo = rng.uniform(0, 0.8, (k, d)).astype(np.float32)
    hi = (lo + rng.uniform(0, 0.3, (k, d))).astype(np.float32)
    lo[2], hi[2] = 1.0, -1.0
    agg = rng.uniform(0, 5, (k, 8)).astype(np.float32)
    lo_t = np.full((8, k), 1.0, np.float32)
    hi_t = np.full((8, k), -1.0, np.float32)
    lo_t[:d], hi_t[:d] = lo.T, hi.T
    rel, exact = ref.query_eval_ref(torch.from_numpy(lo_t),
                                    torch.from_numpy(hi_t),
                                    torch.from_numpy(agg), T["qlo_t"],
                                    T["qhi_t"], d)
    jrel, jexact = jref.query_eval_ref(jnp.asarray(lo_t), jnp.asarray(hi_t),
                                       jnp.asarray(agg),
                                       jnp.asarray(x["qlo_t"]),
                                       jnp.asarray(x["qhi_t"]), d)
    np.testing.assert_array_equal(rel.numpy(), np.asarray(jrel))
    _close(exact, jexact)
    prel, pexact = query_eval_plain(torch.from_numpy(lo),
                                    torch.from_numpy(hi),
                                    torch.from_numpy(agg), T["qlo"],
                                    T["qhi"])
    assert torch.equal(rel, prel)
    _close(exact, pexact.numpy())
    assert 0 < (prel == 2).sum() and 0 < (prel == 1).sum()
    assert ref.NEG_BIG == jref.NEG_BIG and ref.POS_BIG == jref.POS_BIG


@pytest.mark.parametrize("backend", ["jnp", "ref"])
@pytest.mark.parametrize("S,k,d", [(1, 1, 1), (257, 5, 2), (1000, 33, 3)])
def test_flat_ops_match_jax(S, k, d, backend):
    """stratified_moments_flat / weighted_moments_flat on shuffled flat
    samples (pads, ids in any order, empty strata) against the reference's
    stratified_moments_op / weighted_moments_op."""
    rng = np.random.default_rng(S + k)
    c = rng.uniform(0, 1, (S, d)).astype(np.float32)
    a = rng.normal(1, 2, S).astype(np.float32)
    leaf = rng.integers(-1, max(k - 1, 1), S).astype(np.int32)
    w = (rng.poisson(1.0, S) * (leaf >= 0)).astype(np.float32)
    qlo = rng.uniform(0, 0.5, (19, d)).astype(np.float32)
    qhi = (qlo + rng.uniform(0, 0.7, (19, d))).astype(np.float32)
    t = [torch.from_numpy(v) for v in (c, a, leaf, qlo, qhi)]
    got = ops.stratified_moments_flat(*t, k)
    want = jops.stratified_moments_op(*(jnp.asarray(v) for v in
                                        (c, a, leaf, qlo, qhi)), k,
                                      backend=backend)
    _close(got, want, exact_cols=(0,))
    wgot = ops.weighted_moments_flat(t[0], t[1], t[2], torch.from_numpy(w),
                                     t[3], t[4], k)
    wwant = jops.weighted_moments_op(*(jnp.asarray(v) for v in
                                       (c, a, leaf, w, qlo, qhi)), k,
                                     backend=backend)
    _close(wgot, wwant)


def test_flat_slots_layout():
    """Stable layout: slot order is input order within each stratum; pads
    and out-of-range ids are dropped; s_max is the largest count."""
    leaf = torch.tensor([2, -1, 0, 2, 7, 2, 0], dtype=torch.int32)
    a = torch.arange(7, dtype=torch.float32)
    c = a[:, None] * 10
    sc, sa, valid, w = ops.flat_slots(c, a, leaf, 3, weights=a + 1)
    assert sa.shape == (3, 3) and sc.shape == (3, 3, 1)
    assert sa.tolist() == [[2, 6, 0], [0, 0, 0], [0, 3, 5]]
    assert valid.tolist() == [[True, True, False], [False] * 3, [True] * 3]
    assert w.tolist() == [[3, 7, 0], [0, 0, 0], [1, 4, 6]]
    assert torch.equal(sc[..., 0], sa * 10)


def test_token_loader_batches_match_jax():
    t, j = TokenLoader(1000, 32, 8, num_hosts=2, host_id=1, seed=7), \
        JLoader(1000, 32, 8, num_hosts=2, host_id=1, seed=7)
    for _ in range(4):
        tb, jb = t.next_batch(), j.next_batch()
        for key in ("tokens", "labels", "domains"):
            np.testing.assert_array_equal(tb[key], jb[key])
    snap = t.snapshot()
    nxt = t.next_batch()
    t.restore(snap)
    np.testing.assert_array_equal(t.next_batch()["tokens"], nxt["tokens"])
    for step in range(3):
        losses = np.arange(8, dtype=float) + step
        t.record_telemetry(step, losses)
        j.record_telemetry(step, losses)
    for x, y in zip(t.telemetry_table(), j.telemetry_table()):
        np.testing.assert_array_equal(x, y)


def test_loader_telemetry_to_pass_pipeline():
    """The data pipeline's telemetry table is queryable through the port's
    PASS (the reference's test_system.py case)."""
    loader = TokenLoader(1000, 64, 4)
    rng = np.random.default_rng(0)
    for step in range(50):
        loader.next_batch()
        loader.record_telemetry(step, rng.uniform(1, 5, loader.num_domains))
    c, a = loader.telemetry_table()
    syn, _ = build_synopsis(c, a, k=8, sample_rate=0.5, method="eq",
                            device="cpu")
    qs = random_queries(c, 50, seed=1, min_frac=0.2, max_frac=0.5,
                        device="cpu")
    gt = ground_truth(c, a, qs, kind="avg")
    res = PassEngine(syn, ServingConfig(kinds=("avg",)),
                     device="cpu").answer(qs)["avg"]
    keep = np.abs(gt) > 1e-9
    assert np.median(relative_error(res, gt)[keep]) < 0.05
