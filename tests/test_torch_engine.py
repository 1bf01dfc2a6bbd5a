"""The port's PassEngine against the JAX package's, on the CPU.

Both engines serve the very same synopsis (the JAX one, carried across
with ``synopsis_from_numpy``) and the very same query batch. Tolerances:

* estimate, lower, upper, frac_rows_touched: rtol=3e-5 with atol =
  3e-5 * max|estimate| of the batch — fp32 sums over strata taken in
  another order than XLA's, so the error scales with the batch's
  magnitude, not with each entry;
* ci_half, ci_lo, ci_hi: rtol=1e-4 with atol = 1e-4 * max|estimate| —
  the variance terms are differences of two fp32 sums (assemble.py,
  intervals.py), which lose relative precision that the estimate keeps.

A MIN/MAX query with no covered leaf and no relevant sample reads the
+-3.4e38 placeholder. Such entries must be equal in both packages, and
they are left out of the batch's scale, which they would make vacuous.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp
from jax.scipy.special import ndtri

from repro.api import (PassEngine as JEngine, ServingConfig as JServing,
                       CIConfig as JCI)
from repro.api import config as jconfig
from repro.core import query as jquery
from repro.core.synopsis import build_synopsis as jbuild
from repro_torch.api import (PassEngine, ServingConfig, CIConfig,
                             as_ci_config, merge_overrides)
from repro_torch.core import query as tquery
from repro_torch.core.synopsis import build_synopsis as tbuild
from repro_torch.core.types import QueryBatch, synopsis_from_numpy
from repro_torch.engine import executor
from repro_torch.uncertainty.intervals import normal_quantile

KINDS = ("sum", "count", "avg", "min", "max")
FIELDS = ("estimate", "lower", "upper", "frac_rows_touched")
CI_FIELDS = ("ci_half", "ci_lo", "ci_hi")
SYN_FIELDS = ("leaf_lo", "leaf_hi", "leaf_agg", "n_rows", "sample_c",
              "sample_a", "sample_valid", "k_per_leaf", "total_rows")
TREE_FIELDS = ("lo", "hi", "agg", "left", "right", "leaf_id", "level")


def _data(d, n, seed):
    rng = np.random.default_rng(seed)
    if d == 1:
        c = np.sort(rng.uniform(0, 100, n))
        a = rng.lognormal(0, 1, n) * (1 + np.sin(c / 5))
    else:
        c = rng.uniform(0, 100, (n, d))
        a = rng.lognormal(0, 1, n) * (1 + np.sin(c[:, 0] / 5))
    return c, a


def carry(jsyn):
    """The JAX synopsis as a port synopsis on the CPU."""
    fields = {f: np.asarray(getattr(jsyn, f)) for f in SYN_FIELDS}
    fields.update({f"tree.{f}": np.asarray(getattr(jsyn.tree, f))
                   for f in TREE_FIELDS})
    return synopsis_from_numpy(fields, num_leaves=jsyn.num_leaves,
                               d=jsyn.d, device="cpu")


def carry_queries(jq):
    return QueryBatch(torch.tensor(np.asarray(jq.lo)),
                      torch.tensor(np.asarray(jq.hi)))


@pytest.fixture(scope="module")
def served():
    """{d: (jax synopsis, port synopsis, jax queries, port queries)}."""
    out = {}
    for d, method, k in ((1, "adp", 32), (3, "kd", 24)):
        c, a = _data(d, 16000, seed=d)
        jsyn, _ = jbuild(c, a, k=k, sample_rate=0.02, method=method,
                         seed=0, opt_samples=2048)
        jq = jquery.random_queries(c, 48, seed=1, min_frac=0.01,
                                   max_frac=0.5 if d == 1 else 0.8)
        out[d] = (jsyn, carry(jsyn), jq, carry_queries(jq))
    return out


# Magnitudes at or above this are the MIN/MAX placeholder or +-inf.
PLACEHOLDER = 1e30


def batch_scale(estimate) -> float:
    """max|estimate| over the entries that are real values; asserts that
    there is at least one, so no comparison scaled by it is vacuous."""
    est = np.abs(np.asarray(estimate, np.float64))
    real = est[est < PLACEHOLDER]
    assert real.size, "every estimate of the batch is a placeholder"
    return float(real.max())


def assert_results_close(jres, tres, kinds):
    assert set(jres) == set(tres) == set(kinds)
    for kind in kinds:
        j, t = jres[kind], tres[kind]
        scale = batch_scale(j.estimate)
        for field, rtol, atol in (
                [(f, 3e-5, 3e-5 * scale) for f in FIELDS]
                + [(f, 1e-4, 1e-4 * scale) for f in CI_FIELDS]):
            jv, tv = getattr(j, field), getattr(t, field)
            if jv is None:
                assert tv is None, (kind, field)
                continue
            assert tv.dtype == torch.float32, (kind, field)
            jv = np.asarray(jv, np.float64)
            tv = tv.numpy().astype(np.float64)
            held = np.abs(jv) >= PLACEHOLDER
            np.testing.assert_array_equal(tv[held], jv[held],
                                          err_msg=f"{kind}.{field}")
            np.testing.assert_allclose(tv[~held], jv[~held], rtol=rtol,
                                       atol=atol, err_msg=f"{kind}.{field}")


CASES = {
    "plain": (dict(), None),
    "avg_stratum": (dict(avg_mode="stratum"), None),
    "no_aggregates": (dict(use_aggregates=False), None),
    "slots": (dict(sample_slots=5), None),
    "no_fpc_lam": (dict(use_fpc=False, lam=1.5), None),
    "ci_stratum": (dict(), dict(level=0.95)),
    "ci_union": (dict(), dict(level=0.95, delta_budget="union")),
    "ci_no_aggregates": (dict(use_aggregates=False), dict(level=0.9)),
    "ci_slots": (dict(sample_slots=5), dict(level=0.95,
                                            small_n_threshold=4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax_1d(served, case):
    serving_kw, ci_kw = CASES[case]
    jsyn, tsyn, jq, tq = served[1]
    jres = JEngine(jsyn, JServing(kinds=KINDS, **serving_kw),
                   ci=None if ci_kw is None else JCI(**ci_kw)).answer(jq)
    tres = PassEngine(tsyn, ServingConfig(kinds=KINDS, **serving_kw),
                      ci=None if ci_kw is None else CIConfig(**ci_kw),
                      device="cpu").answer(tq)
    assert_results_close(jres, tres, KINDS)


@pytest.mark.parametrize("ci", [None, 0.95])
def test_engine_matches_jax_3d_kd(served, ci):
    jsyn, tsyn, jq, tq = served[3]
    jres = JEngine(jsyn, JServing(kinds=KINDS), ci=ci).answer(jq)
    tres = PassEngine(tsyn, ServingConfig(kinds=KINDS), ci=ci,
                      device="cpu").answer(tq)
    assert_results_close(jres, tres, KINDS)


@pytest.mark.parametrize("d,slots", [(1, None), (1, 5), (3, None)])
def test_min_max_comparison_is_not_vacuous(served, d, slots):
    """The MIN/MAX parity above holds real values: in each fixture most
    queries have a real extreme, and the scale is a data magnitude, far
    below the placeholder."""
    jsyn, _, jq, _ = served[d]
    jres = JEngine(jsyn, JServing(kinds=("min", "max"),
                                  sample_slots=slots)).answer(jq)
    for kind in ("min", "max"):
        est = np.abs(np.asarray(jres[kind].estimate, np.float64))
        assert np.mean(est < PLACEHOLDER) >= 0.5, kind
        assert batch_scale(est) < 1e6, kind


def test_slice_end_to_end_from_raw_rows():
    """Raw rows -> build -> random_queries -> answer(ci=0.95) in each
    package independently: the builds are bit-equal and the answers agree
    within the stated tolerances."""
    c, a = _data(1, 12000, seed=5)
    kw = dict(k=16, sample_rate=0.05, method="adp", seed=3)
    jsyn, _ = jbuild(c, a, **kw)
    tsyn, _ = tbuild(c, a, device="cpu", **kw)
    jq = jquery.random_queries(c, 40, seed=6)
    tq = tquery.random_queries(c, 40, seed=6, device="cpu")
    kinds = ("sum", "count", "avg")
    jres = JEngine(jsyn, JServing(kinds=kinds), ci=0.95).answer(jq)
    tres = PassEngine(tsyn, ServingConfig(kinds=kinds), ci=0.95,
                      device="cpu").answer(tq)
    assert_results_close(jres, tres, kinds)
    truth = jquery.ground_truth(c, a, jq, "sum")
    err = tquery.relative_error(tres["sum"], truth)
    np.testing.assert_allclose(err, jquery.relative_error(jres["sum"], truth),
                               rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(tquery.ci_ratio(tres["sum"], truth),
                               jquery.ci_ratio(jres["sum"], truth),
                               rtol=1e-4, atol=1e-7)
    assert np.median(err) < 0.1
    lo = tres["sum"].ci_lo.numpy().astype(np.float64)
    hi = tres["sum"].ci_hi.numpy().astype(np.float64)
    assert np.mean((lo <= truth * (1 + 1e-5)) & (truth <= hi * (1 + 1e-5))) \
        >= 0.8


def test_plan_cache_counters_match_jax(served):
    jsyn, tsyn, jq, tq = served[1]
    jeng = JEngine(jsyn, JServing(kinds=("sum",)), plan_cache_size=2)
    teng = PassEngine(tsyn, ServingConfig(kinds=("sum",)),
                      plan_cache_size=2, device="cpu")

    def sub(qb, n, jax_side):
        if jax_side:
            return type(qb)(qb.lo[:n], qb.hi[:n])
        return QueryBatch(qb.lo[:n], qb.hi[:n])

    keys = ("hits", "misses", "evictions", "invalidations", "entries",
            "epoch", "aot_compiles")
    for eng, qb, jax_side, syn in ((jeng, jq, True, jsyn),
                                   (teng, tq, False, tsyn)):
        eng.answer(qb)                              # miss
        eng.answer(qb)                              # hit
        eng.answer(sub(qb, 16, jax_side))           # miss
        eng.answer(sub(qb, 8, jax_side))            # miss + eviction
        eng.answer(qb, kinds=("count",))            # miss + eviction
        handle = eng.prepare(sub(qb, 8, jax_side))  # hit
        handle(sub(qb, 8, jax_side))
        handle(sub(qb, 4, jax_side))                # shape change: miss
        eng.replace_source(syn)                     # invalidation
        eng.answer(qb)                              # miss
    jstats, tstats = jeng.stats(), teng.stats()
    assert {k: tstats[k] for k in keys if k != "aot_compiles"} == \
        {k: jstats[k] for k in keys if k != "aot_compiles"}
    assert tstats["aot_compiles"] == 0
    assert tstats["misses"] == 6 and tstats["hits"] == 2


def test_prepared_handle_and_op_counts(served):
    jsyn, tsyn, jq, tq = served[1]
    eng = PassEngine(tsyn, ServingConfig(kinds=("sum", "count", "avg")),
                     ci=0.95, device="cpu")
    handle = eng.prepare(tq)
    executor.reset_op_counts()
    a = handle(tq)
    assert executor.OP_COUNTS == {"classify": 1, "moments": 1,
                                  "extremes": 0}
    b = eng.answer(tq)
    for kind in a:
        assert torch.equal(a[kind].estimate, b[kind].estimate)
        est, lo, hi = a[kind].interval()
        assert torch.equal(lo, a[kind].ci_lo) and torch.equal(hi,
                                                              a[kind].ci_hi)
    executor.reset_op_counts()
    eng.answer(tq, kinds=("min", "max"))
    assert executor.OP_COUNTS == {"classify": 1, "moments": 0,
                                  "extremes": 1}
    assert eng.stats()["hits"] == 1


def test_normal_quantile_within_four_ulp_of_jax():
    """Both packages evaluate float32 ndtri on the same float32 argument,
    each with its own float32 rational approximation; on these levels
    torch's is at most 4 ulp from JAX's (the measured maximum is 4)."""
    levels = np.linspace(0.01, 0.99, 99)
    want = np.asarray(jax.jit(lambda x: ndtri(0.5 + x / 2.0))(
        jnp.asarray(levels, jnp.float32)))
    got = np.array([normal_quantile(float(x)) for x in levels], np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.astype(np.float32).view(np.int32))
    assert ulps.max() <= 4, ulps.max()
    for bad in (0.0, 1.0, 1.5):
        with pytest.raises(ValueError, match="confidence level"):
            normal_quantile(bad)


@pytest.mark.parametrize("call,error", [
    (lambda e, q: e.answer(q, plan=object()), (TypeError, "QueryPlan")),
    (lambda e, q: e.answer(q, deadline_ms=5.0, plan=object()),
     (ValueError, "cannot be combined with plan")),
    (lambda e, q: e.answer(q, ci=CIConfig(method="bootstrap",
                                          boot_normalize="x")),
     (ValueError, "unknown normalize")),
    (lambda e, q: e.answer_progressive(
        q, serving=ServingConfig(sample_slots=4)),
     (ValueError, "sample_slots is managed by the ladder")),
    (lambda e, q: e.answer_join(q), (TypeError, "JoinSynopsis source")),
    (lambda e, q: PassEngine(q, device="cpu").checkpoint("x.npz"),
     (TypeError, "cannot checkpoint source")),
    (lambda e, q: PassEngine.restore("x.npz", mesh=object()),
     (TypeError, "mesh must be a ShardMesh")),
    (lambda e, q: PassEngine.from_sharded(np.zeros(64), np.ones(64), k=4,
                                          method="zebra", device="cpu"),
     (ValueError, "unknown skeleton method")),
    (lambda e, q: PassEngine.from_catalog([]),
     (ValueError, "at least one partition")),
    (lambda e, q: executor.compute_artifacts(e.resolve(), q, ("sum",),
                                             plan_masks=(1, 2, 3)),
     (ValueError, "plan masks")),
], ids=["plan", "deadline", "bootstrap", "progressive",
        "join", "checkpoint", "restore", "sharded", "catalog",
        "plan_masks"])
def test_unported_entry_points_raise(served, call, error):
    """Entry points once refused as not yet ported reject malformed input:
    ``plan=``, the bootstrap, the executor's ``plan_masks``, the ladder's
    ``deadline_ms`` and ``answer_progressive``, ``checkpoint``,
    ``answer_join`` on a source without a join synopsis, ``restore`` with
    a mesh that is not a ``ShardMesh``, ``from_sharded`` with an unknown
    skeleton method and ``from_catalog`` without partitions."""
    _, tsyn, _, tq = served[1]
    eng = PassEngine(tsyn, device="cpu")
    with pytest.raises(error[0], match=error[1]):
        call(eng, tq)


def test_config_validation():
    with pytest.raises(ValueError, match="backend must be None"):
        ServingConfig(backend="jnp").validate()
    with pytest.raises(ValueError, match="unknown kind"):
        ServingConfig(kinds=("median",)).validate()
    assert CIConfig(method="bootstrap").validate().method == "bootstrap"
    with pytest.raises(ValueError, match="avg_mode='ratio'"):
        PassEngine(None, ServingConfig(kinds=("avg",), avg_mode="stratum"),
                   ci=0.95, device="cpu")
    key = CIConfig(key=torch.tensor([3, 4], dtype=torch.int32)).cache_key()
    assert key == JCI(key=jnp.asarray([3, 4], jnp.int32)).cache_key()
    assert key[5] == jconfig._key_token(jnp.asarray([3, 4], jnp.int32))
    assert key[:4] == JCI().cache_key()[:4]
    assert hash(ServingConfig(kinds="sum").cache_key()) == \
        hash(JServing(kinds="sum").cache_key())
    merged = merge_overrides(ServingConfig(), lam=1.0, avg_mode=None)
    assert merged == ServingConfig(lam=1.0)
    assert as_ci_config(0.9) == CIConfig(level=0.9)
    assert as_ci_config(None) is None
