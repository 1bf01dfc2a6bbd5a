"""The port's paper baselines (US, ST, AQP++, KD-US) against the JAX
package's, on the CPU.

Same numpy rows (``nyc_taxi(scale=0.02)``, the reference's own
``test_system.py`` data) go to both packages. Tolerances:

* builds: exact. US / ST are ``build_synopsis`` (host numpy in both), so
  every synopsis array is equal; AQP++'s boxes, aggregates, global sample
  and its partition ids are equal, which pins the hill-climbed cuts and
  the row assignment (and the kd boxes of KD-US);
* US / ST answers (``PassEngine``, ``use_aggregates=False``): estimate,
  lower, upper, frac_rows_touched at rtol=3e-5, atol=1e-3 (fp32 sums over
  strata and slots in another order); ci_half at
  ``test_torch_engine.py``'s 1e-4 scale (a difference of two fp32 sums);
* ``AQPPP.estimate``: rtol=1e-6 (both float64, the sums over partitions
  and samples in another order, then one float32 rounding);
* AQP++'s hard bounds on zero-valued partitions (values +0.0 / -0.0 and
  integers, so every float64 sum is exact): bit-equal; the port's
  ``minmax.maximum_np`` / ``minimum_np`` bit-equal to ``np.maximum`` /
  ``np.minimum`` on signed zeros and NaN.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import PassEngine as JEngine, ServingConfig as JServing
from repro.core import baselines as jbase
from repro.core import query as jquery
from repro_torch.api import PassEngine, ServingConfig
from repro_torch.core import baselines as tbase
from repro_torch.core import query as tquery
from repro_torch.core.synopsis import build_synopsis as tbuild
from repro_torch.core.types import aqppp_from_numpy
from repro_torch.data import synthetic as tdata
from test_torch_engine import (SYN_FIELDS, TREE_FIELDS, batch_scale,
                               carry_queries)

KINDS3 = ("sum", "count", "avg")
AQ_FIELDS = ("bound_lo", "bound_hi", "agg", "sample_c", "sample_a",
             "sample_leaf")


@pytest.fixture(scope="module")
def taxi():
    return tdata.nyc_taxi(scale=0.02)


@pytest.fixture(scope="module")
def taxi3():
    return tdata.nyc_taxi(scale=0.02, dims=3)


def _budget(a):
    return int(0.005 * len(a))


def assert_synopsis_equal(tsyn, jsyn):
    for f in SYN_FIELDS:
        np.testing.assert_array_equal(getattr(tsyn, f).numpy(),
                                      np.asarray(getattr(jsyn, f)),
                                      err_msg=f)
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(tsyn.tree, f).numpy(),
                                      np.asarray(getattr(jsyn.tree, f)),
                                      err_msg=f"tree.{f}")


def assert_answers_close(jres, tres, kinds):
    for kind in kinds:
        j, t = jres[kind], tres[kind]
        scale = batch_scale(j.estimate)
        for field in ("estimate", "lower", "upper", "frac_rows_touched"):
            np.testing.assert_allclose(
                getattr(t, field).numpy().astype(np.float64),
                np.asarray(getattr(j, field), np.float64), rtol=3e-5,
                atol=1e-3, err_msg=f"{kind}.{field}")
        np.testing.assert_allclose(
            t.ci_half.numpy().astype(np.float64),
            np.asarray(j.ci_half, np.float64), rtol=1e-4,
            atol=1e-4 * scale, err_msg=f"{kind}.ci_half")


@pytest.mark.parametrize("which", ["US", "ST"])
def test_sampling_baselines_match_jax(taxi, which):
    """US (k = 1) and ST (k = 64, eq) builds equal the reference's array
    for array, and their answers with use_aggregates=False (all five
    kinds) meet the reference engine's."""
    c, a = taxi
    K = _budget(a)
    if which == "US":
        jsyn, _ = jbase.uniform_synopsis(c, a, K)
        tsyn, _ = tbase.uniform_synopsis(c, a, K, device="cpu")
    else:
        jsyn, _ = jbase.stratified_synopsis(c, a, 64, K)
        tsyn, _ = tbase.stratified_synopsis(c, a, 64, K, device="cpu")
    assert_synopsis_equal(tsyn, jsyn)
    jq = jquery.random_queries(c, 64, seed=11)
    kinds = ("sum", "count", "avg", "min", "max")
    jres = JEngine(jsyn, JServing(kinds=kinds, use_aggregates=False)
                   ).answer(jq)
    tres = PassEngine(tsyn, ServingConfig(kinds=kinds, use_aggregates=False),
                      device="cpu").answer(carry_queries(jq))
    assert_answers_close(jres, {k: v for k, v in tres.items()
                                if k in KINDS3}, KINDS3)
    for kind in ("min", "max"):
        np.testing.assert_array_equal(tres[kind].estimate.numpy(),
                                      np.asarray(jres[kind].estimate))


def _aqppp_pair(c, a, k, K, method):
    jap = jbase.aqppp_synopsis(c, a, k, K, method=method)
    tap = tbase.aqppp_synopsis(c, a, k, K, method=method, device="cpu")
    for f in AQ_FIELDS:
        np.testing.assert_array_equal(getattr(tap, f).numpy(),
                                      np.asarray(getattr(jap, f)), err_msg=f)
    assert tap.n == jap.n
    return jap, tap


def assert_estimates_close(jres, tres, rtol=1e-6):
    for field in ("estimate", "ci_half", "lower", "upper",
                  "frac_rows_touched"):
        t = getattr(tres, field)
        assert t.dtype == torch.float32, field
        np.testing.assert_allclose(t.numpy(), np.asarray(getattr(jres, field)),
                                   rtol=rtol, atol=0, err_msg=field)


@pytest.mark.parametrize("dims,method", [(1, "hill"), (3, "kd")])
def test_aqppp_matches_jax(taxi, taxi3, dims, method):
    """AQP++ (1-D hill climbing) and KD-US (3-D kd boxes): the structure
    equals the reference's field for field, and estimate (SUM, COUNT, AVG)
    meets it within rtol=1e-6."""
    c, a = taxi if dims == 1 else taxi3
    jap, tap = _aqppp_pair(c, a, 64, _budget(a), method)
    jq = jquery.random_queries(c, 64, seed=9)
    tq = carry_queries(jq)
    for kind in KINDS3:
        assert_estimates_close(jap.estimate(jq, kind), tap.estimate(tq, kind))


def test_aqppp_estimate_chunks_agree(taxi, monkeypatch):
    """Chunking the queries (a small plane budget) changes no bit."""
    c, a = taxi
    _, tap = _aqppp_pair(c, a, 16, 400, "hill")
    tq = tquery.random_queries(c, 37, seed=2, device="cpu")
    whole = tap.estimate(tq, "sum")
    monkeypatch.setattr(tbase, "PLANE_ELEMS", 400 * 5)
    parts = tap.estimate(tq, "sum")
    for f in ("estimate", "ci_half", "lower", "upper", "frac_rows_touched"):
        assert torch.equal(getattr(whole, f), getattr(parts, f)), f


def _zero_partition_rows(seed=4):
    """Zero values (+0.0, and a run of -0.0) with two runs of small
    integers, so that whole partitions hold only zeros and every float64
    sum is exact."""
    rng = np.random.default_rng(seed)
    n = 6000
    c = np.sort(rng.uniform(0, 100, n))
    a = np.zeros(n)
    a[(c > 55) & (c < 75)] = -0.0
    run = (c > 10) & (c < 18)
    a[run] = rng.integers(-5, 9, run.sum())
    run = (c > 85) & (c < 90)
    a[run] = rng.integers(-3, 0, run.sum())
    return c, a


@pytest.mark.parametrize("method", ["hill", "kd"])
@pytest.mark.parametrize("kind", ["sum", "count", "avg"])
def test_aqppp_bounds_on_zero_partitions_bit_equal(method, kind):
    """Hard bounds over zero-valued partitions (their MIN / MAX +0.0 or, in
    the kd boxes, -0.0) equal the reference's bit for bit. The per-partition
    bounds follow numpy's signed-zero rule (held by the next test); every
    bound adds +0.0 terms of the other partitions, so the answers' zeros
    are +0.0 in both packages."""
    c, a = _zero_partition_rows()
    jap = jbase.aqppp_synopsis(c, a, 16, 300, seed=1, method=method)
    agg = np.asarray(jap.agg)
    zero = (agg[:, 3] == 0) & (agg[:, 4] == 0)
    assert zero.sum() >= 3
    if method == "kd":
        assert np.signbit(agg[zero, 3]).sum() >= 2
    tap = aqppp_from_numpy(dataclasses.asdict(jap), device="cpu")
    rng = np.random.default_rng(0)
    lo = rng.uniform(0, 100, 96)
    hi = lo + rng.uniform(0, 40, 96)
    jq = jquery.QueryBatch(lo[:, None].astype(np.float32),
                           hi[:, None].astype(np.float32))
    tq = carry_queries(jq)
    jres, tres = jap.estimate(jq, kind), tap.estimate(tq, kind)
    for field in ("lower", "upper"):
        np.testing.assert_array_equal(
            getattr(tres, field).numpy().view(np.int32),
            np.asarray(getattr(jres, field)).view(np.int32), err_msg=field)
    assert_estimates_close(jres, tres)


def test_numpy_rule_minmax_on_signed_zeros():
    """maximum_np / minimum_np give np.maximum / np.minimum's bits on every
    pairing of +-0.0, +-1 and NaN, in float64 and float32."""
    from repro_torch import minmax
    vals = np.array([0.0, -0.0, 1.0, -1.0, np.nan])
    x, y = np.meshgrid(vals, vals)
    for dt, it in ((np.float64, np.int64), (np.float32, np.int32)):
        xa, ya = x.astype(dt).ravel(), y.astype(dt).ravel()
        for tfn, nfn in ((minmax.maximum_np, np.maximum),
                         (minmax.minimum_np, np.minimum)):
            got = tfn(torch.from_numpy(xa), torch.from_numpy(ya)).numpy()
            want = nfn(xa, ya)
            nan = np.isnan(want)
            assert np.isnan(got[nan]).all()
            np.testing.assert_array_equal(got[~nan].view(it),
                                          want[~nan].view(it))


def _median_sum_err(res, gt, keep):
    return float(np.median(tquery.relative_error(res, gt)[keep]))


def test_pass_beats_baselines_at_equal_budget(taxi):
    """Paper Table 1 ordering on the port: PASS clearly beats the pure
    sampling baselines at the same stored-sample budget (the reference's
    test_system.py case, served by the port on the CPU)."""
    c, a = taxi
    K = _budget(a)
    B = 64
    qs = tquery.random_queries(c, 300, seed=7, device="cpu")
    gt = tquery.ground_truth(c, a, qs, kind="sum")
    keep = np.abs(gt) > 1e-9

    def med(syn, **kw):
        res = PassEngine(syn, ServingConfig(kinds=("sum",), **kw),
                         device="cpu").answer(qs)["sum"]
        return _median_sum_err(res, gt, keep)

    us, _ = tbase.uniform_synopsis(c, a, K, device="cpu")
    st, _ = tbase.stratified_synopsis(c, a, B, K, device="cpu")
    ps, _ = tbuild(c, a, k=B, sample_budget=K, method="adp", kind="sum",
                   device="cpu")
    e_us = med(us, use_aggregates=False)
    e_st = med(st, use_aggregates=False)
    e_ps = med(ps)
    assert e_ps < e_us
    assert e_ps < 1.5 * e_st
    assert e_st < e_us


def test_aqppp_baseline_reasonable(taxi):
    c, a = taxi
    ap = tbase.aqppp_synopsis(c, a, 64, _budget(a), device="cpu")
    qs = tquery.random_queries(c, 200, seed=9, device="cpu")
    gt = tquery.ground_truth(c, a, qs, kind="sum")
    keep = np.abs(gt) > 1e-9
    assert _median_sum_err(ap.estimate(qs, kind="sum"), gt, keep) < 0.1


def test_baselines_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = np.linspace(0, 1, 300)
    a = np.ones(300)
    for call in (lambda: tbase.uniform_synopsis(c, a, 30),
                 lambda: tbase.stratified_synopsis(c, a, 4, 30),
                 lambda: tbase.aqppp_synopsis(c, a, 4, 30)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
