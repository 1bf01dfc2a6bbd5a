"""Parity of the PyTorch port's host build with the JAX package.

Same numpy inputs and seeds into both packages; every synopsis array, the
tree's included, must be bit-equal with the same dtype, for the three
partitioning methods. The host helpers (oracles, DP, sampling, k-d tree,
generators, workloads, ground truth) are held to exact equality too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dp as jdp, kdtree as jkd, partition_tree as jpt
from repro.core import prefix as jpx, sampling as jsamp
from repro.core import query as jquery
from repro.core import synopsis as jsyn
from repro.data import synthetic as jdata
from repro_torch.core import dp as tdp, kdtree as tkd, partition_tree as tpt
from repro_torch.core import prefix as tpx, sampling as tsamp
from repro_torch.core import query as tquery
from repro_torch.core import synopsis as tsyn
from repro_torch.data import synthetic as tdata

SYN_FIELDS = ("leaf_lo", "leaf_hi", "leaf_agg", "n_rows", "sample_c",
              "sample_a", "sample_valid", "k_per_leaf", "total_rows")
TREE_FIELDS = ("lo", "hi", "agg", "left", "right", "leaf_id", "level")


def _data(d, n=12000, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 100, (n, d)) if d > 1 else np.sort(
        rng.uniform(0, 100, n))
    a = rng.lognormal(0, 1, n) * (1 + np.sin(np.atleast_2d(c.T)[0] / 5))
    return c, a


def _assert_same(x, y, what):
    x = np.asarray(x)
    y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    assert x.dtype == y.dtype, (what, x.dtype, y.dtype)
    assert x.shape == y.shape, (what, x.shape, y.shape)
    assert np.array_equal(x, y), what


@pytest.mark.parametrize("method,d,allocation", [
    ("adp", 1, "equal"), ("eq", 1, "equal"), ("kd", 3, "equal"),
    ("eq", 1, "proportional")])
def test_build_synopsis_bit_equal(method, d, allocation):
    c, a = _data(d)
    kw = dict(k=48, sample_rate=0.02, method=method, seed=4,
              opt_samples=2048, allocation=allocation)
    js, jrep = jsyn.build_synopsis(c, a, **kw)
    ts, trep = tsyn.build_synopsis(c, a, device="cpu", **kw)
    for f in SYN_FIELDS:
        _assert_same(getattr(js, f), getattr(ts, f), f)
    for f in TREE_FIELDS:
        _assert_same(getattr(js.tree, f), getattr(ts.tree, f), f"tree.{f}")
    assert (js.num_leaves, js.d) == (ts.num_leaves, ts.d)
    assert (jrep.k, jrep.total_samples, jrep.max_variance) == \
        (trep.k, trep.total_samples, trep.max_variance)
    assert js.storage_floats() == ts.storage_floats()


@pytest.mark.parametrize("kind", ["sum", "count", "avg"])
def test_partition_assign_and_dp_equal(kind):
    c, a = _data(1, n=5000, seed=1)
    j = jsyn.partition_assign(c, a, k=16, kind=kind, opt_samples=1024)
    t = tsyn.partition_assign(c, a, k=16, kind=kind, opt_samples=1024)
    _assert_same(j[0], t[0], "assign")
    assert j[1:] == t[1:]
    vals = np.sort(a[:400])
    jc, jv = jdp.dp_monotone(vals, 9, kind=kind, delta_frac=0.05)
    tc, tv = tdp.dp_monotone(vals, 9, kind=kind, delta_frac=0.05)
    _assert_same(jc, tc, "cuts")
    assert jv == tv
    _assert_same(jdp.cuts_to_thresholds(vals, jc),
                 tdp.cuts_to_thresholds(vals, tc), "thresholds")
    _assert_same(jdp.equal_depth_boundaries(401, 7),
                 tdp.equal_depth_boundaries(401, 7), "eq cuts")


def test_prefix_oracles_equal():
    rng = np.random.default_rng(2)
    v = rng.normal(1, 2, 300)
    js1, js2 = jpx.prefix_moments(v)
    ts1, ts2 = tpx.prefix_moments(v)
    _assert_same(js1, ts1, "s1")
    _assert_same(js2, ts2, "s2")
    g = rng.integers(0, 150, 40)
    w = g + rng.integers(1, 150, 40)
    _assert_same(jpx.oracle_sum_split(js1, js2, g, w, 3.0),
                 tpx.oracle_sum_split(ts1, ts2, g, w, 3.0), "sum split")
    scores = jpx.window_sqsum(js2, 6)
    _assert_same(scores, tpx.window_sqsum(ts2, 6), "window")
    jt, tt = jpx.SparseTableArgmax(scores), tpx.SparseTableArgmax(scores)
    _assert_same(jpx.oracle_avg_window(js1, js2, jt, 6, g, w),
                 tpx.oracle_avg_window(ts1, ts2, tt, 6, g, w), "avg window")
    for kind in ("sum", "avg"):
        assert jpx.oracle_exact(js1, js2, 10, 60, kind) == \
            tpx.oracle_exact(ts1, ts2, 10, 60, kind)


@pytest.mark.parametrize("kind", ["sum", "count", "avg"])
def test_kd_partition_equal(kind):
    c, a = _data(3, n=4000, seed=3)
    ja, jb = jkd.kd_partition(c, a, k=24, m=1024, kind=kind, seed=5)
    ta, tb = tkd.kd_partition(c, a, k=24, m=1024, kind=kind, seed=5)
    _assert_same(ja, ta, "assign")
    _assert_same(jb, tb, "boxes")


def test_tree_and_mcf_reference_equal():
    c, a = _data(1, n=3000, seed=6)
    assign = np.minimum((c / 100 * 13).astype(np.int64), 12)
    assign[assign == 5] = 6                       # one empty leaf
    jagg, jlo, jhi = jpt.leaf_stats(c, a, assign, 13)
    tagg, tlo, thi = tpt.leaf_stats(c, a, assign, 13)
    for x, y, what in ((jagg, tagg, "agg"), (jlo, tlo, "lo"),
                       (jhi, thi, "hi")):
        _assert_same(x, y, what)
    jt = jpt.build_tree_from_leaves(jagg, jlo, jhi)
    tt = tpt.build_tree_from_leaves(tagg, tlo, thi)
    for f in TREE_FIELDS:
        _assert_same(getattr(jt, f), getattr(tt, f), f)
    rng = np.random.default_rng(7)
    for _ in range(20):
        lo = rng.uniform(0, 90, 1)
        hi = lo + rng.uniform(0, 40, 1)
        for zv in (False, True):
            assert jpt.mcf_reference(jt, lo, hi, zv) == \
                tpt.mcf_reference(tt, lo, hi, zv)


def test_sampling_equal():
    c, a = _data(1, n=3000, seed=8)
    assign = np.minimum((c / 100 * 10).astype(np.int64), 9)
    alloc_j = jsamp.proportional_allocation(np.bincount(assign), 200)
    alloc_t = tsamp.proportional_allocation(np.bincount(assign), 200)
    _assert_same(alloc_j, alloc_t, "alloc")
    for per_leaf in (17, alloc_j):
        for x, y in zip(jsamp.stratified_sample(c, a, assign, 10, per_leaf,
                                                seed=9),
                        tsamp.stratified_sample(c, a, assign, 10, per_leaf,
                                                seed=9)):
            _assert_same(x, y, "stratified")
    for x, y in zip(jsamp.uniform_sample(c, a, 100, seed=3),
                    tsamp.uniform_sample(c, a, 100, seed=3)):
        _assert_same(x, y, "uniform")


@pytest.mark.parametrize("name,kw", [
    ("intel", dict(scale=0.002)), ("instacart", dict(scale=0.005)),
    ("nyc_taxi", dict(scale=0.001)), ("nyc_taxi", dict(scale=0.001, dims=5)),
    ("adversarial", dict(n=5000))])
def test_generators_identical(name, kw):
    for x, y in zip(jdata.DATASETS[name](**kw), tdata.DATASETS[name](**kw)):
        _assert_same(x, y, name)


def test_workloads_and_truth_equal():
    c, a = _data(1, n=6000, seed=10)
    jq = jquery.random_queries(c, 37, seed=11)
    tq = tquery.random_queries(c, 37, seed=11, device="cpu")
    _assert_same(jq.lo, tq.lo, "lo")
    _assert_same(jq.hi, tq.hi, "hi")
    jc = jquery.challenging_queries(c, a, 21, seed=12)
    tc = tquery.challenging_queries(c, a, 21, seed=12, device="cpu")
    _assert_same(jc.lo, tc.lo, "challenging lo")
    _assert_same(jc.hi, tc.hi, "challenging hi")
    for kind in ("sum", "count", "avg", "min", "max"):
        _assert_same(jquery.ground_truth(c, a, jq, kind, chunk=1000),
                     tquery.ground_truth(c, a, tq, kind, chunk=1000), kind)
    c3, _ = _data(3, n=2000, seed=13)
    jq3 = jquery.random_queries(c3, 9, seed=14)
    tq3 = tquery.random_queries(c3, 9, seed=14, device="cpu")
    _assert_same(jq3.lo, tq3.lo, "lo3")
    _assert_same(jq3.hi, tq3.hi, "hi3")
