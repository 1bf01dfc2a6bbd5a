"""The port's serve layer against the JAX package's, on the CPU: the
degradation ladder (``repro_torch.serve.refine``) and the request
coalescer (``repro_torch.serve.coalescer`` / ``driver``).

* tier 0 is host numpy in both packages, so it is compared bit for bit
  (int32 views; numpy's equality takes -0.0 == +0.0);
* each sample tier's answer against the JAX package's tier: estimate,
  lower and upper at rtol=3e-5, atol=1e-3, the interval fields at
  ``tests/test_torch_engine.py``'s interval tolerance (rtol=1e-4, atol
  1e-4 times the batch's magnitude);
* the coalescer's demux against per-tenant ``answer`` calls of the port:
  bit for bit, every kind and field.

No assertion depends on wall-clock timing and every wait has a timeout.
"""
import concurrent.futures as cf
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import PassEngine as JEngine, ServingConfig as JServing
from repro.core import query as jquery
from repro.core.synopsis import build_synopsis as jbuild
from repro.serve import refine as jrefine
from repro_torch.api import (PassEngine, ServingConfig, CIConfig,
                             CoalescerConfig)
from repro_torch.core.query import random_queries
from repro_torch.core.types import QueryBatch, QueryResult
from repro_torch.engine.executor import MIN_ROWS
from repro_torch.serve import (RequestCoalescer, TickDriver, Overloaded,
                               RefinementHandle, ladder_tiers, tier0_answer,
                               PAD_LO, PAD_HI)
from repro_torch.serve.refine import merge_refinement
from repro_torch.streaming import StreamingIngestor
from test_torch_engine import batch_scale, carry, carry_queries, PLACEHOLDER

KINDS = ("sum", "count", "avg", "min", "max")
FIELDS = ("estimate", "ci_half", "lower", "upper", "frac_rows_touched",
          "ci_lo", "ci_hi")


def bits(x):
    """int32 view of float32 values, every NaN as one code."""
    x = np.array(x.numpy() if isinstance(x, torch.Tensor) else x,
                 np.float32)
    b = x.view(np.int32).copy()
    b[np.isnan(x)] = 0x7FC00000
    return b


def assert_same_bits(got, want, kinds=None):
    kinds = kinds or tuple(want)
    assert set(got) == set(want) == set(kinds)
    for kind in kinds:
        for f in FIELDS:
            g, w = getattr(got[kind], f), getattr(want[kind], f)
            if g is None or w is None:
                assert g is None and w is None, (kind, f)
                continue
            assert np.array_equal(bits(g), bits(w)), (kind, f)


def assert_tier_close(tres, jres):
    """A port tier against the JAX package's (module doc)."""
    for kind in jres:
        j, t = jres[kind], tres[kind]
        scale = batch_scale(j.estimate)
        for f in FIELDS:
            jv, tv = getattr(j, f), getattr(t, f)
            if jv is None:
                assert tv is None, (kind, f)
                continue
            jv = np.asarray(jv, np.float64)
            tv = np.asarray(tv, np.float64)
            held = np.abs(jv) >= PLACEHOLDER
            np.testing.assert_array_equal(tv[held], jv[held],
                                          err_msg=f"{kind}.{f}")
            rtol, atol = ((1e-4, 1e-4 * scale) if f in ("ci_half", "ci_lo",
                                                        "ci_hi")
                          else (3e-5, 1e-3))
            np.testing.assert_allclose(tv[~held], jv[~held], rtol=rtol,
                                       atol=atol, err_msg=f"{kind}.{f}")


@pytest.fixture(scope="module")
def built():
    """{tag: (jax synopsis, port synopsis, jax queries, port queries, c)}:
    integer values (1-D, equal-depth) and float values (3-D, kd)."""
    out = {}
    for tag, d, method in (("1d", 1, "eq"), ("3d", 3, "kd")):
        rng = np.random.default_rng(d)
        n = 12000
        c = (np.sort(rng.uniform(0, 100, n)) if d == 1
             else rng.uniform(0, 100, (n, d)))
        a = (np.floor(rng.uniform(0, 1000, n)) if d == 1
             else rng.lognormal(0, 1, n) * (1 + np.sin(c[:, 0] / 5)))
        jsyn, _ = jbuild(c, a, k=16, sample_rate=0.05, method=method,
                         seed=0)
        jq = jquery.random_queries(c, 24, seed=2, min_frac=0.02,
                                   max_frac=0.5 if d == 1 else 0.8)
        out[tag] = (jsyn, carry(jsyn), jq, carry_queries(jq), c)
    return out


def _tq(q, n=None):
    sl = slice(None) if n is None else slice(0, n)
    return QueryBatch(q.lo[sl].contiguous(), q.hi[sl].contiguous())


# ---------------------------------------------------------------------------
# Tier 0 and the ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [1, 2, 3, 4, 8, 9, 64, 75, 1000])
def test_ladder_tiers_match_reference(cap):
    assert ladder_tiers(cap) == jrefine.ladder_tiers(cap)
    assert ladder_tiers(75) == [9, 18, 37, None]


@pytest.mark.parametrize("tag", ["1d", "3d"])
def test_tier0_bit_equal_to_jax(built, tag):
    jsyn, tsyn, jq, tq, _ = built[tag]
    jeng = JEngine(jsyn, JServing(kinds=KINDS))
    teng = PassEngine(tsyn, ServingConfig(kinds=KINDS), device="cpu")
    assert_same_bits(tier0_answer(teng, tq, KINDS),
                     jrefine.tier0_answer(jeng, jq, KINDS))
    # one host snapshot per (epoch, generation), none on later calls
    snap = teng._tier0_cache
    tier0_answer(teng, tq, ("sum",))
    assert teng._tier0_cache is snap
    teng.replace_source(tsyn)
    tier0_answer(teng, tq, ("sum",))
    assert teng._tier0_cache is not snap


def test_tier0_equals_exact_path_on_covered_queries(built):
    """Leaf-aligned 1-D queries cover whole strata: tier 0 is the exact
    answer, bit for bit, and its SUM/COUNT envelope collapses onto it."""
    _, tsyn, _, _, _ = built["1d"]
    lo = tsyn.leaf_lo[:, 0].numpy()
    hi = tsyn.leaf_hi[:, 0].numpy()
    a = np.arange(6) * 2 % (lo.shape[0] - 1)
    b = np.minimum(lo.shape[0] - 1, a + 3)
    q = QueryBatch(torch.from_numpy(lo[a][:, None].copy()),
                   torch.from_numpy(hi[b][:, None].copy()))
    eng = PassEngine(tsyn, ServingConfig(kinds=KINDS), device="cpu")
    exact = eng.answer(q)
    t0 = tier0_answer(eng, q, KINDS)
    for kind in KINDS:
        want = bits(exact[kind].estimate)
        assert np.array_equal(bits(t0[kind].estimate), want), kind
        if kind in ("sum", "count"):
            assert np.array_equal(bits(t0[kind].lower), want), kind
            assert np.array_equal(bits(t0[kind].upper), want), kind


@pytest.mark.parametrize("tag,ci", [("1d", 0.95), ("3d", 0.95),
                                    ("1d", None)])
def test_tiers_match_jax_and_tighten(built, tag, ci):
    """Every tier of answer_progressive against the JAX package's same
    tier, and the port's ladder tightens monotonically; the last tier's
    own answer is the plain answer, bit for bit."""
    jsyn, tsyn, jq, tq, _ = built[tag]
    kinds = ("sum", "count", "avg") if ci else KINDS
    jeng = JEngine(jsyn, JServing(kinds=kinds), ci=ci)
    teng = PassEngine(tsyn, ServingConfig(kinds=kinds), ci=ci, device="cpu")
    h = teng.answer_progressive(tq)
    jh = jeng.answer_progressive(jq)
    assert isinstance(h, RefinementHandle) and h.tier == 0
    assert h._tiers == jh._tiers == ladder_tiers(int(tsyn.sample_a.shape[1]))
    prev = {k: r.interval()[1:] for k, r in h.results.items()}
    while not h.done:
        slots = h._tiers[0]
        h.refine()
        jh.refine()
        jstep = jeng.answer(jq, serving=JServing(kinds=kinds,
                                                 sample_slots=slots))
        assert_tier_close(h.last_step, jstep)
        assert_tier_close(h.results, jh.results)
        for kind, res in h.results.items():
            # a query touching no stratum starts from an inverted envelope
            _, lo, hi = res.interval()
            proper = prev[kind][0] <= prev[kind][1]
            assert np.all((lo >= prev[kind][0])[proper])
            assert np.all((hi <= prev[kind][1])[proper])
            assert np.all((lo <= hi)[proper])
            prev[kind] = (lo, hi)
    assert h.tier == len(ladder_tiers(int(tsyn.sample_a.shape[1])))
    assert_same_bits(h.last_step, teng.answer(tq))
    st = teng.stats()
    assert st["tier0_serves"] == 1 and st["refine_steps"] == h.tier


def _qr(est, lo, hi):
    f = np.float32
    return QueryResult(f([est]), f([(hi - lo) / 2]), f([lo]), f([hi]),
                       f([1.0]), ci_lo=f([lo]), ci_hi=f([hi]))


def test_merge_refinement_monotone_and_crossing_guard():
    """Hand-made steps: a nested interval tightens to the new one; a
    disjoint one (crossing) collapses to the previous envelope's point
    nearest the new estimate; an estimate outside the merged interval is
    clipped into it."""
    m = merge_refinement({"sum": _qr(5.0, 4.0, 6.0)},
                         {"sum": _qr(5.5, 4.5, 7.0)})["sum"]
    assert (m.ci_lo[0], m.ci_hi[0], m.estimate[0]) == (4.5, 6.0, 5.5)
    m = merge_refinement({"sum": _qr(5.0, 4.0, 6.0)},
                         {"sum": _qr(9.0, 8.0, 10.0)})["sum"]
    assert m.ci_lo[0] == m.ci_hi[0] == m.estimate[0] == 6.0
    assert m.lower[0] <= m.upper[0]
    m = merge_refinement({"sum": _qr(5.0, 4.0, 6.0)},
                         {"sum": _qr(3.0, 3.5, 5.0)})["sum"]
    assert (m.ci_lo[0], m.ci_hi[0], m.estimate[0]) == (4.0, 5.0, 4.0)
    # the reference's merge gives the same bits on the crossing case
    prev, new = _qr(5.0, 4.0, 6.0), _qr(9.0, 8.0, 10.0)
    assert_same_bits(merge_refinement({"sum": prev}, {"sum": new}),
                     jrefine.merge_refinement({"sum": prev}, {"sum": new}))


def test_deadline_zero_serves_tier0_only(built):
    _, tsyn, _, tq, _ = built["1d"]
    eng = PassEngine(tsyn, ServingConfig(kinds=KINDS), ci=0.95, device="cpu")
    res = eng.answer(tq, deadline_ms=0.0)
    st = eng.stats()
    assert (st["tier0_serves"], st["refine_steps"], st["degraded_serves"],
            st["misses"]) == (1, 0, 1, 0)
    assert_same_bits(res, tier0_answer(eng, tq, KINDS))
    eng.answer(tq, deadline_ms=1e9)
    assert eng.stats()["refine_steps"] == len(ladder_tiers(
        int(tsyn.sample_a.shape[1])))
    with pytest.raises(ValueError, match="deadline_ms"):
        eng.answer(tq, deadline_ms=1.0, plan=object())


def test_max_ci_width_stops_early(built):
    """A width tier 0 already meets takes no tier; one no tier meets runs
    them all; one a middle tier reaches stops at that tier."""
    _, tsyn, _, tq, _ = built["1d"]
    sv = ServingConfig(kinds=("sum", "count"))
    cap = int(tsyn.sample_a.shape[1])
    eng = PassEngine(tsyn, sv, device="cpu")
    eng.answer(tq, ci=CIConfig(level=0.95, max_ci_width=1e12))
    assert eng.stats()["refine_steps"] == 0
    eng = PassEngine(tsyn, sv, device="cpu")
    eng.answer(tq, ci=CIConfig(level=0.95, max_ci_width=1e-9))
    assert eng.stats()["refine_steps"] == len(ladder_tiers(cap))
    # CLT intervals from 2 relevant samples on, so that a middle tier
    # narrows the widest interval
    ci = CIConfig(level=0.95, small_n_threshold=2)
    h = PassEngine(tsyn, sv, device="cpu").answer_progressive(tq, ci=ci)
    widths = [h.width()]
    while not h.done:
        h.refine()
        widths.append(h.width())
    assert widths[-2] < widths[0]       # the ladder narrows before its end
    stop = min(t for t, w in enumerate(widths) if w <= widths[-2])
    eng = PassEngine(tsyn, sv, device="cpu")
    eng.answer(tq, ci=dataclasses.replace(ci, max_ci_width=widths[-2]))
    assert 1 <= eng.stats()["refine_steps"] == stop < len(ladder_tiers(cap))
    with pytest.raises(ValueError, match="max_ci_width"):
        CIConfig(max_ci_width=0.0).validate()
    assert (CIConfig(max_ci_width=3.0).cache_key()
            == CIConfig().cache_key())


# ---------------------------------------------------------------------------
# Row bits do not depend on the batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ci", [None, 0.95, "boot"])
def test_short_batches_bit_equal_to_padded_class(built, ci):
    """Q = 1, 3, 8 (served at MIN_ROWS rows) and Q = 24 against the same
    rows in a batch padded with empty rows to 128: every kind and field,
    bit for bit."""
    _, tsyn, _, tq, _ = built["3d"]
    cfg = (CIConfig(method="bootstrap", n_boot=16, key=3) if ci == "boot"
           else ci)
    kinds = ("sum", "count", "avg") if ci == "boot" else KINDS
    eng = PassEngine(tsyn, ServingConfig(kinds=kinds), ci=cfg, device="cpu")
    d = tq.lo.shape[1]
    for n in (1, 3, 8, 24):
        pad = QueryBatch(
            torch.cat([tq.lo[:n], torch.full((128 - n, d), PAD_LO)]),
            torch.cat([tq.hi[:n], torch.full((128 - n, d), PAD_HI)]))
        full = eng.answer(pad)
        want = {k: QueryResult(**{f.name: None if getattr(r, f.name) is None
                                  else getattr(r, f.name)[:n]
                                  for f in dataclasses.fields(r)})
                for k, r in full.items()}
        assert_same_bits(eng.answer(_tq(tq, n)), want)
    assert MIN_ROWS == 16


# ---------------------------------------------------------------------------
# The coalescer
# ---------------------------------------------------------------------------

def _fresh(tsyn, q, serving, ci=None):
    """Per-tenant oracle: a cold engine answering this batch alone."""
    return PassEngine(tsyn, serving=serving, ci=ci, device="cpu").answer(q)


@pytest.mark.parametrize("ci", [None, 0.95, "boot"])
def test_coalesced_bit_identical_to_per_tenant_answers(built, ci):
    jsyn, tsyn, _, _, c = built["1d"]
    cfg = (CIConfig(method="bootstrap", n_boot=16, key=3) if ci == "boot"
           else ci)
    kinds = ("sum", "count", "avg") if ci is not None else KINDS
    serving = ServingConfig(kinds=kinds)
    eng = PassEngine(tsyn, serving=serving, ci=cfg, device="cpu")
    co = RequestCoalescer(eng, CoalescerConfig(shape_classes=(8, 32)))
    sizes = [3, 5, 7, 2, 9, 11, 8, 1]
    batches = {f"t{i}": random_queries(c, q, seed=20 + i, device="cpu")
               for i, q in enumerate(sizes)}
    futs = {t: co.submit(t, qs) for t, qs in batches.items()}
    n_dispatch = co.tick()
    assert 0 < n_dispatch < len(sizes)
    for t, qs in batches.items():
        got = futs[t].result(timeout=0)
        assert isinstance(got[kinds[0]].estimate, np.ndarray)
        assert_same_bits(got, _fresh(tsyn, qs, serving, cfg))
    s = co.stats()
    assert (s["served"], s["coalesced_rows"], s["dispatches"],
            s["failed"]) == (len(sizes), sum(sizes), n_dispatch, 0)
    assert eng.stats()["coalescer"]["served"] == len(sizes)


def test_arrival_order_dedup_and_mixed_configs(built):
    _, tsyn, _, _, c = built["1d"]
    serving = ServingConfig(kinds=("sum", "avg"))
    sizes = [(f"t{i}", 2 + i) for i in range(5)]
    batches = {t: random_queries(c, q, seed=40 + q, device="cpu")
               for t, q in sizes}
    want = {t: _fresh(tsyn, qs, serving) for t, qs in batches.items()}
    for perm_seed in range(2):
        order = np.random.default_rng(perm_seed).permutation(len(sizes))
        co = RequestCoalescer(PassEngine(tsyn, serving, device="cpu"),
                              CoalescerConfig(shape_classes=(4, 16)))
        futs = {sizes[j][0]: co.submit(sizes[j][0], batches[sizes[j][0]])
                for j in order}
        dup = co.submit("copycat", batches["t3"])
        co.tick()
        for t in futs:
            assert_same_bits(futs[t].result(timeout=0), want[t])
        assert_same_bits(dup.result(timeout=0), want["t3"])
        assert co.stats()["dedup_hits"] == 1
    eng = PassEngine(tsyn, ServingConfig(kinds=("sum",)), device="cpu")
    co = RequestCoalescer(eng, CoalescerConfig(shape_classes=(8,)))
    qs = batches["t2"]
    f_plain = co.submit("a", qs)
    f_ci = co.submit("b", qs, ci=0.9)
    f_kinds = co.submit("c", qs, kinds=("count", "max"))
    assert co.tick() == 3
    assert_same_bits(f_plain.result(0),
                     _fresh(tsyn, qs, ServingConfig(kinds=("sum",))))
    assert_same_bits(f_ci.result(0),
                     _fresh(tsyn, qs, ServingConfig(kinds=("sum",)), 0.9))
    assert_same_bits(f_kinds.result(0),
                     _fresh(tsyn, qs, ServingConfig(kinds=("count", "max"))))


@pytest.fixture(scope="module")
def joined():
    """A port join synopsis (k = 8, P = 8) and its fact column."""
    from repro_torch.joins import build_dim_table, build_join_synopsis
    rng = np.random.default_rng(7)
    n, nd = 6000, 200
    c = rng.normal(size=n).astype(np.float32)
    a = rng.gamma(2.0, 1.0, size=n).astype(np.float32)
    keys = rng.integers(0, nd, size=n).astype(np.int32)
    dim = build_dim_table(np.arange(nd), rng.normal(size=nd),
                          num_partitions=8, device="cpu")
    jsyn, _ = build_join_synopsis(c, a, keys, dim, k=8, p_u=0.3, seed=19,
                                  device="cpu")
    return jsyn


def _join_req(rows, seed):
    """A (fact, dim) pair of ``rows`` rectangles from a seed."""
    rng = np.random.default_rng(seed)
    f = np.sort(rng.normal(0, 1.2, (rows, 2)), 1).astype(np.float32)
    d = np.sort(rng.normal(0, 1.2, (rows, 2)), 1).astype(np.float32)
    return (QueryBatch(torch.from_numpy(f[:, :1].copy()),
                       torch.from_numpy(f[:, 1:].copy())),
            QueryBatch(torch.from_numpy(d[:, :1].copy()),
                       torch.from_numpy(d[:, 1:].copy())))


@pytest.mark.parametrize("ci", [None, 0.95])
def test_coalescer_join_roundtrip_and_dedup(joined, ci):
    """Join requests bucket apart from single-table ones and demux to the
    bits of each tenant's own answer_join (coalesced rows against solo
    rows); identical join predicates in a tick dispatch once; a plain
    request of the same tick keeps its own bucket and bits."""
    kinds = ("sum", "count", "avg")
    eng = PassEngine(joined, ServingConfig(kinds=kinds), ci=ci,
                     device="cpu")
    co = RequestCoalescer(eng, CoalescerConfig(shape_classes=(32, 128)))
    reqs = {f"t{i}": _join_req(rows, 60 + i)
            for i, rows in enumerate((2, 17, 5, 40, 9, 1))}
    futs = {t: co.submit(t, r, join=True) for t, r in reqs.items()}
    dups = [co.submit(f"copy{i}", reqs["t1"], join=True) for i in range(2)]
    plain_q = reqs["t0"][0]
    f_plain = co.submit("p", plain_q, kinds=("sum",))
    n = co.tick()
    assert 0 < n < len(reqs)
    stats = co.stats()
    assert stats["dedup_hits"] == 2 and stats["failed"] == 0
    assert stats["served"] == len(reqs) + 3
    for t, (fq, dq) in reqs.items():
        want = eng.answer_join(fq, dq)
        assert_same_bits(futs[t].result(timeout=0), want)
    for f in dups:
        assert_same_bits(f.result(timeout=0),
                         eng.answer_join(*reqs["t1"]))
    assert_same_bits(f_plain.result(timeout=0),
                     eng.answer(plain_q, kinds=("sum",)))
    # the concatenated layout is the same request
    fq, dq = reqs["t3"]
    whole = QueryBatch(torch.cat([fq.lo, dq.lo], 1),
                       torch.cat([fq.hi, dq.hi], 1))
    fut = co.submit("w", whole, join=True)
    co.tick()
    assert_same_bits(fut.result(timeout=0), eng.answer_join(whole))


def test_oversize_and_host_requests(built):
    """A request past the top class rounds up to its multiple; numpy
    requests take the host mux and match too."""
    _, tsyn, _, _, c = built["1d"]
    serving = ServingConfig(kinds=("sum",))
    co = RequestCoalescer(PassEngine(tsyn, serving, device="cpu"),
                          CoalescerConfig(shape_classes=(4, 8)))
    qs = random_queries(c, 19, seed=9, device="cpu")
    host = QueryBatch(qs.lo.numpy(), qs.hi.numpy())
    fut = co.submit("big", qs)
    f_host = co.submit("host", host)
    assert co.tick() == 1
    assert co.stats()["dedup_hits"] == 1
    assert_same_bits(fut.result(0), _fresh(tsyn, qs, serving))
    assert_same_bits(f_host.result(0), _fresh(tsyn, qs, serving))
    assert co.stats()["padded_rows"] == 24 - 19


def test_admission_control_sheds_typed(built):
    _, tsyn, _, _, c = built["1d"]
    co = RequestCoalescer(PassEngine(tsyn, device="cpu"),
                          CoalescerConfig(max_outstanding=2))
    qs = random_queries(c, 4, seed=1, device="cpu")
    co.submit("x", qs)
    co.submit("x", qs)
    with pytest.raises(Overloaded) as ei:
        co.submit("x", qs)
    assert ei.value.reason == "tenant_outstanding" and ei.value.limit == 2
    co.submit("y", qs)
    co.tick()
    co.submit("x", qs)
    co.tick()
    s = co.stats()
    assert s["shed"] == 1 and s["served"] == 4
    assert s["tenants"]["x"]["requests"] == 3
    co = RequestCoalescer(PassEngine(tsyn, device="cpu"),
                          CoalescerConfig(max_queue_depth=3,
                                          max_outstanding=10))
    for t in ("a", "b", "c"):
        co.submit(t, qs)
    with pytest.raises(Overloaded) as ei:
        co.submit("d", qs)
    assert ei.value.reason == "queue_depth" and ei.value.limit == 3
    co.flush()
    assert co.stats()["queue_depth"] == 0


def test_epoch_drain_serves_fresh_merge(built):
    """Requests dispatched before an ingest answer the old epoch, those
    after it the new merge, each bit-equal to its own answer; the bump
    counts one drain."""
    jsyn, _, _, _, c = built["1d"]
    ing = StreamingIngestor(carry(jsyn), seed=3, device="cpu")
    serving = ServingConfig(kinds=("sum", "count"))
    co = RequestCoalescer(PassEngine(ing, serving, device="cpu"),
                          CoalescerConfig(shape_classes=(8,)))
    qs = random_queries(c, 6, seed=5, min_frac=0.2, max_frac=0.6,
                        device="cpu")
    want_old = _fresh(ing, qs, serving)
    f_old = co.submit("a", qs)
    co.tick()
    rng = np.random.default_rng(7)
    ing.ingest(rng.uniform(0, 100, 1024), np.floor(rng.uniform(0, 900, 1024)))
    f_new = co.submit("a", qs)
    co.tick()
    assert_same_bits(f_old.result(0), want_old)
    assert_same_bits(f_new.result(0), _fresh(ing, qs, serving))
    assert co.stats()["epoch_drains"] == 1
    assert not np.array_equal(f_old.result(0)["count"].estimate,
                              f_new.result(0)["count"].estimate)


def test_deadline_routing_to_tier0(built):
    """An overloaded request with a deadline is served tier 0 at once; a
    request whose budget the dispatch EWMA cannot meet is served tier 0
    at the tick."""
    _, tsyn, _, _, c = built["1d"]
    eng = PassEngine(tsyn, ServingConfig(kinds=("sum",)), device="cpu")
    co = RequestCoalescer(eng, CoalescerConfig(max_outstanding=1,
                                               shape_classes=(8,)))
    qs = random_queries(c, 4, seed=3, device="cpu")
    f1 = co.submit("t", qs)
    f2 = co.submit("t", qs, deadline_ms=1e6)
    assert f2.done()
    assert_same_bits(f2.result(0), tier0_answer(eng, qs, ("sum",)))
    co.flush()
    assert f1.done()
    co._dispatch_ewma_ms = 1e9          # no budget survives a dispatch
    f3 = co.submit("t", qs, deadline_ms=5.0)
    assert co.tick() == 0
    assert_same_bits(f3.result(0), tier0_answer(eng, qs, ("sum",)))
    s = co.stats()
    assert s["degraded_served"] == 2 and s["failed"] == 0
    assert eng.stats()["degraded_serves"] == 2
    assert s["tenants"]["t"]["outstanding"] == 0


def test_tick_driver_serves_and_flushes_on_stop(built):
    _, tsyn, _, _, c = built["1d"]
    serving = ServingConfig(kinds=("sum", "count"))
    co = RequestCoalescer(PassEngine(tsyn, serving, device="cpu"),
                          CoalescerConfig(tick_ms=1.0, shape_classes=(8, 32)))
    batches = {f"t{i}": random_queries(c, 3 + i, seed=i, device="cpu")
               for i in range(4)}
    want = {t: _fresh(tsyn, qs, serving) for t, qs in batches.items()}
    with TickDriver(co) as driver:
        assert driver.running
        with pytest.raises(RuntimeError, match="already started"):
            driver.start()
        with cf.ThreadPoolExecutor(4) as ex:
            got = {t: ex.submit(co.answer, t, qs, timeout=60)
                   for t, qs in batches.items()}
            for t in batches:
                assert_same_bits(got[t].result(timeout=60), want[t])
    assert not driver.running
    driver.stop()                              # idempotent
    assert co.queue_depth == 0 and co.stats()["served"] == 4


def test_coalescer_config_and_join_refusal(built):
    with pytest.raises(ValueError, match="tick_ms"):
        CoalescerConfig(tick_ms=0).validate()
    with pytest.raises(ValueError, match="non-empty"):
        CoalescerConfig(shape_classes=()).validate()
    with pytest.raises(ValueError, match="ascending"):
        CoalescerConfig(shape_classes=(32, 8)).validate()
    with pytest.raises(ValueError, match="positive"):
        CoalescerConfig(shape_classes=(0, 8)).validate()
    with pytest.raises(ValueError, match="max_outstanding"):
        CoalescerConfig(max_outstanding=0).validate()
    assert [CoalescerConfig(shape_classes=(4, 8)).padded_size(n)
            for n in (3, 8, 17)] == [4, 8, 24]
    _, tsyn, _, tq, _ = built["1d"]
    co = RequestCoalescer(PassEngine(tsyn, device="cpu"))
    with pytest.raises(TypeError, match="JoinSynopsis source"):
        co.submit("t", tq, join=True)
    with pytest.raises(ValueError, match="single-table requests only"):
        co.submit("t", tq, join=True, deadline_ms=5.0)
    with pytest.raises(ValueError, match="non-empty"):
        co.submit("t", QueryBatch(torch.zeros((0, 1)), torch.zeros((0, 1))))
    with pytest.raises(ValueError, match="deadline_ms"):
        co.submit("t", tq, deadline_ms=-1.0)


def test_concurrent_submitters_counters_reconcile(built):
    """More submitter threads than cores against a tiny admission budget,
    ticks running alongside, a short switch interval: every submit returns
    a future or raises Overloaded, every future resolves after flush(),
    and the counters reconcile (a lost update would break them)."""
    import sys
    import threading
    import time
    _, tsyn, _, _, _ = built["1d"]
    co = RequestCoalescer(PassEngine(tsyn, ServingConfig(kinds=("sum",)),
                                     device="cpu"),
                          CoalescerConfig(shape_classes=(8,),
                                          max_outstanding=2,
                                          max_queue_depth=6))
    n_threads, per_thread = 12, 6
    futures, sheds = [], []
    lock = threading.Lock()
    barrier = threading.Barrier(n_threads)

    def submitter(tid):
        rng = np.random.default_rng(tid)
        barrier.wait(timeout=30)
        for _ in range(per_thread):
            lo = rng.uniform(0, 70, (2, 1)).astype(np.float32)
            q = QueryBatch(torch.from_numpy(lo), torch.from_numpy(lo + 10))
            try:
                f = co.submit(f"t{tid}", q)
                with lock:
                    futures.append(f)
            except Overloaded as exc:
                assert exc.reason in ("tenant_outstanding", "queue_depth")
                with lock:
                    sheds.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while any(t.is_alive() for t in threads):
            co.tick()
            assert time.monotonic() < deadline
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    co.flush()
    assert len(futures) + len(sheds) == n_threads * per_thread
    for f in futures:
        assert set(f.result(timeout=10)) == {"sum"}
    s = co.stats()
    assert s["submitted"] == len(futures) == s["served"]
    assert s["shed"] == len(sheds) == sum(t["shed"]
                                          for t in s["tenants"].values())
    assert all(t["outstanding"] == 0 for t in s["tenants"].values())
    assert s["queue_depth"] == 0 and s["failed"] == 0
