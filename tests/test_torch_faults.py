"""The port's fault harness (``repro_torch.testing``) against the JAX
package's, and the single-device drills of ``tests/test_chaos.py`` on the
port, on the CPU.

Every decision function draws the reference's schedule for the same plan
and call sequence (poisoned batches bit for bit). In the drills every
request resolves to a result or a typed error, the containment counters
are asserted, and a faulted run is bit-equal to its clean run on what the
faults do not touch; on integer values the faulted port ingestor's state
is exact against the faulted JAX ingestor's.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.synopsis import build_synopsis as jbuild
from repro.streaming import StreamingIngestor as JIngestor
from repro.testing import FaultInjector as JInjector, FaultPlan as JPlan
from repro.testing import inject as jinject
from repro_torch.api import (PassEngine, ServingConfig, CIConfig,
                             CoalescerConfig)
from repro_torch.core.types import QueryBatch
from repro_torch.serve import (RequestCoalescer, TickDriver, Overloaded,
                               tier0_answer)
from repro_torch.streaming import StreamingIngestor
from repro_torch.streaming.ingest import STATE_FIELDS, quarantine_mask
from repro_torch.testing import (FaultPlan, FaultInjector, InjectedFault,
                                 active, inject, install, uninstall)
from test_torch_engine import carry

KINDS = ("sum", "count", "avg")
PLANS = [
    dict(seed=7, shard_fail_every=3, shard_fail_persist=2,
         straggler_every=2, straggler_ms=15.0, poison_every=2,
         poison_mode="inf", materialize_fail_parts=(2, 5),
         materialize_fail_times=2),
    dict(seed=1, shard_fail_every=1, shard_fail_persist=-1,
         straggler_every=3, poison_every=1, poison_mode="oob",
         materialize_fail_parts=(1,), materialize_fail_times=-1),
    dict(seed=4, poison_every=3, poison_mode="nan"),
]


def _drive(inj):
    """One fixed call sequence over all four hook sites."""
    rng = np.random.default_rng(0)
    out = []
    for step in range(9):
        out.append(tuple(inj.shard_dispatch_fails(att) for att in range(4)))
        out.append(inj.tick_delay_s())
        c = rng.uniform(0, 1, (16, 2)).astype(np.float32)
        a = rng.uniform(0, 5, 16).astype(np.float32)
        cp, ap, poisoned = inj.poison_batch(c, a)
        out.append((poisoned, cp.tobytes(), ap.tobytes()))
        out.append(tuple(inj.materialize_fails(p) for p in range(6)))
    return out, inj.snapshot()


@pytest.mark.parametrize("plan", range(len(PLANS)))
def test_schedules_equal_reference(plan):
    got = _drive(FaultInjector(FaultPlan(**PLANS[plan])))
    want = _drive(JInjector(JPlan(**PLANS[plan])))
    assert got == want
    assert got == _drive(FaultInjector(FaultPlan(**PLANS[plan])))


def test_plan_validation_and_lifecycle():
    for bad in (dict(shard_fail_every=-1), dict(poison_mode="zebra"),
                dict(straggler_ms=-1.0)):
        with pytest.raises(ValueError):
            FaultPlan(**bad).validate()
    assert active() is None
    inj = install(FaultPlan(poison_every=2))
    try:
        assert active() is inj
    finally:
        uninstall()
    with inject(FaultPlan()) as inj2:
        assert active() is inj2
    assert active() is None
    assert issubclass(InjectedFault, RuntimeError)


@pytest.mark.parametrize("mode", ["nan", "inf", "oob"])
def test_poison_modes_quarantine_whole_batch(mode):
    inj = FaultInjector(FaultPlan(poison_every=1, poison_mode=mode))
    c = np.random.default_rng(1).uniform(0, 1, (8, 2)).astype(np.float32)
    cp, ap, poisoned = inj.poison_batch(c, np.ones(8, np.float32))
    assert poisoned
    bad = quarantine_mask(torch.from_numpy(cp), torch.from_numpy(ap),
                          torch.zeros(2), torch.ones(2))
    assert bool(bad.all()), mode


# ---------------------------------------------------------------------------
# Drills
# ---------------------------------------------------------------------------

def _make(seed=0, n=12000, k=16):
    rng = np.random.default_rng(seed)
    c = np.sort(rng.uniform(0, 100, n))
    a = np.floor(rng.uniform(0, 500, n))
    jsyn, _ = jbuild(c, a, k=k, sample_rate=0.02, method="eq", seed=seed)
    return jsyn


def _queries(seed=1, m=6):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 70, (m, 1)).astype(np.float32)
    hi = (lo + rng.uniform(5, 25, (m, 1))).astype(np.float32)
    return QueryBatch(torch.from_numpy(lo), torch.from_numpy(hi))


def _batches(seed, count, b=200):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 100, b), np.floor(rng.uniform(0, 500, b)))
            for _ in range(count)]


def _assert_bits(got, want):
    for kind in want:
        for f in ("estimate", "ci_half", "lower", "upper"):
            g = np.asarray(getattr(got[kind], f), np.float32).view(np.int32)
            w = np.asarray(getattr(want[kind], f), np.float32).view(np.int32)
            assert np.array_equal(g, w), (kind, f)


@pytest.mark.parametrize("mode", ["nan", "oob"])
def test_poisoned_run_bit_equal_to_clean_run(mode):
    """Poisoned batches are counted no-ops that keep their key split: the
    faulted run equals a clean run whose same batches the quarantine box
    rejects whole, state and answers; and it equals the JAX package's
    faulted run, state exactly."""
    jsyn = _make(seed=3)
    box = ([0.0], [100.0])
    batches = _batches(seed=6, count=6)
    with inject(FaultPlan(poison_every=3, poison_mode=mode)) as inj:
        chaotic = StreamingIngestor(carry(jsyn), seed=7, quarantine_box=box,
                                    device="cpu")
        for c, a in batches:
            chaotic.ingest(c, a)
    assert inj.snapshot() == {"poisoned_batches": 2}
    clean = StreamingIngestor(carry(jsyn), seed=7, quarantine_box=box,
                              device="cpu")
    for i, (c, a) in enumerate(batches, start=1):
        clean.ingest(np.full_like(c, 500.0) if i % 3 == 0 else c, a)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(chaotic.state, f),
                           getattr(clean.state, f)), f
    assert chaotic.n_quarantined == 2 * 200
    eng = PassEngine(chaotic, ServingConfig(kinds=KINDS), device="cpu")
    _assert_bits(eng.answer(_queries(seed=4)),
                 PassEngine(clean, ServingConfig(kinds=KINDS),
                            device="cpu").answer(_queries(seed=4)))
    assert eng.stats()["faults"]["quarantined_rows"] == 400
    with jinject(JPlan(poison_every=3, poison_mode=mode)):
        jing = JIngestor(jsyn, seed=7, quarantine_box=box)
        for c, a in batches:
            jing.ingest(c, a)
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(chaotic.state, f).numpy(),
                                      np.asarray(getattr(jing.state, f)),
                                      err_msg=f)


def test_injector_counts_reach_engine_stats():
    jsyn = _make(seed=2)
    ing = StreamingIngestor(carry(jsyn), seed=5, device="cpu")
    eng = PassEngine(ing, device="cpu")
    assert "injected" not in eng.stats()["faults"]
    with inject(FaultPlan(poison_every=2, poison_mode="nan")):
        for c, a in _batches(seed=1, count=4, b=50):
            ing.ingest(c, a)
        faults = eng.stats()["faults"]
    assert faults == {"quarantined_rows": 100,
                      "injected": {"poisoned_batches": 2}}


def test_straggler_ticks_route_deadline_requests_to_tier0():
    eng = PassEngine(carry(_make(seed=17)), ServingConfig(kinds=("sum",)),
                     device="cpu")
    q = _queries(seed=18)
    co = RequestCoalescer(eng, CoalescerConfig(shape_classes=(8,)))
    co.submit("t0", q)
    co.tick()                         # primes the dispatch EWMA
    with inject(FaultPlan(straggler_every=1, straggler_ms=30.0)) as inj:
        # the 30 ms straggler outlasts the whole 5 ms budget
        fut = co.submit("t0", q, deadline_ms=5.0)
        assert co.tick() == 0
    assert inj.snapshot() == {"straggler_ticks": 1}
    _assert_bits(fut.result(timeout=5), tier0_answer(eng, q, ("sum",)))
    assert co.stats()["degraded_served"] == 1
    assert eng.stats()["degraded_serves"] == 1


def test_overload_with_deadline_serves_degraded_instead_of_shedding():
    eng = PassEngine(carry(_make(seed=19)), ServingConfig(kinds=("sum",)),
                     device="cpu")
    q = _queries(seed=20)
    co = RequestCoalescer(eng, CoalescerConfig(max_outstanding=1,
                                               shape_classes=(8,)))
    f1 = co.submit("t0", q)
    with pytest.raises(Overloaded):
        co.submit("t0", q)
    f2 = co.submit("t0", q, deadline_ms=100.0)
    assert f2.done() and set(f2.result(timeout=0)) == {"sum"}
    st = co.stats()
    assert st["degraded_served"] == 1 and st["shed"] == 1
    co.flush()
    assert f1.done()
    st = co.stats()
    assert st["submitted"] == st["served"] == 2
    assert st["tenants"]["t0"]["outstanding"] == 0


def test_driver_survives_poisoned_tick_and_fails_futures():
    eng = PassEngine(carry(_make(seed=21)), ServingConfig(kinds=("sum",)),
                     device="cpu")
    q = _queries(seed=22)
    co = RequestCoalescer(eng, CoalescerConfig(tick_ms=1.0))
    boom = InjectedFault("tick exploded")
    calls = {"n": 0}
    real_tick = co.tick

    def exploding_tick():
        # Explode once, on a tick that has a queued request.
        if calls["n"] < 1 and co.queue_depth > 0:
            calls["n"] += 1
            raise boom
        return real_tick()

    co.tick = exploding_tick
    drv = TickDriver(co, tick_ms=1.0).start()
    try:
        fut = co.submit("t0", q)
        with pytest.raises(InjectedFault, match="tick exploded"):
            fut.result(timeout=10)
        res = co.submit("t0", q).result(timeout=10)
        assert set(res) == {"sum"}
    finally:
        drv.stop(flush=True)
    st = co.stats()
    assert st["driver_errors"] == 1 and st["failed"] == 1
    assert "tick exploded" in st["last_driver_error"]
    assert st["tenants"]["t0"]["outstanding"] == 0


def test_chaos_soak_every_request_resolves():
    """Concurrent tenants, straggler ticks and a deadline mix under the
    driver: every future resolves to a result, or the submit raised a
    typed Overloaded; the counters reconcile."""
    eng = PassEngine(carry(_make(seed=23)), ServingConfig(kinds=KINDS),
                     ci=CIConfig(level=0.95), device="cpu")
    co = RequestCoalescer(eng, CoalescerConfig(max_outstanding=4,
                                               max_queue_depth=32,
                                               shape_classes=(8, 32)))
    futures, errors = [], []
    lock = threading.Lock()

    def tenant(tid):
        rng = np.random.default_rng(100 + tid)
        for i in range(8):
            m = int(rng.integers(1, 7))
            lo = rng.uniform(0, 70, (m, 1)).astype(np.float32)
            q = QueryBatch(torch.from_numpy(lo), torch.from_numpy(lo + 10.0))
            try:
                f = co.submit(f"t{tid}", q,
                              deadline_ms=50.0 if i % 3 == 0 else None)
                with lock:
                    futures.append(f)
            except Overloaded as exc:
                with lock:
                    errors.append(exc)

    with inject(FaultPlan(straggler_every=5, straggler_ms=5.0)):
        with TickDriver(co, tick_ms=1.0):
            threads = [threading.Thread(target=tenant, args=(t,))
                       for t in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    for f in futures:
        assert set(f.result(timeout=10)) == set(KINDS)
    st = co.stats()
    assert st["submitted"] == st["served"] == len(futures)
    assert st["shed"] == len(errors) and st["failed"] == 0
    assert all(a["outstanding"] == 0 for a in st["tenants"].values())


def test_checkpoint_mid_drill_restores_bit_identical(tmp_path):
    """A checkpoint taken while faults are live restores to an engine that
    serves bit for bit and carries the quarantine counter; after the drill
    both ingest the same batches and stay equal."""
    jsyn = _make(seed=31)
    q = _queries(seed=32)
    batches = _batches(seed=33, count=8)
    with inject(FaultPlan(poison_every=3, poison_mode="nan")):
        ing = StreamingIngestor(carry(jsyn), seed=35,
                                quarantine_box=([0.0], [100.0]),
                                device="cpu")
        for c, a in batches[:5]:
            ing.ingest(c, a)
        eng = PassEngine(ing, ServingConfig(kinds=KINDS), device="cpu")
        want = eng.answer(q)
        eng.checkpoint(tmp_path / "mid.npz")
        eng2 = PassEngine.restore(tmp_path / "mid.npz", device="cpu")
        _assert_bits(eng2.answer(q), want)
        assert eng2.source.n_quarantined == ing.n_quarantined == 200
    for c, a in batches[5:]:
        ing.ingest(c, a)
        eng2.source.ingest(c, a)
    _assert_bits(eng2.answer(q), eng.answer(q))


# ---------------------------------------------------------------------------
# Catalog materialization failures degrade, not fail
# ---------------------------------------------------------------------------

def _catalog_drill(seed, n, parts, cfg):
    from repro_torch.partitions import CatalogSource, partition_rows
    rng = np.random.default_rng(seed)
    c = np.sort(rng.uniform(0, 100, n))
    a = np.floor(rng.uniform(0, 500, n))
    return c, a, CatalogSource(partition_rows(c, a, parts), cfg,
                               device="cpu")


def test_materialization_failure_degrades_to_catalog_bounds(monkeypatch):
    """A partition whose build fails forever is retried, degraded and
    counted; the queries overlapping it get the catalog hard-bound
    envelope (which holds the truth), the others their clean answers bit
    for bit; the JAX package's drill on the same data degrades the same
    queries."""
    from repro.api import CatalogConfig as JCatalog
    from repro.api import PassEngine as JEngine, ServingConfig as JServing
    from repro.partitions import CatalogSource as JSource
    from repro.partitions import partition_rows as jrows
    from repro.partitions import source as jsource
    from repro_torch.api import CatalogConfig
    from repro_torch.partitions import source as psource
    monkeypatch.setattr(psource, "MATERIALIZE_BACKOFF_S", 1e-5)
    monkeypatch.setattr(jsource, "MATERIALIZE_BACKOFF_S", 1e-5)
    # A budget below the partition count keeps the tier selective;
    # pi_floor=1 picks every overlapping partition.
    kw = dict(k=4, s_per_leaf=16, max_partitions=7, pi_floor=1.0)
    c, a, src = _catalog_drill(13, 8000, 8, CatalogConfig(**kw))
    _, _, clean_src = _catalog_drill(13, 8000, 8, CatalogConfig(**kw))
    q = _queries(seed=14)
    sv = ServingConfig(kinds=("sum", "count"))
    eng = PassEngine(src, serving=sv, device="cpu")
    clean = PassEngine(clean_src, serving=sv, device="cpu").answer(q)
    with inject(FaultPlan(materialize_fail_parts=(3,),
                          materialize_fail_times=-1)) as inj:
        res = eng.answer(q)
    assert inj.snapshot()["materialize_failures"] == 4   # 1 + 3 retries
    assert src.degraded_partitions == {3}
    assert eng.stats()["faults"]["degraded_partitions"] == [3]
    st = src.stats()
    assert st["materialize_failures"] == 1 and st["materialize_retries"] == 3
    assert 3 not in st["materialized_ids"]
    lo, hi = q.lo.numpy()[:, 0], q.hi.numpy()[:, 0]
    p3 = src.catalog
    deg = (hi >= float(p3.col_lo[3, 0])) & (lo <= float(p3.col_hi[3, 0])) \
        & ~((lo <= float(p3.col_lo[3, 0])) & (hi >= float(p3.col_hi[3, 0])))
    assert deg.any() and not deg.all()
    for i in range(lo.shape[0]):
        inside = (c >= lo[i]) & (c <= hi[i])
        for kind, truth in (("sum", a[inside].sum()),
                            ("count", float(inside.sum()))):
            r = res[kind]
            assert float(r.lower[i]) - 1e-2 <= truth <= \
                float(r.upper[i]) + 1e-2, (kind, i)
            if deg[i]:
                assert float(r.estimate[i]) == float(
                    0.5 * (r.lower[i] + r.upper[i]))
                assert float(r.ci_half[i]) == float(
                    0.5 * (r.upper[i] - r.lower[i]))
    _assert_bits({k: _rows(r, ~deg) for k, r in res.items()},
                 {k: _rows(r, ~deg) for k, r in clean.items()})
    import jax.numpy as jnp
    from repro.core.types import QueryBatch as JBatch
    jsrc = JSource(jrows(c, a, 8), JCatalog(**kw))
    with jinject(JPlan(materialize_fail_parts=(3,),
                       materialize_fail_times=-1)):
        jres = JEngine(jsrc, serving=JServing(kinds=("sum", "count"))
                       ).answer(JBatch(jnp.asarray(q.lo.numpy()),
                                       jnp.asarray(q.hi.numpy())))
    assert jsrc.degraded_partitions == {3}
    for kind in ("sum", "count"):
        jm = np.asarray(jres[kind].ci_half) == 0.5 * (
            np.asarray(jres[kind].upper) - np.asarray(jres[kind].lower))
        assert np.array_equal(jm[deg], np.ones(deg.sum(), bool)), kind


def _rows(r, m):
    return type(r)(**{f: None if getattr(r, f) is None else getattr(r, f)[
        torch.from_numpy(m)] for f in r.__dataclass_fields__})


def test_materialization_transient_failure_recovers(monkeypatch):
    from repro_torch.api import CatalogConfig
    from repro_torch.partitions import source as psource
    monkeypatch.setattr(psource, "MATERIALIZE_BACKOFF_S", 1e-5)
    _, _, src = _catalog_drill(15, 4000, 6, CatalogConfig(
        k=4, s_per_leaf=8, max_partitions=5, pi_floor=1.0))
    with inject(FaultPlan(materialize_fail_parts=(1,),
                          materialize_fail_times=2)):
        assert src._materialize(1) is not None
    # Two injected failures < the retry budget: the build heals in place.
    assert src.degraded_partitions == set()
    assert src.stats()["materialize_retries"] == 2
