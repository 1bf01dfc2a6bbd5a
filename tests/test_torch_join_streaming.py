"""The port's join streaming (``repro_torch.streaming.join_ingest``)
against the JAX package's ``JoinStreamingIngestor``, on the CPU.

Both ingestors start from the same build (the port's join synopsis is
exactly the reference's, tests/test_torch_joins.py) and take the same
batches with the same explicit uniforms, or the same seeded key. Integer
measure values keep every float sum exact, so the base state, the join
state (cell deltas, universe buffers, counts, overflow) and the served
join view are compared exactly, at d_fact 1 (binary-search routing) and
2 (``ops.route_multid``), through overflow and ``regrow``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.api import PassEngine as JEngine, CIConfig as JCI
from repro.joins import (build_dim_table as jdim, build_join_synopsis as
                         jbuild, universe_mask as jmask)
from repro.streaming import JoinStreamingIngestor as JIngestor
from repro.testing import FaultPlan as JPlan, inject as jinject
from repro_torch.api import PassEngine, CIConfig
from repro_torch.core.query import ground_truth_join
from repro_torch.core.types import QueryBatch
from repro_torch.joins import (build_dim_table, build_join_synopsis,
                               universe_mask)
from repro_torch.streaming import StreamingIngestor
from repro_torch.streaming.ingest import STATE_FIELDS
from repro_torch.streaming.join_ingest import (JoinStreamingIngestor,
                                               JSTATE_FIELDS)
from repro_torch.testing import FaultPlan, inject
from test_torch_joins import assert_results_close, rects

JVIEW = ("cell_agg", "u_c", "u_a", "u_key", "u_dattr", "u_part", "u_valid",
         "u_count", "u_overflow")


def stream_tables(n, nd, seed, d_fact, missing=0.05):
    rng = np.random.default_rng(seed)
    c = (rng.normal(size=n) if d_fact == 1
         else rng.normal(size=(n, d_fact))).astype(np.float32)
    a = np.floor(rng.uniform(0, 50, size=n)).astype(np.float32)
    keys = rng.integers(0, nd, size=n).astype(np.int32)
    out = rng.random(n) < missing
    keys[out] = nd + rng.integers(0, 10, size=int(out.sum()))
    dkeys = np.arange(nd, dtype=np.int32)
    dattr = rng.normal(size=nd).astype(np.float32)
    return c, a, keys, dkeys, dattr


def built(d_fact, n=2400, half=1200, cap=None, seed=0):
    """(JAX synopsis, port synopsis, table) built on the first ``half``
    rows."""
    c, a, keys, dkeys, dattr = tab = stream_tables(n, 50, seed, d_fact)
    kw = dict(k=8, p_u=0.4, seed=3, u_capacity=cap,
              method="adp" if d_fact == 1 else "kd", opt_samples=512)
    jsyn, _ = jbuild(c[:half], a[:half], keys[:half],
                     jdim(dkeys, dattr, num_partitions=4), **kw)
    tsyn, _ = build_join_synopsis(
        c[:half], a[:half], keys[:half],
        build_dim_table(dkeys, dattr, num_partitions=4, device="cpu"),
        device="cpu", **kw)
    return jsyn, tsyn, tab


def assert_same_state(ting, jing):
    for f in STATE_FIELDS:
        w = getattr(jing.state, f, None)
        if w is None:
            continue
        np.testing.assert_array_equal(getattr(ting.state, f).numpy(),
                                      np.asarray(w), err_msg=f)
    for f in JSTATE_FIELDS:
        g, w = getattr(ting.jstate, f).numpy(), np.asarray(
            getattr(jing.jstate, f))
        assert g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    tv, jv = ting.as_join_synopsis(), jing.as_join_synopsis()
    for f in JVIEW:
        np.testing.assert_array_equal(getattr(tv, f).numpy(),
                                      np.asarray(getattr(jv, f)), err_msg=f)
    np.testing.assert_array_equal(tv.base.leaf_agg.numpy(),
                                  np.asarray(jv.base.leaf_agg))


@pytest.mark.parametrize("keyed", [False, True])
@pytest.mark.parametrize("cap", [None, 40])
@pytest.mark.parametrize("d_fact", [1, 2])
def test_join_stream_matches_jax(d_fact, cap, keyed):
    """Batch by batch (explicit uniforms, or the threaded key), through
    overflow and regrow when the capacity is small."""
    jsyn, tsyn, (c, a, keys, _, _) = built(d_fact, cap=cap)
    jing = JIngestor(jsyn, seed=5)
    ting = JoinStreamingIngestor(tsyn, seed=5, device="cpu")
    rng = np.random.default_rng(1)
    for s in range(1200, 2400, 400):
        sl = slice(s, s + 400)
        u = None if keyed else rng.uniform(size=400).astype(np.float32)
        jing.ingest(c[sl], a[sl], keys=keys[sl], u=u)
        ting.ingest(c[sl], a[sl], keys=keys[sl], u=u)
        assert ting.epoch == jing.epoch
    assert ting.n_regrown == jing.n_regrown
    if cap is not None:
        assert ting.n_regrown > 0
    assert_same_state(ting, jing)
    jing.regrow()
    ting.regrow()
    assert_same_state(ting, jing)


def test_join_stream_quarantine_matches_jax():
    """NaN rows, rows outside the quarantine box and poisoned batches are
    dropped from both transitions as the reference drops them."""
    jsyn, tsyn, (c, a, keys, _, _) = built(1)
    box = ([-2.0], [2.0])
    jing = JIngestor(jsyn, seed=2, quarantine_box=box)
    ting = JoinStreamingIngestor(tsyn, seed=2, quarantine_box=box,
                                 device="cpu")
    c = c.copy()
    c[1300:1310] = np.nan
    for s in range(1200, 1800, 300):
        sl = slice(s, s + 300)
        jing.ingest(c[sl], a[sl], keys=keys[sl])
        ting.ingest(c[sl], a[sl], keys=keys[sl])
    with inject(FaultPlan(poison_every=2)):
        for s in range(1800, 2400, 300):
            ting.ingest(c[s:s + 300], a[s:s + 300], keys=keys[s:s + 300])
    with jinject(JPlan(poison_every=2)):
        for s in range(1800, 2400, 300):
            jing.ingest(c[s:s + 300], a[s:s + 300], keys=keys[s:s + 300])
    assert ting.n_quarantined == int(np.asarray(jing.state.quarantined)) > 10
    assert_same_state(ting, jing)


@pytest.mark.parametrize("d_fact", [1, 2])
def test_join_stream_serving_matches_jax(d_fact):
    jsyn, tsyn, (c, a, keys, _, _) = built(d_fact, cap=30)
    jing = JIngestor(jsyn, seed=4)
    ting = JoinStreamingIngestor(tsyn, seed=4, device="cpu")
    for s in range(1200, 2400, 300):
        jing.ingest(c[s:s + 300], a[s:s + 300], keys=keys[s:s + 300])
        ting.ingest(c[s:s + 300], a[s:s + 300], keys=keys[s:s + 300])
    jq, tq = rects(24, d_fact, 1, seed=3)
    kinds = ("sum", "count", "avg")
    jres = JEngine(jing, ci=JCI(level=0.95)).answer_join(jq, kinds=kinds)
    tres = PassEngine(ting, ci=CIConfig(level=0.95),
                      device="cpu").answer_join(tq, kinds=kinds)
    assert_results_close(tres, jres, kinds)


def test_join_streaming_matches_full_build():
    """Build on the first half, stream the second: membership, cell
    totals and served bounds agree with the full build; an ingest bumps
    the epoch and re-pins the engine's entry."""
    c, a, keys, dkeys, dattr = stream_tables(3000, 50, 6, 1, missing=0.0)
    dim = build_dim_table(dkeys, dattr, num_partitions=4, device="cpu")
    kw = dict(k=8, p_u=0.3, seed=17, u_capacity=4096)
    full, _ = build_join_synopsis(c, a, keys, dim, device="cpu", **kw)
    half, _ = build_join_synopsis(c[:1500], a[:1500], keys[:1500], dim,
                                  device="cpu", **kw)
    ing = JoinStreamingIngestor(half, device="cpu")
    for s in range(1500, 3000, 500):
        ing.ingest(c[s:s + 500], a[s:s + 500], keys=keys[s:s + 500])
    view = ing.as_join_synopsis()
    member = universe_mask(full.key_root, keys, full.p_u).numpy()
    assert int(view.u_valid.sum()) == int(member.sum())
    assert int(view.u_overflow.sum()) == 0
    np.testing.assert_allclose(
        view.cell_agg[..., [0, 2]].sum((0, 1)).numpy(),
        full.cell_agg[..., [0, 2]].sum((0, 1)).numpy(), rtol=1e-6)
    eng = PassEngine(ing, ci=0.95, device="cpu")
    tq = QueryBatch(torch.tensor([[-1.0, -1.0]]), torch.tensor([[1.0, 1.0]]))
    eng.answer_join(tq, kinds=("sum",))
    ing.ingest(c[:512], a[:512], keys=keys[:512])
    res = eng.answer_join(tq, kinds=("sum",))["sum"]
    assert eng.stats()["invalidations"] >= 1
    truth = ground_truth_join(np.concatenate([c, c[:512]]),
                              np.concatenate([a, a[:512]]),
                              np.concatenate([keys, keys[:512]]), dkeys,
                              dattr, tq, kind="sum")
    assert res.lower[0] - 1e-3 <= truth[0] <= res.upper[0] + 1e-3
    # the single-table view of the same ingestor
    assert isinstance(ing, StreamingIngestor)
    assert eng.answer(QueryBatch(tq.lo[:, :1], tq.hi[:, :1]))


def test_universe_regrow_recovers_overflow():
    """Parked members are appended on the next epoch: after regrow the
    debt is zero, the buffers hold what an ingestor that never overflowed
    holds, and the served answers have its bits."""
    c, a, keys, dkeys, dattr = stream_tables(4000, 100, 3, 1, missing=0.0)
    dim = build_dim_table(dkeys, dattr, num_partitions=4, device="cpu")

    def make(cap):
        jsyn, _ = build_join_synopsis(c[:2000], a[:2000], keys[:2000], dim,
                                      k=4, p_u=0.5, seed=3, u_capacity=cap,
                                      device="cpu")
        return JoinStreamingIngestor(jsyn, seed=9, device="cpu")

    small, ample = make(600), make(4096)
    for s in range(2000, 4000, 500):
        small.ingest(c[s:s + 500], a[s:s + 500], keys[s:s + 500])
        ample.ingest(c[s:s + 500], a[s:s + 500], keys[s:s + 500])
    small.regrow()
    assert small.n_regrown > 0
    assert int(small.jstate.u_overflow.abs().sum()) == 0
    assert int(ample.jstate.u_overflow.sum()) == 0

    def content(ing):
        js = ing.jstate
        return [sorted(zip(js.u_key[i][js.u_valid[i]].tolist(),
                           js.u_a[i][js.u_valid[i]].tolist()))
                for i in range(js.u_valid.shape[0])]

    assert content(small) == content(ample)
    tq = QueryBatch(torch.tensor([[-1.0, -10.0]]),
                    torch.tensor([[1.0, 10.0]]))
    r_s = PassEngine(small.as_join_synopsis(), ci=0.95,
                     device="cpu").answer_join(tq, kinds=("sum",))["sum"]
    r_a = PassEngine(ample.as_join_synopsis(), ci=0.95,
                     device="cpu").answer_join(tq, kinds=("sum",))["sum"]
    assert torch.equal(r_s.estimate, r_a.estimate)
    assert torch.equal(r_s.ci_half, r_a.ci_half)


def test_join_ingest_needs_keys():
    _, tsyn, (c, a, _, _, _) = built(1)
    with pytest.raises(ValueError, match="fk keys"):
        JoinStreamingIngestor(tsyn, device="cpu").ingest(c[:4], a[:4])
    # JAX membership of streamed keys equals the port's
    rng = np.random.default_rng(0)
    probe = rng.integers(0, 60, size=100).astype(np.int32)
    np.testing.assert_array_equal(
        universe_mask(tsyn.key_root, probe, tsyn.p_u).numpy(),
        np.asarray(jmask(jnp.asarray(np.asarray(tsyn.key_root.numpy(),
                                                np.uint32)),
                         probe, tsyn.p_u)))
