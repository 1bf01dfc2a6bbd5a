"""The port's legacy per-row update path (``core/updates.py``), its
reservoir sampler and the exact DP against the JAX package's, on the CPU.

Both packages wrap the very same synopsis (the JAX one, carried across
with ``synopsis_from_numpy``) and insert the very same rows. Tolerances:

* every host array of ``UpdatableSynopsis`` after the inserts (aggregates,
  boxes, tree, reservoir slots, counters): exact, both being float64
  numpy with the same ``default_rng`` draws;
* ``snapshot()``: every array bit-equal to the reference's; its answers
  within ``tests/test_torch_engine.py``'s tolerances;
* ``to_streaming()``: the ingest state after the same batches exact on
  integer-valued data (as ``tests/test_torch_streaming.py`` holds it);
* ``ReservoirStratum``: the same accept / slot decisions and contents;
* ``dp_exact``: equal cuts and objective.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import PassEngine as JEngine, ServingConfig as JServing
from repro.core import dp as jdp
from repro.core import query as jquery
from repro.core.sampling import ReservoirStratum as JReservoir
from repro.core.synopsis import build_synopsis as jbuild
from repro.core.updates import UpdatableSynopsis as JUpd
from repro_torch.api import PassEngine, ServingConfig
from repro_torch.core import dp as tdp
from repro_torch.core.sampling import ReservoirStratum
from repro_torch.core.updates import UpdatableSynopsis
from test_torch_engine import (KINDS, SYN_FIELDS, TREE_FIELDS,
                               assert_results_close, carry, carry_queries)
from test_torch_streaming import assert_state_matches

UPD_FIELDS = ("leaf_lo", "leaf_hi", "leaf_agg", "sample_c", "sample_a",
              "sample_valid", "k_per_leaf", "seen", "tree_agg", "tree_lo",
              "tree_hi", "leaf_node")


def _setup(d, int_vals, n=5000, k=16, seed=0):
    rng = np.random.default_rng(seed)
    c = (np.sort(rng.uniform(0, 100, n)) if d == 1
         else rng.uniform(0, 100, (n, d)))
    a = (rng.integers(1, 50, n).astype(np.float64) if int_vals
         else rng.lognormal(0, 1, n))
    jsyn, _ = jbuild(c, a, k=k, sample_budget=8 * k,
                     method="eq" if d == 1 else "kd", seed=0)
    return jsyn, c, a


def _rows(d, m, int_vals, seed=1):
    """New rows, some outside every box (new value range)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-20, 130, (m, d))
    a = (rng.integers(-5, 60, m).astype(np.float64) if int_vals
         else rng.lognormal(0.5, 1, m))
    return (c[:, 0] if d == 1 else c), a


def assert_updatable_equal(tupd, jupd):
    for f in UPD_FIELDS:
        np.testing.assert_array_equal(getattr(tupd, f),
                                      np.asarray(getattr(jupd, f)),
                                      err_msg=f)
    assert tupd.total_rows == jupd.total_rows
    assert tupd.inserts_since_build == jupd.inserts_since_build
    assert tupd.staleness() == jupd.staleness()


@pytest.mark.parametrize("d,int_vals", [(1, True), (1, False), (3, False)])
def test_inserts_match_jax_array_for_array(d, int_vals):
    """The same 600 rows (a third outside every box) inserted one by one
    with seed 1: every array equal, reservoir slots included, and the
    reservoir draws went past the initial fill."""
    jsyn, _, _ = _setup(d, int_vals)
    jupd, tupd = JUpd(jsyn, seed=1), UpdatableSynopsis(carry(jsyn), seed=1)
    c, a = _rows(d, 600, int_vals)
    jupd.insert_batch(c, a)
    tupd.insert_batch(c, a)
    assert_updatable_equal(tupd, jupd)
    assert (tupd.seen > tupd.sample_c.shape[1]).any()
    tupd.insert(c[0], float(a[0]))
    jupd.insert(c[0], float(a[0]))
    assert_updatable_equal(tupd, jupd)


@pytest.mark.parametrize("d", [1, 3])
def test_snapshot_bits_and_answers_match_jax(d):
    jsyn, c0, _ = _setup(d, False)
    jupd, tupd = JUpd(jsyn, seed=1), UpdatableSynopsis(carry(jsyn), seed=1)
    c, a = _rows(d, 400, False, seed=2)
    jupd.insert_batch(c, a)
    tupd.insert_batch(c, a)
    jsnap, tsnap = jupd.snapshot(), tupd.snapshot()
    assert tsnap.device.type == "cpu"
    for f in SYN_FIELDS:
        want = np.asarray(getattr(jsnap, f))
        got = getattr(tsnap, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(tsnap.tree, f).numpy(),
                                      np.asarray(getattr(jsnap.tree, f)),
                                      err_msg=f"tree.{f}")
    c_all = np.concatenate([c0, c])
    jq = jquery.random_queries(c_all, 48, seed=3, min_frac=0.05,
                               max_frac=0.5 if d == 1 else 0.8)
    jres = JEngine(jsnap, JServing(kinds=KINDS), ci=0.95).answer(jq)
    tres = PassEngine(tsnap, ServingConfig(kinds=KINDS), ci=0.95,
                      device="cpu").answer(carry_queries(jq))
    assert_results_close(jres, tres, KINDS)


@pytest.mark.parametrize("d", [1, 3])
def test_to_streaming_matches_jax_bridge(d):
    """to_streaming() after per-row inserts: the port's StreamingIngestor
    (row 5, and row 7 in 3-D, in its plain versions here) ends in the
    reference bridge's state after the same batches, exact on integer
    values."""
    jsyn, _, _ = _setup(d, True)
    jupd, tupd = JUpd(jsyn, seed=1), UpdatableSynopsis(carry(jsyn), seed=1)
    c, a = _rows(d, 300, True, seed=4)
    jupd.insert_batch(c, a)
    tupd.insert_batch(c, a)
    jing, ting = jupd.to_streaming(seed=5), tupd.to_streaming(seed=5)
    assert ting.device.type == "cpu"
    rng = np.random.default_rng(6)
    for _ in range(3):
        cb = rng.uniform(-10, 110, (256, d)).astype(np.float32)
        ab = rng.integers(1, 40, 256).astype(np.float32)
        jing.ingest(cb, ab)
        ting.ingest(cb, ab)
    assert_state_matches(ting.state, jing.state)
    with pytest.raises(ValueError, match="backend must be None"):
        tupd.to_streaming(backend="pallas")


def test_reservoir_stratum_draws_match_jax():
    j, t = JReservoir(5, seed=3), ReservoirStratum(5, seed=3)
    rng = np.random.default_rng(0)
    for i in range(200):
        c, a = rng.uniform(0, 1, 2), float(rng.normal())
        assert t.insert(c, a) == j.insert(c, a), i
    assert t.seen == j.seen == 200
    np.testing.assert_array_equal(np.asarray(t.c), np.asarray(j.c))
    assert t.a == j.a


@pytest.mark.parametrize("kind", ["sum", "count", "avg"])
def test_dp_exact_matches_jax(kind):
    rng = np.random.default_rng(11)
    v = np.sort(rng.lognormal(0, 1, 28))
    for k, min_len in ((3, 1), (4, 2)):
        tc, tv = tdp.dp_exact(v, k, kind, min_len)
        jc, jv = jdp.dp_exact(v, k, kind, min_len)
        np.testing.assert_array_equal(tc, jc)
        assert tv == jv
