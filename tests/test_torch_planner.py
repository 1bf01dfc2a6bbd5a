"""The port's MCF planner and ``answer(plan=)`` against the JAX package's,
on the CPU.

``plan_queries`` is host numpy in both packages, so every field of the
plan must be equal: covered nodes, partial leaves, leaf masks, visited
counts and the float64 exact aggregates. It must also match the recursive
``mcf_reference`` node for node. Served answers from a plan meet
``test_torch_engine.py``'s tolerances.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.api import (PassEngine as JEngine, ServingConfig as JServing,
                       CIConfig as JCI)
from repro.core import partition_tree as jpt
from repro.core import query as jquery
from repro.core.synopsis import build_synopsis as jbuild
from repro.engine import planner as jplanner
from repro_torch.api import PassEngine, ServingConfig, CIConfig
from repro_torch.core import partition_tree as tpt
from repro_torch.core.types import QueryBatch
from repro_torch.engine import executor, planner
from repro_torch.kernels import ops
from test_torch_engine import (KINDS, _data, assert_results_close, carry,
                               carry_queries)

PLAN_ARRAYS = ("cover_leaf_mask", "partial_leaf_mask", "exact_agg",
               "visited", "frontier_size")


def assert_plans_equal(jplan, tplan, tree, q_lo, q_hi, zv=False):
    """Field for field against the JAX plan, and node for node against
    the port's recursive mcf_reference."""
    assert tplan.num_leaves == jplan.num_leaves
    for f in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(tplan, f), getattr(jplan, f),
                                      err_msg=f)
    leaf_id = tree.leaf_id.numpy()
    for q in range(q_lo.shape[0]):
        assert tplan.covered_nodes[q].tolist() == \
            jplan.covered_nodes[q].tolist()
        assert tplan.partial_leaves[q].tolist() == \
            jplan.partial_leaves[q].tolist()
        cov, par, visited = tpt.mcf_reference(tree, q_lo[q], q_hi[q],
                                              zero_variance_rule=zv)
        assert sorted(cov) == tplan.covered_nodes[q].tolist(), q
        assert visited == tplan.visited[q], q
        if not zv:
            assert sorted(int(leaf_id[v]) for v in par) == \
                tplan.partial_leaves[q].tolist(), q


@pytest.fixture(scope="module")
def synopses():
    """{name: (jax synopsis, port synopsis, q_lo, q_hi)}: 1-D at k = 13
    and 16 (13 pads the tree to 16 slots), kd in 2-D."""
    out = {}
    for name, d, k, method in (("1d-k13", 1, 13, "eq"),
                               ("1d-k16", 1, 16, "eq"),
                               ("kd-2d", 2, 12, "kd")):
        c, a = _data(d, 3000, seed=k + d)
        jsyn, _ = jbuild(c, a, k=k, sample_rate=0.05, method=method, seed=1)
        jq = jquery.random_queries(c, 8, seed=k, min_frac=0.05,
                                   max_frac=0.6)
        out[name] = (jsyn, carry(jsyn), np.asarray(jq.lo),
                     np.asarray(jq.hi))
    return out


@pytest.mark.parametrize("zv", [False, True])
@pytest.mark.parametrize("name", ["1d-k13", "1d-k16", "kd-2d"])
def test_plan_queries_matches_jax_and_reference(synopses, name, zv):
    jsyn, tsyn, q_lo, q_hi = synopses[name]
    jplan = jplanner.plan_queries(jsyn.tree, q_lo, q_hi, jsyn.num_leaves,
                                  zero_variance_rule=zv)
    tplan = planner.plan_queries(tsyn.tree, torch.tensor(q_lo),
                                 torch.tensor(q_hi), tsyn.num_leaves,
                                 zero_variance_rule=zv)
    assert_plans_equal(jplan, tplan, tsyn.tree, q_lo, q_hi, zv)


def test_padded_leaves_never_reach_consumers():
    """k = 11 pads the tree to 16 slots; padded slots carry leaf_id -1 and
    appear in no frontier, in either package."""
    k = 11
    lo = np.arange(k, dtype=np.float64)[:, None] + 0.1
    hi = lo + 0.8
    agg = np.tile([1.0, 1.0, 1.0, 0.0, 1.0], (k, 1))
    jtree = jpt.build_tree_from_leaves(agg, lo, hi)
    ttree = tpt.build_tree_from_leaves(agg, lo, hi)
    leaf_id = ttree.leaf_id.numpy()
    assert (leaf_id[ttree.left.numpy() < 0] == -1).sum() == 5
    q_lo = np.array([[-1.0], [2.5], [3.0]])
    q_hi = np.array([[100.0], [7.2], [9.95]])
    jplan = jplanner.plan_queries(jtree, q_lo, q_hi, k)
    tplan = planner.plan_queries(ttree, q_lo, q_hi, k)
    assert_plans_equal(jplan, tplan, ttree, q_lo, q_hi)
    assert tplan.covered_nodes[0].tolist() == [0]
    assert tplan.cover_leaf_mask.shape == (3, k)
    assert tplan.cover_leaf_mask[0].all()
    assert tplan.partial_leaf_mask[1].sum() == 2


CI_CASES = {
    "plain": None,
    "clt": dict(level=0.95),
    "bootstrap": dict(level=0.9, method="bootstrap", n_boot=12),
}


@pytest.mark.parametrize("case", sorted(CI_CASES))
def test_answer_with_plan_matches_jax(synopses, case, monkeypatch):
    """answer(plan=) against the JAX engine's for plain, CLT and bootstrap
    serving; the port classifies nothing: query_eval is never called."""
    jsyn, tsyn, q_lo, q_hi = synopses["1d-k13"]
    kinds = KINDS if CI_CASES[case] is None or case == "clt" else \
        ("sum", "count", "avg")
    jci = tci = None
    if CI_CASES[case] is not None:
        jci = JCI(**CI_CASES[case], **(
            {"key": jax.random.PRNGKey(3)} if case == "bootstrap" else {}))
        tci = CIConfig(**CI_CASES[case], **(
            {"key": np.asarray(jax.random.PRNGKey(3))}
            if case == "bootstrap" else {}))
    jq = jquery.QueryBatch(jnp.asarray(q_lo, jnp.float32),
                           jnp.asarray(q_hi, jnp.float32))
    tq = carry_queries(jq)
    jplan = jplanner.plan_queries(jsyn.tree, q_lo, q_hi, jsyn.num_leaves)
    tplan = planner.plan_queries(tsyn.tree, tq.lo, tq.hi, tsyn.num_leaves)
    jres = JEngine(jsyn, JServing(kinds=kinds), ci=jci).answer(jq,
                                                               plan=jplan)

    def refuse(*args, **kwargs):
        raise AssertionError("query_eval called on the planner path")

    monkeypatch.setattr(ops, "query_eval", refuse)
    eng = PassEngine(tsyn, ServingConfig(kinds=kinds), ci=tci, device="cpu")
    tres = eng.answer(tq, plan=tplan)
    assert_results_close(jres, tres, kinds)
    assert eng.stats()["misses"] == 1
    eng.answer(tq, plan=tplan)
    assert eng.stats()["hits"] == 1


def test_plan_entries_keyed_apart_and_rekeyed(synopses):
    """Plan-carrying calls have their own cache slot; a prepared plan
    entry refuses calls without masks, and a batch of another shape is
    re-keyed on its own shape (a counted miss)."""
    _, tsyn, q_lo, q_hi = synopses["1d-k16"]
    tq = QueryBatch(torch.tensor(q_lo), torch.tensor(q_hi))
    lo, hi = tq.lo, tq.hi
    plan = planner.plan_queries(tsyn.tree, lo, hi, tsyn.num_leaves)
    eng = PassEngine(tsyn, ServingConfig(kinds=("sum",)), ci=0.95,
                     device="cpu")
    with_plan = eng.answer(tq, plan=plan)["sum"]
    without = eng.answer(tq)["sum"]
    assert eng.stats()["misses"] == 2 and eng.stats()["entries"] == 2
    # The plan's masks and query_eval's classification agree on these
    # queries, so the two answers agree too.
    torch.testing.assert_close(with_plan.estimate, without.estimate,
                               rtol=3e-5, atol=1e-3)
    entry = eng._lookup(tuple(tq.lo.shape), eng.serving, eng.ci,
                        has_plan=True)
    with pytest.raises(ValueError, match="has_plan=True"):
        entry(tq)
    half = QueryBatch(tq.lo[:4], tq.hi[:4])
    half_plan = planner.plan_queries(tsyn.tree, half.lo, half.hi,
                                     tsyn.num_leaves)
    masks = executor.plan_to_masks(half_plan, "cpu")
    res = entry(half, masks)["sum"]
    assert res.estimate.shape == (4,)
    assert eng.stats()["misses"] == 3
    with pytest.raises(ValueError, match="plan masks"):
        eng.answer(tq, plan=half_plan)          # a plan of another batch


def test_relation_masks_cached_once(synopses):
    _, tsyn, q_lo, q_hi = synopses["kd-2d"]
    tq = QueryBatch(torch.tensor(q_lo), torch.tensor(q_hi))
    planner.clear_relation_cache()
    executor.reset_op_counts()
    rel = planner.relation_masks(tsyn, tq)
    assert planner.relation_masks(tsyn, tq) is rel
    assert executor.OP_COUNTS["classify"] == 1
    want, _ = ops.query_eval(tsyn.leaf_lo, tsyn.leaf_hi, tsyn.leaf_agg,
                             tq.lo, tq.hi)
    assert torch.equal(rel, want)
    planner.clear_relation_cache()
