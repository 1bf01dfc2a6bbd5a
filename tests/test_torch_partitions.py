"""The port's partition tier (``repro_torch.partitions``, DESIGN.md §14)
against the JAX package's ``repro.partitions``, on the CPU.

Exact: ``build_catalog``, the picker's ``Selection`` (cover, overlap, pi,
picked, weights), the partition synopses, their pad blocks and the
stacked pseudo-synopsis, and ``partition_stats``' row counts, histograms
and MIN/MAX (bit for bit, ±0.0 and masked rows included). Within rtol
3e-5 / atol 1e-3: the sketch sums, ``compose_two_stage`` and the catalog
answers' estimates and bounds; the answers' interval fields (ci_half,
ci_lo, ci_hi) within ``tests/test_torch_engine.py``'s interval bar,
rtol 1e-4 with atol 1e-4 of the batch's largest estimate (at least
1e-3): the AVG variance is a difference of fp32 sums and amplifies the
moment kernel's last-bit differences. Within the port: the dense tier is
bit-equal to the flat build, a short batch to the same rows of a padded
one, and the engine's pruning, LRU, plan-cache and error paths behave as
``tests/test_partitions.py`` pins them for the reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from conftest import given, settings, st

from repro.api import (PassEngine as JEngine, CatalogConfig as JCatalog,
                       ServingConfig as JServing)
from repro.core.types import QueryBatch as JBatch
from repro.partitions import (build_catalog as jbuild_catalog,
                              partition_stats as jpartition_stats,
                              combine_catalogs as jcombine,
                              empty_catalog as jempty_catalog,
                              global_bin_edges as jedges,
                              pick_partitions as jpick,
                              stack_synopses as jstack,
                              CatalogSource as JSource,
                              PartitionStore as JStore)
from repro.partitions.executor import _catalog_answer_jit
from repro.uncertainty.intervals import compose_two_stage as jtwo_stage
from repro_torch.api import (PassEngine, CatalogConfig, CIConfig,
                             ServingConfig)
from repro_torch.core.synopsis import build_synopsis
from repro_torch.core.types import QueryBatch, AGG_MAX
from repro_torch.partitions import (build_catalog, partition_stats,
                                    combine_catalogs, empty_catalog,
                                    global_bin_edges, pick_partitions,
                                    classify_partitions, waterfill_pi,
                                    stack_synopses, empty_partition_synopsis,
                                    partition_rows, CatalogSource,
                                    PartitionStore)
from repro_torch.partitions.executor import catalog_answer
from repro_torch.uncertainty.intervals import compose_two_stage

CAT_FIELDS = ("n", "col_lo", "col_hi", "col_sum", "col_sumsq", "hist",
              "m_agg", "bin_lo", "bin_hi")
SYN_FIELDS = ("leaf_lo", "leaf_hi", "leaf_agg", "n_rows", "sample_c",
              "sample_a", "sample_valid", "k_per_leaf", "total_rows")
TREE_FIELDS = ("lo", "hi", "agg", "left", "right", "leaf_id", "level")
FIELDS = ("estimate", "lower", "upper", "frac_rows_touched")
CI_FIELDS = ("ci_half", "ci_lo", "ci_hi")
KINDS = ("sum", "count", "avg")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(x):
    """int32 view of a float32 array: equal iff bit-equal (+0.0 != -0.0)."""
    return np.ascontiguousarray(_np(x), np.float32).view(np.int32)


def _clustered_parts(num_partitions=16, rows=500, gap=10.0, span=8.0,
                     seed=0):
    """Disjoint per-partition supports: partition p covers [gap*p,
    gap*p + span]."""
    rng = np.random.default_rng(seed)
    return [(rng.uniform(gap * p, gap * p + span, size=rows),
             rng.normal(p, 1.0, size=rows)) for p in range(num_partitions)]


def _overlapping_parts(P=32, rows=400, seed=5, d=1, empty=()):
    """Overlapping supports (the messy lake): range queries cut many
    partitions, so the importance-sampling stage is real. Partitions in
    ``empty`` hold no rows."""
    rng = np.random.default_rng(seed)
    parts = []
    for p in range(P):
        lo = rng.uniform(0, 80, size=d)
        n = 0 if p in empty else rows
        c = rng.uniform(lo, lo + 20, size=(n, d))
        a = rng.gamma(2.0, 1.0, size=n) * (1 + p % 5)
        parts.append((c[:, 0] if d == 1 else c, a))
    return parts


def _queries(rng, q, d=1, lo=0.0, hi=60.0, width=(5.0, 40.0)):
    ql = rng.uniform(lo, hi, (q, d))
    qh = ql + rng.uniform(*width, (q, d))
    return ql, qh


def _both(ql, qh):
    return (JBatch(jnp.asarray(ql, jnp.float32), jnp.asarray(qh, jnp.float32)),
            QueryBatch(torch.tensor(ql, dtype=torch.float32),
                       torch.tensor(qh, dtype=torch.float32)))


def assert_catalog_equal(jcat, tcat, exact=CAT_FIELDS):
    assert (tcat.num_partitions, tcat.d, tcat.bins) == \
        (jcat.num_partitions, jcat.d, jcat.bins)
    for f in CAT_FIELDS:
        j, t = _np(getattr(jcat, f)), _np(getattr(tcat, f))
        assert t.dtype == np.float32 and t.shape == j.shape, f
        if f in exact:
            np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=f)
        else:
            np.testing.assert_allclose(t, j, rtol=3e-5, atol=1e-3,
                                       err_msg=f)


def assert_answers_close(jres, tres, kinds=KINDS):
    """Estimates and bounds within rtol 3e-5 / atol 1e-3; interval fields
    within the engine's interval bar (module docstring)."""
    assert set(jres) == set(tres) == set(kinds)
    for kind in kinds:
        j, t = jres[kind], tres[kind]
        scale = float(np.max(np.abs(np.asarray(j.estimate))))
        for field, rtol, atol in ([(f, 3e-5, 1e-3) for f in FIELDS]
                                  + [(f, 1e-4, max(1e-3, 1e-4 * scale))
                                     for f in CI_FIELDS]):
            jv, tv = getattr(j, field), getattr(t, field)
            if jv is None:
                assert tv is None, (kind, field)
                continue
            assert tv.dtype == torch.float32, (kind, field)
            np.testing.assert_allclose(
                tv.numpy().astype(np.float64), np.asarray(jv, np.float64),
                rtol=rtol, atol=atol, err_msg=f"{kind}.{field}")


def assert_same_bits(got, want):
    assert set(got) == set(want)
    for kind in want:
        for f in FIELDS + CI_FIELDS:
            g, w = getattr(got[kind], f), getattr(want[kind], f)
            assert (g is None) == (w is None), (kind, f)
            if g is not None:
                np.testing.assert_array_equal(_bits(g), _bits(w),
                                              err_msg=f"{kind}.{f}")


# ---------------------------------------------------------------------------
# Catalog sketches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 3])
def test_build_catalog_exact(d):
    parts = _overlapping_parts(P=9, rows=300, d=d, empty=(4,))
    assert_catalog_equal(jbuild_catalog(parts, bins=8),
                         build_catalog(parts, bins=8, device="cpu"))
    lo, hi = global_bin_edges(parts)
    jlo, jhi = jedges(parts)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    cat = build_catalog(parts, bins=8, bin_lo=lo - 1, bin_hi=hi + 1,
                        device="cpu")
    assert_catalog_equal(
        jbuild_catalog(parts, bins=8, bin_lo=lo - 1, bin_hi=hi + 1), cat)
    assert cat.total_rows == jbuild_catalog(parts, bins=8).total_rows == \
        8 * 300


def _stats_case(case):
    """(c, a, pid, P, mask, d) of one partition_stats case."""
    rng = np.random.default_rng(3)
    n, P = 3000, 7
    d = 3 if case == "3d" else 1
    c = rng.uniform(0, 100, size=(n, d)).astype(np.float32)
    a = rng.integers(-20, 80, size=n).astype(np.float32)
    pid = rng.integers(0, P - 2, size=n).astype(np.int32)  # 5, 6 empty
    mask = None
    if case == "masked":
        mask = rng.random(n) < 0.7
        pid[~mask & (rng.random(n) < 0.5)] = 6      # masked rows only
    if case == "zeros":
        # Every partition's values and coordinates are +-0.0 in mixed order.
        a = np.where(rng.random(n) < 0.5, 0.0, -0.0).astype(np.float32)
        c[: n // 2] = np.where(rng.random((n // 2, d)) < 0.5, 0.0, -0.0)
    if case == "outside":
        c[::7] = rng.uniform(-500, 600, size=(len(c[::7]), d))
    return c, a, pid, P, mask, d


@pytest.mark.parametrize("case", ["1d", "3d", "masked", "zeros", "outside"])
def test_partition_stats_matches_jax(case):
    c, a, pid, P, mask, d = _stats_case(case)
    kw = dict(bins=8, bin_lo=np.zeros(d), bin_hi=np.full(d, 100.0))
    jcat = jpartition_stats(c, a, pid, P, mask=mask, **kw)
    tcat = partition_stats(torch.tensor(c), torch.tensor(a),
                           torch.tensor(pid), P,
                           mask=None if mask is None else torch.tensor(mask),
                           **kw)
    assert tcat.device.type == "cpu"
    # Sums within tolerance; counts, histograms, boxes, MIN/MAX bit for bit.
    assert_catalog_equal(jcat, tcat, exact=("n", "col_lo", "col_hi", "hist",
                                            "bin_lo", "bin_hi"))
    jm, tm = _np(jcat.m_agg), _np(tcat.m_agg)
    np.testing.assert_array_equal(_bits(tm[:, 2:]), _bits(jm[:, 2:]))
    assert np.all(_np(tcat.col_lo)[5:] == np.inf)
    assert np.all(tm[5:, AGG_MAX] == -np.inf)
    # Arrays go to the device asked for; the same pass.
    acat = partition_stats(c, a, pid, P, mask=mask, device="cpu", **kw)
    for f in CAT_FIELDS:
        assert torch.equal(getattr(acat, f), getattr(tcat, f)), f


def test_combine_catalogs_matches_jax():
    """combine over row splits == the JAX combine (MIN/MAX bits of ±0.0
    included), and == one pass on counts, boxes and histograms."""
    c, a, pid, P, _mask, d = _stats_case("zeros")
    kw = dict(bins=8, bin_lo=np.zeros(d), bin_hi=np.full(d, 100.0))
    h = len(a) // 3
    spans = [slice(0, h), slice(h, 2 * h), slice(2 * h, None)]
    jparts = [jpartition_stats(c[s], a[s], pid[s], P, **kw) for s in spans]
    tparts = [partition_stats(c[s], a[s], pid[s], P, device="cpu", **kw)
              for s in spans]
    jm = jcombine(jcombine(jparts[0], jparts[1]), jparts[2])
    tm = combine_catalogs(combine_catalogs(tparts[0], tparts[1]), tparts[2])
    assert_catalog_equal(jm, tm, exact=("n", "col_lo", "col_hi", "hist"))
    np.testing.assert_array_equal(_bits(_np(tm.m_agg)[:, 2:]),
                                  _bits(_np(jm.m_agg)[:, 2:]))
    whole = partition_stats(c, a, pid, P, device="cpu", **kw)
    for f in ("n", "col_lo", "col_hi", "hist"):
        assert torch.equal(getattr(whole, f), getattr(tm, f)), f
    ident = empty_catalog(P, d, 8, kw["bin_lo"], kw["bin_hi"], device="cpu")
    assert_catalog_equal(jempty_catalog(P, d, 8, kw["bin_lo"], kw["bin_hi"]),
                         ident)
    back = combine_catalogs(whole, ident)
    for f in CAT_FIELDS:
        np.testing.assert_array_equal(_bits(getattr(back, f)),
                                      _bits(getattr(whole, f)), err_msg=f)
    with pytest.raises(ValueError, match="catalog shapes differ"):
        combine_catalogs(whole, empty_catalog(P + 1, d, 8, kw["bin_lo"],
                                              kw["bin_hi"], device="cpu"))


def test_combine_catalogs_signed_zero_ties():
    """Boxes and MIN/MAX whose two halves meet at +0.0 and -0.0, in both
    orders: -0.0 wins the MIN, +0.0 the MAX, as the reference's."""
    z = np.float32(0.0)
    c1 = np.array([[z], [-z], [-z], [z]], np.float32)
    c2 = np.array([[-z], [z], [z], [-z]], np.float32)
    pid = np.array([0, 1, 2, 3], np.int32)
    kw = dict(bins=4, bin_lo=np.full(1, -1.0), bin_hi=np.full(1, 1.0))
    for x, y in ((c1, c2), (c2, c1)):
        jm = jcombine(jpartition_stats(x, x[:, 0], pid, 4, **kw),
                      jpartition_stats(y, y[:, 0], pid, 4, **kw))
        tm = combine_catalogs(
            partition_stats(x, x[:, 0], pid, 4, device="cpu", **kw),
            partition_stats(y, y[:, 0], pid, 4, device="cpu", **kw))
        assert_catalog_equal(jm, tm)


# ---------------------------------------------------------------------------
# The picker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget,d", [(None, 1), (5, 1), (12, 1), (3, 3)])
def test_selection_exact_against_jax(budget, d):
    parts = _overlapping_parts(P=24, rows=200, d=d, empty=(7,))
    jcat = jbuild_catalog(parts, bins=16)
    tcat = build_catalog(parts, bins=16, device="cpu")
    rng = np.random.default_rng(d)
    ql, qh = _queries(rng, 10, d)
    for seed in range(3):
        js = jpick(jcat, ql, qh, budget=budget, seed=seed)
        ts = pick_partitions(tcat, ql, qh, budget=budget, seed=seed)
        for f in ("cover", "overlap", "pi", "picked", "weights"):
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f),
                                          err_msg=f)
        assert ts.seed == js.seed == seed


def test_classify_and_waterfill():
    parts = _clustered_parts(8, rows=100, seed=9)
    cat = build_catalog(parts, bins=8, device="cpu")
    cover, overlap = classify_partitions(cat, np.array([[5.0]]),
                                         np.array([[45.0]]))
    assert set(np.flatnonzero(cover[0])) == {1, 2, 3}
    assert set(np.flatnonzero(overlap[0])) == {0, 4}
    w = np.array([10.0, 1.0, 0.0, 5.0, 1e4])
    pi = waterfill_pi(w, budget=2, pi_floor=0.05)
    assert pi[2] == 0.0 and pi[4] == 1.0
    assert np.all(pi[[0, 1, 3]] >= 0.05) and np.all(pi <= 1.0)
    assert 1.9 <= pi.sum() <= 3.0
    np.testing.assert_array_equal(waterfill_pi(w, budget=4) > 0, w > 0)


def test_selection_records_pi_for_covered():
    parts = _clustered_parts(8, rows=100, seed=10)
    sel = pick_partitions(build_catalog(parts, bins=8, device="cpu"),
                          np.array([[5.0]]), np.array([[45.0]]), budget=1,
                          seed=0)
    for p in (1, 2, 3):
        assert sel.pi[p] == 1.0 and not sel.picked[p]
    assert not np.any(sel.picked & ~sel.overlap.any(axis=0))


# ---------------------------------------------------------------------------
# Partition synopses, pad blocks and the stack
# ---------------------------------------------------------------------------

def assert_synopsis_equal(jsyn, tsyn):
    assert (tsyn.num_leaves, tsyn.d) == (jsyn.num_leaves, jsyn.d)
    for f in SYN_FIELDS:
        j, t = np.asarray(getattr(jsyn, f)), _np(getattr(tsyn, f))
        assert t.dtype == j.dtype and t.shape == j.shape, f
        np.testing.assert_array_equal(t, j, err_msg=f)
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tsyn.tree, f)),
                                      np.asarray(getattr(jsyn.tree, f)),
                                      err_msg=f"tree.{f}")


@pytest.mark.parametrize("method,d", [("eq", 1), ("adp", 1), ("kd", 3)])
def test_partition_synopses_and_stack_exact(method, d):
    """Each partition's synopsis (kd ones padded to k, an empty partition's
    pad block) and the stack of 1-5 of them with 0-3 pad blocks."""
    parts = _overlapping_parts(P=6, rows=150, d=d, empty=(2,))
    kw = dict(k=8, s_per_leaf=6, method=method, seed=4)
    js = JSource(JStore(parts), JCatalog(**kw))
    ts = CatalogSource(PartitionStore(parts), CatalogConfig(**kw),
                       device="cpu")
    jsyns = [js._build_one(p) for p in range(6)]
    tsyns = [ts._build_one(p) for p in range(6)]
    for jsyn, tsyn in zip(jsyns, tsyns):
        assert_synopsis_equal(jsyn, tsyn)
    for n_sel, pad_to in ((1, 1), (2, 4), (3, 4), (5, 8), (0, 1)):
        assert_synopsis_equal(jstack(jsyns[:n_sel], pad_to, 8, 6, d),
                              stack_synopses(tsyns[:n_sel], pad_to, 8, 6, d,
                                             device="cpu"))
    with pytest.raises(ValueError, match="pad_to"):
        stack_synopses(tsyns, 4, 8, 6, d, device="cpu")
    empty = empty_partition_synopsis(8, 6, d, device="cpu")
    assert_synopsis_equal(jsyns[2], empty)


# ---------------------------------------------------------------------------
# The two-stage composition and the catalog answer
# ---------------------------------------------------------------------------

def test_compose_two_stage_matches_jax():
    rng = np.random.default_rng(2)
    Q, P = 9, 6
    t_hat = rng.normal(50, 30, (Q, P)).astype(np.float32)
    v = rng.gamma(2.0, 40.0, (Q, P)).astype(np.float32)
    h = np.where(rng.random((Q, P)) < 0.3, rng.gamma(2, 5, (Q, P)),
                 0).astype(np.float32)
    pi = np.array([1.0, 0.5, 0.05, 0.9, 0.0, 1.0], np.float32)
    mask = (rng.random((Q, P)) < 0.6).astype(np.float32)
    mask[0] = 0.0                         # a query served exactly
    z = np.float32(1.96)
    jout = jtwo_stage(*(jnp.asarray(x) for x in (t_hat, v, h, pi, mask)), z)
    tout = compose_two_stage(*(torch.tensor(x)
                               for x in (t_hat, v, h, pi, mask)),
                             torch.tensor(z))
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=3e-5,
                                   atol=1e-3)
    assert float(tout[1][0]) == 0.0 and float(tout[0][0]) == 0.0


def _sources(parts, **kw):
    return (JSource(JStore(parts), JCatalog(**kw)),
            CatalogSource(PartitionStore(parts), CatalogConfig(**kw),
                          device="cpu"))


@pytest.mark.parametrize("level", [None, 0.95])
@pytest.mark.parametrize("degraded", [False, True])
def test_catalog_answer_matches_jax(level, degraded):
    """One stage each (the same selection: 5 picked partitions, 3 pad
    blocks), then the reference's compiled entry against catalog_answer;
    with a degraded partition the overlapping queries take the envelope."""
    parts = _overlapping_parts(P=32, rows=400)
    js, ts = _sources(parts, k=4, s_per_leaf=16, max_partitions=5, seed=11)
    if degraded:
        js._degraded = {3}
        ts._degraded = {3}
    rng = np.random.default_rng(7)
    jq, tq = _both(*_queries(rng, 24))
    for draw in range(3):
        jargs = js.stage(jq, 2.576)
        targs = ts.stage(tq, 2.576)
        assert targs[0].num_leaves == jargs[0].num_leaves
        assert (targs[9] is None) == (not degraded)
        if degraded:
            np.testing.assert_array_equal(targs[9].numpy(),
                                          np.asarray(jargs[9]))
        statics = dict(kinds=KINDS, k_part=4, level=level,
                       small_n_threshold=12, use_fpc=True,
                       delta_budget="stratum")
        jres = _catalog_answer_jit(*jargs, backend_name="jnp", **statics)
        tres = catalog_answer(*targs, **statics)
        assert_answers_close(jres, tres)
    assert ts.stats()["materialized_ids"] == \
        js.stats()["materialized_ids"]


@pytest.mark.parametrize("level", [None, 0.95])
def test_catalog_answer_zero_values_match_jax_bits(level):
    """Every measure value +-0.0: the answers, bounds and intervals are
    zeros whose signs are the reference's (the max0 / min0 / clip rules),
    with a degraded partition's envelope too."""
    rng = np.random.default_rng(9)
    parts = [(c, np.where(rng.random(c.shape[0]) < 0.5, 0.0, -0.0))
             for c, _ in _overlapping_parts(P=12, rows=200)]
    js, ts = _sources(parts, k=4, s_per_leaf=16, max_partitions=5, seed=2)
    js._degraded = {1}
    ts._degraded = {1}
    jq, tq = _both(*_queries(rng, 16))
    statics = dict(kinds=KINDS, k_part=4, level=level, small_n_threshold=12,
                   use_fpc=True, delta_budget="stratum")
    for _ in range(2):
        jres = _catalog_answer_jit(*js.stage(jq, 2.576), backend_name="jnp",
                                   **statics)
        tres = catalog_answer(*ts.stage(tq, 2.576), **statics)
        want = {k: type(tres[k])(**{
            f: None if getattr(r, f) is None else torch.tensor(np.asarray(
                getattr(r, f))) for f in r.__dataclass_fields__})
            for k, r in jres.items()}
        # SUM and AVG are zeros (AVG's bounds the partitions' MIN / MAX):
        # bit for bit. COUNT is not zero: within the tolerances.
        for kind, fields in (("sum", FIELDS[:3] + CI_FIELDS),
                             ("avg", ("estimate", "lower", "upper",
                                      "ci_lo", "ci_hi"))):
            for f in fields:
                g, w = getattr(tres[kind], f), getattr(want[kind], f)
                assert (g is None) == (w is None) == (
                    level is None and f in ("ci_lo", "ci_hi"))
                if w is not None:
                    assert not torch.any(w != 0)
                    np.testing.assert_array_equal(_bits(g), _bits(w),
                                                  err_msg=f"{kind}.{f}")
        assert_answers_close(jres, tres)


@pytest.mark.parametrize("level,budget,delta", [
    (None, 5, "stratum"), (0.95, 5, "stratum"), (0.9, 12, "union"),
    (0.95, 6, "stratum")])
def test_engine_from_catalog_matches_jax(level, budget, delta):
    """PassEngine.from_catalog in both packages: every answer draws the
    same selection and the answers agree (3-D kd partitions for the last
    case)."""
    d = 3 if budget == 6 else 1
    parts = _overlapping_parts(P=20, rows=300, d=d)
    kw = dict(k=4, s_per_leaf=12, max_partitions=budget, seed=3,
              method="kd" if d == 3 else "eq")
    ci = None if level is None else CIConfig(level=level,
                                             delta_budget=delta)
    from repro.api import CIConfig as JCI
    jci = None if level is None else JCI(level=level, delta_budget=delta)
    je = JEngine.from_catalog(parts, catalog=JCatalog(**kw),
                              serving=JServing(kinds=KINDS), ci=jci)
    te = PassEngine.from_catalog(parts, catalog=CatalogConfig(**kw),
                                 serving=ServingConfig(kinds=KINDS), ci=ci,
                                 device="cpu")
    rng = np.random.default_rng(1)
    jq, tq = _both(*_queries(rng, 20, d, width=(10.0, 50.0)))
    for _ in range(3):
        assert_answers_close(je.answer(jq), te.answer(tq))
    jst, tst = je.stats()["catalog"], te.stats()["catalog"]
    for key in ("materialized", "hits", "evictions", "served_batches",
                "resident", "materialized_ids"):
        assert tst[key] == jst[key], key


def test_short_batch_served_at_min_rows():
    """A Q = 8 batch (bench_partitions' size) agrees with the JAX engine
    and is bit-equal to the same rows of the batch padded with empty
    queries to 16 (the padded operands keep the selection of the real
    rows)."""
    parts = _clustered_parts(24, rows=300, seed=2)
    rng = np.random.default_rng(4)
    starts = rng.integers(0, 20, size=8)
    ql = (10.0 * starts + rng.uniform(5.5, 7.5, 8))[:, None]
    qh = (10.0 * (starts + 3) + rng.uniform(0.5, 2.5, 8))[:, None]
    kw = dict(k=4, s_per_leaf=16, max_partitions=5, seed=0)
    sv = ServingConfig(kinds=KINDS)
    te = PassEngine.from_catalog(parts, catalog=CatalogConfig(**kw),
                                 serving=sv, ci=0.95, device="cpu")
    je = JEngine.from_catalog(parts, catalog=JCatalog(**kw),
                              serving=JServing(kinds=KINDS), ci=0.95)
    jq, tq = _both(ql, qh)
    short = te.answer(tq)
    assert short["sum"].estimate.shape == (8,)
    assert_answers_close(je.answer(jq), short)
    pad = QueryBatch(torch.cat([tq.lo, torch.full((8, 1), 3.0e38)]),
                     torch.cat([tq.hi, torch.full((8, 1), -3.0e38)]))
    te2 = PassEngine.from_catalog(parts, catalog=CatalogConfig(**kw),
                                  serving=sv, ci=0.95, device="cpu")
    full = te2.answer(pad)
    assert_same_bits(short, {k: type(r)(**{
        f: None if getattr(r, f) is None else getattr(r, f)[:8]
        for f in r.__dataclass_fields__}) for k, r in full.items()})
    assert te.stats()["catalog"]["materialized_ids"] == \
        te2.stats()["catalog"]["materialized_ids"]


# ---------------------------------------------------------------------------
# Dense (p = 1) bit-identity with the flat build
# ---------------------------------------------------------------------------

def test_dense_path_bit_identity():
    rng = np.random.default_rng(7)
    c = rng.normal(size=6000)
    a = rng.gamma(2.0, 1.0, size=6000)
    build_kw = dict(k=16, sample_budget=256, method="eq", seed=3)
    syn, _ = build_synopsis(c, a, device="cpu", **build_kw)
    sv = ServingConfig(kinds=("sum", "count", "avg"))
    eng_flat = PassEngine(syn, serving=sv, ci=0.95, device="cpu")
    eng_cat = PassEngine.from_catalog(partition_rows(c, a, 8), serving=sv,
                                      ci=0.95, device="cpu", **build_kw)
    assert not eng_cat._catalog_selective()
    q = QueryBatch(torch.tensor(rng.normal(size=(5, 1)) - 1,
                                dtype=torch.float32),
                   torch.tensor(rng.normal(size=(5, 1)) + 1,
                                dtype=torch.float32))
    assert_same_bits(eng_flat.answer(q), eng_cat.answer(q))
    assert_same_bits(eng_flat.answer(q, ci=None),
                     eng_cat.answer(q, ci=None))
    assert "catalog" in eng_cat.stats()


@given(seed=st.integers(0, 2**31 - 1), num_partitions=st.integers(1, 12),
       k=st.integers(2, 24))
@settings(max_examples=8, deadline=None)
def test_dense_bit_identity_property(seed, num_partitions, k):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(200, 3000))
    c = rng.normal(size=n) * rng.uniform(0.5, 10)
    a = rng.gamma(2.0, 1.0, size=n)
    build_kw = dict(k=k, sample_budget=max(4 * k, 64), method="eq",
                    seed=seed % 1000)
    syn, _ = build_synopsis(c, a, device="cpu", **build_kw)
    eng_flat = PassEngine(syn, ci=0.95, device="cpu")
    eng_cat = PassEngine.from_catalog(partition_rows(c, a, num_partitions),
                                      ci=0.95, device="cpu", **build_kw)
    lo = rng.normal(size=(3, 1)) - rng.uniform(0.1, 2)
    q = QueryBatch(torch.tensor(lo, dtype=torch.float32),
                   torch.tensor(lo + rng.uniform(0.2, 4),
                                dtype=torch.float32))
    assert_same_bits(eng_flat.answer(q, kinds=("sum", "avg")),
                     eng_cat.answer(q, kinds=("sum", "avg")))


# ---------------------------------------------------------------------------
# The engine: pruning, coverage, LRU, plan cache, errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ci", [None, 0.95])
def test_exact_pruning_never_materializes_irrelevant(ci):
    parts = _clustered_parts(16, rows=500, seed=1)
    eng = PassEngine.from_catalog(
        parts, catalog=CatalogConfig(k=4, s_per_leaf=16, max_partitions=4,
                                     seed=2),
        serving=ServingConfig(kinds=("sum", "count")), ci=ci, device="cpu")
    # Partition p spans [10p, 10p+8]: [5, 45] cuts 0 and 4, covers 1..3.
    res = eng.answer(QueryBatch(torch.tensor([[5.0]]), torch.tensor([[45.0]])))
    ids = eng.stats()["catalog"]["materialized_ids"]
    assert set(ids) <= {0, 4} and len(ids) >= 1
    for kind in ("sum", "count"):
        r = res[kind]
        assert float(r.lower[0]) <= float(r.estimate[0]) <= float(r.upper[0])
    c_all = np.concatenate([c for c, _ in parts])
    a_all = np.concatenate([a for _, a in parts])
    rc = eng.answer(QueryBatch(torch.tensor([[10.0]]),
                               torch.tensor([[38.5]])))["sum"]
    mask = (c_all >= 10.0) & (c_all <= 38.5)
    np.testing.assert_allclose(float(rc.estimate[0]), a_all[mask].sum(),
                               rtol=1e-5)
    assert float(rc.ci_half[0]) == 0.0
    rd = eng.answer(QueryBatch(torch.tensor([[1000.0]]),
                               torch.tensor([[2000.0]])))["sum"]
    assert float(rd.estimate[0]) == 0.0 and float(rd.ci_half[0]) == 0.0
    assert set(eng.stats()["catalog"]["materialized_ids"]) <= {0, 4}


def test_two_stage_ci_coverage():
    parts = _overlapping_parts()
    c_all = np.concatenate([c for c, _ in parts])
    a_all = np.concatenate([a for _, a in parts])
    q_lo = np.array([[10.0], [35.0], [55.0], [22.0]])
    q_hi = np.array([[45.0], [70.0], [90.0], [77.0]])
    _, q = _both(q_lo, q_hi)
    truth = np.array([a_all[(c_all >= lo) & (c_all <= hi)].sum()
                      for (lo,), (hi,) in zip(q_lo, q_hi)])
    eng = PassEngine.from_catalog(
        parts, catalog=CatalogConfig(k=4, s_per_leaf=16, max_partitions=12,
                                     seed=11),
        serving=ServingConfig(kinds=("sum",)), ci=CIConfig(level=0.95),
        device="cpu")
    cov, rel = [], []
    for _ in range(40):
        r = eng.answer(q)["sum"]
        lo, hi, est = (r.ci_lo.double().numpy(), r.ci_hi.double().numpy(),
                       r.estimate.double().numpy())
        cov.append((truth >= lo) & (truth <= hi))
        rel.append(np.abs(est - truth) / truth)
    assert float(np.mean(cov)) >= 0.92
    assert float(np.median(rel)) < 0.5
    st_ = eng.stats()["catalog"]
    assert st_["served_batches"] == 40 and st_["hits"] > 0


def test_lru_eviction_accounting():
    parts = _overlapping_parts(P=16, rows=120, seed=12)
    eng = PassEngine.from_catalog(
        parts, catalog=CatalogConfig(k=2, s_per_leaf=8, max_partitions=6,
                                     max_resident=3, seed=1),
        serving=ServingConfig(kinds=("sum",)), ci=None, device="cpu")
    _, qa = _both(np.array([[5.0]]), np.array([[35.0]]))
    _, qb = _both(np.array([[60.0]]), np.array([[95.0]]))
    for _ in range(3):
        eng.answer(qa)
        eng.answer(qb)
    st_ = eng.stats()["catalog"]
    assert st_["resident"] <= max(3, st_["materialized"] - st_["evictions"])
    assert st_["evictions"] > 0 and st_["materialized"] > 3
    assert st_["resident"] == st_["materialized"] - st_["evictions"]


def test_catalog_error_paths():
    parts = _clustered_parts(4, rows=100, seed=13)
    eng = PassEngine.from_catalog(
        parts, catalog=CatalogConfig(max_partitions=2),
        serving=ServingConfig(kinds=("sum",)), device="cpu")
    _, q = _both(np.array([[5.0]]), np.array([[25.0]]))
    with pytest.raises(ValueError, match="catalog serving supports kinds"):
        eng.answer(q, kinds=("min",))
    with pytest.raises(ValueError, match="clt"):
        eng.answer(q, ci=CIConfig(level=0.9, method="bootstrap"))
    with pytest.raises(ValueError, match="plan="):
        eng.answer(q, plan=object())
    with pytest.raises(ValueError, match="deadline_ms"):
        eng.answer(q, deadline_ms=5.0)
    with pytest.raises(ValueError, match="progressive refinement"):
        eng.answer_progressive(q)
    with pytest.raises(ValueError, match="sample_slots"):
        eng.answer(q, serving=ServingConfig(sample_slots=4))
    with pytest.raises(ValueError, match="stage"):
        eng.source.as_synopsis()
    with pytest.raises(ValueError, match="has_plan"):
        eng.prepare(q)(q, plan_masks=(1, 2, 3))
    eng2 = PassEngine.from_catalog(
        parts, catalog=CatalogConfig(max_partitions=2),
        serving=ServingConfig(kinds=("sum", "min", "avg")), device="cpu")
    assert set(eng2.answer(q)) == {"sum", "avg"}
    for bad in (dict(max_partitions=0), dict(pi_floor=0.0), dict(k=0),
                dict(method="zz"), dict(bins=1), dict(max_resident=0)):
        with pytest.raises(ValueError):
            CatalogConfig(**bad).validate()
    assert CatalogConfig().cache_key() == JCatalog().cache_key()
    with pytest.raises(ValueError):
        PartitionStore([])
    with pytest.raises(ValueError, match="dims disagree"):
        PartitionStore([(np.zeros((2, 1)), np.zeros(2)),
                        (np.zeros((2, 2)), np.zeros(2))])


def test_prepared_catalog_plan_cache_reuse():
    """Same-shape answers hit the plan cache; prepare() returns a working
    handle; other shapes fall back; invalidate() re-pins the handle on its
    next call (one invalidation) and rebuilds the partitions."""
    parts = _clustered_parts(8, rows=200, seed=14)
    eng = PassEngine.from_catalog(
        parts, catalog=CatalogConfig(k=4, s_per_leaf=16, max_partitions=3,
                                     seed=3),
        serving=ServingConfig(kinds=("sum",)), ci=0.95, device="cpu")
    _, q = _both(np.array([[5.0], [15.0]]), np.array([[45.0], [55.0]]))
    eng.answer(q)
    eng.answer(q)
    assert eng.stats()["hits"] >= 1 and eng.stats()["entries"] == 1
    prepared = eng.prepare(q)
    assert type(prepared).__name__ == "PreparedCatalogQuery"
    assert torch.isfinite(prepared(q)["sum"].estimate).all()
    _, q1 = _both(np.array([[5.0]]), np.array([[45.0]]))
    assert torch.isfinite(prepared(q1)["sum"].estimate).all()
    built = eng.stats()["catalog"]["materialized"]
    eng.source.invalidate()
    assert eng.epoch == 1
    prepared(q)
    st_ = eng.stats()
    assert st_["invalidations"] == 1 and st_["epoch"] == 1
    assert st_["catalog"]["materialized"] > built
