"""The port's fk-join serving (``repro_torch.joins``) against the JAX
package's (``repro.joins``), on the CPU, at a small size.

Both packages get the same numpy inputs from a seed. Exact: the universe
uniforms and membership (a hash), the dimension table, every buffer of
the join synopsis and its cell aggregates, the key groups and the cell
classification. Within rtol=3e-5, atol=1e-3 (the bar tests/test_kernels.py
sets for Pallas): the join artifacts (``join_cell_moments_plain``, the
version CPU tensors take) and every field of ``answer_join``, each kind,
with and without intervals. The JAX side runs with the conftest's ``jnp``
backend, and its cell classification also through Pallas in interpret
mode.

A replay of the CUDA kernel (``csrc/join_moments.cu``) in numpy float32,
on the sorted layout the kernel reads, gives the plain version's planes
bit for bit: the layout keeps the reference's summation orders.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.api import PassEngine as JEngine, CIConfig as JCI
from repro.core.query import ground_truth_join as jtruth
from repro.core.types import QueryBatch as JQB
from repro.engine.planner import classify_join_cells as jclassify
from repro.joins import (build_dim_table as jdim, build_join_synopsis as
                         jbuild, dim_lookup as jlookup, key_uniforms as jku,
                         universe_mask as jmask)
from repro.joins.executor import (compute_join_artifacts as jartifacts,
                                  universe_group_ids as jgroups)
from repro_torch import random as trandom
from repro_torch.api import PassEngine, CIConfig, ServingConfig
from repro_torch.core.query import ground_truth_join
from repro_torch.core.types import QueryBatch
from repro_torch.engine.executor import MIN_ROWS
from repro_torch.engine.planner import classify_join_cells
from repro_torch.joins import (build_dim_table, build_join_synopsis,
                               dim_lookup, key_uniforms, universe_mask,
                               join_queries, JOIN_KINDS)
from repro_torch.joins.executor import (compute_join_artifacts, join_slots,
                                        universe_group_ids)
from repro_torch.kernels import join_moments as jm

RTOL, ATOL = 3e-5, 1e-3
ART_FIELDS = ("exact3", "s_cell", "c_cell", "v_s", "v_c", "cov_sc", "n_grp",
              "r_s", "r_c", "touched")
RES_FIELDS = ("estimate", "ci_half", "lower", "upper", "frac_rows_touched",
              "ci_lo", "ci_hi")
BUFFERS = ("cell_agg", "u_c", "u_a", "u_key", "u_dattr", "u_part",
           "u_valid", "u_count", "u_overflow", "key_root")
DIM_FIELDS = ("key_sorted", "attr_sorted", "part_sorted", "part_lo",
              "part_hi", "part_agg")


def tables(n=1500, nd=60, seed=0, d_fact=1, d_dim=1, missing=0.0,
           skew=False):
    """Fact rows (c, a, keys) and a dimension relation (dkeys, dattr), the
    reference tests' generator; ``missing`` of the fact keys lie outside
    the dimension side."""
    rng = np.random.default_rng(seed)
    c = (rng.normal(size=n) if d_fact == 1
         else rng.normal(size=(n, d_fact))).astype(np.float32)
    a = rng.gamma(2.0, 1.0, size=n).astype(np.float32)
    if skew:
        a *= np.exp(rng.normal(0, 1, size=n)).astype(np.float32)
    keys = rng.integers(0, nd, size=n).astype(np.int32)
    out = rng.random(n) < missing
    keys[out] = nd + rng.integers(0, nd, size=int(out.sum()))
    dkeys = np.arange(nd, dtype=np.int32)
    dattr = (rng.normal(size=nd) if d_dim == 1
             else rng.normal(size=(nd, d_dim))).astype(np.float32)
    return c, a, keys, dkeys, dattr


def build_both(tab, num_partitions=4, **kw):
    """(JAX join synopsis, port join synopsis on the CPU, both reports)."""
    c, a, keys, dkeys, dattr = tab
    jd = jdim(dkeys, dattr, num_partitions=num_partitions)
    td = build_dim_table(dkeys, dattr, num_partitions=num_partitions,
                         device="cpu")
    jsyn, jrep = jbuild(c, a, keys, jd, **kw)
    tsyn, trep = build_join_synopsis(c, a, keys, td, device="cpu", **kw)
    return jsyn, tsyn, jrep, trep


def rects(m, d_fact, d_dim, seed, scale=1.2):
    """m join rectangles, one sorted normal pair a column (the reference
    benchmark's query generator), as (JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    pairs = np.sort(rng.normal(0, scale, size=(m, d_fact + d_dim, 2)), -1)
    lo = pairs[..., 0].astype(np.float32)
    hi = pairs[..., 1].astype(np.float32)
    return (JQB(jnp.asarray(lo), jnp.asarray(hi)),
            QueryBatch(torch.from_numpy(lo), torch.from_numpy(hi)))


def as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_close(got, want, what):
    np.testing.assert_allclose(as_np(got).astype(np.float64),
                               as_np(want).astype(np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def assert_half_close(got, want, scale, what):
    """``ci_half`` is lam or z times the square root of a difference of
    fp32 sums (AVG: sum v_s - 2 est sum cov_sc + est^2 sum v_c), so where
    that difference cancels to rounding noise its root is noise of size
    sqrt(eps) |est|. The halves are compared as the variances the
    epilogue sums: rtol 2 * RTOL, atol 1e-6 * scale^2 (scale = the batch's
    largest |estimate|)."""
    g2 = as_np(got).astype(np.float64) ** 2
    w2 = as_np(want).astype(np.float64) ** 2
    np.testing.assert_allclose(g2, w2, rtol=2 * RTOL, atol=1e-6 * scale ** 2,
                               err_msg=what)


def assert_results_close(tres, jres, kinds):
    """Every field of every kind within RTOL / ATOL; ``ci_half`` through
    :func:`assert_half_close`."""
    for kind in kinds:
        scale = float(np.abs(as_np(jres[kind].estimate)).max())
        for f in RES_FIELDS:
            w, g = getattr(jres[kind], f), getattr(tres[kind], f)
            if w is None:
                assert g is None, (kind, f)
            elif f == "ci_half":
                assert_half_close(g, w, scale, f"{kind}.{f}")
            else:
                assert_close(g, w, f"{kind}.{f}")


def with_buffers(jsyn, tsyn, **bufs):
    """Both synopses with the same numpy universe buffers swapped in."""
    return (dataclasses.replace(jsyn, **{k: jnp.asarray(v)
                                         for k, v in bufs.items()}),
            dataclasses.replace(tsyn, **{k: torch.from_numpy(v)
                                         for k, v in bufs.items()}))


# ---------------------------------------------------------------------------
# Universe membership, dimension table, synopsis build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_key_uniforms_and_membership_match_jax(seed):
    """Per-key uniforms bit-equal to the reference's (negative keys and
    the int32 extremes included), so membership is exactly its."""
    rng = np.random.default_rng(seed)
    keys = np.concatenate([
        rng.integers(-2 ** 31, 2 ** 31, size=300, dtype=np.int64),
        [0, 1, -1, 2 ** 31 - 1, -2 ** 31]]).astype(np.int32)
    jroot = jax.random.PRNGKey(seed)
    troot = trandom.PRNGKey(seed, "cpu")
    got = key_uniforms(troot, keys).numpy()
    want = np.asarray(jku(jroot, jnp.asarray(keys)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    for p in (0.05, 0.3, 0.999):
        np.testing.assert_array_equal(universe_mask(troot, keys, p).numpy(),
                                      np.asarray(jmask(jroot, keys, p)))
    batch = trandom.fold_in(troot, torch.from_numpy(keys))
    assert torch.equal(trandom.uniform_scalar(batch),
                       trandom.uniform(batch, ()))


def test_membership_is_a_function_of_the_key():
    """Any batching, order or duplication sees the same decisions."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 10 ** 6, size=200).astype(np.int32)
    root = trandom.PRNGKey(11, "cpu")
    full = universe_mask(root, keys, 0.4).numpy()
    idx = rng.integers(0, keys.size, size=400)
    np.testing.assert_array_equal(
        universe_mask(root, keys[idx], 0.4).numpy(), full[idx])
    np.testing.assert_array_equal(
        np.concatenate([universe_mask(root, keys[:77], 0.4).numpy(),
                        universe_mask(root, keys[77:], 0.4).numpy()]), full)
    # monotone in p
    assert not (universe_mask(root, keys, 0.2).numpy() & ~full).any()


@pytest.mark.parametrize("p,d_dim,attrs", [(4, 1, True), (1, 1, True),
                                           (16, 2, True), (8, 1, False)])
def test_build_dim_table_and_lookup_match_jax(p, d_dim, attrs):
    rng = np.random.default_rng(p)
    dkeys = rng.permutation(np.arange(-20, 80)).astype(np.int32)
    dattr = ((rng.normal(size=100) if d_dim == 1
              else rng.normal(size=(100, d_dim))).astype(np.float32)
             if attrs else None)
    jd = jdim(dkeys, dattr, num_partitions=p)
    td = build_dim_table(dkeys, dattr, num_partitions=p, device="cpu")
    assert (td.num_partitions, td.d_attr, td.num_keys) == (
        jd.num_partitions, jd.d_attr, jd.num_keys)
    for f in DIM_FIELDS:
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)), err_msg=f)
    probe = rng.integers(-40, 120, size=300).astype(np.int32)
    for got, want in zip(dim_lookup(td, probe), jlookup(jd, probe)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d_fact,method,cap,missing", [
    (1, "adp", None, 0.0), (1, "eq", 6, 0.05), (2, "kd", None, 0.1),
    (3, "kd", 3, 0.0)])
def test_build_join_synopsis_matches_jax(d_fact, method, cap, missing):
    """Every buffer, the cell aggregates and the report exactly the
    reference's (``u_capacity`` small enough to overflow in two cases)."""
    tab = tables(n=1200, seed=d_fact, d_fact=d_fact, missing=missing)
    jsyn, tsyn, jrep, trep = build_both(
        tab, k=8, p_u=0.3, seed=5, method=method, u_capacity=cap,
        opt_samples=512)
    assert trep == jrep
    if cap is not None:
        assert jrep["universe_overflow"] > 0
    for f in BUFFERS:
        np.testing.assert_array_equal(
            getattr(tsyn, f).numpy(),
            np.asarray(getattr(jsyn, f)).astype(
                getattr(tsyn, f).numpy().dtype), err_msg=f)
    assert (tsyn.p_u, tsyn.key_name, tsyn.d_fact, tsyn.d_dim) == (
        jsyn.p_u, jsyn.key_name, jsyn.d_fact, jsyn.d_dim)
    np.testing.assert_array_equal(tsyn.base.leaf_agg.numpy(),
                                  np.asarray(jsyn.base.leaf_agg))


@pytest.fixture(scope="module")
def pair():
    """{d_fact: (JAX synopsis, port synopsis, table)} at k = 12, P = 6."""
    out = {}
    for d_fact, method in ((1, "adp"), (2, "kd")):
        tab = tables(n=2000, nd=90, seed=10 + d_fact, d_fact=d_fact,
                     missing=0.02, skew=True)
        jsyn, tsyn, _, _ = build_both(tab, num_partitions=6, k=12, p_u=0.35,
                                      seed=2, method=method,
                                      opt_samples=512)
        out[d_fact] = (jsyn, tsyn, tab)
    return out


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("d_fact", [1, 2])
def test_classify_join_cells_matches_jax(pair, d_fact, backend):
    jsyn, tsyn, _ = pair[d_fact]
    jq, tq = rects(24, d_fact, 1, seed=d_fact)
    want = jclassify(jsyn, jq, backend)
    got = classify_join_cells(tsyn, tq)
    for g, w, name in zip(got, want, ("cover", "sampled", "rel_f", "rel_d")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[0].any() and got[1].any()


def test_universe_group_ids_match_jax(pair):
    for jsyn, tsyn, _ in pair.values():
        for g, w in zip(universe_group_ids(tsyn), jgroups(jsyn)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# The join artifacts: join_cell_moments_plain against the reference
# ---------------------------------------------------------------------------

def edge_buffers(tsyn, case, seed=0):
    """Universe buffers of the synopsis's shape for an edge case."""
    rng = np.random.default_rng(seed)
    bufs = {f: getattr(tsyn, f).numpy().copy()
            for f in ("u_c", "u_a", "u_key", "u_dattr", "u_part", "u_valid")}
    v = bufs["u_valid"]
    if case == "nan":                 # NaN coordinates on valid slots
        hit = v & (rng.random(v.shape) < 0.2)
        bufs["u_c"][hit, 0] = np.nan
        bufs["u_dattr"][v & (rng.random(v.shape) < 0.1), 0] = np.nan
    elif case == "zeros":             # every value +0.0 or -0.0
        bufs["u_a"] = np.where(rng.random(v.shape) < 0.5, 0.0,
                               -0.0).astype(np.float32)
    elif case == "nopart":            # every key missing from the dim side
        bufs["u_part"][:] = -1
    elif case == "singles":           # groups of one slot
        bufs["u_key"] = np.arange(v.size, dtype=np.int32).reshape(v.shape)
    elif case == "empty_leaves":      # leaves with no valid slot
        v[::2] = False
    return bufs


@pytest.mark.parametrize("case", ["built", "nan", "zeros", "nopart",
                                  "singles", "empty_leaves"])
@pytest.mark.parametrize("d_fact", [1, 2])
def test_join_artifacts_match_jax(pair, d_fact, case):
    jsyn, tsyn, _ = pair[d_fact]
    if case != "built":
        jsyn, tsyn = with_buffers(jsyn, tsyn, **edge_buffers(tsyn, case))
    jq, tq = rects(40, d_fact, 1, seed=5)
    ja = jartifacts(jsyn, jq)
    ta = compute_join_artifacts(tsyn, tq)
    np.testing.assert_array_equal(ta.cover.numpy(), np.asarray(ja.cover))
    np.testing.assert_array_equal(ta.sampled.numpy(), np.asarray(ja.sampled))
    for f in ART_FIELDS:
        assert_close(getattr(ta, f), getattr(ja, f), f)


def test_join_cell_moments_plain_chunks_rows(pair, monkeypatch):
    """The plain version's query chunks change no bit of a row."""
    _, tsyn, _ = pair[1]
    _, tq = rects(33, 1, 1, seed=9)
    whole = compute_join_artifacts(tsyn, tq)
    monkeypatch.setattr(jm, "plain_chunk_rows", lambda g: 4)
    chunked = compute_join_artifacts(tsyn, tq)
    for f in ART_FIELDS:
        assert torch.equal(getattr(whole, f), getattr(chunked, f)), f


# ---------------------------------------------------------------------------
# The CUDA kernel's algorithm, replayed on its layout
# ---------------------------------------------------------------------------

def replay_kernel(slots, q_lo, q_hi, cover, sampled, cell_agg, total, p_u):
    """csrc/join_moments.cu in numpy float32: per (query, leaf, cell) the
    cell's box test, then a walk over the cell's run of the sorted layout
    folding each key group at its flagged last slot; exact3 / touched as
    chains over the cells in ascending order."""
    f32 = np.float32
    inv_p, one_m_p = (f32(x) for x in (1.0 / p_u, 1.0 - p_u))
    coord, a, last = (slots.s_coord.numpy(), slots.s_a.numpy(),
                      slots.s_last.numpy())
    start, box = slots.cell_start.numpy(), slots.cell_box.numpy()
    k, P = slots.num_leaves, slots.num_partitions
    lo, hi = q_lo.numpy(), q_hi.numpy()
    Q = lo.shape[0]
    out = np.zeros((8, Q, k * P), np.float32)
    for q in range(Q):
        for leaf in range(k):
            for p in range(P):
                cell = leaf * P + p
                if ((hi[q] < box[cell, 0]).any()
                        or (lo[q] > box[cell, 1]).any()):
                    continue
                acc = [f32(0.0)] * 8
                ts = tc = f32(0.0)
                end = start[leaf, p + 1]
                for i in range(start[leaf, p], end):
                    x = coord[leaf, i]
                    inside = bool(((lo[q] <= x) & (x <= hi[q])).all())
                    row_c = inv_p if inside else f32(0.0)
                    tc = f32(tc + row_c)
                    ts = f32(ts + f32(row_c * a[leaf, i]))
                    if last[leaf, i]:
                        acc[0] = f32(acc[0] + ts)
                        acc[1] = f32(acc[1] + tc)
                        acc[2] = f32(acc[2] + f32(ts * ts))
                        acc[3] = f32(acc[3] + f32(tc * tc))
                        acc[4] = f32(acc[4] + f32(ts * tc))
                        acc[5] = f32(acc[5] + f32(1.0 if tc > 0 else 0.0))
                        acc[6] = max(acc[6], abs(ts))
                        acc[7] = max(acc[7], tc)
                        ts = tc = f32(0.0)
                for s in (2, 3, 4):
                    acc[s] = f32(one_m_p * acc[s])
                out[:, q, cell] = acc
    g = cell_agg.numpy()
    cv, sv = cover.numpy(), sampled.numpy()
    exact3 = np.zeros((Q, 3), np.float32)
    touched = np.zeros(Q, np.float32)
    for q in range(Q):
        for col in range(4):
            m = cv[q] if col < 3 else sv[q]
            acc = f32(0.0)
            for cell in range(k * P):
                acc = f32(acc + f32(f32(m[cell]) * g[cell, min(col, 2)]))
            if col < 3:
                exact3[q, col] = acc
            else:
                touched[q] = f32(acc / max(f32(total), f32(1.0)))
    return out, exact3, touched


@pytest.mark.parametrize("case", ["built", "nan", "zeros", "nopart",
                                  "singles", "empty_leaves"])
def test_kernel_replay_equals_plain(pair, case):
    """The kernel's walk over the (partition, key)-sorted layout gives the
    plain version's planes bit for bit (its exact3 / touched chains within
    tolerance of the plain matrix products), and its box test skips only
    cells where nothing is inside."""
    jsyn, tsyn, _ = pair[1]
    if case != "built":
        _, tsyn = with_buffers(jsyn, tsyn, **edge_buffers(tsyn, case))
    _, tq = rects(6, 1, 1, seed=13)
    slots = join_slots(tsyn)
    cover, sampled, _, _ = classify_join_cells(tsyn, tq)
    kp = tsyn.num_leaves * tsyn.num_partitions
    args = (slots, tq.lo, tq.hi, cover, sampled,
            tsyn.cell_agg.reshape(kp, -1), tsyn.base.total_rows)
    planes, exact3, touched = replay_kernel(*args, tsyn.p_u)
    plain = jm.join_cell_moments_plain(*args, tsyn.p_u)
    for i, name in enumerate(jm.PLANES):
        np.testing.assert_array_equal(
            planes[i].view(np.int32),
            getattr(plain, name).numpy().view(np.int32), err_msg=name)
    assert_close(exact3, plain.exact3, "exact3")
    assert_close(touched, plain.touched, "touched")


def test_join_slots_layout():
    """Runs by (partition, key), stable within a key; the boxes leave NaN
    out and open up for a non-finite value; k * P runs cover the live
    slots."""
    rng = np.random.default_rng(0)
    k, su, P = 3, 10, 2
    u_key = rng.integers(0, 4, size=(k, su)).astype(np.int32)
    u_part = (u_key % P).astype(np.int32)
    u_part[0, 0] = -1
    u_valid = rng.random((k, su)) < 0.8
    u_c = rng.normal(size=(k, su, 1)).astype(np.float32)
    u_c[1, 3, 0] = np.nan
    u_a = np.arange(k * su, dtype=np.float32).reshape(k, su)
    u_a[2, 4] = np.inf
    u_valid[2, 4] = True
    T = torch.from_numpy
    s = jm.join_slots(T(u_c), T(u_c), T(u_a), T(u_key), T(u_part),
                      T(u_valid), P)
    live = u_valid & (u_part >= 0)
    start = s.cell_start.numpy()
    for leaf in range(k):
        n = start[leaf, -1]
        assert n == live[leaf].sum()
        run = s.s_a.numpy()[leaf, :n]
        want = sorted(np.flatnonzero(live[leaf]),
                      key=lambda i: (u_part[leaf, i], u_key[leaf, i], i))
        np.testing.assert_array_equal(run, u_a[leaf, want])
        keys = u_key[leaf, want]
        ends = np.append(keys[1:] != keys[:-1], True) if n else keys[:0]
        np.testing.assert_array_equal(s.s_last.numpy()[leaf, :n], ends)
        assert not s.s_last.numpy()[leaf, n:].any()
    box = s.cell_box.numpy()
    assert np.isfinite(box[2:4]).all() or np.isinf(box[2:4]).any()
    cell_inf = 2 * P + u_part[2, 4]
    assert (box[cell_inf, 0] == -np.inf).all()
    assert (box[cell_inf, 1] == np.inf).all()
    assert not np.isnan(box).any()


def test_join_kernel_limits_and_refusal():
    # Any D a C int holds: above JM_MAX_D the wide tile kernel takes the
    # columns in blocks of JM_MAX_D.
    jm.check_join_limits("x", 4, 2, 3, 2, 17)
    jm.check_join_limits("x", 4, 2, 3, 2, 300)
    with pytest.raises(ValueError, match="D < 2"):
        jm.check_join_limits("x", 4, 2, 3, 2, 2 ** 31)
    with pytest.raises(ValueError, match="Q <= "):
        jm.check_join_limits("x", 65536 * jm.JM_QT, 2, 3, 2, 2)
    jm.check_join_limits("x", 65535 * jm.JM_QT, 1, 1, 1, 16)
    tsyn = build_both(tables(n=300, nd=20), k=4, p_u=0.5)[1]
    slots = join_slots(tsyn)
    _, tq = rects(3, 1, 1, seed=0)
    cover = torch.zeros((3, 16), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensors"):
        jm.join_cell_moments_cuda(slots, tq.lo, tq.hi, cover, cover,
                                  tsyn.cell_agg.reshape(16, 5),
                                  tsyn.base.total_rows, 0.5)


# ---------------------------------------------------------------------------
# answer_join against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ci", ["none", "clt", "union"])
@pytest.mark.parametrize("d_fact", [1, 2])
def test_answer_join_matches_jax(pair, d_fact, ci):
    jsyn, tsyn, _ = pair[d_fact]
    jq, tq = rects(40, d_fact, 1, seed=20 + d_fact)
    jci = {"none": None, "clt": JCI(level=0.95),
           "union": JCI(level=0.9, delta_budget="union",
                        small_n_threshold=30)}[ci]
    tci = {"none": None, "clt": CIConfig(level=0.95),
           "union": CIConfig(level=0.9, delta_budget="union",
                             small_n_threshold=30)}[ci]
    jres = JEngine(jsyn, ci=jci).answer_join(jq, kinds=JOIN_KINDS)
    tres = PassEngine(tsyn, ci=tci, device="cpu").answer_join(
        tq, kinds=JOIN_KINDS)
    assert_results_close(tres, jres, JOIN_KINDS)


def test_answer_join_after_overflow_matches_jax():
    """A build that overflowed its universe buffers: the fallback cells."""
    jsyn, tsyn, _, rep = build_both(tables(n=1500, seed=4), k=6, p_u=0.5,
                                    u_capacity=5, seed=1)
    assert rep["universe_overflow"] > 0
    jq, tq = rects(30, 1, 1, seed=2)
    jres = JEngine(jsyn, ci=JCI(level=0.95)).answer_join(jq,
                                                         kinds=JOIN_KINDS)
    tres = PassEngine(tsyn, ci=0.95, device="cpu").answer_join(
        tq, kinds=JOIN_KINDS)
    assert_results_close(tres, jres, JOIN_KINDS)


def test_ground_truth_join_matches_jax(pair):
    jsyn, tsyn, (c, a, keys, dkeys, dattr) = pair[1]
    jq, tq = rects(20, 1, 1, seed=3)
    for kind in ("sum", "count", "avg", "min", "max"):
        np.testing.assert_array_equal(
            ground_truth_join(c, a, keys, dkeys, dattr, tq, kind=kind),
            jtruth(c, a, keys, dkeys, dattr, jq, kind=kind))


@pytest.mark.parametrize("kind", JOIN_KINDS)
def test_join_hard_bounds_contain_truth(pair, kind):
    _, tsyn, (c, a, keys, dkeys, dattr) = pair[2]
    _, tq = rects(30, 2, 1, seed=4)
    res = PassEngine(tsyn, ci=0.95, device="cpu").answer_join(
        tq, kinds=(kind,))[kind]
    truth = ground_truth_join(c, a, keys, dkeys, dattr, tq, kind=kind)
    lo, hi = res.lower.numpy(), res.upper.numpy()
    if kind == "avg":
        keep = ground_truth_join(c, a, keys, dkeys, dattr, tq,
                                 kind="count") > 0
        lo, hi, truth = lo[keep], hi[keep], truth[keep]
    assert np.all(lo <= truth + 1e-3) and np.all(truth <= hi + 1e-3)


def test_all_covered_queries_zero_width(pair):
    """Rectangles covering every cell are answered from the pre-joined
    aggregates: the exact answer and a zero-width interval."""
    _, tsyn, (c, a, keys, dkeys, dattr) = pair[1]
    big = 1e9
    tq = QueryBatch(torch.tensor([[-big, -big]] * 2),
                    torch.tensor([[big, big]] * 2))
    res = PassEngine(tsyn, ci=0.95, device="cpu").answer_join(
        tq, kinds=JOIN_KINDS)
    for kind in JOIN_KINDS:
        truth = ground_truth_join(c, a, keys, dkeys, dattr, tq, kind=kind)
        np.testing.assert_allclose(res[kind].estimate.numpy(), truth,
                                   rtol=1e-5, atol=1e-3)
        assert (res[kind].ci_half.numpy() == 0.0).all(), kind
        assert torch.equal(res[kind].lower, res[kind].upper), kind


def test_join_layouts_and_short_batches(pair):
    """A (fact, dim) pair, dim_queries=, the concatenated batch and a
    fact-width batch (dim side open) serve the same rectangles; a short
    batch is served at MIN_ROWS rows, its rows the bits of the same rows
    in a longer batch."""
    jsyn, tsyn, _ = pair[1]
    _, tq = rects(20, 1, 1, seed=6)
    eng = PassEngine(tsyn, ci=0.95, device="cpu")
    fact = QueryBatch(tq.lo[:, :1], tq.hi[:, :1])
    dim = QueryBatch(tq.lo[:, 1:], tq.hi[:, 1:])
    whole = eng.answer_join(tq)
    for got in (eng.answer_join((fact, dim)), eng.answer_join(fact, dim)):
        for f in RES_FIELDS:
            assert torch.equal(getattr(got["sum"], f),
                               getattr(whole["sum"], f)), f
    open_dim = eng.answer_join(fact)["sum"]
    wide = QueryBatch(torch.cat([fact.lo, torch.full((20, 1), -3.0e38)], 1),
                      torch.cat([fact.hi, torch.full((20, 1), 3.0e38)], 1))
    assert torch.equal(open_dim.estimate,
                       eng.answer_join(wide)["sum"].estimate)
    short = eng.answer_join(QueryBatch(tq.lo[:3], tq.hi[:3]))
    assert short["sum"].estimate.shape == (3,) and MIN_ROWS > 3
    longer = eng.answer_join(QueryBatch(tq.lo[:MIN_ROWS], tq.hi[:MIN_ROWS]))
    for f in RES_FIELDS:
        assert torch.equal(getattr(short["sum"], f),
                           getattr(longer["sum"], f)[:3]), f


# ---------------------------------------------------------------------------
# The engine surface
# ---------------------------------------------------------------------------

def test_prepare_join_cache_reuse(pair):
    _, tsyn, _ = pair[1]
    _, tq = rects(4, 1, 1, seed=7)
    eng = PassEngine(tsyn, ci=0.95, device="cpu")
    eng.answer_join(tq, kinds=("sum",))
    eng.answer_join(tq, kinds=("sum",))
    st = eng.stats()
    assert st["hits"] >= 1 and st["misses"] == 1
    handle = eng.prepare_join(tq, kinds=("sum",))
    assert eng.stats()["hits"] == st["hits"] + 1
    for f in RES_FIELDS:
        assert torch.equal(getattr(handle(tq)["sum"], f),
                           getattr(eng.answer_join(tq, kinds=("sum",))["sum"],
                                   f))
    assert eng.prepare_join((4, 2), kinds=("sum",)) is handle
    # join and single-table entries have their own slots
    out = eng.answer(QueryBatch(tq.lo[:, :1], tq.hi[:, :1]), kinds=("sum",))
    assert "sum" in out and eng.stats()["entries"] == 2
    # a differently-shaped batch through the handle is a counted miss
    misses = eng.stats()["misses"]
    _, tq9 = rects(9 + MIN_ROWS, 1, 1, seed=8)
    assert handle(tq9)["sum"].estimate.shape == (9 + MIN_ROWS,)
    assert eng.stats()["misses"] == misses + 1
    # inherited five-kind configs keep the join kinds
    eng5 = PassEngine(tsyn, ServingConfig(kinds=("sum", "min", "avg")),
                      device="cpu")
    assert set(eng5.answer_join(tq)) == {"sum", "avg"}


def test_join_error_paths(pair):
    jsyn, _, _ = pair[1]
    c, a, keys, dkeys, dattr = tables(n=800, nd=30, seed=8)
    td = build_dim_table(dkeys, dattr, num_partitions=4, device="cpu")
    tsyn, _ = build_join_synopsis(c, a, keys, td, k=4, p_u=0.5, seed=23,
                                  key_name="order_fk", device="cpu")
    eng = PassEngine(tsyn, ci=CIConfig(level=0.95), device="cpu")
    fq = QueryBatch(torch.tensor([[-1.0]]), torch.tensor([[1.0]]))
    dq = QueryBatch(torch.tensor([[-1.0]]), torch.tensor([[1.0]]))
    with pytest.raises(ValueError, match="order_fk"):
        eng.answer_join(fq, dq, on="customer_fk")
    assert eng.answer_join(fq, dq, on="order_fk")
    assert eng.answer_join(fq, dq, dim_table=td)
    other = build_dim_table(dkeys[:20], dattr[:20], device="cpu")
    with pytest.raises(ValueError, match="dim_table differs"):
        eng.answer_join(fq, dq, dim_table=other)
    with pytest.raises(ValueError, match="min"):
        eng.answer_join(fq, dq, kinds=("min",))
    with pytest.raises(ValueError, match="clt"):
        eng.answer_join(fq, dq, ci=CIConfig(level=0.95, method="bootstrap"))
    with pytest.raises(ValueError, match="sample_slots"):
        eng.answer_join(fq, dq, serving=ServingConfig(sample_slots=4))
    with pytest.raises(ValueError, match="matches neither"):
        eng.answer_join(QueryBatch(torch.zeros((1, 3)), torch.ones((1, 3))))
    with pytest.raises(ValueError, match="query counts differ"):
        join_queries(fq, QueryBatch(torch.zeros((2, 1)), torch.ones((2, 1))))
    with pytest.raises(TypeError, match="JoinSynopsis source"):
        PassEngine(tsyn.base, device="cpu").answer_join(fq, dq)
    with pytest.raises(ValueError, match="p_u"):
        build_join_synopsis(c, a, keys, td, p_u=0.0, device="cpu")
    with pytest.raises(ValueError, match="unique"):
        build_dim_table(np.zeros(3, np.int32), device="cpu")
    # the base view still serves single-table queries
    assert eng.answer(fq)["sum"].estimate.shape == (1,)
    assert jsyn.num_leaves == 12
