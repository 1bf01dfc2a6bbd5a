"""Row 11, the fk-join answer's epilogue (``kernels/join_epilogue.py``),
on the CPU at a small size.

``ops.join_epilogue`` on CPU tensors runs ``join_epilogue_plain``, the
port's composition (``assemble_join``, ``compose_join_interval``,
``_with_interval`` a kind). It is held against the JAX package's
``answer_join`` within rtol=3e-5, atol=1e-3 (``ci_half`` as the variance
it is the root of: rtol 6e-5, atol 1e-6 max|estimate|^2), for sum, count
and avg, without an interval, at 0.95 and under the "union" budget, on a
built and an overflowed synopsis, and bit for bit on +-0.0 fact values. It
is bit-equal to the composition assembled by hand, and its rows to the
same queries' artifacts served alone.

The CUDA kernel (``csrc/join_epilogue.cu``) cannot run here. Its
algorithm is replayed in torch on the CPU (float32 terms, each op rounded
as the kernel pins it; each thread's cells in chunks of EPI_CHUNK folded
in cell order into float64 sums, the fixed warp-shuffle tree, the warps
in order, each sum rounded once to float32) and held against the plain
version: within the tolerance above, and bit for bit where the sums are
exact (+-0.0 values, queries with no sampled cell).
The wrapper's refusals and the launch constants are checked against the
source.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.api import PassEngine as JEngine, CIConfig as JCI
from repro.core.types import QueryBatch as JQB
from repro.joins import build_dim_table as jdim
from repro.joins import build_join_synopsis as jbuild
from repro_torch import minmax
from repro_torch.api import ServingConfig
from repro_torch.core.types import QueryBatch
from repro_torch.joins import (JOIN_KINDS, assemble_join,
                               build_dim_table, build_join_synopsis)
from repro_torch.joins.executor import compute_join_artifacts
from repro_torch.kernels import join_epilogue as je
from repro_torch.kernels import native, ops
from repro_torch.uncertainty.intervals import (_z_of, _with_interval,
                                               compose_join_interval)
from test_torch_extremes import assert_bits_equal
from test_torch_joins import (RES_FIELDS, assert_results_close, build_both,
                              rects, tables)

LAM = ServingConfig().lam
CSRC = Path(je.__file__).resolve().parent / "csrc" / "join_epilogue.cu"
# (level, delta_budget, small_n_threshold) of each request.
REQUESTS = {"none": (None, "stratum", 12), "clt": (0.95, "stratum", 12),
            "union": (0.9, "union", 30)}
KIND_SETS = (("sum",), ("count",), ("avg",), JOIN_KINDS)


def jax_ci(name):
    level, budget, thr = REQUESTS[name]
    return None if level is None else JCI(level=level, delta_budget=budget,
                                          small_n_threshold=thr)


def epilogue(tsyn, jart, kinds, name):
    level, budget, thr = REQUESTS[name]
    return ops.join_epilogue(tsyn, jart, kinds, lam=LAM, level=level,
                             small_n_threshold=thr, delta_budget=budget)


@pytest.fixture(scope="module")
def syns():
    """{d_fact: (JAX synopsis, port synopsis)} at k = 10, P = 6 (d_fact 2:
    kd), and an overflowed build at k = 6, P = 4."""
    out = {}
    for d_fact, method in ((1, "adp"), (2, "kd")):
        tab = tables(n=1800, nd=80, seed=40 + d_fact, d_fact=d_fact,
                     missing=0.02, skew=True)
        jsyn, tsyn, _, _ = build_both(tab, num_partitions=6, k=10, p_u=0.35,
                                      seed=3, method=method,
                                      opt_samples=512)
        out[d_fact] = (jsyn, tsyn)
    jsyn, tsyn, _, rep = build_both(tables(n=1500, seed=4), k=6, p_u=0.5,
                                    u_capacity=5, seed=1)
    assert rep["universe_overflow"] > 0
    out["overflow"] = (jsyn, tsyn)
    return out


def zero_valued(d_fact):
    """Fact values all +0.0 or -0.0 (whole dim partitions of -0.0), as
    tests/test_torch_extremes.py builds them: (JAX, port) synopses and
    40 rectangles."""
    rng = np.random.default_rng(50 + d_fact)
    n, nd = 2500, 60
    c = (rng.normal(size=n) if d_fact == 1
         else rng.normal(size=(n, d_fact))).astype(np.float32)
    a = rng.choice([0.0, -0.0], n).astype(np.float32)
    keys = rng.integers(0, nd, n).astype(np.int32)
    a[keys < nd // 4] = -0.0
    dattr = rng.normal(size=nd).astype(np.float32)
    kw = dict(k=8, p_u=0.4, seed=1, method="adp" if d_fact == 1 else "kd",
              opt_samples=512)
    jsyn, _ = jbuild(c, a, keys, jdim(np.arange(nd), dattr,
                                      num_partitions=4), **kw)
    tsyn, _ = build_join_synopsis(
        c, a, keys, build_dim_table(np.arange(nd), dattr, num_partitions=4,
                                    device="cpu"), device="cpu", **kw)
    pairs = np.sort(rng.normal(0, 1.2, (40, d_fact + 1, 2)), -1)
    lo, hi = (pairs[..., i].astype(np.float32) for i in (0, 1))
    return (jsyn, tsyn, JQB(jnp.asarray(lo), jnp.asarray(hi)),
            QueryBatch(torch.from_numpy(lo), torch.from_numpy(hi)))


# ---------------------------------------------------------------------------
# ops.join_epilogue on CPU tensors against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ci", ["none", "clt", "union"])
@pytest.mark.parametrize("d_fact", [1, 2])
def test_epilogue_matches_jax(syns, d_fact, ci):
    jsyn, tsyn = syns[d_fact]
    jq, tq = rects(40, d_fact, 1, seed=30 + d_fact)
    jres = JEngine(jsyn, ci=jax_ci(ci)).answer_join(jq, kinds=JOIN_KINDS)
    tres = epilogue(tsyn, compute_join_artifacts(tsyn, tq), JOIN_KINDS, ci)
    assert_results_close(tres, jres, JOIN_KINDS)


@pytest.mark.parametrize("ci", ["clt", "union"])
def test_epilogue_after_overflow_matches_jax(syns, ci):
    """Strata whose universe buffer overflowed: their cells fall back to
    the deterministic range."""
    jsyn, tsyn = syns["overflow"]
    jq, tq = rects(30, 1, 1, seed=2)
    jres = JEngine(jsyn, ci=jax_ci(ci)).answer_join(jq, kinds=JOIN_KINDS)
    tres = epilogue(tsyn, compute_join_artifacts(tsyn, tq), JOIN_KINDS, ci)
    assert_results_close(tres, jres, JOIN_KINDS)


@pytest.mark.parametrize("ci", ["none", "clt", "union"])
@pytest.mark.parametrize("d_fact", [1, 2])
def test_epilogue_on_zero_values_matches_jax_bits(d_fact, ci):
    """Every field of SUM and AVG has the reference's bits, sign included
    (COUNT's values are row counts, held to tolerance above)."""
    jsyn, tsyn, jq, tq = zero_valued(d_fact)
    kinds = ("sum", "avg")
    jres = JEngine(jsyn, ci=jax_ci(ci)).answer_join(jq, kinds=kinds)
    tres = epilogue(tsyn, compute_join_artifacts(tsyn, tq), kinds, ci)
    signs = 0
    for kind in kinds:
        for f in RES_FIELDS:
            g, w = getattr(tres[kind], f), getattr(jres[kind], f)
            if w is None:
                assert g is None, (kind, f)
                continue
            assert_bits_equal(g, w, f"{kind}.{f}")
            signs += int(np.signbit(np.asarray(w)).sum())
    assert signs > 0                   # some -0.0 among the answers


# ---------------------------------------------------------------------------
# The CPU route: the old composition, row by row
# ---------------------------------------------------------------------------

def same_bits(x, y):
    return (x is None and y is None) or (
        x.shape == y.shape
        and torch.equal(torch.where(torch.isnan(x), 0x7FC00000,
                                    x.view(torch.int32)),
                        torch.where(torch.isnan(y), 0x7FC00000,
                                    y.view(torch.int32))))


@pytest.mark.parametrize("ci", ["none", "clt", "union"])
@pytest.mark.parametrize("kinds", KIND_SETS, ids="-".join)
def test_cpu_route_is_the_old_composition(syns, kinds, ci):
    """``ops.join_epilogue`` on CPU tensors gives the bits of
    assemble_join + compose_join_interval + _with_interval, assembled by
    hand as ``join_answer`` composed them a kind at a time."""
    _, tsyn = syns[1]
    _, tq = rects(25, 1, 1, seed=7)
    jart = compute_join_artifacts(tsyn, tq)
    got = epilogue(tsyn, jart, kinds, ci)
    level, budget, thr = REQUESTS[ci]
    scale = LAM if level is None else _z_of(level)
    assert list(got) == list(kinds)
    for kind in kinds:
        want = assemble_join(tsyn, jart, kind, scale)
        if level is not None:
            half, _ = compose_join_interval(tsyn, jart, kind, level,
                                            small_n_threshold=thr,
                                            delta_budget=budget)
            want = _with_interval(want, half, clip_bounds=True)
        for f in RES_FIELDS:
            assert same_bits(getattr(got[kind], f), getattr(want, f)), \
                (kind, f)


def rows_of(jart, rows):
    """The artifacts of a subset of the batch's queries."""
    return dataclasses.replace(jart, **{
        f.name: getattr(jart, f.name)[rows].contiguous()
        for f in dataclasses.fields(jart)})


@pytest.mark.parametrize("ci", ["none", "clt", "union"])
def test_batch_rows_equal_queries_alone(syns, ci):
    """A query's answer depends on its own artifacts alone: rows 0, 0-2
    and 5-16 of a batch served alone have the batch's bits."""
    _, tsyn = syns[2]
    _, tq = rects(24, 2, 1, seed=8)
    jart = compute_join_artifacts(tsyn, tq)
    whole = epilogue(tsyn, jart, JOIN_KINDS, ci)
    for rows in (slice(0, 1), slice(0, 3), slice(5, 17)):
        part = epilogue(tsyn, rows_of(jart, rows), JOIN_KINDS, ci)
        for kind in JOIN_KINDS:
            for f in RES_FIELDS:
                w = getattr(whole[kind], f)
                assert same_bits(getattr(part[kind], f),
                                 None if w is None else w[rows]), \
                    (rows, kind, f)


# ---------------------------------------------------------------------------
# The kernel's algorithm, replayed on the CPU
# ---------------------------------------------------------------------------

def kernel_fold(terms):
    """(Q, kP) float32 terms summed as the kernel sums them, in float64:
    thread t folds the cells of chunks t, t + THREADS, ... in cell order
    from +0.0, then the warps' shuffle trees (lane l adds lane l + off, or
    itself past the warp), then the warps in order; the sum rounded once
    to float32. Cells past kP add +0.0 (no change)."""
    T, C = je.EPI_THREADS, je.EPI_CHUNK
    Q, kp = terms.shape
    rounds = -(-kp // (T * C))
    pad = torch.zeros((Q, rounds * T * C), dtype=torch.float64)
    pad[:, :kp] = terms.double()
    chunks = pad.reshape(Q, rounds, T, C)
    acc = torch.zeros((Q, T), dtype=torch.float64)
    for r in range(rounds):
        for i in range(C):
            acc = acc + chunks[:, r, :, i]
    acc = acc.reshape(Q, T // 32, 32)
    for off in (16, 8, 4, 2, 1):
        acc = acc + torch.cat([acc[..., off:], acc[..., 32 - off:]], -1)
    out = acc[:, 0, 0]
    for w in range(1, T // 32):
        out = out + acc[:, w, 0]
    return out.float()


def replay_epilogue(tsyn, jart, kinds, ci):
    """csrc/join_epilogue.cu in torch on the CPU."""
    level, budget, thr = REQUESTS[ci]
    f32 = torch.float32
    P = tsyn.num_partitions
    kp = tsyn.num_leaves * P
    agg = tsyn.cell_agg.reshape(kp, 5)
    cnt, s_agg, mn_agg, mx_agg = agg[:, 2], agg[:, 0], agg[:, 3], agg[:, 4]
    m = jart.sampled
    mf = m.to(f32)
    over = torch.repeat_interleave(tsyn.u_overflow > 0, P)[None]
    if level is None:
        fb = torch.zeros_like(m)
        w = mf
        L = None
    else:
        fb = m & ((jart.n_grp < float(thr)) | over)
        w = (m & ~fb).to(f32)
        if budget == "union":
            delta = 1.0 - level
            inv = torch.tensor(np.float32(1.0) / np.float32(delta))
            nfb = fb.sum(1).to(f32)
            L = torch.log(torch.clamp(nfb, min=1.0) * 3.0 * inv)[:, None]
        else:
            L = torch.log(torch.tensor(3.0 / (1.0 - level), dtype=f32))
    mn = torch.where(cnt > 0, mn_agg, 0.0)
    mx = torch.where(cnt > 0, mx_agg, 0.0)
    p_ub = minmax.minimum(cnt * minmax.max0(mx), s_agg - cnt * minmax.min0(mn))
    p_lb = minmax.maximum(cnt * minmax.min0(mn), s_agg - cnt * minmax.max0(mx))

    def half_terms(e, v, r, lb, ub):
        det = minmax.maximum(ub - e, e - lb)
        bern = (torch.sqrt(v * 2.0 * L)
                + r * np.float32(2.0 / 3.0) * L)
        ok = (jart.n_grp > 0) & ~over
        return torch.where(fb, torch.where(ok, minmax.minimum(bern, det),
                                           det), 0.0)

    S = {"s": kernel_fold(mf * jart.s_cell), "c": kernel_fold(mf * jart.c_cell),
         "vs": kernel_fold(w * jart.v_s), "vc": kernel_fold(w * jart.v_c),
         "csc": kernel_fold(w * jart.cov_sc),
         "lbs": kernel_fold(mf * p_lb[None]),
         "ubs": kernel_fold(mf * p_ub[None]),
         "ubc": kernel_fold(mf * cnt[None])}
    if level is not None:
        S["hs"] = kernel_fold(half_terms(jart.s_cell, jart.v_s, jart.r_s,
                                         p_lb[None], p_ub[None]))
        S["hc"] = kernel_fold(half_terms(jart.c_cell, jart.v_c, jart.r_c,
                                         torch.zeros_like(cnt)[None],
                                         cnt[None]))
    scale = LAM if level is None else _z_of(level)
    ex_s, ex_c, tch = jart.exact3[:, 0], jart.exact3[:, 2], jart.touched
    out = {}
    for kind in kinds:
        if kind in ("sum", "count"):
            ex, e, v, lb, ub, h = ((ex_s, "s", "vs", "lbs", "ubs", "hs")
                                   if kind == "sum" else
                                   (ex_c, "c", "vc", None, "ubc", "hc"))
            est = ex + S[e]
            half = scale * torch.sqrt(S[v])
            if level is not None:
                half = half + S[h]
            lower = ex + (S[lb] if lb else 0.0)
            upper = ex + S[ub]
        else:
            s = ex_s + S["s"]
            c = torch.clamp(ex_c + S["c"], min=1.0)
            est = s / c
            var = minmax.max0(S["vs"] - 2.0 * est * S["csc"]
                              + est * est * S["vc"]) / (c * c)
            half = scale * torch.sqrt(var)
            if level is not None:
                half = half + (S["hs"] + torch.abs(est) * S["hc"]) / \
                    torch.clamp(c - S["hc"], min=1.0)
            has_cover = ex_c > 0
            avg_cover = ex_s / torch.clamp(ex_c, min=1.0)
            pmax = minmax.masked_max(mx_agg[None], m, -3.4e38, 1)
            pmin = minmax.masked_min(mn_agg[None], m, 3.4e38, 1)
            both = has_cover & m.any(1)
            upper = torch.where(both, minmax.maximum(avg_cover, pmax),
                                torch.where(has_cover, avg_cover, pmax))
            lower = torch.where(both, minmax.minimum(avg_cover, pmin),
                                torch.where(has_cover, avg_cover, pmin))
        lo = hi = None
        if level is not None:
            lo = minmax.clip(est - half, lower, upper)
            hi = minmax.clip(est + half, lower, upper)
        out[kind] = (est, half, lower, upper, tch, lo, hi)
    return out


def replay_case(syns, case):
    """(port synopsis, artifacts) of a replay case: the built 1-D and 2-D
    synopses, the overflowed one, +-0.0 values; row 0 with no sampled
    cell and row 1 with only covered cells (their exact aggregates
    recomputed)."""
    if case == "zeros":
        _, tsyn, _, tq = zero_valued(1)
    else:
        _, tsyn = syns[{"d1": 1, "d2": 2, "overflow": "overflow"}[case]]
        _, tq = rects(30, tsyn.d_fact, 1, seed=11)
    jart = compute_join_artifacts(tsyn, tq)
    if case == "d1":
        sampled, cover = jart.sampled.clone(), jart.cover.clone()
        sampled[:2] = False
        cover[1] = True
        kp = sampled.shape[1]
        exact3 = cover.to(torch.float32) @ tsyn.cell_agg.reshape(kp, 5)[:, :3]
        jart = dataclasses.replace(jart, sampled=sampled, cover=cover,
                                   exact3=exact3)
    return tsyn, jart


@pytest.mark.parametrize("ci", ["none", "clt", "union"])
@pytest.mark.parametrize("case", ["d1", "d2", "overflow", "zeros"])
def test_kernel_replay_matches_plain(syns, case, ci):
    """The replay within tolerance of the plain version on every field;
    bit for bit on +-0.0 values (SUM and AVG) and on rows without a
    sampled cell."""
    tsyn, jart = replay_case(syns, case)
    plain = epilogue(tsyn, jart, JOIN_KINDS, ci)
    got = replay_epilogue(tsyn, jart, JOIN_KINDS, ci)
    exact_rows = ~jart.sampled.any(1)
    assert case != "d1" or exact_rows[:2].all()
    for kind in JOIN_KINDS:
        want = plain[kind]
        scale = float(want.estimate.abs().max())
        for f, g in zip(RES_FIELDS, got[kind]):
            w = getattr(want, f)
            if w is None:
                assert g is None, (kind, f)
                continue
            if f == "ci_half":
                np.testing.assert_allclose(
                    g.double() ** 2, w.double() ** 2, rtol=6e-5,
                    atol=1e-6 * scale ** 2, err_msg=f"{kind}.{f}")
            else:
                np.testing.assert_allclose(g, w, rtol=3e-5, atol=1e-3,
                                           err_msg=f"{kind}.{f}")
            assert same_bits(g[exact_rows], w[exact_rows]), (kind, f)
            if case == "zeros" and kind != "count":
                assert same_bits(g, w), (kind, f)


# ---------------------------------------------------------------------------
# The wrapper, the registry, the source's constants
# ---------------------------------------------------------------------------

def test_cuda_wrapper_refuses_bad_arguments(syns):
    _, tsyn = syns[1]
    _, tq = rects(4, 1, 1, seed=0)
    jart = compute_join_artifacts(tsyn, tq)
    kw = dict(lam=LAM, level=0.95, small_n_threshold=12,
              delta_budget="stratum")
    with pytest.raises(ValueError, match="CUDA tensors"):
        je.join_epilogue_cuda(tsyn, jart, JOIN_KINDS, **kw)
    bad = dataclasses.replace(jart, sampled=jart.sampled[:, :-1])
    with pytest.raises(ValueError, match="shapes"):
        je.join_epilogue_cuda(tsyn, bad, JOIN_KINDS, **kw)
    bad = dataclasses.replace(jart, exact3=jart.exact3[:3])
    with pytest.raises(ValueError, match="shapes"):
        je.join_epilogue_cuda(tsyn, bad, JOIN_KINDS, **kw)
    bad = dataclasses.replace(jart, v_s=jart.v_s.double())
    with pytest.raises(ValueError, match="v_s must be torch.float32"):
        je.join_epilogue_cuda(tsyn, bad, JOIN_KINDS, **kw)
    bad = dataclasses.replace(jart, sampled=jart.sampled.to(torch.uint8))
    with pytest.raises(ValueError, match="sampled must be torch.bool"):
        je.join_epilogue_cuda(tsyn, bad, JOIN_KINDS, **kw)
    with pytest.raises(ValueError, match="unsupported join kind"):
        je.join_epilogue_cuda(tsyn, jart, ("min",), **kw)
    with pytest.raises(ValueError, match="delta_budget"):
        je.join_epilogue_cuda(tsyn, jart, JOIN_KINDS,
                              **dict(kw, delta_budget="bogus"))
    with pytest.raises(ValueError, match="Q < 2"):
        je.check_epilogue_limits("x", 0, 16, 4)
    with pytest.raises(ValueError, match="k\\*P <="):
        je.check_epilogue_limits("x", 4, 2 ** 31, 4)
    je.check_epilogue_limits("x", 2 ** 31 - 1, 2 ** 31 - 1 - je.EPI_CHUNK, 1)


def test_registered_and_isolated():
    """native lists the kernel and counts its launches; the isolation test
    imports the new module; the wrapper's launch constants are the
    source's."""
    assert native.KERNELS["join_epilogue"] == "join_epilogue"
    assert "join_epilogue" in native.SOURCES
    assert native.LAUNCHES["join_epilogue"] >= 0
    iso = (Path(__file__).parent / "test_torch_isolation.py").read_text()
    assert '"repro_torch.kernels.join_epilogue"' in iso
    src = CSRC.read_text()
    consts = dict(re.findall(r"constexpr int (THREADS|CHUNK) = (\d+);", src))
    assert int(consts["THREADS"]) == je.EPI_THREADS
    assert int(consts["CHUNK"]) == je.EPI_CHUNK
    planes = re.search(r"enum \{([^}]*)\}", src).group(1)
    assert [p.strip().lower() for p in planes.split(",")][:8] == \
        list(je.PLANES)
