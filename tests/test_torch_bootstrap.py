"""The port's Poisson bootstrap and its three kernels' plain versions
against the JAX package's, on the CPU.

Same numpy inputs, made from a seed, go to both packages; the JAX package
runs as its own tests run it (the Pallas kernels through
``get_backend("pallas")`` in interpret mode, the rest under the ``jnp``
backend that ``conftest.py`` sets). Tolerances:

* the Poisson CDF table, the threefry draws and the resample weights are
  bit-equal;
* kernel sums meet rtol=3e-5, atol=1e-3 (``tests/test_kernels.py``'s bar:
  fp32 sums in another order);
* replicates and served answers meet ``test_torch_engine.py``'s
  tolerances (rtol 3e-5 / 1e-4 with atol scaled by the batch's largest
  estimate);
* inside the port, fused and scan replicates are bit-equal, and so is a
  replicate of the plain ``bootstrap_moments`` and the plain
  ``weighted_moments`` with its weight row (DESIGN.md §10).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.api import (PassEngine as JEngine, ServingConfig as JServing,
                       CIConfig as JCI)
from repro.core import query as jquery
from repro.core.synopsis import build_synopsis as jbuild
from repro.core.types import QueryBatch as JQueryBatch
from repro.kernels import backends as _jax_backends  # noqa: F401 (registers)
from repro.kernels.registry import get_backend
from repro.uncertainty import bootstrap as jboot
from repro_torch.api import PassEngine, ServingConfig, CIConfig
from repro_torch.kernels import ops
from repro_torch.kernels.bootstrap import (bootstrap_moments_cuda,
                                           bootstrap_moments_plain)
from repro_torch.kernels.segment_reduce import (
    weighted_segment_reduce_cuda, weighted_segment_reduce_plain)
from repro_torch.kernels.stratified_estimate import (
    stratified_weighted_moments_cuda, weighted_moments_plain)
from repro_torch import random as trandom
from repro_torch.uncertainty import bootstrap as tboot
from test_torch_engine import (_data, assert_results_close, batch_scale,
                               carry, carry_queries)

RTOL, ATOL = 3e-5, 1e-3
BOOT = ("sum", "count", "avg")

# (Q, k, s, d, R): ragged everything, one of each, several replicate
# blocks of the plain version (br = 8) with a ragged last one.
SHAPES = [(8, 13, 32, 3, 11), (1, 1, 1, 1, 1), (5, 16, 7, 2, 24)]


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _inputs(Q, k, s, d, R, seed):
    """Samples with ragged validity (stratum 0 empty), weights that are
    zero, Poisson integers and non-integers, also on invalid slots."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (k, s, d)).astype(np.float32)
    a = rng.normal(0, 3, (k, s)).astype(np.float32)
    valid = rng.random((k, s)) < 0.7
    valid[0] = False
    W = rng.poisson(1.0, (R, k, s)).astype(np.float32)
    W[:, :, ::3] = rng.uniform(0, 2.5, W[:, :, ::3].shape)
    q_lo = rng.uniform(-1, 0, (Q, d)).astype(np.float32)
    q_hi = q_lo + rng.uniform(0, 1.5, (Q, d)).astype(np.float32)
    return c, a, valid, W, q_lo, q_hi


# ---------------------------------------------------------------------------
# Random draws
# ---------------------------------------------------------------------------

def test_p1_cdf_table_bit_equal():
    assert tboot._P1_CDF.dtype == torch.float32
    np.testing.assert_array_equal(tboot._P1_CDF.numpy().view(np.int32),
                                  np.asarray(jboot._P1_CDF).view(np.int32))


@pytest.mark.parametrize("seed", [0, 5, 2 ** 32 - 1])
def test_draw_weights_bit_equal(seed):
    """Single replicates (the scan's draws, r past 2**16 too) and the
    batched draw of all R at once (the fused path's) equal JAX's."""
    jk = jax.random.PRNGKey(seed)
    tk = trandom.PRNGKey(seed, device="cpu")
    shape = (13, 7)
    for r in (0, 3, 70001):
        want = np.asarray(jboot._draw_weights(jk, r, shape))
        got = tboot._draw_weights(tk, r, shape)
        assert got.dtype == torch.float32 and got.shape == shape
        np.testing.assert_array_equal(got.numpy(), want)
    R = 11
    want = np.asarray(jax.vmap(
        lambda r: jboot._draw_weights(jk, r, shape))(jnp.arange(R)))
    got = tboot._draw_weights(tk, torch.arange(R), shape)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) <= set(range(12))


# ---------------------------------------------------------------------------
# The kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("Q,k,s,d,R", SHAPES)
def test_weighted_moments_plain_matches_jax(Q, k, s, d, R, backend):
    c, a, valid, W, q_lo, q_hi = _inputs(Q, k, s, d, R, Q + 7 * k)
    want = jax.jit(get_backend(backend).weighted_moments)(
        *map(jnp.asarray, (c, a, valid, W[0], q_lo, q_hi)))
    got = weighted_moments_plain(*_t(c, a, valid, W[0], q_lo, q_hi))
    assert got.dtype == torch.float32 and got.shape == (Q, k, 3)
    for i in range(3):
        np.testing.assert_allclose(got[..., i].numpy(), np.asarray(want[i]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("Q,k,s,d,R", SHAPES)
def test_bootstrap_moments_plain_matches_jax(Q, k, s, d, R, backend):
    c, a, valid, W, q_lo, q_hi = _inputs(Q, k, s, d, R, Q + 5 * k)
    want = np.asarray(jax.jit(get_backend(backend).bootstrap_moments)(
        *map(jnp.asarray, (c, a, valid, W, q_lo, q_hi))))
    got = bootstrap_moments_plain(*_t(c, a, valid, W, q_lo, q_hi))
    assert got.dtype == torch.float32 and got.shape == (R, Q, k, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("Q,k,s,d,R", SHAPES)
def test_plain_bootstrap_replicate_bit_equals_weighted(Q, k, s, d, R):
    """DESIGN.md §10 on the CPU: replicate r of the plain (and dispatched)
    bootstrap_moments is the plain weighted_moments with W[r], bit for
    bit, whatever replicate block r falls in."""
    c, a, valid, W, q_lo, q_hi = _t(*_inputs(Q, k, s, d, R, Q + 3 * k))
    block = ops.bootstrap_moments(c, a, valid, W, q_lo, q_hi)
    assert torch.equal(block, bootstrap_moments_plain(c, a, valid, W, q_lo,
                                                      q_hi))
    for r in range(R):
        one = ops.weighted_moments(c, a, valid, W[r], q_lo, q_hi)
        assert torch.equal(one, weighted_moments_plain(c, a, valid, W[r],
                                                       q_lo, q_hi))
        assert torch.equal(block[r], one), r
    # invalid slots count as weight 0 whatever W holds there
    zeroed = torch.where(valid, W[0], 0.0)
    assert torch.equal(ops.weighted_moments(c, a, valid, zeroed, q_lo, q_hi),
                       block[0])


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("n,k", [(1, 1), (300, 13), (257, 1)])
def test_weighted_segment_reduce_plain_matches_jax(n, k, backend):
    rng = np.random.default_rng(n + k)
    v = rng.lognormal(0.9, 0.8, n).astype(np.float32)
    w = rng.poisson(1.0, n).astype(np.float32)       # zeros among them
    ids = rng.integers(-1, k + 2, n).astype(np.int32)
    want = np.asarray(jax.jit(get_backend(backend).weighted_segment_reduce,
                              static_argnums=3)(
        *map(jnp.asarray, (v, w, ids)), k))
    got = weighted_segment_reduce_plain(*_t(v, w, ids), k)
    assert got.dtype == torch.float32 and got.shape == (k, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(ops.weighted_segment_reduce(*_t(v, w, ids), k), got)


def test_weighted_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; they never fall back."""
    c, a, valid, W, q_lo, q_hi = _t(*_inputs(3, 4, 5, 2, 2, 0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        stratified_weighted_moments_cuda(c, a, valid, W[0], q_lo, q_hi)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bootstrap_moments_cuda(c, a, valid, W, q_lo, q_hi)
    with pytest.raises(ValueError, match="CUDA tensors"):
        weighted_segment_reduce_cuda(a[0], W[0, 0], torch.zeros(
            5, dtype=torch.int32), 2)


# ---------------------------------------------------------------------------
# Replicates and serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """(jax synopsis, port synopsis, jax queries, port queries): 6 random
    queries and 2 that cover whole leaf runs exactly."""
    c, a = _data(1, 4000, seed=11)
    jsyn, _ = jbuild(c, a, k=12, sample_rate=0.05, method="adp", seed=0,
                     opt_samples=1024)
    assert jsyn.sample_a.shape[1] <= 32
    jq = jquery.random_queries(c, 6, seed=2, min_frac=0.05, max_frac=0.5)
    blo = np.asarray(jsyn.leaf_lo)[:, 0]
    bhi = np.asarray(jsyn.leaf_hi)[:, 0]
    lo = np.concatenate([np.asarray(jq.lo), [[blo[0]], [blo[2]]]])
    hi = np.concatenate([np.asarray(jq.hi), [[bhi[-1]], [bhi[8]]]])
    jq = JQueryBatch(jnp.asarray(lo, jnp.float32), jnp.asarray(hi,
                                                              jnp.float32))
    return jsyn, carry(jsyn), jq, carry_queries(jq)


@pytest.mark.parametrize("normalize", ["hajek", "ht"])
def test_bootstrap_replicates_match_jax(served, normalize):
    jsyn, tsyn, jq, tq = served
    jk = jax.random.PRNGKey(9)
    want = np.asarray(jboot.bootstrap_replicates(
        jsyn, jq, BOOT, n_boot=13, key=jk, normalize=normalize))
    got = tboot.bootstrap_replicates(tsyn, tq, BOOT, n_boot=13,
                                     key=np.asarray(jk), normalize=normalize)
    assert got.shape == want.shape == (13, 3, 8)
    for i in range(3):
        scale = batch_scale(want[:, i])
        np.testing.assert_allclose(got[:, i].numpy(), want[:, i], rtol=3e-5,
                                   atol=3e-5 * scale, err_msg=BOOT[i])


@pytest.mark.parametrize("R", [1, 11])
@pytest.mark.parametrize("normalize", ["hajek", "ht"])
def test_fused_equals_scan_bitwise(served, R, normalize):
    _, tsyn, _, tq = served
    fused = tboot.bootstrap_replicates(tsyn, tq, BOOT, n_boot=R, seed=4,
                                       normalize=normalize, fused=True)
    scan = tboot.bootstrap_replicates(tsyn, tq, BOOT, n_boot=R, seed=4,
                                      normalize=normalize, fused=False)
    assert fused.shape == (R, 3, 8)
    assert torch.equal(fused, scan)


@pytest.mark.parametrize("normalize,fused", [("hajek", True),
                                             ("ht", False)])
def test_engine_bootstrap_matches_jax(served, normalize, fused):
    """PassEngine(ci=CIConfig(method="bootstrap", key=<JAX key data>))
    against the JAX engine; the exactly covered queries get zero-width
    intervals, as in tests/test_uncertainty.py."""
    jsyn, tsyn, jq, tq = served
    jk = jax.random.PRNGKey(21)
    kw = dict(level=0.9, method="bootstrap", n_boot=24,
              boot_normalize=normalize, boot_fused=fused)
    jres = JEngine(jsyn, JServing(kinds=BOOT), ci=JCI(key=jk, **kw)
                   ).answer(jq)
    eng = PassEngine(tsyn, ServingConfig(kinds=BOOT),
                     ci=CIConfig(key=np.asarray(jk, np.uint32), **kw),
                     device="cpu")
    tres = eng.answer(tq)
    assert_results_close(jres, tres, BOOT)
    assert eng.stats()["fused_serves"] == int(fused)
    for kind in BOOT:
        est, lo, hi = (x[6:] for x in tres[kind].interval())
        assert torch.equal(est, lo) and torch.equal(est, hi), kind
        assert (tres[kind].ci_half[6:] == 0.0).all()


def test_key_forms_and_cache_key(served):
    """None is PRNGKey(0); an int, a numpy key and a torch key serve the
    same answer; every bootstrap field keys the plan cache."""
    _, tsyn, _, tq = served
    eng = PassEngine(tsyn, ServingConfig(kinds=("avg",)), device="cpu")
    outs = [eng.answer(tq, ci=CIConfig(method="bootstrap", n_boot=5,
                                       key=key))["avg"].ci_lo
            for key in (None, 0, np.asarray([0, 0], np.uint32),
                        torch.tensor([0, 0]))]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    other = eng.answer(tq, ci=CIConfig(method="bootstrap", n_boot=5,
                                       key=7))["avg"].ci_lo
    assert not torch.equal(outs[0], other)
    base = CIConfig(method="bootstrap")
    keys = {base.cache_key()}
    for change in (dict(n_boot=7), dict(boot_normalize="ht"),
                   dict(boot_fused=False), dict(key=3)):
        keys.add(CIConfig(method="bootstrap", **change).cache_key())
    assert len(keys) == 5


def test_bootstrap_rejects_bad_args(served):
    _, tsyn, _, tq = served
    with pytest.raises(ValueError, match="bootstrap supports"):
        PassEngine(tsyn, ServingConfig(kinds=("sum", "min")),
                   ci=CIConfig(method="bootstrap"), device="cpu")
    with pytest.raises(ValueError, match="unknown normalize"):
        PassEngine(tsyn, ServingConfig(kinds=("sum",)),
                   ci=CIConfig(method="bootstrap", boot_normalize="x"),
                   device="cpu")
    with pytest.raises(ValueError, match="avg_mode='ratio'"):
        PassEngine(tsyn, ServingConfig(kinds=("avg",), avg_mode="stratum"),
                   ci=CIConfig(method="bootstrap"), device="cpu")
    with pytest.raises(ValueError, match="bootstrap supports"):
        tboot.bootstrap_replicates(tsyn, tq, ("max",))
    with pytest.raises(ValueError, match="unknown normalize"):
        tboot.bootstrap_replicates(tsyn, tq, normalize="x")
    with pytest.raises(ValueError, match="two uint32 words"):
        tboot.key_tensor(np.zeros(3, np.uint32), "cpu")
