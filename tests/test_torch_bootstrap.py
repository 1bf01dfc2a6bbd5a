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
  ``weighted_moments`` with its weight row (DESIGN.md §10);
* the identities the CUDA kernels rest on hold bit for bit in the plain
  versions: a covered (query, stratum) pair has the stratum's totals, an
  empty one +0.0 (with one documented exception in the sign of a zero).
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
    WSEG_MAX_CHUNKS, WSEG_MIN_ROWS, weighted_segment_plan,
    weighted_segment_reduce_cuda, weighted_segment_reduce_plain)
from repro_torch.kernels.stratified_estimate import (
    WEIGHTED_CHUNK, WEIGHTED_MAX_K, WEIGHTED_MAX_R, check_weighted_limits,
    stratified_weighted_moments_cuda, weighted_moments_plain,
    weighted_scratch)
from repro_torch import random as trandom
from repro_torch.uncertainty import bootstrap as tboot
from test_torch_engine import (_data, assert_results_close, batch_scale,
                               carry, carry_queries)

RTOL, ATOL = 3e-5, 1e-3
BOOT = ("sum", "count", "avg")

# (Q, k, s, d, R): ragged everything, one of each, several replicate
# blocks of the plain version (br = 8) with a ragged last one.
SHAPES = [(8, 13, 32, 3, 11), (1, 1, 1, 1, 1), (5, 16, 7, 2, 24)]
# The inputs of _class_inputs, where the CUDA kernels' three pair classes
# (covered, empty, mixed) all appear; the last case of each SHAPES test.
CLASSES = (12, 20, 24, 2, 9)
CASES = SHAPES + [pytest.param(*CLASSES, id="covered-empty-boundary")]


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


def _class_inputs(Q, k, s, d, R, seed):
    """Each stratum's samples in its own cell of a grid over [0, 1)^d, with
    ragged validity (stratum 0 empty). Query 0 covers every sample, 1 misses
    everything, 2 is inverted, 3's edges are the exact extremes of the
    first non-empty stratum's valid samples (boundary equality counts), 4's
    lower edge is one of its samples; the rest span a few cells."""
    c, a, valid, W, _, _ = _inputs(Q, k, s, d, R, seed)
    rng = np.random.default_rng(seed + 1)
    g = max(1, int(np.ceil(k ** (1.0 / d) - 1e-9)))
    cell = np.stack([(np.arange(k) // g ** j) % g for j in range(d)], 1)
    c = ((cell[:, None, :] + rng.uniform(0.05, 0.95, (k, s, d)))
         / g).astype(np.float32)
    q_lo = rng.uniform(-0.1, 1.0, (Q, d)).astype(np.float32)
    q_hi = (q_lo + rng.uniform(0.0, 3.0 / g, (Q, d))).astype(np.float32)
    leaf = _first_nonempty(valid)
    pts = c[leaf][valid[leaf]]
    fixed = [(-1.0, 2.0), (3.0, 4.0), (0.9, 0.1),
             (pts.min(0), pts.max(0)), (pts[0], pts.max(0) + 1.0 / g)]
    for i, (lo, hi) in enumerate(fixed[:Q]):
        q_lo[i], q_hi[i] = lo, hi
    return c, a, valid, W, q_lo, q_hi


def _first_nonempty(valid):
    return int(np.flatnonzero(valid.any(1))[0])


def _case_inputs(Q, k, s, d, R, seed):
    if (Q, k, s, d, R) == CLASSES:
        return _class_inputs(Q, k, s, d, R, seed)
    return _inputs(Q, k, s, d, R, seed)


def _classes(c, valid, q_lo, q_hi):
    """(Q, k) masks of the covered, empty and mixed pairs."""
    inside = ((q_lo[:, None, None] <= c[None]).all(-1)
              & (c[None] <= q_hi[:, None, None]).all(-1) & valid[None])
    n = inside.sum(-1)
    empty = n == 0
    covered = ~empty & (n == valid.sum(-1)[None])
    return covered, empty, ~empty & ~covered


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
@pytest.mark.parametrize("Q,k,s,d,R", CASES)
def test_weighted_moments_plain_matches_jax(Q, k, s, d, R, backend):
    c, a, valid, W, q_lo, q_hi = _case_inputs(Q, k, s, d, R, Q + 7 * k)
    want = jax.jit(get_backend(backend).weighted_moments)(
        *map(jnp.asarray, (c, a, valid, W[0], q_lo, q_hi)))
    got = weighted_moments_plain(*_t(c, a, valid, W[0], q_lo, q_hi))
    assert got.dtype == torch.float32 and got.shape == (Q, k, 3)
    for i in range(3):
        np.testing.assert_allclose(got[..., i].numpy(), np.asarray(want[i]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("Q,k,s,d,R", CASES)
def test_bootstrap_moments_plain_matches_jax(Q, k, s, d, R, backend):
    c, a, valid, W, q_lo, q_hi = _case_inputs(Q, k, s, d, R, Q + 5 * k)
    want = np.asarray(jax.jit(get_backend(backend).bootstrap_moments)(
        *map(jnp.asarray, (c, a, valid, W, q_lo, q_hi))))
    got = bootstrap_moments_plain(*_t(c, a, valid, W, q_lo, q_hi))
    assert got.dtype == torch.float32 and got.shape == (R, Q, k, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("Q,k,s,d,R", CASES)
def test_plain_bootstrap_replicate_bit_equals_weighted(Q, k, s, d, R):
    """DESIGN.md §10 on the CPU: replicate r of the plain (and dispatched)
    bootstrap_moments is the plain weighted_moments with W[r], bit for
    bit, whatever replicate block r falls in."""
    c, a, valid, W, q_lo, q_hi = _t(*_case_inputs(Q, k, s, d, R,
                                                  Q + 3 * k))
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


def test_class_inputs_hold_every_class():
    c, a, valid, W, q_lo, q_hi = _class_inputs(*CLASSES, seed=3)
    covered, empty, mixed = _classes(c, valid, q_lo, q_hi)
    assert covered.any() and empty.any() and mixed.any()
    assert covered[0, valid.any(1)].all() and empty[1:3].all()
    leaf = _first_nonempty(valid)
    assert covered[3, leaf] and mixed[4, leaf]


def _nan_class_inputs(seed, nan):
    """_class_inputs with two strata marked: with ``nan``, the first has a
    NaN coordinate on one valid slot and the second NaN in column 0 of
    every slot, so that neither can be covered (the slot test rejects NaN;
    a box built with fminf / fmaxf skips it). Their weights are positive,
    so a pair that copied the stratum's totals would show."""
    c, a, valid, W, q_lo, q_hi = _class_inputs(*CLASSES, seed=seed)
    full = [i for i in range(c.shape[0]) if valid[i].sum() >= 2]
    l1, l2 = full[0], full[1]
    W[:, [l1, l2]] = np.maximum(W[:, [l1, l2]], 0.5)
    if nan:
        c[l1, np.flatnonzero(valid[l1])[0], -1] = np.nan
        c[l2, :, 0] = np.nan
    return (c, a, valid, W, q_lo, q_hi), (l1, l2)


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("fn", ["weighted_moments", "bootstrap_moments"])
@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
def test_weighted_plain_matches_jax_on_nan_classes(nan, fn, backend):
    """On class inputs, finite and with NaN coordinates on valid slots (one
    slot of a stratum, every slot of another), the plain
    stratified_weighted_moments and bootstrap_moments meet the JAX
    package's Pallas and jnp versions. Query 0's box holds every finite
    sample: the two strata's pairs under it are their full-box totals when
    finite, and with NaN mixed and empty, never those totals."""
    (c, a, valid, W, q_lo, q_hi), strata = _nan_class_inputs(11, nan)
    covered, empty, mixed = _classes(c, valid, q_lo, q_hi)
    assert covered.any() and empty.any() and mixed.any()
    l1, l2 = strata
    if nan:
        assert not covered[:, [l1, l2]].any()
        assert mixed[0, l1] and empty[:, l2].all()
    else:
        assert covered[0, [l1, l2]].all()
    if fn == "weighted_moments":
        W = W[:1]
        want = np.stack([np.asarray(x) for x in jax.jit(
            get_backend(backend).weighted_moments)(
                *map(jnp.asarray, (c, a, valid, W[0], q_lo, q_hi)))], -1)
        got = weighted_moments_plain(*_t(c, a, valid, W[0], q_lo,
                                         q_hi))[None].numpy()
        want = want[None]
    else:
        want = np.asarray(jax.jit(get_backend(backend).bootstrap_moments)(
            *map(jnp.asarray, (c, a, valid, W, q_lo, q_hi))))
        got = bootstrap_moments_plain(*_t(c, a, valid, W, q_lo,
                                          q_hi)).numpy()
    assert got.shape == want.shape == (W.shape[0],) + q_lo.shape[:1] + \
        (c.shape[0], 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the totals a covered pair copies: every valid slot, coordinates aside
    wv = np.where(valid[None], W, 0.0).astype(np.float64)
    totals = np.stack([wv.sum(-1), (wv * a).sum(-1),
                       (wv * a * a).sum(-1)], -1)       # (R, k, 3)
    for leaf in strata:
        is_total = np.isclose(got[:, 0, leaf], totals[:, leaf], rtol=RTOL,
                              atol=ATOL).all(-1)
        assert (not is_total.any()) if nan else is_total.all(), leaf


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_covered_pair_equals_full_box(seed):
    """The identity the CUDA kernels copy for a covered (query, stratum)
    pair: its moments are torch.equal to those of a box around every
    sample (the stratum's totals), in every replicate, for the plain
    bootstrap_moments and weighted_moments alike."""
    c, a, valid, W, q_lo, q_hi = _class_inputs(*CLASSES, seed=seed)
    covered, _, _ = _classes(c, valid, q_lo, q_hi)
    assert covered[1:].any()
    c, a, valid, W, q_lo, q_hi = _t(c, a, valid, W, q_lo, q_hi)
    full_lo = torch.full_like(q_lo[:1], -1.0)
    full_hi = torch.full_like(q_hi[:1], 2.0)
    block = bootstrap_moments_plain(c, a, valid, W, q_lo, q_hi)
    totals = bootstrap_moments_plain(c, a, valid, W, full_lo, full_hi)
    for q, leaf in np.argwhere(covered):
        assert torch.equal(block[:, q, leaf], totals[:, 0, leaf]), (q, leaf)
    one = weighted_moments_plain(c, a, valid, W[2], q_lo, q_hi)
    one_totals = weighted_moments_plain(c, a, valid, W[2], full_lo, full_hi)
    for q, leaf in np.argwhere(covered):
        assert torch.equal(one[q, leaf], one_totals[0, leaf]), (q, leaf)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_empty_pair_is_positive_zero(seed):
    """The identity the CUDA kernels write for an empty pair (no valid
    sample inside: boxes that miss everything, inverted boxes, strata
    without a valid sample): every moment is +0.0, sign bit clear, for the
    plain bootstrap_moments and weighted_moments alike."""
    c, a, valid, W, q_lo, q_hi = _class_inputs(*CLASSES, seed=seed)
    _, empty, _ = _classes(c, valid, q_lo, q_hi)
    assert empty[1:3].all() and empty[:, 0].all()
    c, a, valid, W, q_lo, q_hi = _t(c, a, valid, W, q_lo, q_hi)
    block = bootstrap_moments_plain(c, a, valid, W, q_lo, q_hi)
    one = weighted_moments_plain(c, a, valid, W[0], q_lo, q_hi)
    mask = torch.from_numpy(empty)
    assert (block.permute(1, 2, 0, 3)[mask].view(torch.int32) == 0).all()
    assert (one[mask].view(torch.int32) == 0).all()


def test_plain_empty_pair_negative_zero_when_every_value_is_negative():
    """The one exception to +0.0: where every slot of a stratum holds
    a < 0 and s is a power of two (so tree_sum_last adds no +0.0 padding),
    the plain sum of w*a over an empty pair is -0.0 (+0.0 * a). The CUDA
    kernels write +0.0 there; the two compare equal, which is all the
    kernel-against-plain checks ask."""
    k, s = 3, 8
    c = torch.zeros((k, s, 1))
    a = -torch.ones((k, s))
    valid = torch.ones((k, s), dtype=torch.bool)
    W = torch.ones((2, k, s))
    q_lo, q_hi = torch.full((1, 1), 5.0), torch.full((1, 1), 6.0)
    got = bootstrap_moments_plain(c, a, valid, W, q_lo, q_hi)
    assert (got == 0).all()
    assert torch.signbit(got[..., 1]).all()
    assert not torch.signbit(got[..., 0]).any()
    assert not torch.signbit(got[..., 2]).any()


def test_weighted_kernel_limits():
    """The sizes the CUDA wrappers take: tiles of 32 queries along
    gridDim.x, the totals kernel's tiles of 128 segments (a stratum's slot
    chunks of WEIGHTED_CHUNK) and the direct walk's replicate tiles of 16
    along gridDim.y, any slot count a C int holds, any d a C int holds
    (above 16 the wide kernels, the columns in blocks of 16)."""
    check_weighted_limits("w", 2048, 1024, 75, 3, R=WEIGHTED_MAX_R)
    check_weighted_limits("w", 1, WEIGHTED_MAX_K, WEIGHTED_CHUNK, 16)
    check_weighted_limits("w", 1, 1, 0, 1)
    check_weighted_limits("w", 2048, 1, 40_000, 1, R=200)
    check_weighted_limits("w", 1, 1, 2 ** 31 - 1, 16)
    check_weighted_limits("w", 1, 1, 75, 17)
    check_weighted_limits("w", 2048, 1024, 75, 300, R=200)
    for bad in (dict(Q=0), dict(k=0), dict(k=WEIGHTED_MAX_K + 1),
                dict(k=WEIGHTED_MAX_K, s=WEIGHTED_CHUNK + 1), dict(s=2 ** 31),
                dict(s=-1), dict(d=0),
                dict(d=2 ** 31), dict(R=0), dict(R=WEIGHTED_MAX_R + 1),
                dict(Q=2 ** 31 - 1, k=64)):
        args = dict(Q=8, k=16, s=4, d=2, R=3)
        args.update(bad)
        with pytest.raises(ValueError, match="needs"):
            check_weighted_limits("w", args["Q"], args["k"], args["s"],
                                  args["d"], args["R"])
    # totals (R, k, 3), boxes (k, 2, d), valid bits (k, ceil(s / 32)), a
    # NaN flag per leaf and a count per tile of 32 queries x 32 leaves (82
    # floats, padded to 84), the staged walk's two counters (4 floats), an
    # item (2 ints) per (tile, leaf) of the 2 tiles, and a list entry of
    # 1 + ceil(s / 32) words per (query, leaf) of a tile.
    assert weighted_scratch(3, 40, 5, 33, 2, "cpu").numel() == \
        45 + 20 + 10 + 5 + 2 + 2 + 4 + 2 * 2 * 32 + 2 * 32 * 32 * 3
    # Above one chunk of WEIGHTED_CHUNK = 2048 slots: 20 segments of one
    # leaf, 16 a tile (the masks of 64 words a query fill the tile's shared
    # memory), and the (R, Q, 20, 3) partials from a multiple of 4 floats.
    assert WEIGHTED_CHUNK == 2048
    head = 2 * 20 * 3 + 20 * 2 + 20 * 64 + 20 + 2
    head = -(-head // 4) * 4 + 4 + 2 * 2 * 16 + 2 * 32 * 16 * 65
    assert weighted_scratch(2, 3, 1, 40_000, 1, "cpu").numel() == \
        -(-head // 4) * 4 + 2 * 3 * 20 * 3


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


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("k,s", [(24, 75), (300, 7)])
def test_weighted_segment_reduce_plain_matches_jax_leaf_major(k, s,
                                                              backend):
    """The layout the JAX package's fused-bootstrap benchmark hands the
    kernel: the (k, s) samples flattened leaf-major, a Poisson weight per
    slot and -1 on invalid slots; k = 300 is no multiple of 256 (the
    Pallas segment tile), and neither are the rows."""
    rng = np.random.default_rng(k * s)
    a = rng.normal(0, 3, (k, s)).astype(np.float32)
    valid = rng.random((k, s)) < 0.7
    valid[0] = False
    w = rng.poisson(1.0, (k, s)).astype(np.float32)
    ids = np.where(valid, np.arange(k, dtype=np.int32)[:, None], -1)
    v, w, ids = a.reshape(-1), w.reshape(-1), ids.reshape(-1)
    want = np.asarray(jax.jit(get_backend(backend).weighted_segment_reduce,
                              static_argnums=3)(
        *map(jnp.asarray, (v, w, ids)), k))
    got = weighted_segment_reduce_plain(*_t(v, w, ids), k)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert (got[0] == 0).all()


def test_weighted_segment_plan():
    """The one-launch plan: at most WSEG_MAX_CHUNKS chunks of a multiple of
    32 rows (at least WSEG_MIN_ROWS) that cover the rows with no chunk
    left empty, fixed by N alone; one (rows, 3) buffer of out (k, 3), the
    chunks' partials (chunks, k, 3) and their id ranges (chunks, 2)."""
    assert weighted_segment_plan(76800, 1024) == (
        64, 1216, 1024 + 64 * 1024 + 43)
    assert weighted_segment_plan(0, 5) == (1, WSEG_MIN_ROWS, 5 + 5 + 1)
    for n in (1, 17, 255, 256, 257, 4096, 65537, 76800, 10 ** 7):
        for k in (1, 53, 1024, 1025):
            chunks, rows, buf_rows = weighted_segment_plan(n, k)
            assert 1 <= chunks <= WSEG_MAX_CHUNKS
            assert rows % 32 == 0 and rows >= WSEG_MIN_ROWS
            assert (chunks - 1) * rows < n <= chunks * rows
            assert 0 <= 3 * buf_rows - (3 * k + chunks * (3 * k + 2)) < 3
            assert weighted_segment_plan(n, 7)[:2] == (chunks, rows)


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
