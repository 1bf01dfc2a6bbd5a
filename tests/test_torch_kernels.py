"""The port's kernel ops against the JAX package's kernels.

The plain PyTorch versions (what CPU tensors run; the reference the CUDA
kernels are held against on the card by chip_smoke.py) are compared with
the Pallas kernels run the way tests/test_kernels.py runs them (interpret
mode on the CPU) and with the jnp backend. Same numpy inputs, made from a
seed, go to both. Tolerances: relation codes and counts are exact;
float sums meet rtol=3e-5, atol=1e-3, the bar tests/test_kernels.py sets
for Pallas, because fp32 sums are taken in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.kernels import backends as _jax_backends  # noqa: F401 (registers)
from repro.kernels.registry import get_backend
from repro_torch.kernels import native, ops
from repro_torch.kernels.query_eval import (query_eval_cuda,
                                            query_eval_plain)
from repro_torch.kernels.sample_extremes import sample_extremes_cuda
from repro_torch.kernels.stratified_estimate import (
    MOMENTS_LT, MOMENTS_QT, check_moments_limits, stratified_moments_cuda,
    stratified_moments_plain)

RTOL, ATOL = 3e-5, 1e-3

# (Q, k, s, d): ragged Q and k (no multiple of any block), d in {1, 3},
# s = 1 and s a full block of 64, a single query and leaf.
SHAPES = [(130, 53, 7, 3), (64, 128, 64, 1), (1, 1, 1, 3)]


def _leaves(rng, k, d):
    lo = rng.uniform(-1, 0.5, (k, d)).astype(np.float32)
    hi = lo + rng.uniform(0, 1, (k, d)).astype(np.float32)
    agg = rng.normal(0, 1, (k, 5)).astype(np.float32)
    agg[:, 2] = rng.integers(1, 50, k)
    if k > 2:
        # An empty leaf as the build writes it (inverted +-inf box, +-inf
        # extremes) and a finite inverted box.
        lo[k // 2], hi[k // 2] = np.inf, -np.inf
        agg[k // 2] = [0, 0, 0, np.inf, -np.inf]
        hi[1] = lo[1] - 0.5
    return lo, hi, agg


def _queries(rng, Q, d):
    q_lo = rng.uniform(-1, 0, (Q, d)).astype(np.float32)
    q_hi = q_lo + rng.uniform(0, 1.5, (Q, d)).astype(np.float32)
    return q_lo, q_hi


def _samples(rng, k, s, d):
    c = rng.uniform(-1, 1, (k, s, d)).astype(np.float32)
    a = rng.normal(0, 3, (k, s)).astype(np.float32)
    valid = rng.random((k, s)) < 0.7            # ragged validity
    valid[0] = False                            # a stratum with no samples
    return c, a, valid


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


# (Q, k, s, d) of the class inputs, where the CUDA kernel's three pair
# classes (covered, empty, mixed) all appear.
CLASS_SHAPE = (12, 20, 24, 2)


def _class_samples(seed, nan=False):
    """Each stratum's samples in its own cell of a grid over [0, 1)^d,
    ragged validity, strata 0 and k // 2 without a valid sample. Query 0
    covers every sample, 1 misses everything, 2 is inverted, 3's edges are
    the exact extremes of stratum 1's valid samples, 4's lower edge is one
    of them; the rest span a few cells. With ``nan``, stratum 1 has a NaN
    coordinate on a valid slot and stratum 2 NaN in column 0 on every
    slot: neither can then be covered."""
    Q, k, s, d = CLASS_SHAPE
    rng = np.random.default_rng(seed)
    _, a, valid = _samples(rng, k, s, d)
    valid[k // 2] = False
    valid[1, :2] = True
    g = int(np.ceil(k ** (1.0 / d) - 1e-9))
    cell = np.stack([(np.arange(k) // g ** j) % g for j in range(d)], 1)
    c = ((cell[:, None, :] + rng.uniform(0.05, 0.95, (k, s, d)))
         / g).astype(np.float32)
    q_lo = rng.uniform(-0.1, 1.0, (Q, d)).astype(np.float32)
    q_hi = (q_lo + rng.uniform(0.0, 3.0 / g, (Q, d))).astype(np.float32)
    pts = c[1][valid[1]]
    fixed = [(-1.0, 2.0), (3.0, 4.0), (0.9, 0.1),
             (pts.min(0), pts.max(0)), (pts[0], pts.max(0) + 1.0 / g)]
    for i, (lo, hi) in enumerate(fixed):
        q_lo[i], q_hi[i] = lo, hi
    if nan:
        c[1, 1, d - 1] = np.nan
        c[2, :, 0] = np.nan
    return c, a, valid, q_lo, q_hi


def _pair_classes(c, valid, q_lo, q_hi):
    """(Q, k) masks of the covered, empty and mixed pairs."""
    inside = ((q_lo[:, None, None] <= c[None]).all(-1)
              & (c[None] <= q_hi[:, None, None]).all(-1) & valid[None])
    n = inside.sum(-1)
    empty = n == 0
    covered = ~empty & (n == valid.sum(-1)[None])
    return covered, empty, ~empty & ~covered


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("Q,k,s,d", SHAPES)
def test_query_eval_plain_matches_jax(Q, k, s, d, backend):
    rng = np.random.default_rng(Q * 1000 + k)
    lo, hi, agg = _leaves(rng, k, d)
    q_lo, q_hi = _queries(rng, Q, d)
    rel_j, exact_j = jax.jit(get_backend(backend).query_eval)(
        *map(jnp.asarray, (lo, hi, agg, q_lo, q_hi)))
    rel_t, exact_t = query_eval_plain(*_t(lo, hi, agg, q_lo, q_hi))
    assert rel_t.dtype == torch.int32 and rel_t.shape == (Q, k)
    np.testing.assert_array_equal(rel_t.numpy(), np.asarray(rel_j))
    if k > 2:
        assert (rel_t[:, k // 2] == 0).all()    # the empty leaf is NONE
    np.testing.assert_allclose(exact_t.numpy()[:, :3],
                               np.asarray(exact_j)[:, :3], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("Q,k,s,d", SHAPES)
def test_stratified_moments_plain_matches_jax(Q, k, s, d, backend):
    rng = np.random.default_rng(Q * 1000 + k + 1)
    c, a, valid = _samples(rng, k, s, d)
    q_lo, q_hi = _queries(rng, Q, d)
    want = jax.jit(get_backend(backend).stratified_moments)(
        *map(jnp.asarray, (c, a, valid, q_lo, q_hi)))
    out = stratified_moments_plain(*_t(c, a, valid, q_lo, q_hi))
    assert out.dtype == torch.float32 and out.shape == (Q, k, 3)
    np.testing.assert_array_equal(out[..., 0].numpy(), np.asarray(want[0]))
    for i in (1, 2):
        np.testing.assert_allclose(out[..., i].numpy(), np.asarray(want[i]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
def test_stratified_moments_plain_matches_jax_on_classes(nan, backend):
    """On inputs where covered, empty and mixed pairs all appear (with
    ``nan``, also strata with NaN coordinates on valid slots), the plain
    version meets the JAX package's Pallas and jnp versions."""
    c, a, valid, q_lo, q_hi = _class_samples(5, nan)
    covered, empty, mixed = _pair_classes(c, valid, q_lo, q_hi)
    assert covered.any() and empty.any() and mixed.any()
    if nan:
        assert not covered[:, 1:3].any() and mixed[0, 1]
    want = jax.jit(get_backend(backend).stratified_moments)(
        *map(jnp.asarray, (c, a, valid, q_lo, q_hi)))
    out = stratified_moments_plain(*_t(c, a, valid, q_lo, q_hi))
    np.testing.assert_array_equal(out[..., 0].numpy(), np.asarray(want[0]))
    for i in (1, 2):
        np.testing.assert_allclose(out[..., i].numpy(), np.asarray(want[i]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_covered_pair_equals_leaf_totals(seed):
    """The identity the CUDA kernel copies for a covered (query, stratum)
    pair: its moments are torch.equal to those of a box around every
    sample, the stratum's totals."""
    c, a, valid, q_lo, q_hi = _class_samples(seed)
    covered, _, _ = _pair_classes(c, valid, q_lo, q_hi)
    assert covered[1:].any()
    c, a, valid, q_lo, q_hi = _t(c, a, valid, q_lo, q_hi)
    out = stratified_moments_plain(c, a, valid, q_lo, q_hi)
    totals = stratified_moments_plain(c, a, valid, torch.full_like(
        q_lo[:1], -1.0), torch.full_like(q_hi[:1], 2.0))
    assert torch.equal(totals[0, :, 0], valid.sum(1).to(torch.float32))
    for q, leaf in np.argwhere(covered):
        assert torch.equal(out[q, leaf], totals[0, leaf]), (q, leaf)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_empty_pair_is_zero(seed):
    """The identity the CUDA kernel writes for an empty pair (boxes that
    miss everything, inverted boxes, strata without a valid sample):
    every moment is 0. The kernel writes +0.0; the plain sum of a*0 is
    -0.0 where every slot holds a < 0, which compares equal."""
    c, a, valid, q_lo, q_hi = _class_samples(seed)
    _, empty, _ = _pair_classes(c, valid, q_lo, q_hi)
    assert empty[1:3].all() and empty[:, 0].all()
    out = stratified_moments_plain(*_t(c, a, valid, q_lo, q_hi))
    assert (out[torch.from_numpy(empty)] == 0).all()


def test_moments_kernel_limits():
    """The sizes the CUDA wrapper takes: tiles of 128 queries x 16 leaves
    along gridDim.x, sizes that fit a C int, any s, any d (above 16 the
    wide kernels, the columns in blocks of 16): d is refused only past a C
    int."""
    assert (MOMENTS_QT, MOMENTS_LT) == (128, 16)
    check_moments_limits("m", 2048, 1024, 75, 3)
    check_moments_limits("m", 1, 1, 0, 16)
    check_moments_limits("m", 1, 1, 0, 17)
    check_moments_limits("m", 2048, 1024, 75, 300)
    check_moments_limits("m", 2 ** 31 - 1, 16, 2 ** 31 - 1, 1)
    check_moments_limits("m", 1, 1, 1, 2 ** 31 - 1)
    for bad in (dict(Q=0), dict(k=0), dict(s=-1), dict(d=0),
                dict(d=2 ** 31), dict(Q=2 ** 31), dict(k=2 ** 31),
                dict(s=2 ** 31), dict(Q=2 ** 31 - 1, k=2048)):
        args = dict(Q=8, k=16, s=4, d=2)
        args.update(bad)
        with pytest.raises(ValueError, match="needs"):
            check_moments_limits("m", **args)


@pytest.mark.parametrize("Q,k,s,d", SHAPES[:2])
def test_cpu_ops_dispatch_to_plain(Q, k, s, d):
    """CPU tensors take the plain version; sample_extremes equals the JAX
    package's broadcast op exactly (min/max round nothing)."""
    rng = np.random.default_rng(Q + k + s)
    lo, hi, agg = _leaves(rng, k, d)
    c, a, valid = _samples(rng, k, s, d)
    q_lo, q_hi = _queries(rng, Q, d)
    rel, exact = ops.query_eval(*_t(lo, hi, agg, q_lo, q_hi))
    rel_p, exact_p = query_eval_plain(*_t(lo, hi, agg, q_lo, q_hi))
    assert torch.equal(rel, rel_p)
    assert torch.equal(exact[:, :3], exact_p[:, :3])
    moms = ops.stratified_moments(*_t(c, a, valid, q_lo, q_hi))
    plain = stratified_moments_plain(*_t(c, a, valid, q_lo, q_hi))
    for i in range(3):
        assert torch.equal(moms[i], plain[..., i])
    mn, mx = ops.sample_extremes(*_t(c, a, valid, q_lo, q_hi))
    jmn, jmx = jax.jit(get_backend("jnp").sample_extremes)(
        *map(jnp.asarray, (c, a, valid, q_lo, q_hi)))
    np.testing.assert_array_equal(mn.numpy(), np.asarray(jmn))
    np.testing.assert_array_equal(mx.numpy(), np.asarray(jmx))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; they never fall back to the
    plain version."""
    rng = np.random.default_rng(0)
    lo, hi, agg = _leaves(rng, 4, 2)
    c, a, valid = _samples(rng, 4, 3, 2)
    q_lo, q_hi = _queries(rng, 3, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        query_eval_cuda(*_t(lo, hi, agg, q_lo, q_hi))
    with pytest.raises(ValueError, match="CUDA tensors"):
        stratified_moments_cuda(*_t(c, a, valid, q_lo, q_hi))
    with pytest.raises(ValueError, match="CUDA tensors"):
        sample_extremes_cuda(*_t(c, a, valid, q_lo, q_hi))
    with pytest.raises(ValueError, match="several devices"):
        ops.query_eval(*_t(lo, hi, agg, q_lo), torch.empty(3, 2,
                                                           device="meta"))


def test_missing_toolkit_raises(monkeypatch, tmp_path):
    """With no nvcc the kernel library build raises: nothing falls back."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.library("query_eval")
    assert native.library_path("query_eval").parent == tmp_path
    assert set(native.LAUNCHES) == {
        "query_eval", "stratified_moments", "stratified_weighted_moments",
        "bootstrap_moments", "segment_reduce", "weighted_segment_reduce",
        "route_multid", "sample_extremes", "join_cell_moments", "threefry",
        "join_epilogue"}
