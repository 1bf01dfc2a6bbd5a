"""Row 10, the threefry draws, on the CPU.

The kernel of ``kernels/csrc/threefry.cu`` runs only on a card; there
``chip_smoke.py`` holds it bit for bit against its plain version (the
int64 torch code of ``repro_torch.random`` and ``poisson_weights_plain``).
Here:

* the port's fused draw (W masked, K*) equals the JAX package's
  ``_draw_weights`` masked and summed, bit for bit;
* a numpy ``uint32`` model of the kernel's own formulation, its rounds and
  key injections read from the CUDA source, its uniform and its Poisson
  count, gives the plain version's bits;
* CPU keys never reach the kernel's wrappers, and the wrappers refuse CPU
  tensors.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.uncertainty import bootstrap as jboot
from repro_torch import random as trandom
from repro_torch.kernels import threefry as kthreefry
from repro_torch.uncertainty import bootstrap as tboot

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "threefry.cu")
# Raw keys: seeds' keys [0, seed] and keys with the top bit of either word
# set (the split and fold_in outputs the ingests and the bootstrap use).
KEYS = [(0, 0), (0, 5), (0, 2 ** 31), (0x9E3779B9, 0xF00DBEEF),
        (2 ** 32 - 1, 2 ** 32 - 1)]


def _keys(words):
    return (jnp.asarray(np.array(words, np.uint32)),
            tboot.key_tensor(np.array(words, np.uint32), "cpu"))


def _valid(rng, k, s, empty_rows=()):
    valid = rng.random((k, s)) < 0.8
    valid[list(empty_rows)] = False
    return valid


# ---------------------------------------------------------------------------
# The fused draw against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("words", KEYS)
@pytest.mark.parametrize("R,k,s,r0", [(1, 1, 1, 0), (1, 5, 7, 70001),
                                      (4, 3, 1, 0), (7, 6, 33, 3),
                                      (3, 9, 75, 2 ** 31 + 5)])
def test_poisson_weights_bit_equal_to_reference(words, R, k, s, r0):
    """W = the reference's weights of replicates r0 .. r0 + R - 1 where a
    slot is valid, +0.0 elsewhere (a stratum with no valid slot included),
    K* = their sum over the slots; R = 1 at r0 is the scan's draw."""
    rng = np.random.default_rng(R * 1000 + k * 10 + s)
    valid = _valid(rng, k, s, empty_rows=(k - 1,) if k > 1 else ())
    jk, tk = _keys(words)
    rs = jnp.asarray(np.arange(r0, r0 + R, dtype=np.int64).astype(np.uint32))
    wj = np.asarray(jax.vmap(lambda r: jboot._draw_weights(jk, r, (k, s)))(rs))
    want_w = np.where(valid[None], wj, np.float32(0.0)).astype(np.float32)
    want_k = want_w.sum(-1, dtype=np.float32)
    W, k_star = tboot.poisson_weights(tk, torch.from_numpy(valid), R, r0)
    assert W.dtype == k_star.dtype == torch.float32
    assert W.shape == (R, k, s) and k_star.shape == (R, k)
    np.testing.assert_array_equal(W.numpy().view(np.int32),
                                  want_w.view(np.int32))
    np.testing.assert_array_equal(k_star.numpy().view(np.int32),
                                  want_k.view(np.int32))
    if k > 1:
        assert not k_star[:, -1].any()


def test_scan_draws_are_the_fused_draws():
    """The scan draws replicate r alone (R = 1 at r0 = r); each is the
    fused draw's slice r (DESIGN §10)."""
    rng = np.random.default_rng(3)
    valid = torch.from_numpy(_valid(rng, 11, 9, empty_rows=(4,)))
    key = trandom.PRNGKey(5, "cpu")
    W, k_star = tboot.poisson_weights(key, valid, 6)
    for r in range(6):
        w, ks = tboot.poisson_weights(key, valid, 1, r)
        assert torch.equal(w[0], W[r]) and torch.equal(ks[0], k_star[r])


# ---------------------------------------------------------------------------
# A numpy model of the kernel's formulation
# ---------------------------------------------------------------------------

def _kernel_program():
    """The hash's statements in the CUDA source's order: ("init",),
    ("round", r) and ("inject", a, b, c) for ``x0 += k<a>; x1 += k<b> +
    <c>u;``."""
    src = SOURCE.read_text()
    body = src[src.index("threefry2x32(uint32_t k0"):]
    body = body[:body.index("o0 = x0;")]
    assert "uint32_t x0 = c0 + k0, x1 = c1 + k1;" in body
    assert "const uint32_t k2 = k0 ^ k1 ^ KS_PARITY;" in body
    assert "KS_PARITY = 0x1BD11BDAu;" in src
    prog = [("init",)]
    for m in re.finditer(r"REPRO_ROUND\(x0, x1, (\d+)\)|x0 \+= k(\d); "
                         r"x1 \+= k(\d) \+ (\d+)u;", body):
        if m.group(1):
            prog.append(("round", int(m.group(1))))
        else:
            prog.append(("inject", int(m.group(2)), int(m.group(3)),
                         int(m.group(4))))
    assert "#define REPRO_ROUND(x0, x1, r) \\\n  x0 += x1;" in src
    assert "x1 = rotl(x1, r) ^ x0;" in src
    assert "return __funnelshift_l(x, x, r);" in src
    return prog


def _rotl(x, r):
    """``__funnelshift_l(x, x, r)``: the high word of (x:x) << (r & 31)."""
    r = r & 31
    if r == 0:
        return x
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _model_hash(prog, k0, k1, c0, c1):
    k = [np.uint32(k0), np.uint32(k1)]
    k.append(k[0] ^ k[1] ^ np.uint32(0x1BD11BDA))
    x0 = x1 = None
    with np.errstate(over="ignore"):
        for op in prog:
            if op[0] == "init":
                x0, x1 = c0 + k[0], c1 + k[1]
            elif op[0] == "round":
                x0 = x0 + x1
                x1 = _rotl(x1, op[1]) ^ x0
            else:
                x0 = x0 + k[op[1]]
                x1 = x1 + (k[op[2]] + np.uint32(op[3]))
    return x0, x1


def _model_uniform(b1, b2):
    word = ((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)
    return word.view(np.float32) - np.float32(1.0)


def _model_count(u, cdf):
    w = np.zeros(u.shape, np.int32)
    for t in range(cdf.shape[0]):              # 16 compares, unrolled
        w += (u >= cdf[t]).astype(np.int32)
    return w


def test_model_program_is_the_plain_version():
    """The source's 20 rounds and 5 injections, in the plain version's
    order: rotations (13, 15, 26, 6) then (17, 29, 16, 24), injections
    ks[(i+1)%3] and ks[(i+2)%3] + i + 1 after each group of four."""
    prog = _kernel_program()
    want = [("init",)]
    for i in range(5):
        want += [("round", r) for r in trandom._ROTATIONS[i % 2]]
        want.append(("inject", (i + 1) % 3, (i + 2) % 3, i + 1))
    assert prog == want


def test_model_hash_and_uniform_bit_equal_on_random_counters():
    """2**16 random counters (both words) under random keys."""
    rng = np.random.default_rng(0)
    n = 2 ** 16
    k0, k1 = (rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
              for _ in range(2))
    c0, c1 = (rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
              for _ in range(2))
    b1, b2 = _model_hash(_kernel_program(), k0, k1, c0, c1)
    t = [torch.from_numpy(x.astype(np.int64)) for x in (k0, k1, c0, c1)]
    p1, p2 = trandom.threefry_2x32(*t)
    np.testing.assert_array_equal(b1.astype(np.int64), p1.numpy())
    np.testing.assert_array_equal(b2.astype(np.int64), p2.numpy())
    u = _model_uniform(b1, b2)
    want = trandom._uniform_word(p1, p2).numpy()
    np.testing.assert_array_equal(u.view(np.int32), want.view(np.int32))
    cdf = tboot._P1_CDF.numpy()
    np.testing.assert_array_equal(
        _model_count(u, cdf),
        (torch.from_numpy(u)[..., None] >= tboot._P1_CDF).sum(-1).numpy())


def test_model_count_at_every_table_value_and_its_neighbours():
    """The linear count at each P(X <= t) and at its float32 neighbours
    below and above, against the plain version's compare-and-sum."""
    cdf = tboot._P1_CDF.numpy()
    u = np.concatenate([cdf, np.nextafter(cdf, np.float32(-np.inf)),
                        np.nextafter(cdf, np.float32(np.inf)),
                        np.float32([0.0, 1.0 - 2.0 ** -24])])
    u = u[u < 1.0].astype(np.float32)
    want = (torch.from_numpy(u)[..., None] >= tboot._P1_CDF).sum(-1)
    np.testing.assert_array_equal(_model_count(u, cdf), want.numpy())


@pytest.mark.parametrize("words", KEYS[2:])
def test_model_fused_draw_bit_equal_to_plain(words):
    """The kernel's layout: replicate r's key is fold_in(key, r0 + r),
    slot (i, j) draws counter i * s + j under it, an invalid slot writes
    +0.0 and draws nothing, K* is the integer count of the row."""
    prog = _kernel_program()
    R, k, s, r0 = 3, 5, 13, 2 ** 32 - 2          # r0 + r wraps past 2**32
    rng = np.random.default_rng(1)
    valid = _valid(rng, k, s, empty_rows=(2,))
    cdf = tboot._P1_CDF.numpy()
    W = np.zeros((R, k, s), np.float32)
    k_star = np.zeros((R, k), np.float32)
    with np.errstate(over="ignore"):
        for r in range(R):
            rk0, rk1 = _model_hash(prog, words[0], words[1], np.uint32(0),
                                   np.uint32(r0) + np.uint32(r))
            ctr = (np.arange(k, dtype=np.uint32)[:, None] * np.uint32(s)
                   + np.arange(s, dtype=np.uint32)[None])
            b1, b2 = _model_hash(prog, np.full_like(ctr, rk0),
                                 np.full_like(ctr, rk1),
                                 np.zeros_like(ctr), ctr)
            w = np.where(valid, _model_count(_model_uniform(b1, b2), cdf), 0)
            W[r] = w.astype(np.float32)
            k_star[r] = w.sum(-1).astype(np.float32)
    key = tboot.key_tensor(np.array(words, np.uint32), "cpu")
    got_w, got_k = tboot.poisson_weights_plain(key, torch.from_numpy(valid),
                                               R, r0)
    np.testing.assert_array_equal(got_w.numpy().view(np.int32),
                                  W.view(np.int32))
    np.testing.assert_array_equal(got_k.numpy(), k_star)


def test_model_split_fold_in_uniform_bit_equal_to_jax():
    """The kernel's split (counters 0..n-1), fold_in (negative int32 data
    as its two's complement, data >= 2**31) and uniform in the model,
    against jax.random."""
    prog = _kernel_program()
    # split is fold_in's kind 0 at scalar 0: counter scalar + t
    assert "uint32_t c = scalar + (uint32_t)t;" in SOURCE.read_text()
    jk = jnp.asarray(np.array([0x9E3779B9, 0xF00DBEEF], np.uint32))
    k0, k1 = np.uint32(0x9E3779B9), np.uint32(0xF00DBEEF)
    n = 33
    ctr = np.arange(n, dtype=np.uint32)
    b1, b2 = _model_hash(prog, k0, k1, np.zeros_like(ctr), ctr)
    np.testing.assert_array_equal(np.stack([b1, b2], 1),
                                  np.asarray(jax.random.split(jk, n)))
    np.testing.assert_array_equal(
        _model_uniform(b1, b2),
        np.asarray(jax.random.uniform(jk, (n,), jnp.float32)))
    data = np.array([-1, -2 ** 31, 0, 7, 2 ** 31 - 1], np.int32)
    f1, f2 = _model_hash(prog, k0, k1, np.zeros(5, np.uint32),
                         data.view(np.uint32))
    want = np.stack([np.asarray(jax.random.fold_in(jk, jnp.int32(v)))
                     for v in data])
    np.testing.assert_array_equal(np.stack([f1, f2], 1), want)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _refuse(*_a, **_k):
    raise AssertionError("a CPU key reached the CUDA wrapper")


def test_cpu_keys_never_reach_the_kernel(monkeypatch):
    """Every draw of ``repro_torch.random`` and the bootstrap's weights on
    CPU keys take the plain version, with the wrappers made to fail."""
    for name in ("split_cuda", "fold_in_cuda", "uniform_cuda",
                 "poisson_weights_cuda"):
        monkeypatch.setattr(kthreefry, name, _refuse)
    key = trandom.PRNGKey(11, "cpu")
    keys = trandom.split(key, 5)
    assert torch.equal(keys, trandom.split_plain(key, 5))
    f = trandom.fold_in(key, torch.tensor([-3, 2 ** 31 + 1]))
    assert torch.equal(f, trandom.fold_in_plain(key, torch.tensor(
        [-3, 2 ** 31 + 1])))
    assert torch.equal(trandom.uniform(keys[1], (4, 3)),
                       trandom.uniform_plain(keys[1], (4, 3)))
    assert torch.equal(trandom.uniform_scalar(f),
                       trandom.uniform_scalar_plain(f))
    valid = torch.ones((3, 4), dtype=torch.bool)
    W, ks = tboot.poisson_weights(key, valid, 2)
    W0, ks0 = tboot.poisson_weights_plain(key, valid, 2)
    assert torch.equal(W, W0) and torch.equal(ks, ks0)


def test_wrappers_refuse_cpu_tensors():
    key = trandom.PRNGKey(1, "cpu")
    valid = torch.ones((2, 3), dtype=torch.bool)
    for call in (lambda: kthreefry.split_cuda(key, 2),
                 lambda: kthreefry.fold_in_cuda(key, 3),
                 lambda: kthreefry.uniform_cuda(key, (4,)),
                 lambda: kthreefry.poisson_weights_cuda(
                     key, tboot._P1_CDF, valid, 2)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(TypeError):
        kthreefry.uniform_cuda(key.to(torch.int32), (4,))


def test_cdf_table_and_op_counts():
    """The table the kernel compares against is the 16-entry float32 one;
    the bound's least operation counts add up as the source's note says:
    86 a valid slot of the fused draw."""
    assert tboot._P1_CDF.shape == (kthreefry.CDF_LEN,)
    assert "constexpr int CDF_LEN = 16;" in SOURCE.read_text()
    assert kthreefry.KEY_OPS == 2 + 5
    assert kthreefry.HASH_OPS == 1 + 20 * 3 + 5 * 2
    assert (kthreefry.HASH_OPS + kthreefry.UNIFORM_OPS + kthreefry.COUNT_OPS
            + 1) == 86
    assert 16 * kthreefry.MAX_SLOTS < 2 ** 24 <= 16 * (kthreefry.MAX_SLOTS + 1)


def _search_count(u, cdf):
    """The bound's Poisson count: a branchless binary search over the
    monotone 16-entry table, 5 compares (and 5 adds) for 17 outcomes."""
    base = np.zeros(u.shape, np.int64)
    for half in (8, 4, 2, 1):
        base = np.where(u >= cdf[base + half - 1], base + half, base)
    return base + (u >= cdf[base])


def test_bound_count_is_the_linear_count():
    """COUNT_OPS rests on a binary search that gives the linear count's
    integer at every table value, its float neighbours and 2**16 random
    uniforms."""
    cdf = tboot._P1_CDF.numpy()
    rng = np.random.default_rng(3)
    u = np.concatenate([
        cdf, np.nextafter(cdf, np.float32(-np.inf)),
        np.nextafter(cdf, np.float32(np.inf)),
        np.float32([0.0, 1.0 - 2.0 ** -24]),
        (rng.integers(0, 2 ** 23, 2 ** 16) * 2.0 ** -23).astype(np.float32)])
    u = u[u < 1.0].astype(np.float32)
    np.testing.assert_array_equal(_search_count(u, cdf), _model_count(u, cdf))
