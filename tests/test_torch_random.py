"""The port's threefry keys and uniforms against ``jax.random``.

``repro_torch.random`` reproduces jax's raw threefry2x32 keys under the
installed defaults (``jax_threefry_partitionable=True``, 64-bit mode off),
so the streaming ingest's keyed reservoir draws and the bootstrap's
per-replicate ``fold_in`` draws are the JAX package's. Every comparison
is bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro_torch import random as trandom

SEEDS = [0, 1, 7, 11, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 123456789]


def _key(seed):
    return jax.random.PRNGKey(seed), trandom.PRNGKey(seed, device="cpu")


def test_partitionable_threefry_is_the_installed_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_uniform_bit_equal(seed):
    jk, tk = _key(seed)
    assert tk.dtype == torch.int64
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for num in (2, 257):
        np.testing.assert_array_equal(
            trandom.split(tk, num).numpy(),
            np.asarray(jax.random.split(jk, num)), err_msg=f"split {num}")
    for n in (1, 4097):
        want = np.asarray(jax.random.uniform(jk, (n,), jnp.float32))
        got = trandom.uniform(tk, n)
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32),
                                      err_msg=f"uniform {n}")


def test_chained_splits_and_shaped_uniform_bit_equal():
    """The ingestor's pattern: ``key, sub = split(key)`` once per batch,
    then a uniform per row from ``sub``; plus a 2-D shape."""
    jk, tk = _key(11)
    for step in range(6):
        jk, jsub = jax.random.split(jk)
        keys = trandom.split(tk)
        tk, tsub = keys[0], keys[1]
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(
            trandom.uniform(tsub, (17,)).numpy(),
            np.asarray(jax.random.uniform(jsub, (17,), jnp.float32)))
    want = np.asarray(jax.random.uniform(jk, (3, 5), jnp.float32))
    got = trandom.uniform(tk, (3, 5)).numpy()
    np.testing.assert_array_equal(got, want)
    assert ((got >= 0.0) & (got < 1.0)).all()


def test_threefry_hash_known_answer():
    """The Threefry-2x32 known-answer vector of the Random123 suite, as
    jax's own tests check it."""
    x1, x2 = trandom.threefry_2x32(
        0x13198A2E, 0x03707344,
        torch.tensor([0x243F6A88], dtype=torch.int64),
        torch.tensor([0x85A308D3], dtype=torch.int64))
    assert (int(x1), int(x2)) == (0xC4923A9C, 0x483DF7A0)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 1])
def test_fold_in_bit_equal(seed):
    """Scalar and vector data, r past 2**16 and 2**31 included."""
    jk, tk = _key(seed)
    rs = [0, 1, 199, 2 ** 16, 2 ** 16 + 3, 2 ** 31 + 5, 2 ** 32 - 1]
    for r in rs:
        np.testing.assert_array_equal(trandom.fold_in(tk, r).numpy(),
                                      np.asarray(jax.random.fold_in(jk, r)),
                                      err_msg=f"fold_in {r}")
    batch = trandom.fold_in(tk, torch.tensor(rs))
    assert batch.shape == (len(rs), 2)
    want = np.stack([np.asarray(jax.random.fold_in(jk, r)) for r in rs])
    np.testing.assert_array_equal(batch.numpy(), want)


def test_batched_uniform_equals_vmapped_fold_in():
    """One draw over an (R, 2) key batch is jax's
    ``vmap(lambda r: uniform(fold_in(key, r), shape))``."""
    jk, tk = _key(5)
    shape = (3, 7)
    rs = np.array([0, 1, 2, 70000, 2 ** 20 + 1], np.uint32)
    want = np.asarray(jax.vmap(
        lambda r: jax.random.uniform(jax.random.fold_in(jk, r), shape,
                                     jnp.float32))(jnp.asarray(rs)))
    got = trandom.uniform(trandom.fold_in(tk, torch.tensor(rs.astype(
        np.int64))), shape)
    assert got.shape == (5, *shape) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
