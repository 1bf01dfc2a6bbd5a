"""Counter-based threefry2x32 keys and uniforms, bit-equal to ``jax.random``.

The streaming ingest draws its reservoir-replacement uniforms from a key
threaded through the batches (``streaming/ingest.py``), as the JAX package
does with ``jax.random``. These functions reproduce jax 0.9.0's raw
``uint32[2]`` keys under its defaults (``jax_threefry_partitionable=True``,
64-bit mode off), so a seeded ingest draws the very same uniforms in both
packages:

* :func:`PRNGKey` — ``jax.random.PRNGKey`` (``prng.threefry_seed``);
* :func:`split`   — ``jax.random.split`` (``prng._threefry_split_foldlike``);
* :func:`fold_in` — ``jax.random.fold_in`` (``prng._threefry_fold_in``);
* :func:`uniform` — ``jax.random.uniform`` in float32 over [0, 1)
  (``random._uniform`` on ``prng._threefry_random_bits_partitionable``);
* :func:`uniform_scalar` — ``jax.random.uniform(key, ())`` for a batch of
  keys, one draw each (the join universe's per-key uniforms).

The bootstrap draws its resample weights from ``fold_in(key, r)`` once
per replicate r; :func:`fold_in` takes a vector of r and :func:`uniform`
a batch of keys, so all R replicates are drawn in one pass that equals
``jax.vmap(lambda r: uniform(fold_in(key, r), shape))(arange(R))``.

A key is a (2,) int64 tensor holding two uint32 words; a batch of keys is
a (..., 2) tensor. Work runs on the key's device, and the key's device
picks the version, as ``kernels/ops.py`` does for the other kernels: a
CUDA key launches the hand-written kernel of ``kernels/csrc/threefry.cu``
(row 10; one launch a call, the key words read on the device, so nothing
is read back to the host), or raises; a CPU key takes the plain version,
the ``*_plain`` functions below. There every word lives in an int64
tensor and is masked with ``& 0xFFFFFFFF`` after each add and shift,
since torch has no uint32 arithmetic on every device. On the card the
plain versions are the yardstick the kernel is held against, bit for bit.
:func:`split` and :func:`fold_in` take one key on the card, as
``jax.random`` does.
"""
from __future__ import annotations

import torch

from .device import resolve_device
from .kernels import threefry as _kernel

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry_2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the counter pairs (x1, x2) under the key
    words (k1, k2): 20 rounds, key injection every 4 (``prng.py``
    ``_threefry2x32_lowering``). Every argument holds uint32 values in
    int64; returns two int64 tensors of x1's shape."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x = [(x1 + ks[0]) & MASK32, (x2 + ks[1]) & MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x[0], x[1]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: the seed is taken
    as a 32-bit integer, so the key is ``[0, seed mod 2**32]``. ``device``
    None means the CUDA card."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=resolve_device(device))


def _bits(key: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The two threefry output words over the 64-bit iota 0..n-1 (high
    words 0, low words the index: ``prng.iota_2x32_shape``), for each key
    of a (..., 2) batch: two (..., n) tensors."""
    if n >= 2 ** 32:
        raise ValueError(f"at most 2**32 - 1 draws per key, got {n}")
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry_2x32(key[..., 0, None], key[..., 1, None],
                         torch.zeros_like(lo), lo)


def split_plain(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """:func:`split` as int64 torch ops."""
    b1, b2 = _bits(key, num)
    return torch.stack([b1, b2], dim=1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: a (num, 2) tensor of new keys."""
    if key.device.type == "cuda":
        return _kernel.split_cuda(key, num)
    return split_plain(key, num)


def fold_in_plain(key: torch.Tensor, data) -> torch.Tensor:
    """:func:`fold_in` as int64 torch ops; a (..., 2) batch of keys
    broadcasts against ``data``."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK32
    b1, b2 = threefry_2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                           data)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the threefry hash of the counter
    pair (0, data mod 2**32) under ``key`` (``threefry_seed(data)`` as the
    count). ``data`` is an int or an int tensor; a (R,) tensor gives the
    (R, 2) batch of ``fold_in(key, data[r])``."""
    if key.device.type == "cuda":
        return _kernel.fold_in_cuda(key, data)
    return fold_in_plain(key, data)


def _uniform_word(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    word = ((b1 ^ b2) >> 9) | 0x3F800000       # < 2**31: fits int32
    return word.to(torch.int32).view(torch.float32) - 1.0


def uniform_plain(key: torch.Tensor, shape) -> torch.Tensor:
    """:func:`uniform` as int64 torch ops."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = 1
    for s in shape:
        n *= int(s)
    b1, b2 = _bits(key, n)
    return _uniform_word(b1, b2).reshape(*key.shape[:-1], *shape)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)``: 23 random mantissa bits
    under the exponent of 1.0, minus 1, so values lie in [0, 1). A (..., 2)
    batch of keys gives a (..., *shape) tensor, one draw per key."""
    if key.device.type == "cuda":
        return _kernel.uniform_cuda(key, shape)
    return uniform_plain(key, shape)


def uniform_scalar_plain(keys: torch.Tensor) -> torch.Tensor:
    """:func:`uniform_scalar` as int64 torch ops."""
    zero = torch.zeros_like(keys[..., 0])
    return _uniform_word(*threefry_2x32(keys[..., 0], keys[..., 1], zero,
                                        zero))


def uniform_scalar(keys: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key, (), float32)`` for every key of a (..., 2)
    batch: the hash of the one count pair (0, 0) (``iota_2x32_shape(())``)
    under each key. Returns a (...,) float32 tensor; equal to
    ``uniform(keys, ())`` without the count axis."""
    if keys.device.type == "cuda":
        return _kernel.uniform_cuda(keys, ())
    return uniform_scalar_plain(keys)


__all__ = ["PRNGKey", "split", "fold_in", "uniform", "uniform_scalar",
           "threefry_2x32", "split_plain", "fold_in_plain", "uniform_plain",
           "uniform_scalar_plain"]
