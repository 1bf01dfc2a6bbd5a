"""The threefry draws on the card (row 10): ``split``, ``fold_in``,
``uniform`` and the bootstrap's Poisson(1) weights, one launch each.

These wrappers launch the hand-written kernels of ``csrc/threefry.cu``.
The JAX package has no Pallas kernel for this stage: its draws are
``jax.random``'s threefry2x32, reached from
``repro/uncertainty/bootstrap.py:67-74`` (``_draw_weights``), the ingests'
``split`` and ``uniform`` and the join universe's per-key uniforms. The
plain versions are the int64 torch code of :mod:`repro_torch.random`
(``split_plain``, ``fold_in_plain``, ``uniform_plain``,
``uniform_scalar_plain``) and ``uncertainty/bootstrap.py``
``poisson_weights_plain``: the versions CPU tensors take, and the
yardstick the kernels are held against, bit for bit, on the card.

Keys are (..., 2) int64 tensors of two uint32 words; they are read on the
device through their pointer, so no draw reads anything back to the host.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import native

NAME = "threefry"
# Slots a row of the fused draw may hold: its count K* sums at most 16 a
# slot and must stay an exact float32 integer (below 2**24).
MAX_SLOTS = (1 << 24) // 16 - 1
CDF_LEN = 16
# Int32 operations of the least work a draw needs, for the bound (see
# csrc/threefry.cu): a key's k2 (two xors) and five injection constants,
# once a key; a counter's hash under a prepared key (its add into x1, 20
# rounds of add, rotate and xor, 5 injections of two adds); the uniform's
# xor, shift, or and subtract; the Poisson count as a binary search over
# the monotone table (5 compares and 5 adds for its 17 outcomes).
KEY_OPS = 2 + 5
HASH_OPS = 1 + 20 * 3 + 5 * 2
UNIFORM_OPS = 4
COUNT_OPS = 5 + 5

_lib = None


def _kernels():
    global _lib
    if _lib is None:
        lib = native.library("threefry")
        p, i, ll, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_uint)
        lib.repro_threefry_fold_in.argtypes = [p, p, i, u, ll, p, p]
        lib.repro_threefry_uniform.argtypes = [p, ll, ll, p, p]
        lib.repro_poisson_weights.argtypes = [p, p, p, i, u, i, i, p, p, p]
        for fn in (lib.repro_threefry_fold_in, lib.repro_threefry_uniform,
                   lib.repro_poisson_weights):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _key(name: str, key: torch.Tensor, batch: bool) -> torch.Tensor:
    """``key`` checked: int64 on a CUDA device, (2,) or, with ``batch``,
    (..., 2); made contiguous (a row of a key batch already is)."""
    native.check_dtype(name, torch.int64, key=key)
    if key.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors")
    if key.shape[-1:] != (2,) or (not batch and key.dim() != 1):
        raise ValueError(f"{name}: a key is two uint32 words"
                         f"{', (..., 2) for a batch' if batch else ''}, "
                         f"got shape {tuple(key.shape)}")
    return key.contiguous()


def _count(n: int) -> int:
    if n >= 2 ** 32:
        raise ValueError(f"at most 2**32 - 1 draws per key, got {n}")
    return n


def split_cuda(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` of one key: (num, 2) int64."""
    key = _key("split", key, batch=False)
    num = _count(int(num))
    out = torch.empty((num, 2), dtype=torch.int64, device=key.device)
    if num:
        native.launch(NAME, key.device, _kernels().repro_threefry_fold_in,
                      key.data_ptr(), None, 0, 0, num, out.data_ptr())
    return out


def fold_in_cuda(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` of one key: a Python int gives a
    (2,) key, an integer tensor of shape S a (*S, 2) batch, one key for
    each value taken modulo 2**32 (two's complement for a negative one)."""
    key = _key("fold_in", key, batch=False)
    dev = key.device
    if not isinstance(data, (int, np.integer)):
        data = torch.as_tensor(data)
        if data.dtype not in (torch.int32, torch.int64):
            data = data.to(torch.int64)
        data = data.to(dev).contiguous()
        out = torch.empty((*data.shape, 2), dtype=torch.int64, device=dev)
        if data.numel():
            kind = 1 if data.dtype == torch.int32 else 2
            native.launch(NAME, dev, _kernels().repro_threefry_fold_in,
                          key.data_ptr(), data.data_ptr(), kind, 0,
                          data.numel(), out.data_ptr())
        return out
    out = torch.empty((2,), dtype=torch.int64, device=dev)
    native.launch(NAME, dev, _kernels().repro_threefry_fold_in,
                  key.data_ptr(), None, 0, int(data) & 0xFFFFFFFF, 1,
                  out.data_ptr())
    return out


def uniform_cuda(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` for each key of a
    (..., 2) batch: (..., *shape) float32, one launch over every key."""
    keys = _key("uniform", keys, batch=True)
    shape = (shape,) if isinstance(shape, int) else tuple(int(x)
                                                          for x in shape)
    n = 1
    for x in shape:
        n *= x
    n = _count(n)
    nkeys = keys.numel() // 2
    out = torch.empty((*keys.shape[:-1], *shape), dtype=torch.float32,
                      device=keys.device)
    if n and nkeys:
        native.launch(NAME, keys.device, _kernels().repro_threefry_uniform,
                      keys.data_ptr(), nkeys, n, out.data_ptr())
    return out


def poisson_weights_cuda(key: torch.Tensor, cdf: torch.Tensor,
                         valid: torch.Tensor, n_boot: int, r0: int = 0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The bootstrap's resample weights of replicates r0 .. r0 + n_boot - 1
    in one launch: W (n_boot, k, s) float32, w = #{t : u >= cdf[t]} for
    the uniform of counter i * s + j under ``fold_in(key, r)`` on a valid
    slot and +0.0 on an invalid one, and K* (n_boot, k) = W.sum(-1)."""
    name = "poisson_weights"
    key = _key(name, key, batch=False)
    native.check_tensors(name, key=key, cdf=cdf, valid=valid)
    native.check_dtype(name, torch.float32, cdf=cdf)
    native.check_dtype(name, torch.bool, valid=valid)
    if cdf.shape != (CDF_LEN,) or valid.dim() != 2:
        raise ValueError(f"{name}: cdf must be ({CDF_LEN},) and valid "
                         f"(k, s), got {tuple(cdf.shape)} "
                         f"{tuple(valid.shape)}")
    k, s = valid.shape
    R = int(n_boot)
    if not (1 <= R < 2 ** 31 and k >= 1 and 1 <= s <= MAX_SLOTS):
        raise ValueError(f"{name}: needs 1 <= R < 2**31, k >= 1 and 1 <= s "
                         f"<= {MAX_SLOTS} (K* exact in float32), got R={R} "
                         f"k={k} s={s}")
    _count(k * s)
    dev = key.device
    W = torch.empty((R, k, s), dtype=torch.float32, device=dev)
    k_star = torch.empty((R, k), dtype=torch.float32, device=dev)
    native.launch(NAME, dev, _kernels().repro_poisson_weights,
                  key.data_ptr(), cdf.data_ptr(), valid.data_ptr(), R,
                  int(r0) & 0xFFFFFFFF, k, s, W.data_ptr(),
                  k_star.data_ptr())
    return W, k_star


__all__ = ["split_cuda", "fold_in_cuda", "uniform_cuda",
           "poisson_weights_cuda", "KEY_OPS", "HASH_OPS", "UNIFORM_OPS",
           "COUNT_OPS", "MAX_SLOTS", "CDF_LEN"]
