"""Per-(query, stratum) MIN/MAX over the relevant samples.

``sample_extremes_cuda`` launches the hand-written kernel of
``csrc/sample_extremes.cu``. The JAX package has no Pallas kernel for this
op: every backend shares one ``jnp`` broadcast
(``repro/kernels/backends.py`` ``KernelBackend.sample_extremes``).
``sample_extremes_plain`` is that broadcast, its MIN/MAX under the
reference's signed-zero rule (:mod:`repro_torch.minmax`): the version CPU
tensors take and the reference the kernel is held against on the card.

Both take the synopsis's leaf-major layout, sample_c (k, s, d) float32,
sample_a (k, s) float32, sample_valid (k, s) bool, q_lo/q_hi (Q, d)
float32, and return (samp_min, samp_max), each (Q, k) float32. A sample
is relevant iff valid and inside the box, bounds inclusive; a pair with
no relevant sample reads +BIG / -BIG. Each result is the min (max) of the
pair's s terms ``relevant ? a : +BIG`` (``-BIG``): a NaN value on a
relevant slot gives NaN, one on another slot is masked away, and a value
beyond +-BIG on a relevant slot wins only where every slot is relevant.
"""
from __future__ import annotations

import ctypes

import torch

from .. import minmax
from . import native
from .stratified_estimate import pair_launch, samples_inside

# Sentinel of the relevant-sample extremes (``backends.py`` ``_BIG``).
BIG = 3.4e38


def sample_extremes_plain(sample_c, sample_a, sample_valid, q_lo, q_hi):
    inside = samples_inside(sample_c, sample_valid, q_lo, q_hi)
    a = sample_a.to(torch.float32)[None]
    return (minmax.masked_min(a, inside, BIG, -1),
            minmax.masked_max(a, inside, -BIG, -1))


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = native.library("sample_extremes")
        lib.repro_sample_extremes.argtypes = [ctypes.c_void_p] * 7 + \
            [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.repro_sample_extremes.restype = ctypes.c_int
        _lib = lib
    return _lib.repro_sample_extremes


# Limits of the kernel's launch (csrc/sample_extremes.cu): row 2's one-pass
# tiles of EXTREMES_QT queries x EXTREMES_LT leaves, at most 2**31 - 1 of
# them along gridDim.x (above PAIR_CHUNK slots row 2's cooperative chunk
# grid, at most the resident blocks); sizes that fit a C int; s >= 1 (an
# empty slot axis has no extreme); any d (above 16 columns row 2's wide
# kernels, the columns in blocks of 16).
EXTREMES_QT, EXTREMES_LT = 128, 16


def check_extremes_limits(name, Q, k, s, d):
    """Raise ValueError unless the extremes kernel takes these sizes."""
    if not (1 <= Q < 2 ** 31 and 1 <= k < 2 ** 31 and 1 <= s < 2 ** 31
            and 1 <= d < 2 ** 31
            and -(-Q // EXTREMES_QT) * -(-k // EXTREMES_LT) < 2 ** 31):
        raise ValueError(
            f"{name}: needs 1 <= Q, k, s, d < 2**31 and "
            f"ceil(Q / {EXTREMES_QT}) * ceil(k / {EXTREMES_LT}) < 2**31, "
            f"got Q={Q} k={k} s={s} d={d}")


def sample_extremes_cuda(sample_c, sample_a, sample_valid, q_lo, q_hi):
    """Launch the CUDA kernel on the tensors' device and current stream.
    samp_min and samp_max are the two planes of the launch's one buffer."""
    name = "sample_extremes"
    native.check_tensors(name, sample_c=sample_c, sample_a=sample_a,
                         sample_valid=sample_valid, q_lo=q_lo, q_hi=q_hi)
    native.check_dtype(name, torch.float32, sample_c=sample_c,
                       sample_a=sample_a, q_lo=q_lo, q_hi=q_hi)
    native.check_dtype(name, torch.bool, sample_valid=sample_valid)
    k, s, d = sample_c.shape
    Q = q_lo.shape[0]
    if (sample_a.shape != (k, s) or sample_valid.shape != (k, s)
            or q_lo.shape != (Q, d) or q_hi.shape != (Q, d)):
        raise ValueError(f"{name}: shapes {sample_c.shape} {sample_a.shape} "
                         f"{sample_valid.shape} {q_lo.shape} {q_hi.shape}")
    check_extremes_limits(name, Q, k, s, d)
    out = torch.empty((2, Q, k), dtype=torch.float32,
                      device=sample_c.device)
    pair_launch(name, _kernel(), sample_c, sample_a, sample_valid, q_lo,
                q_hi, out, 2)
    return out[0], out[1]


__all__ = ["sample_extremes_plain", "sample_extremes_cuda",
           "check_extremes_limits", "EXTREMES_QT", "EXTREMES_LT", "BIG"]
