"""MIN and MAX under the JAX package's signed-zero rule.

XLA's min and max, through which the JAX package's aggregates, extremes,
boxes and epilogue bounds and clips go, order -0.0 below +0.0 and
propagate a NaN. PyTorch's ``amin``, ``amax``, ``minimum``, ``maximum``,
``clamp`` and ``scatter_reduce`` propagate a NaN too, but a tie of two
zeros of either sign goes to whichever operand the code path keeps: on
the CPU the reductions keep the first one met, and the elementwise ops
the second operand in vectorized lanes and the first in the scalar tail,
so the sign depends on a value's position. Every MIN/MAX of the port whose
result is an aggregate, an extreme, a box or a bound of an answer goes
through this module, so that its bits are the reference's on every device.

Each function takes PyTorch's result and sets its sign only, from the
integer min (max) of the operands' int32 bit patterns: that is negative
iff some operand has its sign bit set (for a max: iff every operand has).
A min is negative, -0.0 or NaN whenever an operand is, and not negative
otherwise, so the sign changes nothing but a tie of zeros, which it
settles as -0.0 (a max's as +0.0). The rule is order-free: the bits do
not depend on the order of the inputs (nor, in a kernel, on which thread
met which value first). NaN stays NaN and +-inf is untouched.

All tensors are float32, but for :func:`maximum_np` and
:func:`minimum_np`: the JAX package computes AQP++'s hard bounds
(``core/baselines.py``) with numpy's ``np.maximum`` / ``np.minimum`` in
float64, and numpy's rule is not XLA's. It propagates a NaN too, but
settles a tie of two zeros as the second operand (the SIMD ``max_pd`` /
``min_pd`` it runs on); these two follow it, on any float dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise min; -0.0 wins a tie of zeros."""
    return torch.minimum(a, b).copysign(torch.minimum(_bits(a), _bits(b)))


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise max; +0.0 wins a tie of zeros."""
    return torch.maximum(a, b).copysign(torch.maximum(_bits(a), _bits(b)))


def max0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0.0)``: +0.0 for either zero and every x < 0, NaN
    kept. ``threshold`` is ``x <= 0 ? 0 : x`` on both devices, one launch
    (``clamp(x, min=0.0)`` keeps -0.0 on the CPU)."""
    return F.threshold(x, 0.0, 0.0)


def min0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum(x, 0.0)``: +0.0 for every x > 0, x otherwise (-0.0
    and NaN included). ``clamp(x, max=0.0)`` keeps x on a tie with +0.0,
    which is XLA's answer for both zeros, on both devices."""
    return torch.clamp(x, max=0.0)


def clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
         ) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` = min(max(x, lo), hi) elementwise, the
    operands broadcast; ties of zeros as XLA breaks them. The sign comes
    from the same clip of the bit patterns (sign of max(x, lo) from their
    integer max, of the min with hi from the integer min)."""
    return torch.clamp(x, lo, hi).copysign(
        torch.clamp(_bits(x), _bits(lo), _bits(hi)))


def masked_min(x: torch.Tensor, mask: torch.Tensor, fill: float,
               dim: int) -> torch.Tensor:
    """min over ``dim`` of ``where(mask, x, fill)``; -0.0 wins a tie of
    zeros."""
    t = torch.where(mask, x, fill)
    return t.amin(dim).copysign(_bits(t).amin(dim))


def masked_max(x: torch.Tensor, mask: torch.Tensor, fill: float,
               dim: int) -> torch.Tensor:
    """max over ``dim`` of ``where(mask, x, fill)``; +0.0 wins a tie of
    zeros."""
    t = torch.where(mask, x, fill)
    return t.amax(dim).copysign(_bits(t).amax(dim))


def scatter_min_(out: torch.Tensor, index: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """``out.scatter_reduce_(0, index, src, "amin")`` (out included) on 1-D
    tensors, in place; -0.0 wins a tie of zeros."""
    sign = _bits(out).clone().scatter_reduce_(0, index, _bits(src), "amin")
    return out.scatter_reduce_(0, index, src, "amin").copysign_(sign)


def scatter_max_(out: torch.Tensor, index: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """``out.scatter_reduce_(0, index, src, "amax")`` (out included) on 1-D
    tensors, in place; +0.0 wins a tie of zeros."""
    sign = _bits(out).clone().scatter_reduce_(0, index, _bits(src), "amax")
    return out.scatter_reduce_(0, index, src, "amax").copysign_(sign)


def maximum_np(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``np.maximum(a, b)``: NaN propagates, a tie (of zeros too) gives
    ``b``."""
    return torch.where((a > b) | torch.isnan(a), a, b)


def minimum_np(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``np.minimum(a, b)``: NaN propagates, a tie (of zeros too) gives
    ``b``."""
    return torch.where((a < b) | torch.isnan(a), a, b)


__all__ = ["minimum", "maximum", "maximum_np", "minimum_np", "max0", "min0",
           "clip", "masked_min", "masked_max", "scatter_min_", "scatter_max_"]
