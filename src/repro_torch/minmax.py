"""MIN and MAX under the JAX package's signed-zero rule.

XLA's min and max, through which the JAX package's aggregates, extremes
and boxes go, order -0.0 below +0.0 and propagate a NaN. PyTorch's
``amin``, ``amax``, ``minimum``, ``maximum`` and ``scatter_reduce``
propagate a NaN too, but of two zeros of either sign they keep whichever
comes first. Every MIN/MAX of the port whose result is an aggregate, an
extreme or a box goes through this module, so that its bits are the
reference's.

Each function takes PyTorch's result and sets its sign only, from the
integer min (max) of the operands' int32 bit patterns: that is negative
iff some operand has its sign bit set (for a max: iff every operand has).
A min is negative, -0.0 or NaN whenever an operand is, and not negative
otherwise, so the sign changes nothing but a tie of zeros, which it
settles as -0.0 (a max's as +0.0). The rule is order-free: the bits do
not depend on the order of the inputs (nor, in a kernel, on which thread
met which value first). NaN stays NaN and +-inf is untouched.

All tensors are float32.
"""
from __future__ import annotations

import torch


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise min; -0.0 wins a tie of zeros."""
    return torch.minimum(a, b).copysign(torch.minimum(_bits(a), _bits(b)))


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise max; +0.0 wins a tie of zeros."""
    return torch.maximum(a, b).copysign(torch.maximum(_bits(a), _bits(b)))


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


__all__ = ["minimum", "maximum", "masked_min", "masked_max", "scatter_min_",
           "scatter_max_"]
