"""The port's kernel op surface, dispatched by the device of the tensors.

In place of the JAX package's named backend registry (``pallas | jnp |
ref``), the tensors decide: CUDA tensors launch the hand-written kernel
(or raise), CPU tensors run the plain PyTorch version. No environment
variable or config routes CUDA tensors to the plain version.
"""
from __future__ import annotations

import torch

from .native import device_type
from .query_eval import query_eval_cuda, query_eval_plain
from .stratified_estimate import (samples_inside, stratified_moments_cuda,
                                  stratified_moments_plain)

# Sentinel of the relevant-sample extremes (``backends.py`` ``_BIG``).
_BIG = 3.4e38


def query_eval(leaf_lo, leaf_hi, leaf_agg, q_lo, q_hi):
    """Classify leaves vs queries and accumulate exact covered aggregates.
    leaf_lo/leaf_hi (k, d), leaf_agg (k, A), q_lo/q_hi (Q, d).
    Returns (rel (Q, k) int32, exact (Q, A) f32)."""
    args = [t.contiguous() for t in (leaf_lo, leaf_hi, leaf_agg, q_lo, q_hi)]
    if device_type("query_eval", *args) == "cuda":
        return query_eval_cuda(*args)
    return query_eval_plain(*args)


def stratified_moments(sample_c, sample_a, sample_valid, q_lo, q_hi):
    """Per-(query, stratum) relevant-sample moments over the synopsis-shaped
    (k, s, .) sample arrays. Returns (k_pred, s_sum, s_sumsq), each (Q, k)."""
    args = [t.contiguous()
            for t in (sample_c, sample_a, sample_valid, q_lo, q_hi)]
    if device_type("stratified_moments", *args) == "cuda":
        out = stratified_moments_cuda(*args)
    else:
        out = stratified_moments_plain(*args)
    return out.unbind(-1)


def sample_extremes(sample_c, sample_a, sample_valid, q_lo, q_hi):
    """Per-(query, stratum) MIN/MAX over relevant samples; irrelevant
    strata read +BIG / -BIG. Returns (samp_min, samp_max), each (Q, k).
    The reference has no Pallas kernel for it, so one torch formulation
    serves both devices."""
    device_type("sample_extremes", sample_c, sample_a, sample_valid, q_lo,
                q_hi)
    inside = samples_inside(sample_c, sample_valid, q_lo, q_hi)
    a = sample_a.to(torch.float32)[None]
    return (torch.where(inside, a, _BIG).amin(-1),
            torch.where(inside, a, -_BIG).amax(-1))


__all__ = ["query_eval", "stratified_moments", "sample_extremes"]
