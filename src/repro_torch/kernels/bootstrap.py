"""All bootstrap replicate moments in one pass.

``bootstrap_moments_cuda`` launches the hand-written kernel of
``csrc/weighted_moments.cu`` (which replaces the Pallas megakernel
``repro/kernels/bootstrap.py::bootstrap_moments``);
``bootstrap_moments_plain`` is the replicate-tiled broadcast-reduce of the
JAX package's ``JnpBackend.bootstrap_moments``, the version CPU tensors
take and the reference the kernel is held against on the card.

Both take the synopsis's leaf-major sample arrays (as
``stratified_estimate``), resample weights W (R, k, s) float32 and
q_lo/q_hi (Q, d), and return (R, Q, k, 3) float32 = [sum w, sum w*a,
sum w*a^2] over each replicate's relevant samples; an invalid slot counts
as w = 0 whatever W holds. Replicate r equals the weighted moments with
the weight row W[r] bit for bit: on the card the weighted moments are the
same launch with R = 1, on the CPU the two plain versions share their
arithmetic (DESIGN.md §10).
"""
from __future__ import annotations

import torch

from . import native
from .stratified_estimate import (check_weighted_args, samples_inside,
                                  weighted_library, weighted_scratch,
                                  weighted_terms)

# Replicates per block of the plain version's (REP_TILE, Q, k, s)
# temporaries: the JAX package's ``REP_TILE``.
REP_TILE = 8


def bootstrap_moments_plain(sample_c, sample_a, sample_valid, W, q_lo, q_hi):
    """The predicate is computed once and reused by every replicate; the
    replicates run in blocks of REP_TILE, so (REP_TILE, Q, k, s) is the
    largest temporary."""
    inside = samples_inside(sample_c, sample_valid, q_lo, q_hi)[None]
    a = sample_a.to(torch.float32)[None, None]
    W = W.to(torch.float32)
    R, k = W.shape[0], W.shape[1]
    Q = q_lo.shape[0]
    out = torch.empty((R, Q, k, 3), dtype=torch.float32, device=W.device)
    for r0 in range(0, R, REP_TILE):
        out[r0:r0 + REP_TILE] = weighted_terms(
            inside, W[r0:r0 + REP_TILE, None], a)
    return out


def bootstrap_moments_cuda(sample_c, sample_a, sample_valid, W, q_lo, q_hi):
    """Launch the CUDA kernels on the tensors' device and current stream.

    The kernels work on segments, a stratum's chunk of at most
    WEIGHTED_CHUNK slots each (one a stratum up to one chunk). First each
    segment's moments over its valid slots for every replicate, and each
    segment's box and valid bits, into ``weighted_scratch``. Then one
    block per tile of 32 queries x up to 32 segments classifies each
    (query, segment) pair once and writes every replicate's tile as
    contiguous rows: the segment's totals where the query box holds all of
    its valid samples, +0.0 where it holds none, and lists each segment's
    other pairs. Then the walks add each listed pair's relevant slots in
    slot order: a segment's pairs of one tile one thread per (pair,
    replicate) when they are fewer than 8, else with the segment's weights
    staged in shared memory once for 128 replicates at a time, a lane 4
    replicates (a lane a pair up to R = 8). Above one chunk these are
    partials, folded in chunk order into the output
    (``csrc/weighted_moments.cu``)."""
    name = "bootstrap_moments"
    if W.dim() != 3:
        raise ValueError(f"{name}: W must be (R, k, s), got "
                         f"{tuple(W.shape)}")
    Q, k, s, d = check_weighted_args(name, sample_c, sample_a, sample_valid,
                                     W, q_lo, q_hi)
    R = W.shape[0]
    dev = sample_c.device
    out = torch.empty((R, Q, k, 3), dtype=torch.float32, device=dev)
    scratch = weighted_scratch(R, Q, k, s, d, dev)
    native.launch(name, dev, weighted_library().repro_bootstrap_moments,
                  sample_c.data_ptr(), sample_a.data_ptr(),
                  sample_valid.data_ptr(), W.data_ptr(), q_lo.data_ptr(),
                  q_hi.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                  scratch.numel(), R, Q, k, s, d)
    return out


__all__ = ["bootstrap_moments_plain", "bootstrap_moments_cuda", "REP_TILE"]
