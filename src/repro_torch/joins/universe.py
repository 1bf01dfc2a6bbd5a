"""Universe sampling on the join key: hash-threshold membership (the port
of ``repro/joins/universe.py``).

A fact row (and a dimension row) belongs to the rate-``p`` key universe
iff one threefry uniform of its key value, drawn from a shared root key,
falls below ``p``. The decision depends only on ``(root_key, key value)``,
so a key has the same decision in every stratum, in every streamed batch
and on both sides of the join: the correlation the Horvitz-Thompson
estimator of ``joins/assemble.py`` rests on. The uniforms are bit-equal
to the JAX package's ``jax.random.uniform(jax.random.fold_in(root, v), ())``
for every int32 ``v`` (``repro_torch.random``), so membership is exactly
the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import random as trandom


def _key_tensor(keys, device) -> torch.Tensor:
    """Key values as an int32 tensor on ``device`` (the reference's
    ``jnp.asarray(keys, jnp.int32)``: wider integers wrap)."""
    if not isinstance(keys, torch.Tensor):
        keys = torch.from_numpy(np.asarray(keys).astype(np.int32))
    return keys.to(device=device, dtype=torch.int32)


def key_uniforms(root_key: torch.Tensor, keys) -> torch.Tensor:
    """Per-key-value uniforms in [0, 1), float32, of ``keys``' shape, on
    the root key's device: equal key values give equal uniforms."""
    kv = _key_tensor(keys, root_key.device)
    return trandom.uniform_scalar(trandom.fold_in(root_key, kv))


def universe_mask(root_key: torch.Tensor, keys, p) -> torch.Tensor:
    """Membership (bool, ``keys``' shape) of each key value in the rate-``p``
    universe; both join sides use the same ``root_key`` and ``p``. Monotone
    in ``p``: a smaller rate's universe is a subset of a larger one's."""
    return key_uniforms(root_key, keys) < float(np.float32(p))


__all__ = ["key_uniforms", "universe_mask"]
