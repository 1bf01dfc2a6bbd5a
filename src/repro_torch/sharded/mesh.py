"""Shard layout for the sharded synopsis layer (DESIGN.md §11); the port of
``repro/sharded/mesh.py``.

The JAX package lays the leading axis of every sharded
:class:`~repro_torch.streaming.ingest.StreamState` field over a device
mesh's ``"shards"`` axis. The port keeps that ``(D, k, ...)`` layout on one
device: a :class:`ShardMesh` names its axes and their sizes and holds the
one ``torch.device`` every shard lives on, so D logical shards run one
after another on the card. Each collective of the reference becomes a
fixed-order operation over the leading axis (``sharded/merge.py``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..device import resolve_device

SHARD_AXIS = "shards"


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """Named logical axes of a shard layout, all on one device."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    device: torch.device

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")
        if any(int(s) < 1 for s in self.sizes):
            raise ValueError(f"mesh axis sizes must be >= 1, got "
                             f"{self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_mesh(sizes, axis_names, device=None) -> ShardMesh:
    """A mesh of the given axis sizes and names on ``device`` (None = the
    CUDA card): ``jax.make_mesh``'s arguments."""
    return ShardMesh(tuple(axis_names), tuple(int(s) for s in sizes),
                     resolve_device(device))


def data_mesh(n_dev: int | None = None, device=None) -> ShardMesh:
    """1-D ``"shards"`` mesh of ``n_dev`` logical shards on ``device``
    (None = the CUDA card). ``n_dev=None`` takes the number of visible
    CUDA devices on a CUDA device (as the reference's default takes
    ``jax.devices()``), 1 on the CPU."""
    dev = resolve_device(device)
    if n_dev is None:
        n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    return make_mesh((n_dev,), (SHARD_AXIS,), dev)


def num_shards(mesh: ShardMesh) -> int:
    return mesh.shape[SHARD_AXIS]


def shard_leading(mesh: ShardMesh, obj):
    """``obj`` (a dataclass of tensors in the ``(D, ...)`` layout) with
    every tensor field on the mesh's device."""
    moved = {f.name: getattr(obj, f.name).to(mesh.device)
             for f in dataclasses.fields(obj)
             if isinstance(getattr(obj, f.name), torch.Tensor)}
    return dataclasses.replace(obj, **moved)


def split_rows(c: torch.Tensor, a: torch.Tensor, n_shards: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, d) rows -> per-shard (D, Bs, d) blocks and a (D, Bs) validity
    mask. Rows are dealt out in contiguous blocks; a ragged tail is padded
    with the last real row, masked out downstream (a real row keeps every
    padded coordinate inside the data's support)."""
    b = a.shape[0]
    bs = -(-b // n_shards)
    pad = n_shards * bs - b
    if pad:
        c = torch.cat([c, c[-1:].expand(pad, -1)])
        a = torch.cat([a, a[-1:].expand(pad)])
    mask = (torch.arange(n_shards * bs, device=a.device) < b
            ).reshape(n_shards, bs)
    return c.reshape(n_shards, bs, -1), a.reshape(n_shards, bs), mask


__all__ = ["ShardMesh", "SHARD_AXIS", "make_mesh", "data_mesh",
           "num_shards", "shard_leading", "split_rows"]
