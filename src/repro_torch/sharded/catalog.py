"""Data-parallel maintenance of the partition catalog (DESIGN.md §14 x
§11); the port of ``repro/sharded/catalog.py``.

Every :class:`~repro_torch.partitions.PartitionCatalog` field is a
mergeable summary, so keeping the catalog current under sharded ingest
takes the pattern the synopsis state uses: each shard runs
:func:`~repro_torch.partitions.partition_stats` over its row block (d + 2
row-5 launches), then the shards fold in shard order through
:func:`~repro_torch.partitions.combine_catalogs` (counts, sums and
histograms add, boxes and measure extremes MIN/MAX). The result equals
the stats pass over the concatenated rows up to the order of float32
additions.
"""
from __future__ import annotations

import functools

import torch

from ..partitions.catalog import (PartitionCatalog, combine_catalogs,
                                  empty_catalog, partition_stats)
from ..device import to_numpy
from .mesh import ShardMesh, data_mesh, num_shards


def catalog_delta_sharded(c, a, pid, num_partitions: int, *, bins: int,
                          bin_lo, bin_hi, mesh: ShardMesh | None = None,
                          device=None) -> PartitionCatalog:
    """Catalog delta of one ingest batch, computed shard by shard.

    ``c`` (B, d) rows, ``a`` (B,) measures, ``pid`` (B,) partition ids
    (tensors or arrays, moved to the mesh's device; ``mesh=None`` is a
    ``data_mesh`` on ``device``, None = the CUDA card). Rows are dealt
    into D contiguous blocks, the tail padded with the last real row and
    masked out; each shard sketches its block and the blocks fold. Fold
    the delta into the running catalog with ``combine_catalogs``; the
    fixed ``bin_lo`` / ``bin_hi`` edges keep that fold pointwise.
    """
    mesh = mesh if mesh is not None else data_mesh(device=device)
    n_shards = num_shards(mesh)
    dev = mesh.device
    c = torch.as_tensor(c, device=dev).to(torch.float32)
    if c.dim() == 1:
        c = c[:, None]
    a = torch.as_tensor(a, device=dev).to(torch.float32).reshape(-1)
    pid = torch.as_tensor(pid, device=dev).to(torch.int32).reshape(-1)
    b = a.shape[0]
    if b == 0:
        return empty_catalog(num_partitions, c.shape[1], bins,
                             to_numpy(bin_lo), to_numpy(bin_hi), dev)
    bs = -(-b // n_shards)
    pad = n_shards * bs - b
    if pad:
        c = torch.cat([c, c[-1:].expand(pad, -1)])
        a = torch.cat([a, a[-1:].expand(pad)])
        pid = torch.cat([pid, pid[-1:].expand(pad)])
    mask = (torch.arange(n_shards * bs, device=dev) < b).reshape(
        n_shards, bs)
    c = c.reshape(n_shards, bs, -1)
    a = a.reshape(n_shards, bs)
    pid = pid.reshape(n_shards, bs)
    cats = [partition_stats(c[i], a[i], pid[i], num_partitions, bins=bins,
                            bin_lo=bin_lo, bin_hi=bin_hi, mask=mask[i])
            for i in range(n_shards)]
    return functools.reduce(combine_catalogs, cats)


__all__ = ["catalog_delta_sharded"]
