"""Dimension-table synopsis: the partitioned, pk-sorted lookup side of an
fk-join (DESIGN.md §13); the port of ``repro/joins/dim.py``.

A :class:`DimTable` holds the dimension relation in join-serving form:
the primary keys sorted ascending (``torch.searchsorted`` gives the fk ->
row lookup of the build, the streaming ingest and the oracles), the
attributes in the same order (extra predicate columns of a join query),
and an equal-depth partitioning of the keys by the first attribute with
exact per-partition boxes and aggregates: the dimension side's strata. A
(fact stratum x dim partition) cell is answered exactly iff both sides
classify as covered against their half of the query rectangle.

The build is host numpy, step for step the reference's, then one float32
conversion and one copy to the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import dp as _dp
from ..core import partition_tree as _pt
from ..core.types import NUM_AGGS, _to
from ..device import resolve_device


@dataclasses.dataclass
class DimTable:
    """Join-ready dimension table (pk-sorted, partitioned).

    ``key_sorted`` (Dn,) int32 ascending unique primary keys;
    ``attr_sorted`` (Dn, d_attr) f32 attributes in key order;
    ``part_sorted`` (Dn,) int32 partition id per key;
    ``part_lo``/``part_hi`` (P, d_attr) f32 exact partition boxes;
    ``part_agg`` (P, NUM_AGGS) f32 aggregates of the first attribute per
    partition (COUNT is the key count), ``leaf_agg``'s layout.
    """
    key_sorted: torch.Tensor
    attr_sorted: torch.Tensor
    part_sorted: torch.Tensor
    part_lo: torch.Tensor
    part_hi: torch.Tensor
    part_agg: torch.Tensor
    num_partitions: int
    d_attr: int
    num_keys: int

    def to(self, device) -> "DimTable":
        return _to(self, device)


def build_dim_table(keys, attrs=None, *, num_partitions: int = 16,
                    device=None) -> DimTable:
    """Host build of a DimTable from a dimension relation, on ``device``
    (None = the CUDA card).

    ``keys``: (Dn,) unique integer primary keys. ``attrs``: (Dn,) or (Dn,
    d_attr) attribute columns; None uses the key itself as the one
    attribute. Partitioning is equal-depth on the first attribute.
    """
    dev = resolve_device(device)
    keys = np.asarray(keys)
    if keys.ndim != 1:
        raise ValueError(f"dim keys must be 1-D, got shape {keys.shape}")
    if not np.issubdtype(keys.dtype, np.integer):
        raise ValueError(f"dim keys must be integers, got {keys.dtype}")
    dn = keys.shape[0]
    if dn < 1:
        raise ValueError("dim table must be non-empty")
    if np.unique(keys).size != dn:
        raise ValueError("dim keys must be unique (primary key of the "
                         "fk-join dimension side)")
    if attrs is None:
        attrs = keys.astype(np.float64)
    attrs = np.asarray(attrs, np.float64)
    if attrs.ndim == 1:
        attrs = attrs[:, None]
    if attrs.shape[0] != dn:
        raise ValueError(
            f"attrs rows {attrs.shape[0]} != keys rows {dn}")

    order = np.argsort(keys, kind="stable")
    keys_s = keys[order].astype(np.int64)
    attrs_s = attrs[order]

    p = int(min(num_partitions, dn))
    # Equal-depth cut on the first attribute (rank space): contiguous in
    # attr0, so the partition boxes barely overlap.
    a0 = attrs_s[:, 0]
    rorder = np.argsort(a0, kind="stable")
    ranks = np.empty(dn, dtype=np.int64)
    ranks[rorder] = np.arange(dn)
    cuts = _dp.equal_depth_boundaries(dn, p)
    part = np.searchsorted(cuts[1:-1], ranks, side="right").astype(np.int32)

    agg, lo, hi = _pt.leaf_stats(attrs_s, a0, part, p)

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    return DimTable(
        key_sorted=torch.from_numpy(keys_s.astype(np.int32)).to(dev),
        attr_sorted=f32(attrs_s), part_sorted=torch.from_numpy(part).to(dev),
        part_lo=f32(lo), part_hi=f32(hi), part_agg=f32(agg[:, :NUM_AGGS]),
        num_partitions=p, d_attr=int(attrs_s.shape[1]), num_keys=dn)


def dim_lookup(dim: DimTable, keys):
    """fk -> (partition id (B,) int32, joined attrs (B, d_attr) f32, found
    (B,) bool), on the table's device. Keys absent from the dimension
    side never join: part -1, zero attrs, found False."""
    kv = keys if isinstance(keys, torch.Tensor) else torch.from_numpy(
        np.asarray(keys).astype(np.int32))
    kv = kv.to(device=dim.key_sorted.device, dtype=torch.int32).reshape(-1)
    idx = torch.clamp(torch.searchsorted(dim.key_sorted, kv), 0,
                      dim.num_keys - 1)
    found = dim.key_sorted[idx] == kv
    part = torch.where(found, dim.part_sorted[idx], -1).to(torch.int32)
    attrs = torch.where(found[:, None], dim.attr_sorted[idx], 0.0)
    return part, attrs, found


__all__ = ["DimTable", "build_dim_table", "dim_lookup"]
