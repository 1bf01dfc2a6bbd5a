"""Per-partition summary-statistics catalog (DESIGN.md §14; PS3-style
sketches above the PASS tree); the port of ``repro/partitions/catalog.py``.

A :class:`PartitionCatalog` holds, for each of P storage partitions, the
cheap statistics a picker needs to decide whether the partition can
matter to a predicate at all and how much it is likely to contribute:

* row count and per-column min/max boxes: exact pruning (a partition
  whose box is disjoint from, or contained in, a query rectangle is
  irrelevant, or answered exactly from the measure aggregates);
* per-column SUM/SUMSQ moments and an equal-width histogram over fixed
  global bin edges: selectivity estimates for the importance weights;
* measure [SUM, SUMSQ, COUNT, MIN, MAX] in the standard aggregate layout:
  exact covered answers, partition-granularity §2.3 hard bounds and the
  E[a²] scale term of the weights.

Every field is a mergeable summary (additive, or min/max:
:func:`combine_catalogs`). :func:`build_catalog` makes one host numpy
pass per contiguous partition block; :func:`partition_stats` is the
device-side maintenance pass over rows with partition ids, d + 2
``segment_reduce`` launches (row 5, fixed summation order, no float
atomics) on a CUDA tensor and its plain version on a CPU one. MIN/MAX
follow the reference's signed-zero rule (:mod:`repro_torch.minmax`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import minmax
from ..core.types import NUM_AGGS, AGG_MIN, AGG_MAX
from ..device import resolve_device, to_numpy
from ..kernels import ops

_INF = float("inf")


@dataclasses.dataclass
class PartitionCatalog:
    """Stacked per-partition sketches, every tensor leading-dim P, on one
    device.

    Empty partitions carry the inverted box (+inf lo, -inf hi) and
    +inf/-inf measure extremes, the empty-leaf convention of the synopsis
    builder, so they classify as disjoint against any query.
    ``bin_lo``/``bin_hi`` are the (d,) global histogram edges; two
    catalogs merge iff their edges and meta match. ``n_host`` is a host
    copy of ``n`` where the catalog was made on the host (None after a
    device pass), so :attr:`total_rows` needs no device sync.
    """
    n: torch.Tensor          # (P,) f32 row counts
    col_lo: torch.Tensor     # (P, d) f32 per-column minima
    col_hi: torch.Tensor     # (P, d) f32 per-column maxima
    col_sum: torch.Tensor    # (P, d) f32
    col_sumsq: torch.Tensor  # (P, d) f32
    hist: torch.Tensor       # (P, d, bins) f32 equal-width bin counts
    m_agg: torch.Tensor      # (P, NUM_AGGS) f32 measure aggregates
    bin_lo: torch.Tensor     # (d,) f32 global histogram lower edges
    bin_hi: torch.Tensor     # (d,) f32 global histogram upper edges
    num_partitions: int
    d: int
    bins: int
    n_host: np.ndarray | None = None

    @property
    def device(self) -> torch.device:
        return self.n.device

    @property
    def total_rows(self) -> float:
        """Float32 sum of the row counts, as the reference sums them."""
        n = self.n_host if self.n_host is not None else to_numpy(self.n)
        return float(np.sum(n, dtype=np.float32))


def empty_catalog(num_partitions: int, d: int, bins: int, bin_lo, bin_hi,
                  device=None) -> PartitionCatalog:
    """All-empty catalog on ``device`` (None = the CUDA card): the identity
    element of :func:`combine_catalogs`."""
    dev = resolve_device(device)
    p = int(num_partitions)
    m_agg = torch.zeros((p, NUM_AGGS), dtype=torch.float32, device=dev)
    m_agg[:, AGG_MIN] = _INF
    m_agg[:, AGG_MAX] = -_INF
    f32 = dict(dtype=torch.float32, device=dev)
    return PartitionCatalog(
        n=torch.zeros((p,), **f32),
        col_lo=torch.full((p, d), _INF, **f32),
        col_hi=torch.full((p, d), -_INF, **f32),
        col_sum=torch.zeros((p, d), **f32),
        col_sumsq=torch.zeros((p, d), **f32),
        hist=torch.zeros((p, d, bins), **f32),
        m_agg=m_agg,
        bin_lo=torch.as_tensor(np.asarray(bin_lo, np.float32).reshape(d),
                               device=dev),
        bin_hi=torch.as_tensor(np.asarray(bin_hi, np.float32).reshape(d),
                               device=dev),
        num_partitions=p, d=int(d), bins=int(bins),
        n_host=np.zeros(p, np.float32))


def _extremes(out: torch.Tensor, count: torch.Tensor):
    """The MIN and MAX columns of a ``segment_reduce`` result with its
    empty segments' +-3.0e38 replaced by +-inf, the reference's fill."""
    empty = count == 0
    return (torch.where(empty, _INF, out[:, 3]),
            torch.where(empty, -_INF, out[:, 4]))


def partition_stats(c, a, pid, num_partitions: int, *, bins: int, bin_lo,
                    bin_hi, mask=None, device=None) -> PartitionCatalog:
    """One pass: rows -> per-partition sketches, on the rows' device.

    ``c`` (B, d) predicate columns, ``a`` (B,) measure, ``pid`` (B,) int
    partition ids in [0, P); tensors stay on their device, arrays go to
    ``device`` (None = the CUDA card). ``mask`` (B,) bool drops rows
    (the sharded path deals rows out in fixed-size blocks). Each sketch is
    one ``segment_reduce`` over the partition ids (dropped rows get id -1,
    which the reduction skips): one per predicate column ([Σc_j, Σc_j², ·,
    min, max] -> ``col_sum``, ``col_sumsq``, ``col_lo``, ``col_hi``), one
    for the measure (``m_agg``'s own layout, whose count is ``n``) and one
    over the flat ids ``pid·d·bins + j·bins + bin``, whose count column is
    ``hist``: d + 2 launches.
    """
    p = int(num_partitions)
    dev = c.device if isinstance(c, torch.Tensor) else resolve_device(device)
    c = torch.as_tensor(c, device=dev).to(torch.float32)
    if c.dim() == 1:
        c = c[:, None]
    c = c.contiguous()
    a = torch.as_tensor(a, device=dev).to(torch.float32).reshape(-1)
    pid = torch.as_tensor(pid, device=dev).to(torch.int32).reshape(-1)
    d = c.shape[1]
    blo = torch.as_tensor(bin_lo, device=dev).to(torch.float32).reshape(d)
    bhi = torch.as_tensor(bin_hi, device=dev).to(torch.float32).reshape(d)
    if a.shape[0] == 0:
        return empty_catalog(p, d, bins, to_numpy(blo), to_numpy(bhi), dev)
    keep = (pid >= 0) & (pid < p)
    if mask is not None:
        keep &= torch.as_tensor(mask, device=dev).reshape(-1).bool()
    idx = torch.where(keep, pid, -1)

    cols = [ops.segment_reduce(c[:, j].contiguous(), idx, p)
            for j in range(d)]
    meas = ops.segment_reduce(a, idx, p)
    n = meas[:, 2].contiguous()
    lo_hi = [_extremes(o, n) for o in cols]
    m_min, m_max = _extremes(meas, n)
    m_agg = torch.cat([meas[:, :3], m_min[:, None], m_max[:, None]], 1)

    width = torch.clamp(bhi - blo, min=1e-30)
    # Clamping before the cast is clip(trunc(x)) for every non-NaN x, and
    # no far-out value overflows the int32 cast.
    b = torch.clamp((c - blo) / width * bins, 0, bins - 1).to(torch.int32)
    flat = (idx[:, None] * (d * bins)
            + torch.arange(d, dtype=torch.int32, device=dev)[None] * bins + b)
    flat = torch.where(keep[:, None], flat, -1)
    hist = ops.segment_reduce(c.reshape(-1), flat.reshape(-1),
                              p * d * bins)[:, 2].reshape(p, d, bins)

    return PartitionCatalog(
        n=n, col_lo=torch.stack([lo for lo, _ in lo_hi], 1),
        col_hi=torch.stack([hi for _, hi in lo_hi], 1),
        col_sum=torch.stack([o[:, 0] for o in cols], 1),
        col_sumsq=torch.stack([o[:, 1] for o in cols], 1),
        hist=hist, m_agg=m_agg, bin_lo=blo, bin_hi=bhi,
        num_partitions=p, d=d, bins=int(bins))


def combine_catalogs(x: PartitionCatalog, y: PartitionCatalog
                     ) -> PartitionCatalog:
    """Mergeable-summary combine: counts, sums and histograms add, boxes
    and measure extremes min/max (signed zeros as the reference's)."""
    if (x.num_partitions, x.d, x.bins) != (y.num_partitions, y.d, y.bins):
        raise ValueError(
            f"catalog shapes differ: P/d/bins "
            f"{(x.num_partitions, x.d, x.bins)} vs "
            f"{(y.num_partitions, y.d, y.bins)}")
    m_agg = torch.cat(
        [x.m_agg[:, 0:3] + y.m_agg[:, 0:3],
         minmax.minimum(x.m_agg[:, 3:4], y.m_agg[:, 3:4]),
         minmax.maximum(x.m_agg[:, 4:5], y.m_agg[:, 4:5])], 1)
    n_host = (x.n_host + y.n_host
              if x.n_host is not None and y.n_host is not None else None)
    return dataclasses.replace(
        x, n=x.n + y.n,
        col_lo=minmax.minimum(x.col_lo, y.col_lo),
        col_hi=minmax.maximum(x.col_hi, y.col_hi),
        col_sum=x.col_sum + y.col_sum,
        col_sumsq=x.col_sumsq + y.col_sumsq,
        hist=x.hist + y.hist, m_agg=m_agg, n_host=n_host)


def global_bin_edges(parts) -> tuple[np.ndarray, np.ndarray]:
    """Global per-column [min, max] over a list of (c, a) partitions: the
    fixed histogram edges every sketch of the catalog shares."""
    los, his = [], []
    for c, _a in parts:
        c2 = np.asarray(c, np.float64)
        if c2.ndim == 1:
            c2 = c2[:, None]
        if c2.shape[0]:
            los.append(c2.min(axis=0))
            his.append(c2.max(axis=0))
    if not los:
        raise ValueError("cannot derive histogram edges from empty data")
    lo = np.min(np.stack(los), axis=0)
    hi = np.max(np.stack(his), axis=0)
    # Degenerate columns still need a nonzero bin width.
    hi = np.where(hi > lo, hi, lo + 1.0)
    return lo.astype(np.float32), hi.astype(np.float32)


def build_catalog(parts, *, bins: int = 16, bin_lo=None, bin_hi=None,
                  device=None) -> PartitionCatalog:
    """Catalog over a list of ``(c, a)`` partitions: one vectorized host
    pass per partition (the blocks are contiguous, so plain reductions
    beat scatters), the reference's float64 -> float32 casts, then the
    tensors on ``device`` (None = the CUDA card). ``bin_lo``/``bin_hi``
    override the derived global edges (pass them when partitions arrive
    incrementally)."""
    dev = resolve_device(device)
    if bin_lo is None or bin_hi is None:
        bin_lo, bin_hi = global_bin_edges(parts)
    p = len(parts)
    c0 = np.asarray(parts[0][0])
    d = 1 if c0.ndim == 1 else c0.shape[1]
    blo = np.asarray(bin_lo, np.float64).reshape(d)
    bhi = np.asarray(bin_hi, np.float64).reshape(d)
    width = np.maximum(bhi - blo, 1e-30)
    n = np.zeros(p, np.float32)
    col_lo = np.full((p, d), np.inf, np.float32)
    col_hi = np.full((p, d), -np.inf, np.float32)
    col_sum = np.zeros((p, d), np.float32)
    col_sumsq = np.zeros((p, d), np.float32)
    hist = np.zeros((p, d, bins), np.float32)
    m_agg = np.zeros((p, NUM_AGGS), np.float32)
    m_agg[:, AGG_MIN] = np.inf
    m_agg[:, AGG_MAX] = -np.inf
    for i, (c, a) in enumerate(parts):
        c2 = np.asarray(c, np.float64)
        if c2.ndim == 1:
            c2 = c2[:, None]
        a1 = np.asarray(a, np.float64).reshape(-1)
        if not a1.shape[0]:
            continue
        n[i] = a1.shape[0]
        col_lo[i] = c2.min(axis=0)
        col_hi[i] = c2.max(axis=0)
        col_sum[i] = c2.sum(axis=0)
        col_sumsq[i] = (c2 * c2).sum(axis=0)
        b = np.clip(((c2 - blo) / width * bins).astype(np.int64),
                    0, bins - 1)
        for dd in range(d):
            hist[i, dd] = np.bincount(b[:, dd], minlength=bins)
        m_agg[i] = (a1.sum(), (a1 * a1).sum(), a1.shape[0],
                    a1.min(), a1.max())

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    return PartitionCatalog(
        n=t(n), col_lo=t(col_lo), col_hi=t(col_hi), col_sum=t(col_sum),
        col_sumsq=t(col_sumsq), hist=t(hist), m_agg=t(m_agg),
        bin_lo=t(blo), bin_hi=t(bhi),
        num_partitions=p, d=int(d), bins=int(bins), n_host=n)


__all__ = ["PartitionCatalog", "partition_stats", "combine_catalogs",
           "empty_catalog", "build_catalog", "global_bin_edges"]
