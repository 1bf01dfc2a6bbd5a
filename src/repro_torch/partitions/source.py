"""``CatalogSource``: the engine-facing partition tier (DESIGN.md §14);
the port of ``repro/partitions/source.py``.

It stands where a Synopsis or a streaming ingestor would as a
``PassEngine`` source, but holds a :class:`PartitionStore` and its sketch
catalog and decides **per query batch** which partitions deserve a PASS
synopsis at all:

* **dense mode** (``max_partitions=None`` or >= the partition count):
  every partition would be picked with probability 1, so the tier
  collapses to flat serving: ``as_synopsis()`` builds one flat synopsis
  over the concatenated rows with the engine's ``build_kw``, bit-identical
  to never having partitioned the data (the store keeps row order), and
  the engine serves it through the ordinary prepared path.
* **selective mode** (a real budget): ``stage(queries)`` runs the picker
  on the host, materializes PASS synopses only for the picked partitions
  (kept on the serving device, LRU-cached under ``max_resident``),
  stacks them into the pseudo-synopsis (one ``torch.cat`` a field) and
  returns the operands of :func:`~repro_torch.partitions.executor.
  catalog_answer` on the serving device. Covered and disjoint partitions
  are pruned exactly and never cost a build.

Each ``stage`` draws a fresh selection (the seed advances once a batch),
so repeated answers over one batch realize the partition-sampling design
the two-stage intervals account for.
"""
from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np
import torch

from ..core.synopsis import (build_synopsis, partition_assign,
                             synopsis_from_assignment)
from ..core.types import QueryBatch
from ..device import resolve_device, to_numpy
from ..engine.executor import pad_rows
from ..testing import faults as _faults
from .catalog import build_catalog
from .executor import (stack_synopses, pad_partition_synopsis,
                       empty_partition_synopsis)
from .picker import pick_partitions
from .store import PartitionStore

# Materialization containment policy (DESIGN.md §15): a failed partition
# synopsis build retries with exponential backoff, then the partition is
# marked degraded and the queries overlapping it fall back to
# catalog-granularity hard bounds instead of failing the batch.
# Module-level so tests can shrink the backoff.
MATERIALIZE_RETRIES = 3
MATERIALIZE_BACKOFF_S = 0.001


class CatalogSource:
    """Partition-tier serving source over a :class:`PartitionStore`.

    ``config`` is a frozen :class:`repro_torch.api.CatalogConfig` (the
    per-partition synopsis shape k x s_per_leaf, selection budget, LRU
    capacity, sketch resolution); ``build_kw`` goes to the flat
    ``build_synopsis`` on the dense path only. ``device`` (None = the CUDA
    card) holds the partition synopses and the serving operands; the
    catalog the picker reads stays on the host.
    """

    is_catalog_source = True

    def __init__(self, store: PartitionStore, config, build_kw=None,
                 device=None):
        self.store = store
        self.config = config
        self.device = resolve_device(device)
        self._build_kw = dict(build_kw or {})
        self._catalog = None
        self._cat_dev = None
        self._flat = None
        self._resident: OrderedDict[int, object] = OrderedDict()
        self._built: set[int] = set()
        self._degraded: set[int] = set()
        self._draws = 0
        self._epoch = 0
        self._stats = {"materialized": 0, "hits": 0, "evictions": 0,
                       "served_batches": 0, "materialize_retries": 0,
                       "materialize_failures": 0}

    # -- catalog / mode ----------------------------------------------------
    @property
    def catalog(self):
        """Sketch catalog over every partition on the host, built once on
        first use (one vectorized pass over the store)."""
        if self._catalog is None:
            self._catalog = build_catalog(self.store.parts(),
                                          bins=self.config.bins,
                                          device="cpu")
        return self._catalog

    def _catalog_operands(self):
        """(m_agg, total_rows) of the catalog on the serving device, copied
        once a catalog."""
        if self._cat_dev is None:
            cat = self.catalog
            self._cat_dev = (
                cat.m_agg.to(self.device),
                torch.tensor(float(cat.total_rows), dtype=torch.float32,
                             device=self.device))
        return self._cat_dev

    @property
    def serves_flat(self) -> bool:
        """True when the budget admits every partition: the selection is
        deterministic (pi = 1 everywhere) and flat serving is exact."""
        m = self.config.max_partitions
        return m is None or m >= self.store.num_partitions

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def degraded_partitions(self) -> set[int]:
        """Partitions whose synopsis build failed past its retries; the
        queries overlapping them serve catalog-granularity hard bounds."""
        return set(self._degraded)

    def invalidate(self) -> None:
        """Drop every derived artifact (catalog, flat synopsis, resident
        partition synopses) and bump the epoch so prepared plans re-pin.
        Degraded partitions get a fresh chance to materialize."""
        self._catalog = None
        self._cat_dev = None
        self._flat = None
        self._resident.clear()
        self._degraded.clear()
        self._epoch += 1

    def as_synopsis(self):
        """Dense-path serving synopsis: the flat build over all rows, on
        the serving device."""
        if not self.serves_flat:
            raise ValueError(
                "CatalogSource with a partition budget serves through "
                "stage(), not a flat synopsis; raise max_partitions to "
                "cover every partition for dense serving")
        if self._flat is None:
            c, a = self.store.all_rows()
            self._flat, _report = build_synopsis(c, a, device=self.device,
                                                 **self._build_kw)
        return self._flat

    # -- materialization ---------------------------------------------------
    def _build_one(self, p: int):
        cfg = self.config
        inj = _faults.active()
        if inj is not None and inj.materialize_fails(p):
            raise _faults.InjectedFault(
                f"injected materialization failure p={p}")
        c, a = self.store.rows(p)
        if c.shape[0] == 0:
            return empty_partition_synopsis(cfg.k, cfg.s_per_leaf,
                                            self.store.d, self.device)
        # Per-partition seeds keep every build independent and
        # reproducible whatever the pick order.
        assign, k_real, _vmax = partition_assign(
            c, a, k=cfg.k, method=cfg.method, seed=cfg.seed + p)
        syn, _info = synopsis_from_assignment(
            c, a, assign, k_real, s_per_leaf=cfg.s_per_leaf,
            seed=cfg.seed + p + 1, device=self.device)
        return pad_partition_synopsis(syn, cfg.k, self.store.d)

    def _materialize(self, p: int):
        """Partition synopsis for ``p``, or None when the build fails past
        the retry budget (the partition is then degraded and served from
        catalog hard bounds until :meth:`invalidate`)."""
        cached = self._resident.get(p)
        if cached is not None:
            self._resident.move_to_end(p)
            self._stats["hits"] += 1
            return cached
        if p in self._degraded:
            return None
        for attempt in range(MATERIALIZE_RETRIES + 1):
            try:
                syn = self._build_one(p)
                break
            except Exception:
                # Any build failure is contained here: the partition is
                # retried, then degraded and counted, never fatal.
                if attempt >= MATERIALIZE_RETRIES:
                    self._degraded.add(p)
                    self._stats["materialize_failures"] += 1
                    return None
                self._stats["materialize_retries"] += 1
                time.sleep(MATERIALIZE_BACKOFF_S * (2 ** attempt))
        self._resident[p] = syn
        self._built.add(p)
        self._stats["materialized"] += 1
        return syn

    def _capacity(self) -> int:
        cfg = self.config
        if cfg.max_resident is not None:
            return int(cfg.max_resident)
        if cfg.max_partitions is not None:
            return max(2 * int(cfg.max_partitions), 8)
        return self.store.num_partitions

    def _evict(self, keep: set) -> None:
        cap = self._capacity()
        for p in [p for p in self._resident if p not in keep]:
            if len(self._resident) <= cap:
                break
            del self._resident[p]
            self._stats["evictions"] += 1

    # -- staging -----------------------------------------------------------
    def stage(self, queries: QueryBatch, lam: float, min_rows: int = 1):
        """Select, materialize and stack for one batch; returns the
        positional operands of ``catalog_answer`` on the serving device.

        The picker runs once, on the batch's own rows (one selection draw
        a call). A batch of fewer than ``min_rows`` rows is served padded:
        empty predicates (``engine.executor.pad_rows``) whose rows of
        ``ov_sel``, ``cat_cover``, ``cat_overlap`` and ``deg_q`` are zero;
        the caller takes the real rows back. ``deg_q`` is None when no
        partition is degraded."""
        cfg, dev = self.config, self.device
        q_lo = np.asarray(to_numpy(queries.lo), np.float64)
        q_hi = np.asarray(to_numpy(queries.hi), np.float64)
        cat = self.catalog
        sel = pick_partitions(cat, q_lo, q_hi, budget=cfg.max_partitions,
                              pi_floor=cfg.pi_floor,
                              seed=cfg.seed + self._draws)
        self._draws += 1
        self._stats["served_batches"] += 1
        syns, ok = [], []
        for p in np.flatnonzero(sel.picked):
            syn = self._materialize(int(p))
            if syn is None:      # degraded: serve from catalog bounds
                continue
            ok.append(int(p))
            syns.append(syn)
        picked = np.asarray(ok, np.int64)
        self._evict(set(ok))
        n_sel = len(picked)
        p_pad = 1 << max(0, int(n_sel - 1).bit_length()) if n_sel else 1
        stacked = stack_synopses(syns, p_pad, cfg.k, cfg.s_per_leaf,
                                 self.store.d, dev)
        q = q_lo.shape[0]
        rows = max(q, int(min_rows))
        pi = np.ones(p_pad, np.float32)
        ov_sel = np.zeros((rows, p_pad), np.float32)
        if n_sel:
            pi[:n_sel] = sel.pi[picked]
            ov_sel[:q, :n_sel] = sel.overlap[:, picked]
        cover = np.zeros((rows, cat.num_partitions), np.float32)
        overlap = np.zeros((rows, cat.num_partitions), np.float32)
        cover[:q] = sel.cover
        overlap[:q] = sel.overlap
        # Queries overlapping a degraded partition widen to the catalog
        # hard-bound envelope (covered partitions contribute exactly from
        # the catalog aggregates and never need a synopsis).
        deg_q = None
        if self._degraded:
            deg = sorted(self._degraded)
            deg_q = np.zeros(rows, np.float32)
            deg_q[:q] = (sel.overlap[:, deg] > 0).any(axis=1)
            deg_q = torch.from_numpy(deg_q).to(dev)
        queries = queries.to(dev)
        if rows > q:
            queries, _ = pad_rows(queries, None, rows)
        m_agg, total = self._catalog_operands()

        def t(x):
            return torch.from_numpy(x).to(dev)

        return (stacked, queries,
                torch.tensor(lam, dtype=torch.float32, device=dev),
                t(pi), t(ov_sel), t(cover), t(overlap), m_agg, total, deg_q)

    # -- instrumentation ---------------------------------------------------
    def stats(self) -> dict:
        """Tier instrumentation: synopsis builds, LRU hits and evictions,
        batch count, resident set size, and every partition id ever
        materialized (the exact-pruning tests assert that covered and
        disjoint ids never show up here)."""
        return dict(self._stats, resident=len(self._resident),
                    num_partitions=self.store.num_partitions,
                    materialized_ids=sorted(self._built),
                    degraded=sorted(self._degraded))


__all__ = ["CatalogSource"]
