"""`PassEngine`: the one front door for PASS serving.

A :class:`PassEngine` is built once from a
:class:`~repro_torch.core.types.Synopsis` plus two frozen typed configs,
then answers query batches:

    eng = PassEngine(syn, serving=ServingConfig(kinds=("sum", "avg")),
                     ci=CIConfig(level=0.95))
    results = eng.answer(queries)            # {kind: QueryResult}

The engine serves on ``device`` (None = the CUDA card): the synopsis is
moved there once per pinned plan and each batch on every call.

``eng.prepare(queries)`` returns a :class:`PreparedQuery` handle pinning
the resolved synopsis and the serving function for that batch shape x
config. An LRU plan cache keyed on batch shape x config lives in the
engine, so plain ``eng.answer(...)`` reuses prepared entries;
``eng.stats()`` counts hits, misses, evictions, invalidations and fused
bootstrap serves with the reference's meaning. There is no ahead-of-time
compile step yet, so ``aot_compiles`` stays 0.

``answer(queries, plan=plan)`` serves from a planner ``QueryPlan``
(``engine.planner.plan_queries``): its leaf masks and exact aggregates
replace the ``query_eval`` classification, for plain, CLT and bootstrap
serving alike.

``answer(queries, deadline_ms=...)`` and ``CIConfig(max_ci_width=...)``
serve through the degradation ladder (``serve/refine.py``): a tier-0
answer from the aggregate tree on the host, then sample tiers on the
device; ``answer_progressive`` returns the ladder's handle. A
:class:`~repro_torch.serve.RequestCoalescer` built on an engine attaches
to it, and ``checkpoint`` / ``restore`` round-trip a synopsis or a
streaming, sharded, join or catalog source through one ``.npz``
(``serve/checkpoint.py``).

Over a join synopsis (``joins.build_join_synopsis``) or a
``JoinStreamingIngestor``, ``answer_join`` / ``prepare_join`` serve
approximate fk-join aggregates (DESIGN.md §13) through the same plan
cache, in :class:`PreparedJoinQuery` entries.

``PassEngine.from_sharded(c, a, k=..., mesh=data_mesh(D))`` builds a
synopsis over D shards and serves its ``ShardedIngestor`` (DESIGN.md §11,
``sharded/``).

``PassEngine.from_catalog(parts, catalog=CatalogConfig(...))`` serves
partitioned data through the partition tier (DESIGN.md §14,
``partitions/``): with a ``max_partitions`` budget each batch runs the
picker, builds synopses only for the picked partitions and answers them
in one artifact pass over their stack (:class:`PreparedCatalogQuery`);
without one it serves the flat synopsis over all rows.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict

import torch

from ..core.types import QueryBatch, QueryResult
from ..device import resolve_device
from ..engine import executor as _executor
from ..engine.assemble import answer_batch
from ..testing import faults as _faults
from ..uncertainty.bootstrap import BOOT_KINDS, bootstrap_answer, key_tensor
from ..uncertainty.intervals import ci_answer
from .config import ServingConfig, CIConfig, as_ci_config


class _Unset:
    """Sentinel distinguishing 'inherit the engine's CIConfig' from an
    explicit ci=None (= no intervals)."""

    def __repr__(self):
        return "<inherit>"


_UNSET = _Unset()


def _resolve_key(key, device):
    """CIConfig.key (None | int seed | key array) as a (2,) key tensor on
    ``device``; None means ``PRNGKey(0)``."""
    return key_tensor(0 if key is None else key, device)


def _validate_request(serving: ServingConfig, ci: CIConfig | None) -> None:
    serving.validate()
    if ci is None:
        return
    ci.validate()
    if ci.method == "bootstrap":
        for kind in serving.kinds:
            if kind not in BOOT_KINDS:
                raise ValueError(
                    f"bootstrap supports {BOOT_KINDS}, got {kind!r}")
    if "avg" in serving.kinds and serving.avg_mode != "ratio":
        # Both ci methods center AVG intervals on the ratio estimator.
        raise ValueError(
            f"{ci.method} intervals support avg_mode='ratio' only"
            if ci.method == "bootstrap" else
            "calibrated intervals support avg_mode='ratio' only")


def _validate_join_request(serving: ServingConfig, ci: CIConfig | None):
    from ..joins import JOIN_KINDS
    serving.validate()
    if serving.sample_slots is not None:
        raise ValueError(
            "sample_slots applies to the single-table refinement ladder "
            "only; join serving estimates from key-universe samples, not "
            "the stratified reservoir")
    for kind in serving.kinds:
        if kind not in JOIN_KINDS:
            raise ValueError(
                f"join serving supports kinds {JOIN_KINDS}, got {kind!r} "
                "(min/max have no unbiased universe-sample estimator)")
    if ci is not None:
        ci.validate()
        if ci.method != "clt":
            raise ValueError(
                "join serving supports ci method 'clt' only "
                f"(got {ci.method!r}); the bootstrap resamples reservoir "
                "rows, not key universes")


def _join_dispatch_entry(serving: ServingConfig, ci: CIConfig | None):
    """The join serving function for one config: (pinned, queries,
    plan_masks) -> results, where ``pinned`` is the (JoinSynopsis,
    JoinSlots) pair; one function covers the plain (``ci=None``,
    lam-scaled CLT width) and the calibrated-interval paths."""
    from ..joins.executor import join_answer
    return functools.partial(
        join_answer, kinds=serving.kinds, lam=serving.lam,
        level=None if ci is None else float(ci.level),
        small_n_threshold=12 if ci is None else int(ci.small_n_threshold),
        delta_budget="stratum" if ci is None else ci.delta_budget)


def _validate_catalog_request(serving: ServingConfig, ci: CIConfig | None):
    from ..partitions import CATALOG_KINDS
    serving.validate()
    if serving.sample_slots is not None:
        raise ValueError(
            "sample_slots applies to the single-table refinement ladder "
            "only; the partition tier re-stacks per-partition reservoirs "
            "per batch")
    for kind in serving.kinds:
        if kind not in CATALOG_KINDS:
            raise ValueError(
                f"catalog serving supports kinds {CATALOG_KINDS}, got "
                f"{kind!r} (min/max cannot be composed across an "
                "importance-sampled partition stage)")
    if ci is not None:
        ci.validate()
        if ci.method != "clt":
            raise ValueError(
                "catalog serving supports ci method 'clt' only "
                f"(got {ci.method!r}); the bootstrap resamples rows, not "
                "the partition-selection stage")


def _catalog_dispatch_entry(serving: ServingConfig, ci: CIConfig | None,
                            k_part: int):
    """The catalog serving function for one config: (source, queries) ->
    results. ``source.stage`` selects, materializes and stacks the
    partitions of this batch (a batch under ``executor.MIN_ROWS`` rows
    padded to it) and hands back the operands of ``catalog_answer``."""
    from ..partitions.executor import catalog_answer
    answer = functools.partial(
        catalog_answer, kinds=serving.kinds, k_part=int(k_part),
        level=None if ci is None else float(ci.level),
        small_n_threshold=12 if ci is None else int(ci.small_n_threshold),
        use_fpc=serving.use_fpc,
        delta_budget="stratum" if ci is None else ci.delta_budget)
    lam = serving.lam

    def run(src, queries):
        n = queries.lo.shape[0]
        out = answer(*src.stage(queries, lam, _executor.MIN_ROWS))
        return out if n >= _executor.MIN_ROWS else \
            _executor.take_rows(out, n)
    return run


def _dispatch_entry(serving: ServingConfig, ci: CIConfig | None, device):
    """The serving function for one config: (syn, queries, plan_masks) ->
    results. The bootstrap's key is resolved here, once, on ``device``."""
    if ci is None:
        return functools.partial(
            answer_batch, kinds=serving.kinds, lam=serving.lam,
            use_fpc=serving.use_fpc, zero_var_rule=serving.zero_var_rule,
            use_aggregates=serving.use_aggregates, avg_mode=serving.avg_mode)
    if ci.method == "clt":
        return functools.partial(
            ci_answer, kinds=serving.kinds, level=float(ci.level),
            small_n_threshold=int(ci.small_n_threshold),
            use_fpc=serving.use_fpc, zero_var_rule=serving.zero_var_rule,
            use_aggregates=serving.use_aggregates, avg_mode=serving.avg_mode,
            delta_budget=ci.delta_budget)
    return functools.partial(
        bootstrap_answer, key=_resolve_key(ci.key, device),
        kinds=serving.kinds, n_boot=int(ci.n_boot), level=float(ci.level),
        normalize=ci.boot_normalize, use_aggregates=serving.use_aggregates,
        fused=bool(ci.boot_fused))


class PreparedQuery:
    """A pinned (batch shape x config) serving entry.

    Calling the handle with a same-shaped :class:`QueryBatch` runs the
    pinned serving function with no re-setup: configs are pre-validated
    and the synopsis is pinned on the engine's device (re-resolved only
    when the source's epoch or the engine's generation changes).
    Differently-shaped batches go to ``engine.answer`` (a plan-cache miss
    there), so a handle never answers wrongly. A handle pinned with
    ``has_plan=True`` takes the planner's masks with every call.
    """

    def __init__(self, engine: "PassEngine", serving: ServingConfig,
                 ci: CIConfig | None, shape: tuple, has_plan: bool = False):
        self._engine = engine
        self.serving = serving
        self.ci = ci
        self.shape = tuple(shape)
        self.has_plan = bool(has_plan)
        self._epoch = engine.epoch
        self._generation = engine._generation
        self._syn = self._resolve_source()
        self._run = self._make_entry()

    # Subclass hooks: which source view is pinned, which serving function
    # serves it, and where differently-shaped batches go instead.
    def _make_entry(self):
        return _dispatch_entry(self.serving, self.ci, self._engine.device)

    def _resolve_source(self):
        return _executor.slice_sample_slots(self._engine.resolve(),
                                            self.serving.sample_slots)

    def _fallback_answer(self, queries) -> dict[str, QueryResult]:
        return self._engine.answer(queries, kinds=self.serving.kinds,
                                   ci=self.ci, serving=self.serving)

    def _refresh(self) -> None:
        """Re-pin the serving synopsis after a source epoch bump or a
        replace_source() swap."""
        eng = self._engine
        if eng.epoch == self._epoch and eng._generation == self._generation:
            return
        self._epoch = eng.epoch
        self._generation = eng._generation
        self._syn = self._resolve_source()
        eng._stats["invalidations"] += 1

    def __call__(self, queries: QueryBatch,
                 plan_masks=None) -> dict[str, QueryResult]:
        if (plan_masks is not None) != self.has_plan:
            raise ValueError(
                "prepared entry was pinned with has_plan="
                f"{self.has_plan}; pass plan_masks accordingly")
        if tuple(queries.lo.shape) != self.shape:
            if self.has_plan:
                # Planner masks are (Q, k): re-key on the batch's own shape
                # so the fallback stays a counted plan-cache miss.
                return self._engine._lookup(
                    tuple(queries.lo.shape), self.serving, self.ci,
                    has_plan=True)(queries, plan_masks)
            return self._fallback_answer(queries)
        self._refresh()
        _executor.count_artifact_pass(self.serving.kinds)
        if (self.ci is not None and self.ci.method == "bootstrap"
                and self.ci.boot_fused):
            self._engine._stats["fused_serves"] += 1
        return self._serve(queries, plan_masks)

    def _serve(self, queries: QueryBatch, plan_masks):
        """Run the pinned serving function on one same-shaped batch."""
        queries = queries.to(self._engine.device)
        n = queries.lo.shape[0]
        if n >= _executor.MIN_ROWS:
            return self._run(self._syn, queries, plan_masks)
        # A short batch is served at MIN_ROWS rows, so its rows have the
        # bits they would have in any larger batch.
        queries, plan_masks = _executor.pad_rows(queries, plan_masks,
                                                 _executor.MIN_ROWS)
        return _executor.take_rows(self._run(self._syn, queries, plan_masks),
                                   n)


class PreparedJoinQuery(PreparedQuery):
    """A pinned fk-join serving entry (DESIGN.md §13): the lifecycle of
    :class:`PreparedQuery` (plan-cache slot, epoch-driven re-pin, short
    batches served at ``executor.MIN_ROWS`` rows), pinning the resolved
    :class:`~repro_torch.joins.JoinSynopsis` with its universe slots in
    row 9's layouts (derived once per pin) and the join serving function.
    The pinned shape is the concatenated ``(Q, d_fact + d_dim)`` join
    rectangle's."""

    def _make_entry(self):
        return _join_dispatch_entry(self.serving, self.ci)

    def _resolve_source(self):
        from ..joins.executor import join_slots
        jsyn = self._engine.resolve_join()
        return jsyn, join_slots(jsyn)

    def _fallback_answer(self, queries) -> dict[str, QueryResult]:
        return self._engine.answer_join(queries, kinds=self.serving.kinds,
                                        ci=self.ci, serving=self.serving)


class PreparedCatalogQuery(PreparedQuery):
    """A pinned partition-tier serving entry (DESIGN.md §14): the
    lifecycle of :class:`PreparedQuery` (plan-cache slot, epoch-driven
    re-pin), pinning the :class:`~repro_torch.partitions.CatalogSource`
    itself. Every call re-draws the partition selection, so the stacked
    operands' width changes with the number of picked partitions (padded
    to a power of two)."""

    def _make_entry(self):
        return _catalog_dispatch_entry(self.serving, self.ci,
                                       self._engine._source.config.k)

    def _resolve_source(self):
        return self._engine._source

    def _serve(self, queries: QueryBatch, plan_masks):
        return self._run(self._syn, queries)


class PassEngine:
    """Stateful PASS serving facade: configure once, serve many.

    ``source`` is a :class:`~repro_torch.core.types.Synopsis`, a
    :class:`~repro_torch.streaming.StreamingIngestor` or a
    :class:`~repro_torch.sharded.ShardedIngestor`, whose epoch bump on
    every ingest re-pins the prepared entries (one invalidation each).
    ``ci=None`` serves plain estimates, ``ci=0.95`` is shorthand for
    ``CIConfig(level=0.95)``. ``device=None`` serves on the CUDA card and
    raises when there is none.
    """

    def __init__(self, source, serving: ServingConfig | None = None,
                 ci: CIConfig | float | None = None,
                 plan_cache_size: int = 32, device=None):
        self.device = resolve_device(device)
        self._source = source
        self.serving = (serving or ServingConfig()).validate()
        self.ci = as_ci_config(ci)
        _validate_request(self.serving, self.ci)
        if plan_cache_size < 1:
            raise ValueError("plan_cache_size must be >= 1")
        self._plan_cache_size = int(plan_cache_size)
        self._cache: OrderedDict[tuple, PreparedQuery] = OrderedDict()
        self._generation = 0
        self._coalescer = None
        self._stats = {"hits": 0, "misses": 0, "evictions": 0,
                       "invalidations": 0, "aot_compiles": 0,
                       "fused_serves": 0, "tier0_serves": 0,
                       "refine_steps": 0, "degraded_serves": 0}
        self._refine_ewma_ms = 0.0

    # -- construction ------------------------------------------------------
    @classmethod
    def from_sharded(cls, c, a, *, k: int = 64, mesh=None,
                     serving: ServingConfig | None = None,
                     ci: CIConfig | float | None = None,
                     plan_cache_size: int = 32, device=None,
                     **build_kw) -> "PassEngine":
        """Build a synopsis data-parallel over ``mesh``'s shards and serve
        it.

        Runs :func:`repro_torch.sharded.build_synopsis_sharded` (rows dealt
        over the ``"shards"`` axis, O(k) merge) and serves the resulting
        :class:`~repro_torch.sharded.ShardedIngestor`, so the engine goes
        on streaming data-parallel: ``eng.source.ingest(...)`` bumps the
        epoch and prepared plans re-pin on their next call, as with the
        single-device streaming source. ``mesh=None`` is a ``data_mesh``
        on ``device`` (None = the CUDA card); the engine serves on the
        mesh's device. ``build_kw`` goes to ``build_synopsis_sharded``
        (``sample_budget``, ``method``, ``opt_samples``, ``seed``, ...).
        """
        from ..sharded import build_synopsis_sharded, data_mesh
        mesh = mesh if mesh is not None else data_mesh(device=device)
        ing, _report = build_synopsis_sharded(c, a, k=k, mesh=mesh,
                                              **build_kw)
        return cls(ing, serving=serving, ci=ci,
                   plan_cache_size=plan_cache_size, device=mesh.device)

    @classmethod
    def from_catalog(cls, parts, *, catalog=None,
                     serving: ServingConfig | None = None,
                     ci: CIConfig | float | None = None,
                     plan_cache_size: int = 32, device=None,
                     **build_kw) -> "PassEngine":
        """Serve partitioned data through the sketch-guided partition tier
        (DESIGN.md §14).

        ``parts`` is a :class:`~repro_torch.partitions.PartitionStore` or a
        sequence of per-partition ``(c, a)`` row blocks; ``catalog`` a
        :class:`~repro_torch.api.CatalogConfig`. With a ``max_partitions``
        budget the engine builds PASS synopses only for the partitions
        the picker selects a batch (disjoint and covered ones are pruned
        exactly) and composes the answers by Horvitz-Thompson with
        two-stage intervals. Without a budget it serves the flat synopsis
        over all rows (``build_kw`` goes to ``build_synopsis``),
        bit-identical to never partitioning. ``device=None`` serves on the
        CUDA card.
        """
        from ..partitions import CatalogSource, PartitionStore
        from .config import CatalogConfig
        store = (parts if isinstance(parts, PartitionStore)
                 else PartitionStore(parts))
        cfg = (catalog if catalog is not None else CatalogConfig()).validate()
        dev = resolve_device(device)
        return cls(CatalogSource(store, cfg, build_kw, device=dev),
                   serving=serving, ci=ci, plan_cache_size=plan_cache_size,
                   device=dev)

    # -- checkpoint / restore (DESIGN.md §15) ------------------------------
    def checkpoint(self, path) -> dict:
        """Snapshot the serving state (synopsis or streaming reservoir and
        delta) at an epoch boundary into one ``.npz``; see
        :func:`repro_torch.serve.checkpoint.save_engine`. Returns the
        metadata dict that was written."""
        from ..serve.checkpoint import save_engine
        return save_engine(self, path)

    @classmethod
    def restore(cls, path, *, serving: ServingConfig | None = None,
                ci: CIConfig | float | None = None, mesh=None,
                plan_cache_size: int = 32, device=None) -> "PassEngine":
        """Rebuild an engine from a :meth:`checkpoint` file (one the JAX
        package wrote too), bit-identical on the serving path; see
        :func:`repro_torch.serve.checkpoint.load_engine`. ``serving=`` /
        ``ci=`` default to the checkpointed configs; ``mesh=`` places a
        sharded source (default: the checkpoint's shard count on the
        engine's device); ``device=None`` serves on the CUDA card."""
        from ..serve.checkpoint import load_engine
        return load_engine(cls, path, serving=serving, ci=ci, mesh=mesh,
                           plan_cache_size=plan_cache_size, device=device)

    # -- source ------------------------------------------------------------
    @property
    def source(self):
        return self._source

    def _catalog_selective(self) -> bool:
        """True when the source is a budgeted CatalogSource: serving goes
        through the partition-selection entry (a dense catalog source
        takes the ordinary flat path)."""
        src = self._source
        return (getattr(src, "is_catalog_source", False)
                and not src.serves_flat)

    @property
    def epoch(self) -> int:
        """Change counter of the source (0 for an immutable synopsis; a
        streaming ingestor bumps it on every ingest)."""
        return getattr(self._source, "epoch", 0)

    def resolve(self):
        """Current serving synopsis (delta-merged for a streaming source),
        on the engine's device."""
        return _executor.resolve_synopsis(self._source).to(self.device)

    def replace_source(self, source) -> "PassEngine":
        """Swap the serving source and invalidate every cached plan (the
        generation bump also reaches handles the user still holds)."""
        self._source = source
        self._generation += 1
        self.clear_cache()
        self._stats["invalidations"] += 1
        return self

    # -- config plumbing ---------------------------------------------------
    def _effective_catalog(self, kinds, ci, serving):
        from ..partitions import CATALOG_KINDS
        sv = serving if serving is not None else self.serving
        if kinds is not None:
            sv = dataclasses.replace(sv, kinds=kinds)
        else:
            # Inherited kinds keep the catalog-answerable ones (the join
            # serving's rule).
            sv = dataclasses.replace(
                sv, kinds=tuple(k for k in sv.kinds if k in CATALOG_KINDS)
                or ("sum",))
        cfg = self.ci if ci is _UNSET else as_ci_config(ci)
        _validate_catalog_request(sv, cfg)
        return sv, cfg

    def _effective(self, kinds, ci, serving):
        sv = serving if serving is not None else self.serving
        if kinds is not None:
            sv = dataclasses.replace(sv, kinds=kinds)
        cfg = self.ci if ci is _UNSET else as_ci_config(ci)
        _validate_request(sv.validate(), cfg)
        return sv, cfg

    # -- plan cache --------------------------------------------------------
    def _lookup(self, shape, serving, ci, has_plan: bool = False,
                join: bool = False, catalog: bool = False) -> PreparedQuery:
        key = (tuple(shape), serving.cache_key(),
               ci.cache_key() if ci is not None else None, has_plan, join,
               catalog)
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            self._stats["hits"] += 1
            return hit
        self._stats["misses"] += 1
        cls = (PreparedCatalogQuery if catalog
               else PreparedJoinQuery if join else PreparedQuery)
        prepared = cls(self, serving, ci, shape, has_plan=has_plan)
        self._cache[key] = prepared
        if len(self._cache) > self._plan_cache_size:
            self._cache.popitem(last=False)
            self._stats["evictions"] += 1
        return prepared

    def clear_cache(self) -> None:
        self._cache.clear()

    def stats(self) -> dict:
        """Plan-cache counters, ``fused_serves`` (answers served through
        the fused bootstrap kernel), the ladder's ``tier0_serves``,
        ``refine_steps`` and ``degraded_serves``, the current entry count
        and the source epoch; ``"faults"`` (:meth:`_fault_snapshot`),
        ``"coalescer"`` when a request coalescer is attached and
        ``"catalog"`` (the partition tier's counters) over a catalog
        source."""
        out = dict(self._stats, entries=len(self._cache), epoch=self.epoch)
        if self._coalescer is not None:
            out["coalescer"] = self._coalescer.stats()
        if getattr(self._source, "is_catalog_source", False):
            out["catalog"] = self._source.stats()
        out["faults"] = self._fault_snapshot()
        return out

    def _fault_snapshot(self) -> dict:
        """Containment observability (DESIGN.md §15): a streaming source's
        quarantined row count, a sharded source's dispatch counters
        (retries, dropped and poisoned batches), a catalog source's
        degraded partitions, and the injected event counts when a fault
        harness is installed."""
        faults: dict = {}
        src = self._source
        if hasattr(src, "n_quarantined"):
            faults["quarantined_rows"] = src.n_quarantined
        if hasattr(src, "fault_stats"):
            faults.update(src.fault_stats())
        if hasattr(src, "degraded_partitions"):
            faults["degraded_partitions"] = sorted(src.degraded_partitions)
        inj = _faults.active()
        if inj is not None:
            faults["injected"] = inj.snapshot()
        return faults

    # -- serving -----------------------------------------------------------
    def prepare(self, queries_or_shape, *, kinds=None, ci=_UNSET,
                serving: ServingConfig | None = None) -> PreparedQuery:
        """Pin a (batch shape x config) serving entry and return the handle.
        ``queries_or_shape`` is a :class:`QueryBatch` or a ``(Q, d)``
        tuple."""
        shape = (tuple(queries_or_shape.lo.shape)
                 if hasattr(queries_or_shape, "lo")
                 else tuple(queries_or_shape))
        if len(shape) != 2:
            raise ValueError(f"expected a (Q, d) batch shape, got {shape}")
        if self._catalog_selective():
            sv, cfg = self._effective_catalog(kinds, ci, serving)
            return self._lookup(shape, sv, cfg, catalog=True)
        sv, cfg = self._effective(kinds, ci, serving)
        return self._lookup(shape, sv, cfg)

    def answer(self, queries: QueryBatch, *, kinds=None, ci=_UNSET,
               serving: ServingConfig | None = None, plan=None,
               deadline_ms: float | None = None) -> dict[str, QueryResult]:
        """Answer a batch for every configured kind from one shared
        artifact pass; returns ``{kind: QueryResult}``. ``kinds=`` /
        ``ci=`` / ``serving=`` override the engine configs for this call.
        ``plan=`` injects a planner ``QueryPlan`` whose masks replace the
        leaf classification; plan-carrying calls have their own plan-cache
        slot per shape x config.

        ``deadline_ms=`` (or ``CIConfig(max_ci_width=...)``) switches to
        the degradation ladder (DESIGN.md §15): a tier-0 aggregates-only
        answer from the planner descent and the §2.3 hard bounds (host
        numpy, no sample work), then refined through growing sample slices
        until the width target or the deadline is met. A tier starts only
        when its EWMA-predicted latency still fits the deadline. The
        ladder's results are host numpy.

        Over a budgeted catalog source every batch goes through the
        partition tier (``plan=`` and ``deadline_ms`` are refused: the
        tier re-stacks strata a batch and degrades a partition at a time
        instead)."""
        shape = tuple(queries.lo.shape)
        if self._catalog_selective():
            if plan is not None:
                raise ValueError(
                    "plan= is not supported with a budgeted catalog "
                    "source; planner masks are per-stratum of ONE synopsis "
                    "while the partition tier re-stacks strata per batch")
            if deadline_ms is not None:
                raise ValueError(
                    "deadline_ms needs the aggregate-tree tier-0 path; a "
                    "budgeted catalog source degrades per partition "
                    "instead (see stats()['faults'])")
            sv, cfg = self._effective_catalog(kinds, ci, serving)
            return self._lookup(shape, sv, cfg, catalog=True)(queries)
        sv, cfg = self._effective(kinds, ci, serving)
        if (deadline_ms is not None
                or (cfg is not None and cfg.max_ci_width is not None
                    and plan is None)):
            if plan is not None:
                raise ValueError(
                    "deadline_ms cannot be combined with plan=; the "
                    "ladder plans tier 0 itself")
            return self.answer_progressive(
                queries, kinds=kinds, ci=ci, serving=serving,
                deadline_ms=deadline_ms).run()
        if plan is not None:
            return self._lookup(shape, sv, cfg, has_plan=True)(
                queries, _executor.plan_to_masks(plan, self.device))
        return self._lookup(shape, sv, cfg)(queries)

    def answer_progressive(self, queries: QueryBatch, *, kinds=None,
                           ci=_UNSET, serving: ServingConfig | None = None,
                           deadline_ms: float | None = None):
        """Start the degradation ladder and return its
        :class:`~repro_torch.serve.RefinementHandle`: ``handle.results``
        holds the tier-0 answer at once; ``refine()`` / ``final()`` /
        ``run()`` tighten it from growing sample slices."""
        from ..serve.refine import RefinementHandle
        if self._catalog_selective():
            raise ValueError(
                "progressive refinement needs the aggregate-tree tier-0 "
                "path; not available on a budgeted catalog source")
        sv, cfg = self._effective(kinds, ci, serving)
        if sv.sample_slots is not None:
            raise ValueError(
                "sample_slots is managed by the ladder itself; pass a "
                "serving config without it")
        return RefinementHandle(self, queries, sv, cfg,
                                deadline_ms=deadline_ms)

    # -- fk-join serving (DESIGN.md §13) ------------------------------------
    def resolve_join(self):
        """Current join synopsis on the engine's device; raises TypeError
        when the source has no join augmentation (``build_join_synopsis``
        / ``JoinStreamingIngestor``)."""
        from ..joins import resolve_join_synopsis
        return resolve_join_synopsis(self._source).to(self.device)

    def _effective_join(self, kinds, ci, serving):
        sv = serving if serving is not None else self.serving
        if kinds is not None:
            sv = dataclasses.replace(sv, kinds=kinds)
        else:
            from ..joins import JOIN_KINDS
            # Inherited kinds keep the join-answerable ones, so an engine
            # configured for five kinds still answers joins.
            sv = dataclasses.replace(
                sv, kinds=tuple(k for k in sv.kinds if k in JOIN_KINDS)
                or ("sum",))
        cfg = self.ci if ci is _UNSET else as_ci_config(ci)
        _validate_join_request(sv, cfg)
        return sv, cfg

    def _as_join_batch(self, queries, dim_queries=None) -> QueryBatch:
        """The concatenated ``[fact ‖ dim attrs]`` rectangle, on the
        engine's device: from a (fact, dim) pair, a full-width batch, or a
        fact-width batch (dim side unconstrained, +-3.0e38)."""
        from ..joins import join_queries
        from ..kernels.segment_reduce import NEG_BIG, POS_BIG
        if dim_queries is not None:
            return join_queries(queries, dim_queries).to(self.device)
        if isinstance(queries, tuple):
            return join_queries(*queries).to(self.device)
        jsyn = self.resolve_join()
        d_f, d_d = jsyn.d_fact, jsyn.d_dim
        width = queries.lo.shape[1]
        if width == d_f + d_d:
            return QueryBatch(
                *(torch.as_tensor(x).to(self.device, torch.float32)
                  for x in (queries.lo, queries.hi)))
        if width == d_f:
            q = queries.lo.shape[0]
            fill = QueryBatch(torch.full((q, d_d), NEG_BIG),
                              torch.full((q, d_d), POS_BIG))
            return join_queries(queries, fill).to(self.device)
        raise ValueError(
            f"join query width {width} matches neither the fact side "
            f"({d_f}) nor the concatenated layout ({d_f + d_d})")

    def _check_join_binding(self, dim_table, on) -> None:
        from ..joins import resolve_join_synopsis
        jsyn = resolve_join_synopsis(self._source)
        if on is not None and on != jsyn.key_name:
            raise ValueError(
                f"engine's join synopsis is keyed on {jsyn.key_name!r}, "
                f"got on={on!r}; universe membership is drawn per key at "
                "build time, so the join key cannot change at query time")
        if dim_table is not None and dim_table is not jsyn.dim:
            d = jsyn.dim
            if (dim_table.num_keys != d.num_keys
                    or dim_table.num_partitions != d.num_partitions
                    or dim_table.d_attr != d.d_attr):
                raise ValueError(
                    "dim_table differs from the one this join synopsis "
                    "was built against; rebuild with build_join_synopsis "
                    "to join a different dimension relation")

    def prepare_join(self, queries_or_shape, *, kinds=None, ci=_UNSET,
                     serving: ServingConfig | None = None
                     ) -> PreparedJoinQuery:
        """Pin a join serving entry (the join analogue of :meth:`prepare`).
        Takes a :class:`QueryBatch` in any layout :meth:`answer_join`
        accepts, a (fact, dim) batch pair, or a concatenated ``(Q, d_fact
        + d_dim)`` shape tuple."""
        if hasattr(queries_or_shape, "lo") or (
                isinstance(queries_or_shape, tuple) and queries_or_shape
                and hasattr(queries_or_shape[0], "lo")):
            shape = tuple(self._as_join_batch(queries_or_shape).lo.shape)
        else:
            shape = tuple(queries_or_shape)
        if len(shape) != 2:
            raise ValueError(f"expected a (Q, d) batch shape, got {shape}")
        sv, cfg = self._effective_join(kinds, ci, serving)
        return self._lookup(shape, sv, cfg, join=True)

    def answer_join(self, fact_queries, dim_queries=None, *, dim_table=None,
                    on: str | None = None, kinds=None, ci=_UNSET,
                    serving: ServingConfig | None = None
                    ) -> dict[str, QueryResult]:
        """Answer fk-join aggregate queries from the engine's join synopsis;
        returns ``{kind: QueryResult}`` like :meth:`answer`.

        ``fact_queries`` is a :class:`QueryBatch` over the fact columns
        (the dim side then unconstrained), a concatenated ``[fact ‖ dim
        attrs]`` batch, or a (fact, dim) pair; or pass the dim side as
        ``dim_queries=``. ``dim_table=`` / ``on=`` assert which dimension
        relation and key the query means (the synopsis is bound to one at
        build time). Cells covered on both sides are answered exactly from
        the pre-joined aggregates, overlapping cells by Horvitz-Thompson
        over the correlated key-universe samples, with CLT / Bernstein
        intervals (``uncertainty.intervals.compose_join_interval``).
        """
        self._check_join_binding(dim_table, on)
        queries = self._as_join_batch(fact_queries, dim_queries)
        sv, cfg = self._effective_join(kinds, ci, serving)
        return self._lookup(tuple(queries.lo.shape), sv, cfg, join=True)(
            queries)


__all__ = ["PassEngine", "PreparedQuery", "PreparedJoinQuery",
           "PreparedCatalogQuery"]
