"""Typed, frozen serving configuration.

The two dataclasses are the single source of truth for every serving
default, field for field the JAX package's. Both are immutable, so a
config can key the engine's prepared-plan cache: :meth:`cache_key`
returns a hashable token.

The one difference from the reference: ``ServingConfig.backend`` must
be None. The port has no named backend: the device of the tensors picks
each kernel (a CUDA tensor the hand-written kernel, a CPU tensor its
plain version).
"""
from __future__ import annotations

import dataclasses

import numpy as np

KINDS = ("sum", "count", "avg", "min", "max")
CI_METHODS = ("clt", "bootstrap")
DELTA_BUDGETS = ("stratum", "union")
BOOT_NORMALIZE = ("hajek", "ht")


def _normalize_kinds(kinds) -> tuple[str, ...]:
    return (kinds,) if isinstance(kinds, str) else tuple(kinds)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """What to serve and how to estimate it (paper §2.1-§2.3, §3.4).

    ``kinds``          aggregate kinds answered per batch (one shared
                       artifact pass covers all of them).
    ``backend``        must be None: the tensors' device picks each
                       kernel.
    ``lam``            CLT multiplier for the ``ci_half`` field.
    ``use_fpc``        finite-population correction (§2.1.1 footnote 1).
    ``zero_var_rule``  §3.4 zero-variance promotion (stratum-mode AVG).
    ``use_aggregates`` exact-cover shortcut + deterministic hard bounds;
                       False is classic stratified sampling.
    ``avg_mode``       'ratio' (est-SUM/est-COUNT) or 'stratum'.
    ``sample_slots``   serve from only the first N sample slots of every
                       stratum (None = all); a prefix of a uniform
                       without-replacement sample is itself uniform.
    """
    kinds: tuple[str, ...] = ("sum",)
    backend: str | None = None
    lam: float = 2.576
    use_fpc: bool = True
    zero_var_rule: bool = True
    use_aggregates: bool = True
    avg_mode: str = "ratio"
    sample_slots: int | None = None

    def __post_init__(self):
        object.__setattr__(self, "kinds", _normalize_kinds(self.kinds))

    def validate(self) -> "ServingConfig":
        for k in self.kinds:
            if k not in KINDS:
                raise ValueError(f"unknown kind: {k}")
        if self.backend is not None:
            raise ValueError(
                f"backend={self.backend!r}: repro_torch has no named "
                "backends; the device of the tensors picks each kernel (a "
                "CUDA tensor the hand-written kernel, a CPU tensor its "
                "plain version), so backend must be None")
        if self.avg_mode not in ("ratio", "stratum"):
            raise ValueError(f"unknown avg_mode: {self.avg_mode!r}")
        if self.sample_slots is not None and self.sample_slots < 1:
            raise ValueError(
                f"sample_slots must be >= 1 or None, got {self.sample_slots}")
        return self

    def cache_key(self) -> tuple:
        return (self.kinds, self.backend, float(self.lam), self.use_fpc,
                self.zero_var_rule, self.use_aggregates, self.avg_mode,
                self.sample_slots)


def _key_token(key):
    """Hashable digest of a PRNG key (None | int seed | key array)."""
    if key is None or isinstance(key, int):
        return key
    if hasattr(key, "detach"):
        key = key.detach().cpu()
    return tuple(np.asarray(key).reshape(-1).tolist())


@dataclasses.dataclass(frozen=True)
class CIConfig:
    """Calibrated-interval configuration.

    ``level``             nominal two-sided confidence level in (0, 1).
    ``method``            'clt' (stratified composition with Bernstein /
                          range fallbacks) or 'bootstrap' (Poisson
                          bootstrap on the card).
    ``small_n_threshold`` effective-n below which a sampled stratum leaves
                          the CLT regime (CLT method only).
    ``delta_budget``      'stratum' (every fallback stratum spends the full
                          delta = 1 - level) or 'union' (delta /
                          n_fallback_strata per query).
    ``n_boot``            bootstrap replicate count.
    ``key``               bootstrap PRNG key (None = seed 0 | int seed |
                          array of two uint32 words, a JAX key's data
                          included); excluded from equality and digested
                          for the plan-cache key.
    ``boot_normalize``    'hajek' (rescale by the resampled stratum size,
                          recommended for AVG) or 'ht' (fixed design
                          scale).
    ``boot_fused``        True serves through the one-pass
                          ``bootstrap_moments`` kernel; False runs the
                          per-replicate reference loop. The two are
                          bit-identical for the same key.
    ``max_ci_width``      progressive-refinement stop criterion: when set,
                          ``PassEngine.answer`` serves through the
                          degradation ladder (``serve/refine.py``) and
                          stops refining once every query's interval width
                          (ci_hi - ci_lo) is at most this value, or the
                          samples run out. None disables it. Not part of
                          the plan-cache key: every ladder tier shares the
                          prepared entries of plain serving.
    """
    level: float = 0.95
    method: str = "clt"
    small_n_threshold: int = 12
    delta_budget: str = "stratum"
    n_boot: int = 200
    key: object = dataclasses.field(default=None, compare=False)
    boot_normalize: str = "hajek"
    boot_fused: bool = True
    max_ci_width: float | None = None

    def validate(self) -> "CIConfig":
        if not 0.0 < self.level < 1.0:
            raise ValueError(
                f"confidence level must be in (0, 1), got {self.level}")
        if self.method not in CI_METHODS:
            raise ValueError(f"unknown ci_method: {self.method!r}")
        if self.delta_budget not in DELTA_BUDGETS:
            raise ValueError(f"unknown delta_budget: {self.delta_budget!r}")
        if self.boot_normalize not in BOOT_NORMALIZE:
            raise ValueError(f"unknown normalize: {self.boot_normalize!r}")
        if self.max_ci_width is not None and self.max_ci_width <= 0.0:
            raise ValueError(
                f"max_ci_width must be > 0 or None, got {self.max_ci_width}")
        return self

    def cache_key(self) -> tuple:
        # max_ci_width is a stop criterion of the ladder, not a property of
        # the serving function, so it stays out of the key.
        return (float(self.level), self.method, int(self.small_n_threshold),
                self.delta_budget, int(self.n_boot), _key_token(self.key),
                self.boot_normalize, self.boot_fused)


@dataclasses.dataclass(frozen=True)
class CoalescerConfig:
    """Multi-tenant request-coalescer configuration (``serve/coalescer.py``).

    ``tick_ms``           coalescing window: how long the ``TickDriver``
                          sleeps between ticks. Every request queued when a
                          tick fires rides that tick's dispatches (the
                          synchronous mode ignores it and ticks on demand).
    ``shape_classes``     ascending padded-batch ladder. A dispatch is padded
                          up to the smallest class holding its rows, so each
                          bucket reuses one prepared entry per (class x
                          config); oversized requests round up to a multiple
                          of the largest class.
    ``max_outstanding``   per-tenant admission budget: submitted but not yet
                          served requests beyond it are shed with
                          ``Overloaded``.
    ``max_queue_depth``   global queued-request bound; submissions past it
                          are shed whatever the tenant.
    ``wait_window``       per-tenant queue-wait samples kept for the p50/p95
                          in ``stats()``.
    """
    tick_ms: float = 2.0
    shape_classes: tuple[int, ...] = (8, 32, 128)
    max_outstanding: int = 8
    max_queue_depth: int = 256
    wait_window: int = 1024

    def __post_init__(self):
        object.__setattr__(self, "shape_classes",
                           tuple(int(s) for s in self.shape_classes))

    def validate(self) -> "CoalescerConfig":
        if self.tick_ms <= 0.0:
            raise ValueError(f"tick_ms must be > 0, got {self.tick_ms}")
        if not self.shape_classes:
            raise ValueError("shape_classes must be non-empty")
        if any(s <= 0 for s in self.shape_classes):
            raise ValueError(
                f"shape_classes must be positive, got {self.shape_classes}")
        if tuple(sorted(self.shape_classes)) != self.shape_classes:
            raise ValueError(
                f"shape_classes must be ascending, got {self.shape_classes}")
        if self.max_outstanding < 1:
            raise ValueError("max_outstanding must be >= 1")
        if self.max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        if self.wait_window < 1:
            raise ValueError("wait_window must be >= 1")
        return self

    def padded_size(self, q: int) -> int:
        """Rows -> padded batch size: the smallest class that holds them,
        or a multiple of the largest class past the top."""
        if q < 1:
            raise ValueError(f"padded_size needs >= 1 rows, got {q}")
        for s in self.shape_classes:
            if q <= s:
                return s
        top = self.shape_classes[-1]
        return -(-q // top) * top


@dataclasses.dataclass(frozen=True)
class CatalogConfig:
    """Partition-tier configuration (DESIGN.md §14), field for field the
    JAX package's.

    ``k`` / ``s_per_leaf``  uniform per-partition synopsis shape: every
                          materialized partition gets k strata x
                          s_per_leaf samples, so a selection stacks into
                          one pseudo-synopsis (one artifact pass a batch).
    ``method``            per-partition partitioning method ('eq' default:
                          the partition boundary already did the
                          clustering).
    ``max_partitions``    expected number of overlapping partitions
                          materialized a batch (the importance-sampling
                          budget); None = no budget, which collapses the
                          tier to exact flat serving.
    ``pi_floor``          least inclusion probability of an overlapping
                          candidate (bounds the 1/pi HT variance).
    ``max_resident``      LRU capacity of materialized partition synopses
                          (None = 2x budget, at least 8; unbounded when
                          dense).
    ``bins``              per-column histogram resolution of the sketch.
    ``seed``              base seed: partition p builds from seed+p, the
                          i-th selection draw from seed+i.
    """
    k: int = 8
    s_per_leaf: int = 32
    method: str = "eq"
    max_partitions: int | None = None
    pi_floor: float = 0.05
    max_resident: int | None = None
    bins: int = 16
    seed: int = 0

    def validate(self) -> "CatalogConfig":
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.s_per_leaf < 1:
            raise ValueError(
                f"s_per_leaf must be >= 1, got {self.s_per_leaf}")
        if self.method not in ("eq", "adp", "kd"):
            raise ValueError(f"unknown method: {self.method!r}")
        if self.max_partitions is not None and self.max_partitions < 1:
            raise ValueError(
                f"max_partitions must be >= 1 or None, got "
                f"{self.max_partitions}")
        if not 0.0 < self.pi_floor <= 1.0:
            raise ValueError(
                f"pi_floor must be in (0, 1], got {self.pi_floor}")
        if self.max_resident is not None and self.max_resident < 1:
            raise ValueError(
                f"max_resident must be >= 1 or None, got "
                f"{self.max_resident}")
        if self.bins < 2:
            raise ValueError(f"bins must be >= 2, got {self.bins}")
        return self

    def cache_key(self) -> tuple:
        return (self.k, self.s_per_leaf, self.method, self.max_partitions,
                float(self.pi_floor), self.max_resident, self.bins,
                int(self.seed))


def as_ci_config(ci) -> CIConfig | None:
    """Coerce ``None | float level | CIConfig`` to an optional CIConfig."""
    if ci is None or isinstance(ci, CIConfig):
        return ci
    return CIConfig(level=float(ci))


def merge_overrides(cfg, **overrides):
    """``dataclasses.replace(cfg, ...)`` dropping ``None`` values."""
    real = {k: v for k, v in overrides.items() if v is not None}
    return dataclasses.replace(cfg, **real) if real else cfg


__all__ = ["ServingConfig", "CIConfig", "CoalescerConfig", "CatalogConfig",
           "as_ci_config", "merge_overrides",
           "KINDS", "CI_METHODS", "DELTA_BUDGETS", "BOOT_NORMALIZE"]
