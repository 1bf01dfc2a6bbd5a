"""Deterministic, seed-keyed fault injection for the serving stack
(DESIGN.md §15); the port of ``repro/testing/faults.py``, numpy only.

Production code calls :func:`active` at a handful of **hook sites**; when
no injector is installed the hook is a single ``is None`` check, so the hot
paths pay nothing. A test (or an operator drill) installs a
:class:`FaultPlan` and every hook site starts drawing deterministic
faults:

* **straggler ticks** — every ``straggler_every``-th coalescer tick
  sleeps ``straggler_ms`` before coalescing (deadline pressure without
  touching results). Wired: ``serve/coalescer.py`` ``RequestCoalescer.tick``.
* **corrupt ingest batches** — every ``poison_every``-th ingested batch is
  corrupted in toto (NaN / Inf measures or out-of-box coordinates, per
  ``poison_mode``), modelling an upstream producer shipping garbage; the
  streaming quarantine turns the whole batch into a counted no-op. Wired:
  ``streaming/ingest.py`` ``StreamingIngestor.ingest``.
* **partition-materialization failures** — the listed partitions fail
  their synopsis builds a number of times (or forever); the partition
  tier retries, then serves the queries overlapping a partition that
  stays failed from catalog hard bounds. Wired:
  ``partitions/source.py`` ``CatalogSource._build_one``.
* **shard dispatch failures** — every ``shard_fail_every``-th sharded
  dispatch fails its first ``shard_fail_persist`` attempts (-1: every
  attempt); the sharded ingest retries with backoff, then drops the batch
  and counts it. Wired: ``sharded/ingest.py`` ``ShardedIngestor._dispatch``.

Decisions are functions of (plan, per-site counter) only, never of wall
clock or global RNG state, so a fixed plan over a fixed call sequence
reproduces the same fault schedule as the JAX package's harness; a faulted
run and a clean run can then be held bit for bit on what the faults do not
touch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np


class InjectedFault(RuntimeError):
    """An artificially injected failure (never raised in production unless
    an injector is installed)."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative fault schedule. ``*_every = 0`` disables that fault
    class; ``seed`` keys the poison row corruption draws."""
    seed: int = 0
    shard_fail_every: int = 0
    shard_fail_persist: int = 2
    straggler_every: int = 0
    straggler_ms: float = 20.0
    poison_every: int = 0
    poison_mode: str = "nan"          # nan | inf | oob
    materialize_fail_parts: tuple[int, ...] = ()
    materialize_fail_times: int = 2   # -1 = fail forever

    def validate(self) -> "FaultPlan":
        for name in ("shard_fail_every", "straggler_every", "poison_every"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        if self.poison_mode not in ("nan", "inf", "oob"):
            raise ValueError(f"unknown poison_mode: {self.poison_mode!r}")
        if self.straggler_ms < 0.0:
            raise ValueError("straggler_ms must be >= 0")
        return self


class FaultInjector:
    """Live injector: per-site counters + injected-event telemetry.

    Thread-safe (the coalescer tick and submitters run concurrently); all
    counters are plain ints behind one lock.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan.validate()
        self._lock = threading.Lock()
        self._site_counts: dict[str, int] = {}
        self._events: dict[str, int] = {}
        self._mat_attempts: dict[int, int] = {}

    def _bump_site(self, site: str) -> int:
        """Post-increment the per-site call counter (1-based index out)."""
        with self._lock:
            n = self._site_counts.get(site, 0) + 1
            self._site_counts[site] = n
            return n

    def _record(self, event: str) -> None:
        with self._lock:
            self._events[event] = self._events.get(event, 0) + 1

    # -- hook sites --------------------------------------------------------
    def shard_dispatch_fails(self, attempt: int) -> bool:
        """Called once per (dispatch, attempt); attempt 0 advances the
        dispatch counter. Injected dispatches fail their first
        ``shard_fail_persist`` attempts, then succeed (transient)."""
        every = self.plan.shard_fail_every
        if attempt == 0:
            idx = self._bump_site("shard_dispatch")
            with self._lock:
                self._site_counts["_shard_live"] = idx
        else:
            with self._lock:
                idx = self._site_counts.get("_shard_live", 0)
        if not every or idx % every:
            return False
        persist = self.plan.shard_fail_persist
        if persist < 0 or attempt < persist:   # -1 = fail forever
            self._record("shard_dispatch_failures")
            return True
        return False

    def tick_delay_s(self) -> float:
        """Seconds the current coalescer tick should stall (0 = none)."""
        every = self.plan.straggler_every
        if not every:
            return 0.0
        idx = self._bump_site("tick")
        if idx % every:
            return 0.0
        self._record("straggler_ticks")
        return self.plan.straggler_ms / 1e3

    def poison_batch(self, c: np.ndarray, a: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, bool]:
        """Maybe corrupt one ingest batch (whole-batch poison). Returns
        (c, a, poisoned); inputs are never mutated in place."""
        every = self.plan.poison_every
        if not every:
            return c, a, False
        idx = self._bump_site("ingest_batch")
        if idx % every:
            return c, a, False
        self._record("poisoned_batches")
        rng = np.random.default_rng((self.plan.seed, idx))
        c = np.array(c, np.float32, copy=True)
        a = np.array(a, np.float32, copy=True)
        mode = self.plan.poison_mode
        if mode == "nan":
            a[:] = np.nan
        elif mode == "inf":
            a[:] = np.where(rng.random(a.shape) < 0.5, np.inf, -np.inf)
        else:                                              # out-of-box rows
            c[:] = 4.0e8 * np.sign(rng.standard_normal(c.shape) + 0.5)
        return c, a, True

    def materialize_fails(self, part: int) -> bool:
        """Per-partition attempt counter: listed partitions fail their
        first ``materialize_fail_times`` attempts (-1 = forever)."""
        if part not in self.plan.materialize_fail_parts:
            return False
        with self._lock:
            n = self._mat_attempts.get(part, 0)
            self._mat_attempts[part] = n + 1
        times = self.plan.materialize_fail_times
        if times >= 0 and n >= times:
            return False
        self._record("materialize_failures")
        return True

    # -- telemetry ---------------------------------------------------------
    def snapshot(self) -> dict:
        """Injected-event counts (what the harness actually fired)."""
        with self._lock:
            return dict(self._events)


# One process-wide injector slot; hooks read it lock-free (attribute read
# of a module global is atomic in CPython) and pay a single None check
# when no harness is installed.
_ACTIVE: FaultInjector | None = None


def active() -> FaultInjector | None:
    """The installed injector, or None (the production fast path)."""
    return _ACTIVE


def install(plan: FaultPlan) -> FaultInjector:
    """Install a plan process-wide; returns the live injector."""
    global _ACTIVE
    _ACTIVE = FaultInjector(plan)
    return _ACTIVE


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Scoped install: ``with inject(FaultPlan(...)) as inj: ...``."""
    inj = install(plan)
    try:
        yield inj
    finally:
        uninstall()


__all__ = ["FaultPlan", "FaultInjector", "InjectedFault", "active",
           "inject", "install", "uninstall"]
