"""Async multi-tenant request coalescer over :class:`PassEngine`
(DESIGN.md §12); the port of ``repro/serve/coalescer.py``.

Production PASS traffic is many concurrent tenants issuing small ragged
query batches, where the per-call cost of ``answer`` (hundreds of launches
from the host) dominates. The coalescer turns that workload back into the
shape the prepared-query layer is fastest at:

1. **Shape classes**: a request is assigned the smallest padded batch
   size from ``CoalescerConfig.shape_classes`` that holds its rows and is
   bucketed by ``(padded_B, ServingConfig, CIConfig)``. Each bucket reuses
   one prepared entry of the engine's plan cache, so the entry set stays
   bounded however ragged the tenants are.
2. **Cross-tenant batching**: at each tick, every bucket's queued requests
   are concatenated into padded batches, each served by one engine call.
   Requests whose queries already lie on the engine's device are muxed by
   one ``torch.cat`` with a cached pad block there; any other mix takes
   one padded upload. Pad rows are empty predicates (``lo = PAD_LO >
   hi = PAD_HI``): they match no stratum and never perturb real rows
   (every per-query artifact is row-independent, and the engine serves
   every batch at ``executor.MIN_ROWS`` rows or more, so a row's bits do
   not depend on its batch).
3. **Demux**: the whole result dict of a dispatch comes to the host in one
   device-to-host copy (every field of every kind stacked) and is sliced
   into per-request row ranges as numpy views, delivered through
   per-request :class:`concurrent.futures.Future`\\ s. Slicing per field on
   the device would cost a copy per field per request (the reference
   measured ~85x slower, DESIGN.md §12).

Admission control sheds load at submit time: a tenant past its
``max_outstanding`` budget, or any submission past the global
``max_queue_depth``, raises the typed :class:`Overloaded` error instead of
growing an unbounded queue. A request with a ``deadline_ms`` is served
the tier-0 answer (``serve/refine.py``, host numpy, no launch) instead of
being shed, or when the dispatch-latency EWMA predicts a blown budget.
Per-tenant accounting rides along in ``coalescer.stats()`` and
``engine.stats()["coalescer"]``.

Streaming epoch invalidation is structural: every dispatch is materialized
on the host before ``tick()`` returns, so a bucket launched against epoch N
never observes epoch N+1 state; the tick that first serves a new epoch
counts one ``epoch_drains``.

Threads and streams: ``TickDriver`` ticks on its own thread, and
PyTorch's current stream is per thread. A request whose queries lie on a
CUDA device records an event on the submitting thread's current stream at
``submit``; the tick makes its own current stream wait on it before the
mux reads the queries (the hand kernels launch on the current stream).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future

import numpy as np
import torch

from ..api.config import ServingConfig, CIConfig, CoalescerConfig
from ..api.engine import PassEngine, _UNSET
from ..core.types import QueryBatch, QueryResult
from ..device import to_numpy
from ..engine.executor import PAD_LO, PAD_HI
from ..testing import faults as _faults


class Overloaded(RuntimeError):
    """Typed admission-control rejection: the request was shed, not queued.

    ``reason`` is ``"tenant_outstanding"`` (the tenant's own budget) or
    ``"queue_depth"`` (global shed threshold); ``limit`` is the budget
    that tripped. Back off and resubmit.
    """

    def __init__(self, tenant, reason: str, limit: int):
        super().__init__(
            f"request from tenant {tenant!r} shed ({reason}, limit={limit})")
        self.tenant = tenant
        self.reason = reason
        self.limit = limit


@dataclasses.dataclass
class _Pending:
    """One queued tenant request (host-side bookkeeping only). ``dups``
    collects same-tick requests with bit-identical (predicate, config)
    payloads: they ride this request's dispatch and demux from its row
    range. ``ready`` is the event recorded at submit on the submitter's
    stream (device-resident queries only)."""
    tenant: object
    queries: QueryBatch
    serving: ServingConfig
    ci: CIConfig | None
    future: Future
    t_submit: float
    rows: int
    t_deadline: float | None = None   # absolute perf_counter deadline
    ready: object = None
    join: bool = False
    dups: list = dataclasses.field(default_factory=list)


class _TenantAccount:
    """Per-tenant serving telemetry (bounded queue-wait window)."""

    def __init__(self, window: int):
        self.requests = 0
        self.queries = 0
        self.shed = 0
        self.outstanding = 0
        self.waits = deque(maxlen=window)

    def snapshot(self) -> dict:
        waits = np.asarray(self.waits, np.float64)
        p50, p95 = ((float(np.percentile(waits, 50) * 1e3),
                     float(np.percentile(waits, 95) * 1e3))
                    if waits.size else (0.0, 0.0))
        return {"requests": self.requests, "queries": self.queries,
                "shed": self.shed, "outstanding": self.outstanding,
                "wait_p50_ms": p50, "wait_p95_ms": p95}


_QR_FIELDS = tuple(f.name for f in dataclasses.fields(QueryResult))


def _pull_host(results: dict[str, QueryResult]) -> dict[str, list]:
    """The whole result dict of one engine call on the host in one
    device-to-host copy: every field of every kind stacked into one
    (fields, Q) float32 block first. Returns ``{kind: [field arrays in
    _QR_FIELDS order, None where unset]}``, rows of that block."""
    slots, parts = [], []
    for kind, r in results.items():
        for i, name in enumerate(_QR_FIELDS):
            v = getattr(r, name)
            if v is not None:
                slots.append((kind, i))
                parts.append(v)
    block = torch.stack(parts).cpu().numpy()
    host = {kind: [None] * len(_QR_FIELDS) for kind in results}
    for row, (kind, i) in zip(block, slots):
        host[kind][i] = row
    return host


def _slice_results(host: dict[str, list], off: int, rows: int
                   ) -> dict[str, QueryResult]:
    """Demux one request's row range out of a pulled batch result
    (numpy views, no copy)."""
    end = off + rows
    return {kind: QueryResult(*[None if a is None else a[off:end]
                                for a in arrs])
            for kind, arrs in host.items()}


def host_results(results: dict[str, QueryResult]) -> dict[str, QueryResult]:
    """``{kind: QueryResult}`` of tensors as host numpy, in one copy."""
    host = _pull_host(results)
    rows = next(iter(results.values())).estimate.shape[0]
    return _slice_results(host, 0, rows)


class RequestCoalescer:
    """Multi-tenant front door over one :class:`PassEngine` (module doc)."""

    def __init__(self, engine: PassEngine,
                 config: CoalescerConfig | None = None):
        self.engine = engine
        self.config = (config or CoalescerConfig()).validate()
        self._lock = threading.Lock()
        self._queue: list[_Pending] = []
        self._tenants: dict[object, _TenantAccount] = {}
        self._stats = {"submitted": 0, "served": 0, "shed": 0,
                       "dispatches": 0, "ticks": 0, "coalesced_rows": 0,
                       "padded_rows": 0, "epoch_drains": 0, "dedup_hits": 0,
                       "degraded_served": 0, "failed": 0,
                       "driver_errors": 0, "last_driver_error": None}
        # EWMA of dispatch latency: the deadline router compares a
        # request's remaining budget against this prediction.
        self._dispatch_ewma_ms = 0.0
        self._epoch = engine.epoch
        self._generation = engine._generation
        # Only makes the epoch-transition drain observable in stats().
        self._dispatched_since_drain = False
        engine._coalescer = self

    # -- submission --------------------------------------------------------
    def _account(self, tenant) -> _TenantAccount:
        acct = self._tenants.get(tenant)
        if acct is None:
            acct = self._tenants[tenant] = _TenantAccount(
                self.config.wait_window)
        return acct

    def submit(self, tenant, queries: QueryBatch, *, kinds=None, ci=_UNSET,
               serving: ServingConfig | None = None,
               join: bool = False,
               deadline_ms: float | None = None) -> Future:
        """Queue one tenant request; returns a Future resolving to the same
        ``{kind: QueryResult}`` that ``engine.answer`` would return, bit for
        bit, as host numpy arrays. ``kinds=``/``ci=``/``serving=`` override
        the engine configs per request, exactly like ``engine.answer``;
        requests share a dispatch only with requests of the same effective
        config. Raises :class:`Overloaded` when admission control sheds
        the request.

        ``deadline_ms`` opts the request into degraded serving instead of
        shedding: a submission admission control would reject, or a tick
        that predicts the dispatch would blow the remaining budget, serves
        the tier-0 answer (hard-bound envelope, no sample work) at once.

        ``join=True`` serves the request as ``engine.answer_join`` would
        (``queries`` in any layout it accepts); join requests bucket apart
        from single-table ones and have no tier 0, so they take no
        ``deadline_ms``.
        """
        if join:
            if deadline_ms is not None:
                raise ValueError(
                    "deadline_ms applies to single-table requests only "
                    "(tier-0 degraded serving has no join analogue)")
            sv, cfg = self.engine._effective_join(kinds, ci, serving)
            queries = self.engine._as_join_batch(queries)
        else:
            sv, cfg = self.engine._effective(kinds, ci, serving)
        if deadline_ms is not None and deadline_ms < 0:
            raise ValueError(f"deadline_ms must be >= 0, got {deadline_ms}")
        if queries.lo.ndim != 2 or queries.lo.shape[0] < 1:
            raise ValueError(
                f"expected a non-empty (q, d) batch, got "
                f"{tuple(queries.lo.shape)}")
        ready = None
        lo = queries.lo
        if isinstance(lo, torch.Tensor) and lo.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(lo.device))
        now = time.perf_counter()
        pend = _Pending(tenant=tenant, queries=queries, serving=sv, ci=cfg,
                        future=Future(), t_submit=now,
                        rows=int(queries.lo.shape[0]), ready=ready,
                        join=join,
                        t_deadline=(None if deadline_ms is None
                                    else now + deadline_ms / 1e3))
        with self._lock:
            acct = self._account(tenant)
            shed_reason = None
            if len(self._queue) >= self.config.max_queue_depth:
                shed_reason = ("queue_depth", self.config.max_queue_depth)
            elif acct.outstanding >= self.config.max_outstanding:
                shed_reason = ("tenant_outstanding",
                               self.config.max_outstanding)
            if shed_reason is not None and pend.t_deadline is None:
                acct.shed += 1
                self._stats["shed"] += 1
                raise Overloaded(tenant, *shed_reason)
            acct.requests += 1
            self._stats["submitted"] += 1
            if shed_reason is None:
                acct.outstanding += 1
                self._queue.append(pend)
        if shed_reason is not None:
            # Deadline-aware overload: the request that would have been
            # shed gets the degraded tier inline (no queue slot consumed).
            self._serve_tier0(pend, count_outstanding=False)
        return pend.future

    def answer(self, tenant, queries: QueryBatch, *, timeout=None,
               **overrides) -> dict[str, QueryResult]:
        """Blocking convenience: ``submit(...).result()`` (driver mode; in
        synchronous mode call ``tick()`` yourself)."""
        return self.submit(tenant, queries, **overrides).result(timeout)

    # -- epoch drain -------------------------------------------------------
    def _drain_on_epoch_bump(self) -> None:
        """Re-pin bookkeeping on a source epoch bump (ingest or
        replace_source). In-flight buckets are already drained: the demux
        materializes every dispatch on the host before tick() returns, which
        leaves only the transition count to record."""
        eng = self.engine
        if (eng.epoch == self._epoch
                and eng._generation == self._generation):
            return
        if self._dispatched_since_drain:
            self._stats["epoch_drains"] += 1
        self._dispatched_since_drain = False
        self._epoch = eng.epoch
        self._generation = eng._generation

    # -- dispatch ----------------------------------------------------------
    def _mux(self, group: list[_Pending], padded_b: int, d: int
             ) -> QueryBatch:
        """The padded cross-tenant batch. Requests on the engine's device
        are joined by one ``torch.cat`` per bound with a pad block there;
        any other mix is built on the host and uploaded once."""
        dev = self.engine.device
        pad = padded_b - sum(p.rows for p in group)
        if all(isinstance(p.queries.lo, torch.Tensor)
               and isinstance(p.queries.hi, torch.Tensor)
               and p.queries.lo.device == dev and p.queries.hi.device == dev
               for p in group):
            parts_lo = [p.queries.lo.to(torch.float32) for p in group]
            parts_hi = [p.queries.hi.to(torch.float32) for p in group]
            if pad:
                parts_lo.append(torch.full((pad, d), PAD_LO, device=dev))
                parts_hi.append(torch.full((pad, d), PAD_HI, device=dev))
            return QueryBatch(torch.cat(parts_lo), torch.cat(parts_hi))
        both = np.empty((2, padded_b, d), np.float32)
        both[0] = PAD_LO
        both[1] = PAD_HI
        off = 0
        for p in group:
            both[0, off:off + p.rows] = to_numpy(p.queries.lo).reshape(
                p.rows, d)
            both[1, off:off + p.rows] = to_numpy(p.queries.hi).reshape(
                p.rows, d)
            off += p.rows
        up = torch.from_numpy(both).to(dev)
        return QueryBatch(up[0], up[1])

    def _serve_tier0(self, p: _Pending, count_outstanding: bool = True
                     ) -> None:
        """Resolve one request with the tier-0 aggregates-only answer
        (deadline-degraded path: planner hard bounds on the host, no
        sample work, no launch)."""
        from .refine import tier0_answer
        try:
            res = tier0_answer(self.engine, p.queries, p.serving.kinds)
        except Exception as exc:
            p.future.set_exception(exc)
            res = None
        now = time.perf_counter()
        with self._lock:
            acct = self._account(p.tenant)
            if count_outstanding:
                acct.outstanding -= 1
            if res is not None:
                acct.queries += p.rows
                acct.waits.append(now - p.t_submit)
                self._stats["served"] += 1
                self._stats["degraded_served"] += 1
            else:
                self._stats["failed"] += 1
        if res is not None:
            self.engine._stats["degraded_serves"] += 1
            p.future.set_result(res)

    def _dispatch(self, group: list[_Pending], padded_b: int,
                  serving: ServingConfig, ci: CIConfig | None) -> None:
        """Serve one padded batch (one engine call) and demux."""
        t0 = time.perf_counter()
        d = int(group[0].queries.lo.shape[1])
        rows = sum(p.rows for p in group)
        pad = padded_b - rows
        everyone = [q for p in group for q in (p, *p.dups)]
        try:
            prepare = (self.engine.prepare_join if group[0].join
                       else self.engine.prepare)
            prepared = prepare((padded_b, d), serving=serving, ci=ci)
            results = prepared(self._mux(group, padded_b, d))
            # One synchronizing copy of the whole result dict; the
            # per-request demux below is numpy views.
            host = _pull_host(results)
        except Exception as exc:                  # deliver, don't swallow
            for p in everyone:
                p.future.set_exception(exc)
            self._finish(everyone, served=False)
            return
        dt_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self._dispatched_since_drain = True
            self._stats["dispatches"] += 1
            self._stats["coalesced_rows"] += rows
            self._stats["padded_rows"] += pad
            self._dispatch_ewma_ms = (
                dt_ms if self._dispatch_ewma_ms == 0.0
                else 0.7 * self._dispatch_ewma_ms + 0.3 * dt_ms)
        off = 0
        for p in group:
            p.future.set_result(_slice_results(host, off, p.rows))
            # Deduped duplicates demux the same row range; each gets its
            # own view dict, so tenants never share result objects.
            for q in p.dups:
                q.future.set_result(_slice_results(host, off, q.rows))
            off += p.rows
        self._finish(everyone, served=True)

    def _finish(self, group: list[_Pending], served: bool) -> None:
        now = time.perf_counter()
        with self._lock:
            for p in group:
                acct = self._account(p.tenant)
                acct.outstanding -= 1
                if served:
                    acct.queries += p.rows
                    acct.waits.append(now - p.t_submit)
                    self._stats["served"] += 1
                else:
                    self._stats["failed"] += 1

    def _primaries(self, group: list[_Pending]) -> list[_Pending]:
        """Cross-tenant dedup within one bucket: identical predicate
        batches dispatch once; later arrivals ride the first request's
        rows (each request's bounds read on the host once)."""
        primaries: list[_Pending] = []
        first: dict[tuple, _Pending] = {}
        for p in group:
            sig = (p.rows,
                   to_numpy(p.queries.lo).astype(np.float32).tobytes(),
                   to_numpy(p.queries.hi).astype(np.float32).tobytes())
            owner = first.get(sig)
            if owner is None:
                first[sig] = p
                primaries.append(p)
            else:
                owner.dups.append(p)
                with self._lock:
                    self._stats["dedup_hits"] += 1
        return primaries

    def tick(self) -> int:
        """One coalescing pass: drain on an epoch bump, bucket everything
        queued, dispatch each bucket's padded batches, demux. Returns the
        number of dispatches. Deterministic: buckets form in
        first-submission order and pack requests in arrival order, so a
        given submission sequence always yields the same batches."""
        inj = _faults.active()
        if inj is not None:
            delay = inj.tick_delay_s()
            if delay:
                time.sleep(delay)   # injected straggler tick
        with self._lock:
            batch, self._queue = self._queue, []
        if not batch:
            self._stats["ticks"] += 1
            return 0
        # Queries written on another thread's stream: this thread's stream
        # waits for them before anything reads them.
        for p in batch:
            if p.ready is not None:
                torch.cuda.current_stream(p.queries.lo.device).wait_event(
                    p.ready)
        # Deadline routing: a request whose remaining budget is unlikely to
        # survive a dispatch (EWMA prediction) gets the tier-0 answer now.
        now = time.perf_counter()
        ready = []
        for p in batch:
            if (p.t_deadline is not None
                    and (p.t_deadline - now) * 1e3 <= self._dispatch_ewma_ms):
                self._serve_tier0(p)
            else:
                ready.append(p)
        batch = ready
        if not batch:
            self._stats["ticks"] += 1
            return 0
        self._drain_on_epoch_bump()
        # Bucket by (padded shape class, d, serving config, ci config, join
        # flag); a request past the top class gets a rounded-up class of
        # its own.
        buckets: OrderedDict[tuple, list[_Pending]] = OrderedDict()
        for p in batch:
            padded_b = self.config.padded_size(p.rows)
            key = (padded_b, int(p.queries.lo.shape[1]),
                   p.serving.cache_key(),
                   p.ci.cache_key() if p.ci is not None else None, p.join)
            buckets.setdefault(key, []).append(p)
        n_dispatch = 0
        for (padded_b, _d, _sk, _ck, _jn), group in buckets.items():
            cur: list[_Pending] = []
            cur_rows = 0
            for p in self._primaries(group):   # greedy, never split one
                if cur and cur_rows + p.rows > padded_b:
                    self._dispatch(cur, padded_b, cur[0].serving, cur[0].ci)
                    n_dispatch += 1
                    cur, cur_rows = [], 0
                cur.append(p)
                cur_rows += p.rows
            if cur:
                self._dispatch(cur, padded_b, cur[0].serving, cur[0].ci)
                n_dispatch += 1
        self._stats["ticks"] += 1
        return n_dispatch

    def flush(self) -> int:
        """Tick until the queue is empty (shutdown / test convenience);
        returns the total dispatches."""
        total = 0
        while True:
            with self._lock:
                empty = not self._queue
            if empty:
                return total
            total += self.tick()

    def fail_pending(self, exc: BaseException) -> int:
        """Fail every queued future with ``exc`` and release their queue
        accounting; returns the number of requests failed. The driver's
        last-resort containment: no future is left unresolved by a tick
        that cannot run."""
        with self._lock:
            batch, self._queue = self._queue, []
            for p in batch:
                acct = self._account(p.tenant)
                acct.outstanding -= 1
                self._stats["failed"] += 1
        for p in batch:
            p.future.set_exception(exc)
        return len(batch)

    def _record_driver_error(self, exc: BaseException) -> None:
        """Surface an exception that escaped a driver tick: count it, pin
        its repr in ``stats()``, and fail whatever was queued so no
        submitter blocks forever on a dead tick."""
        with self._lock:
            self._stats["driver_errors"] += 1
            self._stats["last_driver_error"] = repr(exc)
        self.fail_pending(exc)

    # -- telemetry ---------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def stats(self) -> dict:
        """Coalescer snapshot: overall counters (submitted / served / shed,
        ``dispatches`` against ``coalesced_rows``, pad overhead, epoch
        drains, dedup hits, degraded serves, failures, driver errors) plus
        ``tenants``: per-tenant requests, queries served, shed count,
        outstanding, and queue-wait p50/p95 in ms over the last
        ``wait_window`` served requests."""
        with self._lock:
            out = dict(self._stats, queue_depth=len(self._queue))
            out["tenants"] = {t: a.snapshot()
                              for t, a in self._tenants.items()}
        return out


__all__ = ["RequestCoalescer", "Overloaded", "PAD_LO", "PAD_HI",
           "host_results"]
