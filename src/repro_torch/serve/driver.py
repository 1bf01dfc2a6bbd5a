"""Event-loop drivers for the request coalescer (DESIGN.md §12); the port
of ``repro/serve/driver.py``.

Two ways to make ticks happen:

* :class:`TickDriver` — a pure-Python daemon thread calling
  ``coalescer.tick()`` every ``CoalescerConfig.tick_ms`` milliseconds.
  This is the production mode: tenants ``submit()`` from any thread and
  block on their futures; the driver amortizes everything queued within
  a tick window into per-bucket device dispatches. Use as a context
  manager so shutdown always flushes the queue (no stranded futures).

* Synchronous mode — no driver at all: the test/bench harness calls
  ``coalescer.tick()`` / ``flush()`` itself. Fully deterministic
  (bucketing depends only on submission order), which is what the
  bit-identity tests and the ``coalesced_serving_speedup_x`` bench
  need — timing jitter never changes which requests share a dispatch.

The tick thread serves on its own current CUDA stream (the default stream
unless it is given another); requests made on other streams are ordered
before their dispatch by the event each records at ``submit``.
"""
from __future__ import annotations

import threading

from .coalescer import RequestCoalescer


class TickDriver:
    """Background tick thread for a :class:`RequestCoalescer`.

        with TickDriver(coalescer):
            fut = coalescer.submit("tenant-a", queries)
            results = fut.result()

    ``stop()`` (or context exit) stops the loop and flushes whatever is
    still queued, so every submitted future resolves before the driver
    is gone. The thread is a daemon either way — a forgotten driver
    never blocks interpreter exit.
    """

    def __init__(self, coalescer: RequestCoalescer,
                 tick_ms: float | None = None):
        self.coalescer = coalescer
        self.tick_s = (coalescer.config.tick_ms
                       if tick_ms is None else float(tick_ms)) / 1e3
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "TickDriver":
        if self._thread is not None:
            raise RuntimeError("driver already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="repro-torch-serve-tick")
        self._thread.start()
        return self

    def _run(self) -> None:
        # An exception escaping tick() must not kill the loop silently
        # with futures still pending: record it, fail whatever is queued,
        # and keep ticking (the next tick may succeed — e.g. a transient
        # injected fault or a single poisoned bucket).
        while not self._stop.wait(self.tick_s):
            try:
                self.coalescer.tick()
            except Exception as exc:
                self.coalescer._record_driver_error(exc)

    def stop(self, flush: bool = True) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
        if flush:
            try:
                self.coalescer.flush()
            except Exception as exc:
                # Shutdown must resolve every future even when the flush
                # itself cannot serve them.
                self.coalescer._record_driver_error(exc)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def __enter__(self) -> "TickDriver":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = ["TickDriver"]
