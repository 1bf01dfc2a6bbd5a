"""Serving around ``PassEngine.answer`` (DESIGN.md §12, §15); the port of
``repro/serve``.

Many concurrent tenants, small ragged query batches, one
:class:`~repro_torch.api.PassEngine`::

    from repro_torch.api import PassEngine, ServingConfig, CoalescerConfig
    from repro_torch.serve import RequestCoalescer, TickDriver, Overloaded

    eng = PassEngine(syn, serving=ServingConfig(kinds=("sum", "avg")))
    co = RequestCoalescer(eng, CoalescerConfig(shape_classes=(8, 32, 128)))
    with TickDriver(co):
        fut = co.submit("tenant-a", queries)     # Future per request
        results = fut.result()                   # {kind: QueryResult}

Requests bucket into padded shape classes, batch across tenants into one
engine call per bucket per tick, and demux back to per-tenant futures, bit
for bit the per-tenant ``engine.answer``. Admission control sheds overload
with the typed :class:`Overloaded` error.

Deadline-aware serving lives here too: the degradation ladder
(:class:`RefinementHandle`, ``engine.answer(deadline_ms=...)``,
``submit(..., deadline_ms=...)``) and epoch-consistent checkpoint/restore
(``engine.checkpoint()`` / ``PassEngine.restore()``).
"""
from .coalescer import RequestCoalescer, Overloaded, PAD_LO, PAD_HI
from .driver import TickDriver
from .refine import RefinementHandle, tier0_answer, ladder_tiers
from .checkpoint import save_engine, load_engine, CHECKPOINT_VERSION
from ..api.config import CoalescerConfig

__all__ = ["RequestCoalescer", "TickDriver", "Overloaded",
           "CoalescerConfig", "PAD_LO", "PAD_HI",
           "RefinementHandle", "tier0_answer", "ladder_tiers",
           "save_engine", "load_engine", "CHECKPOINT_VERSION"]
