"""Deterministic fault-injection harness for the serving stack
(DESIGN.md §15)::

    from repro_torch.testing import FaultPlan, inject

    with inject(FaultPlan(seed=7, poison_every=3, straggler_every=5)):
        ...   # ingest / coalescer traffic now sees injected faults

Seed-keyed and counter-driven: a fixed plan over a fixed call sequence
injects the same faults every run, and the same ones as the JAX package's
harness.
"""
from .faults import (FaultPlan, FaultInjector, InjectedFault, active,
                     inject, install, uninstall)

__all__ = ["FaultPlan", "FaultInjector", "InjectedFault", "active",
           "inject", "install", "uninstall"]
