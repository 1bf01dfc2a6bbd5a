"""Calibrated confidence intervals composed from the shared artifacts
(``intervals``, the stratified CLT) and the key-threaded Poisson bootstrap
that cross-checks them (``bootstrap``). ``answer_with_ci`` /
``poisson_bootstrap`` are deprecated shims over ``PassEngine``."""
from .intervals import (normal_quantile, compose_interval,
                        compose_two_stage, answer_with_ci)
from .bootstrap import poisson_bootstrap, bootstrap_replicates, BOOT_KINDS

__all__ = ["normal_quantile", "compose_interval", "compose_two_stage",
           "answer_with_ci", "poisson_bootstrap", "bootstrap_replicates",
           "BOOT_KINDS"]
