"""Calibrated confidence intervals composed from the shared artifacts
(``intervals``, the stratified CLT) and the key-threaded Poisson bootstrap
that cross-checks them (``bootstrap``)."""
from .bootstrap import BOOT_KINDS, bootstrap_replicates

__all__ = ["BOOT_KINDS", "bootstrap_replicates"]
