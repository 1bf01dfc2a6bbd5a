"""The serving front door: ``PassEngine`` and its frozen configs.

Everything else (``engine.answer``, ``core.query.answer``,
``core.estimators.estimate``, ``uncertainty.answer_with_ci`` /
``poisson_bootstrap``) is a deprecated shim over ``PassEngine``; each
warns once (:func:`warn_once`) with its replacement.
"""
from .config import (ServingConfig, CIConfig, CoalescerConfig, CatalogConfig,
                     as_ci_config, merge_overrides)
from .engine import PassEngine, PreparedQuery
from .deprecation import warn_once, reset_deprecation_warnings

__all__ = ["PassEngine", "PreparedQuery", "ServingConfig", "CIConfig",
           "CoalescerConfig", "CatalogConfig", "as_ci_config",
           "merge_overrides", "warn_once", "reset_deprecation_warnings"]
