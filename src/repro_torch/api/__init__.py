"""The serving front door: ``PassEngine`` and its frozen configs."""
from .config import (ServingConfig, CIConfig, CoalescerConfig, CatalogConfig,
                     as_ci_config, merge_overrides)
from .engine import PassEngine, PreparedQuery

__all__ = ["PassEngine", "PreparedQuery", "ServingConfig", "CIConfig",
           "CoalescerConfig", "CatalogConfig", "as_ci_config",
           "merge_overrides"]
