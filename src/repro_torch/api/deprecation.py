"""Warn-once deprecation plumbing for the legacy free-function API.

Every legacy entry point calls :func:`warn_once` with its dotted name and
the exact ``repro_torch.api.PassEngine`` replacement; the warning fires
on the FIRST call per entry point per process (not per call: a
steady-state serving loop through a shim must not spam stderr) and the
text always spells out the replacement, so the migration is
copy-pasteable.
"""
from __future__ import annotations

import warnings

_WARNED: set[str] = set()


def warn_once(entrypoint: str, replacement: str) -> None:
    """Emit one DeprecationWarning per ``entrypoint`` per process."""
    if entrypoint in _WARNED:
        return
    _WARNED.add(entrypoint)
    warnings.warn(
        f"{entrypoint} is deprecated; use {replacement} "
        "(see README 'Migrating to PassEngine')",
        DeprecationWarning, stacklevel=3)


def reset_deprecation_warnings() -> None:
    """Re-arm every entry point's warning (test hook)."""
    _WARNED.clear()


__all__ = ["warn_once", "reset_deprecation_warnings"]
