"""Cross-cutting module-level helpers (counterpart of ``torchebm_tpu.core.module``)."""

from __future__ import annotations

import warnings
from typing import Set

__all__ = ["warn_once"]

_WARNED: Set[str] = set()


def warn_once(key: str, message: str, category=DeprecationWarning) -> None:
    """Emit ``message`` at most once per process for a given ``key``."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(message, category, stacklevel=3)
