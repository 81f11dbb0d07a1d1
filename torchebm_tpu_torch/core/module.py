"""Cross-cutting module-level helpers (counterpart of ``torchebm_tpu.core.module``)."""

from __future__ import annotations

import warnings
from typing import Set

import torch

__all__ = ["default_device", "warn_once"]

_WARNED: Set[str] = set()


def warn_once(key: str, message: str, category=DeprecationWarning) -> None:
    """Emit ``message`` at most once per process for a given ``key``."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(message, category, stacklevel=3)


def default_device() -> torch.device:
    """Where an entry point that is handed no tensor and no device puts its
    data: the current CUDA device when there is one, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")
