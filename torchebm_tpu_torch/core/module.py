"""Cross-cutting module-level helpers (counterpart of ``torchebm_tpu.core.module``)."""

from __future__ import annotations

import warnings
import weakref
from typing import Any, Callable, Dict, Set, Tuple

import torch

__all__ = ["default_device", "warn_once"]

_WARNED: Set[str] = set()
#: ``(id(tensor), fn) -> (weak reference, (device, version), value)`` of tensor_memo
_MEMO: Dict[Tuple[int, Callable], Tuple[Any, Tuple[torch.device, int], Any]] = {}


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


def tensor_memo(t: torch.Tensor, fn: Callable[[torch.Tensor], Any]) -> Any:
    """``fn(t)``, computed once per state of ``t``: the entry is keyed by the
    tensor's identity, its device and its version counter, so an in-place
    edit or a ``.to()`` (a new tensor) computes it anew. Gates that read a
    parameter on the host (a ``.cpu()``, a ``float()``) keep the device
    waiting once, not on every call. A tensor without a version counter
    (made under ``torch.inference_mode``) is not cached."""
    if t.is_inference():
        return fn(t)
    key = (id(t), fn)
    state = (t.device, t._version)
    hit = _MEMO.get(key)
    if hit is not None and hit[0]() is t and hit[1] == state:
        return hit[2]
    value = fn(t)
    _MEMO[key] = (weakref.ref(t, lambda _, key=key: _MEMO.pop(key, None)), state, value)
    return value
