r"""Training utilities: EMA, parameter freezing, checkpoints (counterpart of
:mod:`torchebm_tpu.utils.training`).

- :func:`update_ema` blends an EMA copy of the parameters in place.
- :func:`freeze_mask` builds a per-name mask from a predicate and applies it
  as ``requires_grad`` (the JAX package feeds its mask to ``optax.masked``).
- Checkpoints are ``torch.save`` payloads in step-numbered directories,
  ``<ckpt_dir>/step_XXXXXXXX/state.pt``, the JAX package's names (it writes
  Orbax checkpoints there). They hold tensors, numbers, strings and
  containers only, so :func:`load_checkpoint` reads them with
  ``weights_only=True``. In a multi-process run rank 0 alone writes one.
- A payload that holds DTensors (a model sharded by FSDP2, a sharded replay
  buffer) is written to the same directory by
  ``torch.distributed.checkpoint``: every process writes its own shards, and
  :func:`load_checkpoint` reads them back in place into a ``template`` of
  the same structure, onto the template's placements.
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable, Dict, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..parallel.mesh import is_dtensor
from ..parallel.shim import get_rank, is_distributed

Tensor = torch.Tensor

__all__ = [
    "update_ema",
    "freeze_mask",
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint_step",
]

_FILE = "state.pt"


@torch.no_grad()
def update_ema(ema_params: Mapping[str, Tensor], params: Mapping[str, Tensor],
               decay: float = 0.9999) -> Mapping[str, Tensor]:
    r"""``ema = decay·ema + (1-decay)·params`` for every name, in place;
    returns ``ema_params``."""
    for name, e in ema_params.items():
        e.mul_(decay).add_(params[name].detach(), alpha=1.0 - decay)
    return ema_params


def freeze_mask(model: nn.Module, predicate: Callable[[str, Tensor], bool]) -> Dict[str, bool]:
    """``{name: trainable}`` over ``model``'s parameters from
    ``predicate(name, parameter)``, applied as each parameter's
    ``requires_grad`` (a frozen parameter gets no gradient, so optimisers
    skip it)."""
    mask = {}
    for name, p in model.named_parameters():
        mask[name] = bool(predicate(name, p))
        p.requires_grad_(mask[name])
    return mask


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{int(step):08d}")


def _holds_dtensor(tree: Any) -> bool:
    if isinstance(tree, dict):
        return any(_holds_dtensor(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_holds_dtensor(v) for v in tree)
    return is_dtensor(tree)


def save_checkpoint(ckpt_dir: str, step: int, params: Mapping[str, Tensor], *,
                    ema_params: Optional[Mapping[str, Tensor]] = None,
                    opt_state: Any = None, extra: Optional[Dict[str, Any]] = None) -> str:
    """Write a step-numbered checkpoint; returns its directory. ``extra``
    carries replay buffers, generator states and the like. A payload holding
    DTensors goes through ``torch.distributed.checkpoint`` (a call every
    process makes); any other is one file that rank 0 writes."""
    path = _step_dir(ckpt_dir, step)
    os.makedirs(path, exist_ok=True)
    payload = {"step": int(step), "params": dict(params)}
    if ema_params is not None:
        payload["ema_params"] = dict(ema_params)
    if opt_state is not None:
        payload["opt_state"] = opt_state
    if extra:
        payload["extra"] = extra
    if _holds_dtensor(payload):
        import torch.distributed.checkpoint as dcp

        dcp.save(payload, checkpoint_id=path)
        return path
    if get_rank() == 0:
        tmp = os.path.join(path, f"{_FILE}.{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, _FILE))
    if is_distributed():
        dist.barrier()
    return path


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", name))]
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None, *,
                    map_location: Any = None, template: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """The payload of a checkpoint (the latest step when ``step`` is None),
    its tensors on ``map_location`` (where they were saved by default).

    A checkpoint of ``torch.distributed.checkpoint`` needs ``template``, a
    payload of the saved structure (``{"step", "params", ...}``): its tensors
    are filled in place, each on its own placement and device, its other
    leaves replaced, and it is returned."""
    if step is None:
        step = latest_checkpoint_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"No checkpoints found under {ckpt_dir}")
    path = _step_dir(ckpt_dir, step)
    if os.path.exists(os.path.join(path, _FILE)):
        return torch.load(os.path.join(path, _FILE), map_location=map_location,
                          weights_only=True)
    if not os.path.exists(os.path.join(path, ".metadata")):
        raise FileNotFoundError(f"No checkpoint at {path}")
    if template is None:
        raise ValueError(f"{path} holds a sharded checkpoint: pass template=, a payload of its "
                         "structure on the placements to restore onto")
    import torch.distributed.checkpoint as dcp

    dcp.load(template, checkpoint_id=path)
    return template
