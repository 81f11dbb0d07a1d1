"""Input-pipeline utilities (counterpart of :mod:`torchebm_tpu.utils.data`).

- :func:`stack_batches` turns per-step batches into the stacked form that
  :meth:`~torchebm_tpu_torch.core.trainer.BaseTrainer.train_epoch_scanned`
  takes (a leading steps axis on every tensor).
- :func:`prefetch_to_device` keeps a bounded queue of batches in flight
  ahead of the consumer: copies from pinned host memory with
  ``non_blocking=True`` overlap the device's work; with ``sharding=(mesh,
  placements)`` each batch arrives as a DTensor laid out so.
"""

from __future__ import annotations

import collections
import itertools
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence, Tuple

import torch

from ..core.module import default_device

__all__ = ["stack_batches", "prefetch_to_device"]


def _structure(tree: Any):
    """The nesting of tuples, lists and dicts of ``tree``, tensors as leaves."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(v)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return "leaf"


def _map(fn: Callable, *trees: Any) -> Any:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def stack_batches(batches: Iterable[Any]) -> Any:
    """Stack batches of one structure (tensors, ``(data, cond_dict)`` tuples
    or ``{"data": ..., **cond}`` dicts) along a new leading steps axis.
    Raises on an empty iterable or on mismatched structures or shapes."""
    batches = list(batches)
    if not batches:
        raise ValueError("stack_batches needs at least one batch")
    structure = _structure(batches[0])
    for b in batches[1:]:
        if _structure(b) != structure:
            raise ValueError(
                f"All batches must share one structure; got {_structure(b)} vs {structure}")
    return _map(lambda *xs: torch.stack(xs), *batches)


def prefetch_to_device(batches: Iterable[Any], size: int = 2,
                       device: Optional[torch.device] = None,
                       sharding: Optional[Tuple[Any, Sequence[Any]]] = None) -> Iterator[Any]:
    """Yield ``batches`` moved to ``device`` (the current CUDA device when
    there is one, else the CPU), with up to ``size`` copies queued ahead of
    the consumer.

    ``sharding=(mesh, placements)`` (e.g. ``(mesh, batch_sharding(mesh,
    ndim))``) makes each tensor a DTensor on the mesh's device with those
    placements instead: every process passes the whole batch, rank 0's copy
    is distributed."""
    if size < 1:
        raise ValueError("size must be >= 1")
    if sharding is not None:
        mesh, placements = sharding
        device = torch.device(mesh.device_type)
    device = default_device() if device is None else torch.device(device)

    def put(b):
        def move(t):
            if not isinstance(t, torch.Tensor):
                return t
            if device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
            t = t.to(device, non_blocking=True)
            if sharding is None:
                return t
            from torch.distributed.tensor import distribute_tensor

            return distribute_tensor(t, mesh, placements)

        return _map(move, b)

    it = iter(batches)
    queue: collections.deque = collections.deque(put(b) for b in itertools.islice(it, size))
    while queue:
        nxt = next(it, _SENTINEL)
        if nxt is not _SENTINEL:
            queue.append(put(nxt))
        yield queue.popleft()


_SENTINEL = object()
