r"""Sharded replay-buffer operations for multi-process PCD (counterpart of
:mod:`torchebm_tpu.parallel.buffer`).

Persistent-CD replay buffers split over the ``data`` axis need a periodic
global shuffle so that each process's chains mix over the whole buffer. The
buffer stays split on its rows; every ``shuffle_every`` training steps, call
:func:`shuffle_sharded`.

With a sharded buffer, ``ContrastiveDivergence`` reads and writes only the
local rows: its starts are drawn from the local rows, its negatives pushed
into the local ring, and the write pointer counts local rows (the same on
every process, since the shards are equal).
"""

from __future__ import annotations

import torch

from .mesh import batch_sharding, is_dtensor, like_rows, row_shard

__all__ = ["shuffle_sharded", "shard_replay_buffer"]


def shard_replay_buffer(buffer, mesh, axis: str = "data"):
    """The buffer's samples split on their rows over ``axis``; the pointer,
    a Python int, is the same on every process."""
    from torch.distributed.tensor import distribute_tensor

    from ..losses.contrastive_divergence import ReplayBuffer

    samples = buffer.samples
    return ReplayBuffer(
        samples=distribute_tensor(samples, mesh, batch_sharding(mesh, samples.ndim, axis)),
        ptr=buffer.ptr,
    )


def shuffle_sharded(generator: torch.Generator, buffer):
    """The buffer under one global permutation of its rows, drawn from
    ``generator``; the placement and the write pointer are kept (the ring is
    invariant under a permutation of its contents).

    Every process must hold a generator in the same state: each computes the
    same ``randperm``. A sharded buffer is gathered (O(buffer) memory on each
    process) and each process keeps its rows of the permuted whole."""
    from ..losses.contrastive_divergence import ReplayBuffer

    samples = buffer.samples
    perm = torch.randperm(samples.shape[0], generator=generator, device=generator.device)
    if not is_dtensor(samples):
        return ReplayBuffer(samples=samples[perm.to(samples.device)], ptr=buffer.ptr)
    local, start, _ = row_shard(samples)
    whole = samples.full_tensor()
    rows = whole[perm.to(whole.device)[start:start + local.shape[0]]]
    return ReplayBuffer(samples=like_rows(rows, samples), ptr=buffer.ptr)
