r"""Contrastive divergence (CD-k / PCD) with a replay buffer (counterpart of
:mod:`torchebm_tpu.losses.contrastive_divergence`).

Call convention, as in the JAX package::

    cd = ContrastiveDivergence(model=e, sampler=LangevinDynamics(e, ...), k_steps=10)
    loss, (negatives, new_buffer) = cd(None, x, generator, buffer)
    loss.backward()

``params=None`` uses the module's own parameters (see :mod:`.base`). For
standard CD pass ``buffer=None``: the chains start at the data. For PCD
(``persistent=True``) create the buffer once with :meth:`init_buffer` and
thread it through the calls. The negatives are drawn under
``torch.no_grad()`` and carry no graph (the CD estimator), so the chain can
take the neural kernel; the loss's gradient is autograd through the
energies of the data and of the negatives. :meth:`loss_and_energies` also
returns the mean energies the loss was made of, detached, for the trainer's
metrics.

A batch sharded on its rows (``x`` a DTensor, from
:func:`~torchebm_tpu_torch.parallel.shard_batch`) runs on each process's
rows: the chains start there and run on the unsharded call's streams
(the sampler takes the sharded starts; :class:`ParallelTemperingCD`'s ladder
is sharded on its chain axis for ``run_replicas``), the energies of the
local rows and negatives make the loss, and a sharded PCD buffer is read and written in its local rows only (the pointer
counts local rows). The loss's value and the logged energies are the whole
batch's (a sum all-reduce); its gradient is the local rows' mean scaled by
the shard's share, so that the mean over processes that FSDP2 takes, and the
trainer takes for the parameters FSDP2 leaves replicated, is the whole
batch's gradient.

One repair of the JAX package: :meth:`ContrastiveDivergence.init_buffer`
lets an exception of the warm-up sampler propagate, where the JAX package
catches every exception and keeps the chunk's noise. On the card that catch
would hide a kernel that fails to build or launch. The shape-mismatch
warning is kept.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.energies import Energy
from ..core.module import warn_once
from ..parallel.mesh import is_dtensor, like_rows, row_shard, row_shards, sum_over_rows
from ..samplers.base import BaseSampler
from .base import BaseLoss, inject_params

Tensor = torch.Tensor

__all__ = [
    "ReplayBuffer",
    "ContrastiveDivergence",
    "PersistentContrastiveDivergence",
    "ParallelTemperingCD",
]


@dataclass(eq=False)
class ReplayBuffer:
    """PCD replay buffer: a ring of samples and its write pointer."""

    samples: Tensor  # (buffer_size, *data_shape)
    ptr: int = 0

    @property
    def size(self) -> int:
        return self.samples.shape[0]

    def push(self, batch: Tensor) -> "ReplayBuffer":
        """FIFO ring write with wraparound. The samples are written in place
        (the ring is the size of a dataset; the JAX package copies it), and
        the returned buffer shares them with its pointer advanced."""
        n = batch.shape[0]
        idx = (self.ptr + torch.arange(n, device=self.samples.device)) % self.size
        self.samples[idx] = batch.detach().to(self.samples.dtype)
        return ReplayBuffer(samples=self.samples, ptr=(self.ptr + n) % self.size)


def _normal(g: torch.Generator, shape, dtype=torch.float32) -> Tensor:
    return torch.randn(tuple(shape), generator=g, device=g.device, dtype=dtype)


def _stratified_indices(g: torch.Generator, size: int, batch: int) -> Tensor:
    """One index per stratum of ``size // batch`` slots (uniform when the
    buffer is smaller than the batch)."""
    if size < batch:
        return torch.randint(0, size, (batch,), generator=g, device=g.device)
    stride = size // batch
    offset = torch.randint(0, stride, (batch,), generator=g, device=g.device)
    return (torch.arange(batch, device=g.device) * stride + offset) % size


def _cd_loss(model, x: Tensor, negatives: Tensor, generator, mk, add_noise_to_real: bool,
             noise_scale: float, energy_reg_weight: float,
             rows=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """``E[E(x)] - E[E(x⁻)]`` plus the energy-magnitude regulariser, with the
    non-finite guard (a non-finite loss reads 0.1); and the two means,
    detached, as ``{"pos_energy", "neg_energy"}``. ``rows=(start, n)``: ``x``
    holds rows ``[start, start + len(x))`` of a batch of ``n``, whose noise
    is drawn whole and cut to them."""
    if add_noise_to_real:
        start, n = (0, x.shape[0]) if rows is None else rows
        noise = _normal(generator, (n, *x.shape[1:]), x.dtype)[start:start + x.shape[0]]
        x_in = x + noise_scale * noise
    else:
        x_in = x
    x_energy = model.energy(x_in, **mk)
    neg_energy = model.energy(negatives, **mk)
    pos_mean, neg_mean = torch.mean(x_energy), torch.mean(neg_energy)
    loss = pos_mean - neg_mean
    if energy_reg_weight > 0:
        loss = loss + energy_reg_weight * (torch.mean(x_energy**2) + torch.mean(neg_energy**2))
    loss = torch.where(torch.isfinite(loss), loss, torch.full_like(loss, 0.1))
    return loss, {"pos_energy": pos_mean.detach(), "neg_energy": neg_mean.detach()}


@dataclass(eq=False)
class ContrastiveDivergence(BaseLoss):
    r"""CD-k / PCD loss: :math:`\mathbb E[E(x)] - \mathbb E[E(x^-)]` plus an
    optional energy-magnitude regulariser, with a non-finite guard."""

    model: Energy = None
    sampler: BaseSampler = None
    k_steps: int = 10
    persistent: bool = False
    buffer_size: int = 10_000
    init_steps: int = 100
    new_sample_ratio: float = 0.05
    energy_reg_weight: float = 0.001
    add_noise_to_real: bool = False
    noise_scale: float = 1e-4

    # ------------------------------------------------------------- buffer

    def init_buffer(self, generator: torch.Generator, data_shape: Tuple[int, ...],
                    chunk_size: int = 1024, init_noise_scale: float = 0.01,
                    params: Any = None) -> ReplayBuffer:
        """Noise-initialise the buffer on the generator's device, then warm it
        up with ``init_steps`` sampler steps, ``chunk_size`` chains at a time.

        A sampler error propagates (the JAX package keeps the chunk's noise);
        an output of the wrong shape keeps the noise with a warning."""
        if not self.persistent:
            raise ValueError("init_buffer is only meaningful for persistent=True")
        if self.buffer_size <= 0:
            raise ValueError(f"Replay buffer size must be positive, got {self.buffer_size}")
        samples = _normal(generator, (self.buffer_size, *data_shape)) * init_noise_scale
        if self.init_steps > 0:
            sampler = self.sampler.replace(model=inject_params(self.sampler.model, params))
            chunk = min(self.buffer_size, chunk_size)
            updated = []
            for i in range(0, self.buffer_size, chunk):
                noise_chunk = samples[i: i + chunk]
                out = sampler.sample(generator, x=noise_chunk, n_steps=self.init_steps)
                if out.shape != noise_chunk.shape:
                    warn_once(
                        "cd-init-buffer-shape",
                        "Sampler output shape mismatch during buffer init: expected "
                        f"{tuple(noise_chunk.shape)}, got {tuple(out.shape)}. Keeping noise "
                        f"for chunk {i}-{i + noise_chunk.shape[0]}.",
                        RuntimeWarning,
                    )
                    out = noise_chunk
                updated.append(out)
            samples = torch.cat(updated, dim=0)
        return ReplayBuffer(samples=samples, ptr=0)

    def get_negative_samples(self, generator: torch.Generator, batch_size: int,
                             data_shape: Tuple[int, ...],
                             buffer: Optional[ReplayBuffer] = None) -> Tensor:
        """Negatives drawn outside a loss call: ``N(0, I)`` noise for CD (or
        without a buffer); for PCD ``new_sample_ratio`` fresh noise rows and
        uniform draws from the buffer."""
        if not self.persistent or buffer is None:
            return _normal(generator, (batch_size, *data_shape))
        n_new = max(1, int(batch_size * self.new_sample_ratio))
        n_old = batch_size - n_new
        fresh = _normal(generator, (n_new, *data_shape))
        if n_old <= 0:
            return fresh
        indices = torch.randint(0, buffer.size, (n_old,), generator=generator,
                                device=generator.device)
        return torch.cat([fresh, buffer.samples[indices]], dim=0)

    def _start_points(self, x: Tensor, buffer: Optional[ReplayBuffer],
                      generator: torch.Generator) -> Tensor:
        """Data starts (CD) or stratified buffer draws with exploration noise on
        ``new_sample_ratio`` of them (PCD)."""
        if not self.persistent:
            return x.detach()
        if buffer is None:
            raise ValueError(
                "persistent=True requires a ReplayBuffer state; create one with "
                "cd.init_buffer(generator, data_shape) and thread it through calls."
            )
        batch = x.shape[0]
        starts = buffer.samples[_stratified_indices(generator, buffer.size, batch)]
        if self.new_sample_ratio > 0.0:
            n_new = max(1, int(batch * self.new_sample_ratio))
            noise_idx = torch.randperm(batch, generator=generator, device=generator.device)[:n_new]
            starts[noise_idx] += 0.01 * _normal(generator, (n_new, *x.shape[1:]), starts.dtype)
        return starts

    # --------------------------------------------------------------- call

    def __call__(self, params: Any, x: Tensor, generator: torch.Generator,
                 buffer: Optional[ReplayBuffer] = None, *,
                 model_kwargs: Optional[Dict[str, Any]] = None):
        """Returns ``(loss, (negatives, new_buffer))``; ``new_buffer`` is None
        for CD. The loss is differentiable with respect to the model's
        parameters; the negatives carry no graph."""
        return self.loss_and_energies(params, x, generator, buffer, model_kwargs=model_kwargs)[:2]

    def loss_and_energies(self, params: Any, x: Tensor, generator: torch.Generator,
                          buffer: Optional[ReplayBuffer] = None, *,
                          model_kwargs: Optional[Dict[str, Any]] = None):
        """:meth:`__call__`'s ``(loss, (negatives, new_buffer))`` and the mean
        energies of the data and of the negatives in the loss, detached:
        ``{"pos_energy", "neg_energy"}``."""
        mk = model_kwargs or {}
        model = self._model(params)
        sampler = self.sampler
        if params is not None:
            sampler = sampler.replace(model=inject_params(sampler.model, params))
        if is_dtensor(x):
            return self._sharded_loss(model, sampler, x, generator, buffer, mk)
        starts = self._start_points(x, buffer, generator)
        with torch.no_grad():
            negatives = sampler.sample(generator, x=starts, n_steps=self.k_steps,
                                       model_kwargs=mk)
        new_buffer = buffer.push(negatives) if (self.persistent and buffer is not None) else None
        loss, energies = _cd_loss(model, x, negatives, generator, mk, self.add_noise_to_real,
                                  self.noise_scale, self.energy_reg_weight)
        return loss, (negatives, new_buffer), energies

    def _sharded_loss(self, model, sampler, x, generator, buffer, mk):
        """:meth:`loss_and_energies` on a batch sharded on its rows (module
        docstring): the negatives a DTensor like ``x``, a sharded buffer
        written in its local rows."""
        x_local, start, n = row_shard(x)
        local_buffer = None
        if buffer is not None:
            samples = buffer.samples.to_local() if is_dtensor(buffer.samples) else buffer.samples
            local_buffer = ReplayBuffer(samples=samples, ptr=buffer.ptr)
        starts = self._start_points(x_local, local_buffer, generator)
        with torch.no_grad():
            negatives = sampler.sample(generator, x=like_rows(starts, x), n_steps=self.k_steps,
                                       model_kwargs=mk)
        neg_local = negatives.to_local()
        new_buffer = None
        if self.persistent and buffer is not None:
            # the local rows are the DTensor's own storage: the ring write lands in it
            new_buffer = ReplayBuffer(samples=buffer.samples, ptr=local_buffer.push(neg_local).ptr)
        loss, energies = _pooled_loss(
            *_cd_loss(model, x_local, neg_local, generator, mk, self.add_noise_to_real,
                      self.noise_scale, self.energy_reg_weight, rows=(start, n)), x)
        return loss, (negatives, new_buffer), energies


def _pooled_loss(loss: Tensor, energies: Dict[str, Tensor], x) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The loss and mean energies of a batch sharded on its rows (``x``, a
    DTensor) from those of this process's rows: the value is the mean over
    every row, and the gradient this process's share of it (the trainer sums
    the gradients over the shards)."""
    n = x.shape[0]
    b = x.to_local().shape[0]
    share = b * row_shards(x) / n
    whole = sum_over_rows(loss.detach() * b, x) / n
    loss = loss * share + (whole - loss.detach() * share)
    return loss, {k: sum_over_rows(v * b, x) / n for k, v in energies.items()}


def PersistentContrastiveDivergence(*args, **kwargs) -> ContrastiveDivergence:
    """PCD: ``ContrastiveDivergence(persistent=True)``."""
    kwargs.setdefault("persistent", True)
    return ContrastiveDivergence(*args, **kwargs)


@dataclass(eq=False)
class ParallelTemperingCD(BaseLoss):
    r"""CD with replica-exchange Langevin negatives: the cold chain of a
    :class:`~torchebm_tpu_torch.samplers.ParallelTemperingLangevin` ladder,
    advanced by its ``run_replicas``.

    With ``persistent=True`` the buffer keeps whole ladders,
    ``(buffer_size, n_replicas, *data_shape)``, so every temperature's chain
    persists across steps; CD starts every replica at the data.
    """

    model: Energy = None
    sampler: Any = None  # ParallelTemperingLangevin
    k_steps: int = 10
    persistent: bool = False
    buffer_size: int = 10_000
    init_steps: int = 100
    new_sample_ratio: float = 0.05
    energy_reg_weight: float = 0.001
    add_noise_to_real: bool = False
    noise_scale: float = 1e-4

    def __post_init__(self):
        from ..samplers.parallel_tempering import ParallelTemperingLangevin

        if self.sampler is not None and not isinstance(self.sampler, ParallelTemperingLangevin):
            raise TypeError(
                "ParallelTemperingCD needs a ParallelTemperingLangevin sampler; got "
                f"{type(self.sampler).__name__}. For single-temperature negatives use "
                "ContrastiveDivergence."
            )

    def init_buffer(self, generator: torch.Generator, data_shape: Tuple[int, ...],
                    chunk_size: int = 1024, init_noise_scale: float = 0.01,
                    params: Any = None) -> ReplayBuffer:
        """Noise-initialise a ``(buffer_size, n_replicas, *data_shape)`` ladder
        buffer, then warm it up with ``run_replicas``, chunk by chunk."""
        if not self.persistent:
            raise ValueError("init_buffer is only meaningful for persistent=True")
        if self.buffer_size <= 0:
            raise ValueError(f"Replay buffer size must be positive, got {self.buffer_size}")
        n_rep = self.sampler.n_replicas
        samples = _normal(generator, (self.buffer_size, n_rep, *data_shape)) * init_noise_scale
        if self.init_steps > 0:
            sampler = self.sampler.replace(model=inject_params(self.sampler.model, params))
            chunk = min(self.buffer_size, chunk_size)
            updated = []
            for i in range(0, self.buffer_size, chunk):
                ladder = samples[i: i + chunk].movedim(0, 1).contiguous()  # (R, b, *ds)
                ladder, _ = sampler.run_replicas(generator, ladder, self.init_steps)
                updated.append(ladder.movedim(0, 1))
            samples = torch.cat(updated, dim=0)
        return ReplayBuffer(samples=samples, ptr=0)

    def _start_ladder(self, x: Tensor, buffer: Optional[ReplayBuffer],
                      generator: torch.Generator) -> Tensor:
        """Start ladder ``(n_replicas, B, *data_shape)``: the data on every
        replica (CD) or stratified buffer draws with exploration noise (PCD)."""
        n_rep = self.sampler.n_replicas
        if not self.persistent:
            return x.detach()[None].expand((n_rep, *x.shape)).contiguous()
        if buffer is None:
            raise ValueError(
                "persistent=True requires a ReplayBuffer state; create one with "
                "ptcd.init_buffer(generator, data_shape) and thread it through calls."
            )
        batch = x.shape[0]
        idx = _stratified_indices(generator, buffer.size, batch)
        starts = buffer.samples[idx].movedim(0, 1).contiguous()  # (R, B, *ds)
        if self.new_sample_ratio > 0.0:
            n_new = max(1, int(batch * self.new_sample_ratio))
            noise_idx = torch.randperm(batch, generator=generator, device=generator.device)[:n_new]
            starts[:, noise_idx] += 0.01 * _normal(generator, (n_rep, n_new, *x.shape[1:]),
                                                   starts.dtype)
        return starts

    def __call__(self, params: Any, x: Tensor, generator: torch.Generator,
                 buffer: Optional[ReplayBuffer] = None, *,
                 model_kwargs: Optional[Dict[str, Any]] = None):
        """Returns ``(loss, (negatives, new_buffer))``: the negatives are the
        cold chain; ``new_buffer`` is None for CD."""
        return self.loss_and_energies(params, x, generator, buffer, model_kwargs=model_kwargs)[:2]

    def loss_and_energies(self, params: Any, x: Tensor, generator: torch.Generator,
                          buffer: Optional[ReplayBuffer] = None, *,
                          model_kwargs: Optional[Dict[str, Any]] = None):
        """:meth:`__call__`'s result and the loss's mean energies, detached,
        as :meth:`ContrastiveDivergence.loss_and_energies` gives them."""
        mk = model_kwargs or {}
        model = self._model(params)
        sampler = self.sampler
        if params is not None:
            sampler = sampler.replace(model=inject_params(sampler.model, params))
        if is_dtensor(x):
            return self._sharded_loss(model, sampler, x, generator, buffer, mk)
        starts = self._start_ladder(x, buffer, generator)
        with torch.no_grad():
            ladder, _ = sampler.run_replicas(generator, starts, self.k_steps, model_kwargs=mk)
        negatives = ladder[0]
        new_buffer = (buffer.push(ladder.movedim(0, 1))
                      if (self.persistent and buffer is not None) else None)
        loss, energies = _cd_loss(model, x, negatives, generator, mk, self.add_noise_to_real,
                                  self.noise_scale, self.energy_reg_weight)
        return loss, (negatives, new_buffer), energies

    def _sharded_loss(self, model, sampler, x, generator, buffer, mk):
        """:meth:`loss_and_energies` on a batch sharded on its rows, as
        :meth:`ContrastiveDivergence._sharded_loss` does it: the start ladder
        of the local rows sharded on its chain axis through ``run_replicas``,
        the negatives (the cold chain) a DTensor like ``x``, a sharded buffer
        written in its local rows."""
        x_local, start, n = row_shard(x)
        local_buffer = None
        if buffer is not None:
            samples = buffer.samples.to_local() if is_dtensor(buffer.samples) else buffer.samples
            local_buffer = ReplayBuffer(samples=samples, ptr=buffer.ptr)
        starts = self._start_ladder(x_local, local_buffer, generator)
        with torch.no_grad():
            ladder, _ = sampler.run_replicas(generator, like_rows(starts, x, dim=1),
                                             self.k_steps, model_kwargs=mk)
        ladder = ladder.to_local()
        neg_local = ladder[0]
        new_buffer = None
        if self.persistent and buffer is not None:
            # the local rows are the DTensor's own storage: the ring write lands in it
            new_buffer = ReplayBuffer(samples=buffer.samples,
                                      ptr=local_buffer.push(ladder.movedim(0, 1)).ptr)
        loss, energies = _pooled_loss(
            *_cd_loss(model, x_local, neg_local, generator, mk, self.add_noise_to_real,
                      self.noise_scale, self.energy_reg_weight, rows=(start, n)), x)
        return loss, (like_rows(neg_local, x), new_buffer), energies
