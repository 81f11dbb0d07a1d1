r"""Parallel-tempered Langevin dynamics (counterpart of
:mod:`torchebm_tpu.samplers.parallel_tempering`).

The replica ladder is one more batch axis, ``(R, B, *data_shape)``; replica
:math:`r` at inverse temperature :math:`\beta_r = 1/T_r` steps as

.. math::
    x_{t+1}^{(r)} = x_t^{(r)} - \eta\,\beta_r \nabla U(x_t^{(r)})
    + \text{noise\_scale}\cdot\sqrt{2\eta}\,\varepsilon_t ,

and every ``swap_every`` steps adjacent pairs exchange states with
probability :math:`\min(1, e^{(\beta_r - \beta_{r+1})(U_r - U_{r+1})})`,
independently per chain, in alternating even/odd phases (the single pair
every sweep for two replicas). ``sample()`` returns the cold
(``temperatures[0]``) chain.

Calls on a Gaussian mixture or a Gaussian (the Langevin ``mixture`` and
``gaussian`` dispatch rows) with a constant step and noise run the whole
ladder, exchanges included, as one CUDA kernel
(:mod:`torchebm_tpu_torch.ops.fused_pt`) when the generator lives on a CUDA
device (``fused="auto"``); ``fused="force"`` sends CPU calls to the kernels'
plain versions, ``fused="off"`` always takes the generic loop. Diagnostics,
schedules, conditioning, the double well and ladders of more than 32
replicas take the loop.

A batch sharded on its rows (``sample``), or a ladder sharded on its chain
axis (``run_replicas``), runs its chains with the kernel at their place in
the whole batch (``chain_offset`` and ``total_chains``) or the loop on the
whole batch's normals and exchange uniforms, and pools the swap acceptance
over every shard (:mod:`.base`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..core.energies import Energy
from ..core.schedulers import BaseScheduler, sched_value
from ..parallel.mesh import is_dtensor
from .base import (
    BaseSampler,
    _check_model_device,
    _concrete_scalar,
    _kernel_seed,
    _rand,
    _randn,
    _row_draws,
    _Rows,
    _same_device,
    _sample_impl,
)
from .langevin import FUSED_DISPATCH, _fused_gates_ok

Tensor = torch.Tensor

__all__ = ["ParallelTemperingLangevin"]


@dataclass(eq=False)
class ParallelTemperingLangevin(BaseSampler):
    """Replica-exchange Langevin over a static temperature ladder.

    ``temperatures`` is strictly increasing; ``temperatures[0]`` is the cold
    chain whose samples are returned. ``step_size`` and ``noise_scale`` are
    schedulable as in :class:`~.langevin.LangevinDynamics`; ``swap_every``
    is the number of Langevin steps between exchange sweeps; ``clamp`` bounds
    the state per step.
    """

    model: Energy
    temperatures: Tuple[float, ...] = (1.0, 1.6, 2.56, 4.1)
    step_size: Union[float, BaseScheduler] = 1e-2
    noise_scale: Union[float, BaseScheduler] = 1.0
    swap_every: int = 5
    clamp: Optional[Tuple[float, float]] = None
    fused: str = "auto"

    def __post_init__(self):
        temps = tuple(float(t) for t in self.temperatures)
        if len(temps) < 2:
            raise ValueError("temperatures needs >= 2 entries for replica exchange")
        if any(t <= 0 for t in temps):
            raise ValueError(f"temperatures must be positive, got {temps}")
        if any(b >= a for b, a in zip(temps, temps[1:])):
            raise ValueError(f"temperatures must be strictly increasing, got {temps}")
        if self.swap_every < 1:
            raise ValueError("swap_every must be >= 1")
        if self.clamp is not None and self.clamp[0] >= self.clamp[1]:
            raise ValueError(f"clamp min must be < max, got {self.clamp}")
        if self.fused not in ("auto", "off", "force"):
            raise ValueError(f"fused must be 'auto', 'off' or 'force', got {self.fused!r}")
        self.temperatures = temps

    @property
    def n_replicas(self) -> int:
        return len(self.temperatures)

    def _betas(self) -> Tuple[float, ...]:
        return tuple(1.0 / t for t in self.temperatures)

    def _flat(self, fn, replicas: Tensor) -> Tensor:
        """``fn`` over the ladder as one batch of ``R·B`` states, reshaped to
        ``(R, B, ...)``."""
        out = fn(replicas.reshape(-1, *replicas.shape[2:]))
        return out.reshape(replicas.shape[:2] + out.shape[1:])

    def _langevin_all(self, replicas: Tensor, i, generator, model_kwargs) -> Tensor:
        """One tempered Langevin step on every replica at once."""
        eta = sched_value(self.step_size, i)
        ns = sched_value(self.noise_scale, i)
        grad = self._flat(lambda x: self.gradient_of(x, model_kwargs, step=i), replicas)
        betas = torch.tensor(self._betas(), dtype=replicas.dtype, device=replicas.device)
        betas = betas.reshape((-1,) + (1,) * (replicas.ndim - 1))
        noise = _randn(generator, replicas.shape, device=replicas.device, dtype=replicas.dtype,
                       chain_dim=1)
        new = replicas - eta * betas * grad + ns * torch.sqrt(2.0 * eta) * noise
        if self.clamp is not None:
            new = torch.clamp(new, self.clamp[0], self.clamp[1])
        return new

    def _swap(self, replicas: Tensor, phase: int, generator, model_kwargs):
        """One sweep of adjacent-pair exchanges in ``phase`` (0: pairs 0–1,
        2–3, …; 1: pairs 1–2, 3–4, …). Returns ``(replicas, mean acceptance
        probability over the pairs tried)``; a uniform is drawn for every
        pair, tried or not."""
        energies = self._flat(lambda x: self.energy_of(x, model_kwargs), replicas)
        betas = self._betas()
        reps, es, accs = list(replicas), list(energies), []
        for r in range(self.n_replicas - 1):
            u = _rand(generator, es[r].shape, device=replicas.device, dtype=energies.dtype)
            if r % 2 != phase:
                continue
            delta = (betas[r] - betas[r + 1]) * (es[r] - es[r + 1])
            accept_prob = torch.clamp(torch.exp(torch.clamp(delta, -50.0, 50.0)), max=1.0)
            do = u < accept_prob
            mask = do.reshape(do.shape + (1,) * (replicas.ndim - 2))
            lo, hi = reps[r], reps[r + 1]
            reps[r], reps[r + 1] = torch.where(mask, hi, lo), torch.where(mask, lo, hi)
            # swapped states carry their energies along
            es[r], es[r + 1] = torch.where(do, es[r + 1], es[r]), torch.where(do, es[r], es[r + 1])
            accs.append(torch.mean(accept_prob))
        return torch.stack(reps), torch.mean(torch.stack(accs))

    # ---------------------------------------------------------------- hooks

    def init_carry(self, x0, generator, model_kwargs) -> Dict[str, Any]:
        replicas = x0[None].expand((self.n_replicas,) + tuple(x0.shape))
        return {"x": x0, "replicas": replicas,
                "swap_accept": torch.zeros((), dtype=torch.float32, device=x0.device)}

    def step(self, carry, i, generator, model_kwargs):
        replicas = self._langevin_all(carry["replicas"], i, generator, model_kwargs)
        acc = carry["swap_accept"]
        if i % self.swap_every == self.swap_every - 1:
            # with two replicas the single pair is tried every sweep
            phase = (i // self.swap_every) % 2 if self.n_replicas > 2 else 0
            replicas, acc = self._swap(replicas, phase, generator, model_kwargs)
        return {"x": replicas[0], "replicas": replicas, "swap_accept": acc}

    def extra_diagnostics(self, carry, model_kwargs):
        return {"swap_acceptance_rate": carry["swap_accept"]}

    # ------------------------------------------------------ fused fast path

    def _fused_row(self):
        """The Langevin ``gaussian`` or ``mixture`` dispatch row claiming the
        model, if any: the ladder kernel shares their evaluators, so the
        double well (another kernel family) stays on the loop."""
        for row in FUSED_DISPATCH:
            if row.chain != "mixture_langevin_chain":
                continue
            if type(self.model) is row.model_type and row.supports(self):
                return row
        return None

    def _dispatch_row(self, device: torch.device, return_diagnostics: bool, model_kwargs):
        """The gates and the row lookup in one pass (None = the loop): a CUDA
        generator (or ``fused="force"``), no diagnostics, no conditioning, a
        constant step size and noise scale, and at most 32 replicas."""
        from ..ops.fused_pt import MAX_REPLICAS

        if return_diagnostics or self.n_replicas > MAX_REPLICAS:
            return None
        if not _fused_gates_ok(self, device, model_kwargs, schedulables=()):
            return None
        if not (_concrete_scalar(self.step_size) and _concrete_scalar(self.noise_scale)):
            return None
        return self._fused_row()

    def _kernel_call(self, name: str, replicas: Tensor, kargs: dict, generator, n_steps, rows,
                     **kw):
        """Kernel ``name`` on the ladder ``replicas``; with ``rows`` (a shard
        of a ladder sharded on its chains) at the shard's place in the whole
        batch."""
        from ..ops import fused_pt

        if rows is not None:
            kw.update(chain_offset=rows.start, total_chains=rows.n_global)
        return getattr(fused_pt, name)(
            replicas.contiguous(), n_steps=int(n_steps), step_size=float(self.step_size),
            noise_scale=float(self.noise_scale), betas=self._betas(),
            swap_every=int(self.swap_every), seed=_kernel_seed(generator), clamp=self.clamp,
            **kargs, **kw,
        )

    def _run(self, generator, x0, n_steps, thin, return_trajectory, return_diagnostics,
             model_kwargs, rows=None):
        """Run the ladder and return the cold chain: the ladder kernel (its
        trajectory variant for ``return_trajectory``) where a row claims the
        call, the generic loop otherwise; ``rows``: a shard of a sharded batch
        (:mod:`.base`). The kernel's Philox seed is drawn from ``generator``
        after the initial state."""
        row = self._dispatch_row(generator.device, return_diagnostics, model_kwargs)
        if row is not None:
            kargs = row.kernel_kwargs(self, x0) if x0.dtype == torch.float32 else None
            if kargs is not None and (not return_trajectory or n_steps // thin >= 1):
                replicas = x0[None].expand((self.n_replicas,) + tuple(x0.shape))
                if return_trajectory:
                    traj, _, _ = self._kernel_call("pt_langevin_chain_trajectory", replicas,
                                                   kargs, generator, n_steps, rows,
                                                   thin=int(thin))
                    return traj.movedim(0, 1)
                return self._kernel_call("pt_langevin_chain", replicas, kargs, generator,
                                         n_steps, rows)[0][0]
            # unsupported state shape or dtype, or n_steps < thin: the loop takes the call
        return _sample_impl(self, x0, generator, n_steps, thin, return_trajectory,
                            return_diagnostics, model_kwargs, rows)

    # ------------------------------------------------------------- replicas

    @torch.no_grad()
    def run_replicas(self, generator: torch.Generator, replicas: Tensor, n_steps: int, *,
                     model_kwargs: Optional[Dict[str, Any]] = None) -> Tuple[Tensor, Tensor]:
        """Advance a whole ``(n_replicas, B, *data_shape)`` ladder ``n_steps``
        steps: the persistence entry point of tempered contrastive divergence.
        Returns ``(new_replicas, acceptance of the last sweep)``; the ladder
        kernel takes a float32 ``(R, B, d)`` ladder under the gates of
        :meth:`sample`. A ladder sharded on its chain axis (a DTensor split on
        dim 1; any other placement raises) gives a DTensor laid out alike with
        the unsharded call's values, and the acceptance over every shard's
        chains."""
        if not isinstance(generator, torch.Generator):
            raise TypeError(f"run_replicas needs a torch.Generator, got {type(generator).__name__}")
        rows = None
        if is_dtensor(replicas):
            rows = _Rows(replicas, dim=1)
            replicas = rows.local
        replicas = torch.as_tensor(replicas)
        if replicas.ndim < 2 or replicas.shape[0] != self.n_replicas:
            raise ValueError(
                f"replicas must be (n_replicas={self.n_replicas}, B, *data_shape); "
                f"got {tuple(replicas.shape)}"
            )
        if not _same_device(replicas.device, generator.device):
            raise ValueError(
                f"replicas is on {replicas.device} but the generator is on {generator.device}")
        _check_model_device(self.model, generator.device)
        ladder, acc = self._replicas(generator, replicas, n_steps, model_kwargs or {}, rows)
        if rows is None:
            return ladder, acc
        return rows.like_this(ladder), rows.pool(acc)

    def _replicas(self, generator, replicas: Tensor, n_steps: int, model_kwargs, rows):
        """:meth:`run_replicas` on a plain ladder (``rows``: its chains are a
        shard of a sharded ladder's): ``(ladder, this ladder's acceptance)``."""
        row = self._dispatch_row(generator.device, False, model_kwargs)
        if row is not None and replicas.ndim == 3 and replicas.dtype == torch.float32:
            kargs = row.kernel_kwargs(self, replicas[0])
            if kargs is not None:
                return self._kernel_call("pt_langevin_chain", replicas, kargs, generator,
                                         n_steps, rows)
        draws = _row_draws(generator, rows)
        carry = {"x": replicas[0], "replicas": replicas,
                 "swap_accept": torch.zeros((), dtype=torch.float32, device=replicas.device)}
        for i in range(int(n_steps)):
            carry = self.step(carry, i, draws, model_kwargs)
        return carry["replicas"], carry["swap_accept"]
