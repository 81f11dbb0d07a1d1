r"""Metropolis-adjusted Langevin algorithm (counterpart of :mod:`torchebm_tpu.samplers.mala`).

One transition from :math:`x`:

.. math::
    y &= x - \eta\,\nabla U(x) + \sqrt{2\eta}\,\varepsilon \\
    \log q(b\mid a) &= -\lVert b - a + \eta \nabla U(a)\rVert^2 / (4\eta) \\
    \alpha &= \min\!\big(1,\ e^{\,U(x)-U(y)+\log q(x\mid y)-\log q(y\mid x)}\big)

Energies are clamped to ±1e10 and the log-ratio to ±50, as in the HMC
sampler. Calls on a Gaussian mixture or a full-covariance Gaussian run as one
whole-chain CUDA kernel (:mod:`torchebm_tpu_torch.ops.fused_mala`) when the
generator lives on a CUDA device (``fused="auto"``); ``fused="force"`` sends
CPU calls to the kernels' plain versions, ``fused="off"`` always takes the
generic loop. A sharded batch (:mod:`.base`) runs the kernel at its
``chain_offset`` or the loop on the whole batch's draws, and pools
``acceptance_rate`` over every shard.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple, Union

import torch

from ..core.energies import Energy
from ..core.schedulers import BaseScheduler, sched_value
from .base import BaseSampler, _kernel_seed, _metropolis_target, _rand, _randn, _sample_impl

Tensor = torch.Tensor

__all__ = ["MetropolisAdjustedLangevin"]


@dataclass(eq=False)
class MetropolisAdjustedLangevin(BaseSampler):
    """MALA sampler: Langevin proposal and exact Metropolis–Hastings correction.

    ``step_size`` is schedulable. Diagnostics add ``acceptance_rate`` to the
    standard ``mean``/``var``/``energy`` keys. A practical tuning target is an
    acceptance rate near 0.574 (Roberts & Rosenthal optimal scaling).
    """

    model: Energy
    step_size: Union[float, BaseScheduler] = 1e-2
    fused: str = "auto"

    def __post_init__(self):
        if self.fused not in ("auto", "off", "force"):
            raise ValueError(f"fused must be 'auto', 'off' or 'force', got {self.fused!r}")

    def _log_q(self, b: Tensor, a: Tensor, grad_a: Tensor, eta) -> Tensor:
        diff = b - a + eta * grad_a
        sq = torch.sum(torch.square(diff).reshape(diff.shape[0], -1), dim=-1)
        return -sq / (4.0 * eta)

    def _transition(self, x: Tensor, generator: torch.Generator, eta,
                    model_kwargs) -> Tuple[Tensor, Tensor]:
        """One MH proposal; returns ``(new_x, mean acceptance probability)``."""
        grad_x = self.gradient_of(x, model_kwargs)
        eps = _randn(generator, x.shape, device=x.device, dtype=x.dtype)
        y = x - eta * grad_x + torch.sqrt(2.0 * eta) * eps
        grad_y = self.gradient_of(y, model_kwargs)
        u_x = torch.clamp(self.energy_of(x, model_kwargs), -1e10, 1e10)
        u_y = torch.clamp(self.energy_of(y, model_kwargs), -1e10, 1e10)
        log_ratio = u_x - u_y + self._log_q(x, y, grad_y, eta) - self._log_q(y, x, grad_x, eta)
        accept_prob = torch.clamp(torch.exp(torch.clamp(log_ratio, -50.0, 50.0)), max=1.0)
        u = _rand(generator, accept_prob.shape, device=x.device, dtype=accept_prob.dtype)
        mask = (u < accept_prob).reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.where(mask, y, x), torch.mean(accept_prob)

    # ---------------------------------------------------------------- hooks

    def init_carry(self, x0, generator, model_kwargs) -> Dict[str, Any]:
        return {"x": x0, "accept_rate": torch.zeros((), device=x0.device)}

    def step(self, carry, i, generator, model_kwargs):
        x_new, acc = self._transition(carry["x"], generator, sched_value(self.step_size, i),
                                      model_kwargs)
        return {"x": x_new, "accept_rate": acc}

    def extra_diagnostics(self, carry, model_kwargs):
        return {"acceptance_rate": carry["accept_rate"]}

    # -------------------------------------------------------- fused fast path

    def _run(self, generator, x0, n_steps, thin, return_trajectory, return_diagnostics,
             model_kwargs, rows=None):
        """Run the chain: the whole-chain kernel where :func:`_metropolis_target`
        claims the call (at the shard's ``chain_offset`` for ``rows``), the
        generic loop otherwise. The kernel's Philox seed is drawn from
        ``generator`` after the initial state."""
        target = _metropolis_target(self, generator.device, return_diagnostics, model_kwargs)
        if target is not None:
            means, target_kw = target
            if (x0.dtype == torch.float32 and x0.ndim == 2 and x0.shape[-1] == means.shape[-1]
                    and (not return_trajectory or n_steps // thin >= 1)):
                from ..ops import fused_mala as ops

                kw = dict(seed=_kernel_seed(generator), **target_kw)
                if rows is not None:
                    kw["chain_offset"] = rows.start
                if return_trajectory:
                    traj, _, _ = ops.mixture_mala_chain_trajectory(
                        x0.contiguous(), means, n_steps, float(self.step_size), thin=thin, **kw
                    )
                    return traj.movedim(0, 1)
                return ops.mixture_mala_chain(
                    x0.contiguous(), means, n_steps, float(self.step_size), **kw
                )[0]
            # unsupported state shape or dtype, or n_steps < thin: the loop takes the call
        return _sample_impl(self, x0, generator, n_steps, thin, return_trajectory,
                            return_diagnostics, model_kwargs, rows)
