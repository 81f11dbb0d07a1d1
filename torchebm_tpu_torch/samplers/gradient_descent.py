r"""Deterministic mode-seeking samplers: gradient descent and Nesterov.

Counterpart of :mod:`torchebm_tpu.samplers.gradient_descent`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch

from ..core.energies import Energy
from ..core.schedulers import BaseScheduler, sched_value
from .base import BaseSampler, _sample_impl

Tensor = torch.Tensor

__all__ = ["GradientDescentSampler", "NesterovSampler"]


@dataclass(eq=False)
class GradientDescentSampler(BaseSampler):
    r"""Deterministic energy minimisation :math:`x_{k+1} = x_k - \eta \nabla E(x_k)`.

    Descent is the whole-chain Langevin kernel at ``noise_scale = 0`` (the
    ``+ 0·ε`` term is an exact no-op), so calls on the analytic targets that a
    :data:`~torchebm_tpu_torch.samplers.langevin.FUSED_DISPATCH` row claims
    take the same kernels as
    :class:`~torchebm_tpu_torch.samplers.langevin.LangevinDynamics`, with the
    same ``fused`` contract ("auto" on a CUDA generator, "force" on any,
    "off" never); the result does not depend on the seed.
    """

    model: Energy
    step_size: Union[float, BaseScheduler] = 1e-3
    fused: str = "auto"

    def __post_init__(self):
        if self.fused not in ("auto", "off", "force"):
            raise ValueError(f"fused must be 'auto', 'off' or 'force', got {self.fused!r}")

    def step(self, carry, i, generator, model_kwargs):
        eta = sched_value(self.step_size, i)
        x = carry["x"]
        return {"x": x - eta * self.gradient_of(x, model_kwargs, step=i)}

    def _run(self, generator, x0, n_steps, thin, return_trajectory, return_diagnostics,
             model_kwargs, rows=None):
        """Run the descent: a Langevin dispatch row's kernel at noise 0 where
        one claims the call, the generic loop otherwise; a sharded batch
        (:mod:`.base`) runs its rows and pools the diagnostics."""
        from .langevin import _call_fused_row, _claiming_row, _fused_gates_ok, _sched_table_arg

        row = None
        if _fused_gates_ok(self, generator.device, model_kwargs, schedulables=(self.step_size,)):
            row = _claiming_row(self)
        if row is not None:
            kargs = row.kernel_kwargs(self, x0) if x0.dtype == torch.float32 else None
            if kargs is not None and (
                not (return_trajectory or return_diagnostics) or n_steps // thin >= 1
            ):
                return _call_fused_row(
                    row, x0.contiguous(), self.model,
                    n_steps=n_steps, thin=thin,
                    return_trajectory=return_trajectory,
                    return_diagnostics=return_diagnostics,
                    kargs=kargs,
                    step_size=_sched_table_arg(self.step_size, n_steps, x0.device),
                    noise_scale=0.0,
                    seed=0,
                    clamp=None,
                    rows=rows,
                )
            # unsupported state shape or dtype, or n_steps < thin: the loop takes the call
        return _sample_impl(self, x0, generator, n_steps, thin, return_trajectory,
                            return_diagnostics, model_kwargs, rows)


@dataclass(eq=False)
class NesterovSampler(BaseSampler):
    r"""Nesterov accelerated gradient descent (generic loop only).

    .. math::
        v_{k+1} = \mu v_k - \eta \nabla E(x_k + \mu v_k), \qquad
        x_{k+1} = x_k + v_{k+1}
    """

    model: Energy
    step_size: Union[float, BaseScheduler] = 1e-3
    momentum: float = 0.9

    def __post_init__(self):
        if not 0 <= self.momentum < 1:
            raise ValueError("momentum must be in [0, 1)")

    def init_carry(self, x0, generator, model_kwargs):
        return {"x": x0, "v": torch.zeros_like(x0)}

    def step(self, carry, i, generator, model_kwargs):
        eta = sched_value(self.step_size, i)
        x, v = carry["x"], carry["v"]
        grad = self.gradient_of(x + self.momentum * v, model_kwargs, step=i)
        v = self.momentum * v - eta * grad
        return {"x": x + v, "v": v}
