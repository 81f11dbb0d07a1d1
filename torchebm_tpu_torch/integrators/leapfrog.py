r"""Symplectic leapfrog (Störmer–Verlet) integrator for separable Hamiltonians.

Counterpart of :class:`torchebm_tpu.integrators.leapfrog.LeapfrogIntegrator`.
``integrate`` carries ``(x, p, force)``: the force at the end of one step is
the start force of the next, so an n-step trajectory evaluates the force
n + 1 times. The generalised (non-separable) variant comes with RMHMC.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, ClassVar, Optional

import torch

from .base import BaseSymplecticIntegrator, State

Tensor = torch.Tensor
DriftFn = Callable[[Tensor, Tensor], Tensor]

__all__ = ["LeapfrogIntegrator"]


@dataclass(frozen=True)
class LeapfrogIntegrator(BaseSymplecticIntegrator):
    r"""Separable-Hamiltonian Störmer–Verlet. One step with force
    :math:`F = -\nabla_x U` and (optional) mass :math:`M`:

    .. math::
        p_{1/2} = p + \tfrac h2 F(x), \qquad
        x' = x + h\, p_{1/2} / M, \qquad
        p' = p_{1/2} + \tfrac h2 F(x').

    Registry name ``"leapfrog"``.
    """

    separable: ClassVar[bool] = True

    def _apply_mass(self, p_half: Tensor, mass, x: Tensor) -> Tensor:
        if mass is None:
            return p_half
        return p_half / self._broadcast_mass(mass, x)

    def step(self, state: State, step_size, mass=None, *, drift: DriftFn, safe: bool = False,
             t=None, force: Optional[Tensor] = None, **_) -> State:
        """One leapfrog step; ``force`` may carry a pre-computed F(x) to reuse.
        Returns ``{"x", "p", "force"}`` (the force at the new position)."""
        x, p = state["x"], state["p"]
        t = torch.as_tensor(0.0 if t is None else t, dtype=x.dtype, device=x.device)
        h = torch.as_tensor(step_size, dtype=x.dtype, device=x.device)

        f = drift(x, t) if force is None else force
        if safe:
            f = self._safe_clamp(f)
        p_half = p + 0.5 * h * f
        x_new = x + h * self._apply_mass(p_half, mass, x)
        f_new = drift(x_new, t)
        if safe:
            f_new = self._safe_clamp(f_new)
        p_new = p_half + 0.5 * h * f_new
        if safe:
            c = self.SAFE_CLAMP
            x_new = torch.nan_to_num(x_new, nan=0.0, posinf=c, neginf=-c)
            p_new = torch.nan_to_num(p_new, nan=0.0, posinf=c, neginf=-c)
        # the caller's state dtype: an f32 force must not promote a bf16 carry
        return {"x": x_new.to(x.dtype), "p": p_new.to(p.dtype), "force": f_new}

    def integrate(self, state: State, step_size, n_steps: int, mass=None, *, drift: DriftFn,
                  safe: bool = False, **_) -> State:
        """An ``n_steps`` leapfrog trajectory with force reuse."""
        if n_steps is None or n_steps <= 0:
            raise ValueError("n_steps must be positive")
        x, p = state["x"], state["p"]
        f = drift(x, torch.zeros((), dtype=x.dtype, device=x.device))
        if safe:
            f = self._safe_clamp(f)
        for _ in range(int(n_steps)):
            out = self.step({"x": x, "p": p}, step_size, mass, drift=drift, safe=safe, force=f)
            x, p, f = out["x"], out["p"], out["force"]
        return {"x": x, "p": p}
