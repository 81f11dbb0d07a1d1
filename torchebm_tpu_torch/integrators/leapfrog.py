r"""Symplectic leapfrog (Störmer–Verlet) integrators: separable and generalised.

Counterpart of :mod:`torchebm_tpu.integrators.leapfrog`.
:class:`LeapfrogIntegrator`'s ``integrate`` carries ``(x, p, force)``: the
force at the end of one step is the start force of the next, so an n-step
trajectory evaluates the force n + 1 times. The generalised (non-separable)
variant, for Riemannian HMC, solves its two implicit stages by Picard
iteration, with no host read.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, ClassVar, Optional

import torch

from .base import BaseSymplecticIntegrator, NormFn, State, _rms_norm

Tensor = torch.Tensor
DriftFn = Callable[[Tensor, Tensor], Tensor]
HamiltonField = Callable[[Tensor, Tensor, Tensor], Tensor]

__all__ = ["LeapfrogIntegrator", "GeneralisedLeapfrogIntegrator"]


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


@dataclass(frozen=True)
class GeneralisedLeapfrogIntegrator(BaseSymplecticIntegrator):
    r"""Generalised leapfrog for non-separable Hamiltonians (Girolami &
    Calderhead 2011). With ``velocity`` :math:`= \partial H/\partial p` and
    ``force`` :math:`= -\partial H/\partial x`:

    .. math::
        p_{1/2} &= p + \tfrac h2\, \text{force}(x, p_{1/2})
            \quad\text{(implicit)} \\
        x' &= x + \tfrac h2 \big[\text{velocity}(x, p_{1/2}) +
            \text{velocity}(x', p_{1/2})\big] \quad\text{(implicit)} \\
        p' &= p_{1/2} + \tfrac h2\, \text{force}(x', p_{1/2}).

    Both implicit stages are Picard-iterated: ``solver_max_iter`` updates, or
    with ``solver_check_every > 0`` until the RMS change over the whole batch
    (``norm=``'s, if given: one pooled over the shards of a sharded batch) is
    at most ``solver_tol``. That stop is kept on the device: every update
    runs, and the iterate is frozen once a flag says the loop has stopped,
    which gives the JAX ``while_loop``'s result without a host read.
    Registry names ``"generalised_leapfrog"`` and ``"generalized_leapfrog"``.
    """

    separable: ClassVar[bool] = False

    solver_max_iter: int = 8
    solver_tol: float = 1e-6
    solver_check_every: int = 0

    def __post_init__(self):
        if self.solver_max_iter < 1:
            raise ValueError("solver_max_iter must be >= 1")

    def _picard(self, init: Tensor, update: Callable[[Tensor], Tensor],
                norm: Optional[NormFn] = None) -> Tensor:
        y = update(init)
        if self.solver_check_every <= 0:
            for _ in range(self.solver_max_iter - 1):
                y = update(y)
            return y
        done = torch.zeros((), dtype=torch.bool, device=y.device)
        for _ in range(self.solver_max_iter - 1):
            y_next = update(y)
            resid = (norm or _rms_norm)(y_next - y)
            y = torch.where(done, y, y_next)
            # the loop goes on while resid > tol, so a NaN residual stops it
            done = done | ~(resid > self.solver_tol)
        return y

    def step(self, state: State, step_size, *, force: HamiltonField, velocity: HamiltonField,
             safe: bool = False, norm: Optional[NormFn] = None, **_) -> State:
        """One generalised leapfrog step; returns ``{"x", "p"}``. ``norm``: the
        Picard residual's (class docstring)."""
        x, p = state["x"], state["p"]
        # 0-d scalars left where they are: a CPU scalar enters CUDA ops as a
        # number, so a host step size is never copied to the device
        t = torch.zeros((), dtype=x.dtype)
        half_h = 0.5 * torch.as_tensor(step_size, dtype=x.dtype)

        def clamp(v):
            return self._safe_clamp(v) if safe else v

        # implicit momentum half-step: p½ = p + h/2 · force(x, p½)
        p_half = self._picard(p, lambda ph: p + half_h * clamp(force(x, ph, t)), norm)
        # implicit trapezoidal position step:
        # x' = x + h/2 · [velocity(x, p½) + velocity(x', p½)]
        v0 = clamp(velocity(x, p_half, t))
        x_new = self._picard(x, lambda xn: x + half_h * (v0 + clamp(velocity(xn, p_half, t))),
                             norm)
        # explicit momentum half-step
        p_new = p_half + half_h * clamp(force(x_new, p_half, t))
        if safe:
            c = self.SAFE_CLAMP
            x_new = torch.nan_to_num(x_new, nan=0.0, posinf=c, neginf=-c)
            p_new = torch.nan_to_num(p_new, nan=0.0, posinf=c, neginf=-c)
        return {"x": x_new, "p": p_new}

    def integrate(self, state: State, step_size, n_steps: int, *, force: HamiltonField,
                  velocity: HamiltonField, safe: bool = False, norm: Optional[NormFn] = None,
                  **_) -> State:
        """``n_steps`` generalised leapfrog steps."""
        if n_steps is None or n_steps <= 0:
            raise ValueError("n_steps must be positive")
        out = {"x": state["x"], "p": state["p"]}
        for _ in range(int(n_steps)):
            out = self.step(out, step_size, force=force, velocity=velocity, safe=safe, norm=norm)
        return out
