r"""Integrator contracts: explicit Runge-Kutta, additive-noise SDE and symplectic families.

PyTorch counterpart of the explicit part of :mod:`torchebm_tpu.integrators.base`.
Integrators are frozen, tensor-free dataclasses; the Butcher tableau is a
class-level tuple unrolled in Python. Noise comes from an explicit
``torch.Generator`` on the state's device, or is injected with ``noise=``.
The adaptive controller and the implicit (DIRK) stages come with the
integrators that need them.

State is a plain dict: ``{"x": position}`` (and ``"p"``, the momentum, for the
symplectic family).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, ClassVar, Dict, Optional, Tuple

import torch

Tensor = torch.Tensor
State = Dict[str, Tensor]
DriftFn = Callable[[Tensor, Tensor], Tensor]  # f(x, t) -> dx/dt

__all__ = [
    "BaseIntegrator",
    "BaseRungeKuttaIntegrator",
    "BaseSDERungeKuttaIntegrator",
    "BaseSymplecticIntegrator",
]


class BaseIntegrator:
    """Common integrator contract; ``family`` ("ode" | "sde" | "symplectic")
    is what :func:`~torchebm_tpu_torch.integrators.resolve_integrator` checks."""

    family: str = "ode"

    def step(self, state: State, step_size, **kwargs) -> State:
        raise NotImplementedError

    def integrate(self, state: State, step_size, n_steps: int, **kwargs) -> State:
        raise NotImplementedError


@dataclass(frozen=True)
class BaseRungeKuttaIntegrator(BaseIntegrator):
    """Explicit Butcher-tableau Runge-Kutta base.

    Subclasses define ``tableau_a`` (row ``i`` holds :math:`a_{i0..i-1}`),
    ``tableau_b`` (weights) and ``tableau_c`` (nodes).
    """

    tableau_a: ClassVar[Tuple[Tuple[float, ...], ...]] = ()
    tableau_b: ClassVar[Tuple[float, ...]] = ()
    tableau_c: ClassVar[Tuple[float, ...]] = ()

    @property
    def n_stages(self) -> int:
        return len(self.tableau_c)

    def _evaluate_stages(self, x: Tensor, t, h, drift: DriftFn) -> list:
        a, c = self.tableau_a, self.tableau_c
        ks: list = []
        for i in range(self.n_stages):
            x_stage = x
            row = a[i] if i < len(a) else ()
            if len(row) > i and row[i] != 0.0:
                raise NotImplementedError(
                    f"{type(self).__name__} has an implicit stage; only explicit "
                    "tableaus are ported"
                )
            for j in range(min(i, len(row))):
                if row[j] != 0.0:
                    x_stage = x_stage + (h * row[j]) * ks[j]
            ks.append(drift(x_stage, t + c[i] * h))
        return ks

    def _combine(self, x: Tensor, h, ks: list, weights: Tuple[float, ...]) -> Tensor:
        acc = None
        for w, k in zip(weights, ks):
            if w == 0.0:
                continue
            acc = (w * k) if acc is None else acc + w * k
        if acc is None:
            return x
        return x + h * acc

    def _deterministic_step(self, x: Tensor, h, drift: DriftFn, t) -> Tensor:
        return self._combine(x, h, self._evaluate_stages(x, t, h, drift), self.tableau_b)

    def step(self, state: State, step_size, *, drift: DriftFn, t=None, **_) -> State:
        """One deterministic RK step of size ``step_size``."""
        x = state["x"]
        t = torch.as_tensor(0.0 if t is None else t, dtype=x.dtype)
        h = torch.as_tensor(step_size, dtype=x.dtype)
        return {"x": self._deterministic_step(x, h, drift, t)}

    def _build_time_grid(self, x: Tensor, step_size, n_steps: Optional[int], t) -> Tensor:
        if t is None:
            if n_steps is None or n_steps <= 0:
                raise ValueError("n_steps must be positive")
            h = torch.as_tensor(step_size, dtype=x.dtype)
            return torch.arange(n_steps + 1, dtype=x.dtype) * h
        t = torch.as_tensor(t, dtype=x.dtype)
        if t.ndim != 1 or t.shape[0] < 2:
            raise ValueError("t must be a 1D array with length >= 2")
        return t

    def integrate(self, state: State, step_size, n_steps: Optional[int] = None, *,
                  drift: DriftFn, t: Optional[Tensor] = None, **_) -> State:
        """Fixed-grid ODE integration as a Python loop over the grid."""
        x = state["x"]
        grid = self._build_time_grid(x, step_size, n_steps, t)
        for i in range(grid.shape[0] - 1):
            x = self._deterministic_step(x, grid[i + 1] - grid[i], drift, grid[i])
        return {"x": x}


@dataclass(frozen=True)
class BaseSDERungeKuttaIntegrator(BaseRungeKuttaIntegrator):
    r"""RK deterministic update plus Euler-order additive noise:

    .. math:: x_{n+1} = \Big(x_n + h \sum_i b_i k_i\Big) + \sqrt{2 D h}\,\varepsilon

    ``diffusion`` is :math:`D`; when omitted the amplitude is
    ``noise_scale·√(2h)``, so Langevin's ``noise_scale`` multiplies
    :math:`\sqrt{2h}`.
    """

    family: ClassVar[str] = "sde"

    def step(self, state: State, step_size, *, drift: DriftFn,
             generator: Optional[torch.Generator] = None, noise_scale=1.0,
             diffusion=None, t=None, noise: Optional[Tensor] = None, **_) -> State:
        x = state["x"]
        t = torch.as_tensor(0.0 if t is None else t, dtype=x.dtype)
        h = torch.as_tensor(step_size, dtype=x.dtype)
        x_det = self._deterministic_step(x, h, drift, t)
        if noise is None:
            if generator is None:
                raise ValueError("SDE step requires a torch.Generator (or explicit `noise`).")
            noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        if diffusion is None:
            amp = torch.as_tensor(noise_scale, dtype=x.dtype) * torch.sqrt(2.0 * h)
        else:
            amp = torch.sqrt(2.0 * torch.as_tensor(diffusion, dtype=x.dtype) * h)
        return {"x": x_det + amp * noise}

    def integrate(self, state: State, step_size, n_steps: Optional[int] = None, *,
                  drift: DriftFn, generator: Optional[torch.Generator] = None,
                  noise_scale=1.0, diffusion=None, t: Optional[Tensor] = None,
                  **_) -> State:
        """Fixed-grid SDE integration, one generator draw per step."""
        x = state["x"]
        if generator is None:
            raise ValueError("SDE integrate requires a torch.Generator.")
        grid = self._build_time_grid(x, step_size, n_steps, t)
        for i in range(grid.shape[0] - 1):
            x = self.step(
                {"x": x}, grid[i + 1] - grid[i], drift=drift, generator=generator,
                noise_scale=noise_scale, diffusion=diffusion, t=grid[i],
            )["x"]
        return {"x": x}


@dataclass(frozen=True)
class BaseSymplecticIntegrator(BaseIntegrator):
    """Symplectic family base.

    ``separable`` subclasses take ``drift(x, t)`` (the force) and ``mass``.
    ``safe`` mode clamps forces to ±:attr:`SAFE_CLAMP` and replaces NaN and
    infinities, so a diverging trajectory is rejected by the Metropolis test
    instead of poisoning the chain.
    """

    family: ClassVar[str] = "symplectic"
    separable: ClassVar[bool] = True

    SAFE_CLAMP: ClassVar[float] = 1e6

    @staticmethod
    def _safe_clamp(v: Tensor) -> Tensor:
        c = BaseSymplecticIntegrator.SAFE_CLAMP
        return torch.nan_to_num(torch.clamp(v, -c, c), nan=0.0, posinf=c, neginf=-c)

    @staticmethod
    def _broadcast_mass(mass, x: Tensor) -> Tensor:
        """A scalar or per-dimension mass, floored at 1e-10, shaped to
        broadcast against ``x`` (its last axis)."""
        mass = torch.as_tensor(mass, dtype=x.dtype, device=x.device)
        if mass.ndim == 0:
            return torch.clamp(mass, min=1e-10)
        return torch.clamp(mass.reshape((1,) * (x.ndim - 1) + (-1,)), min=1e-10)
