r"""Integrator contracts: explicit and DIRK Runge-Kutta, additive-noise SDE and symplectic families.

PyTorch counterpart of :mod:`torchebm_tpu.integrators.base`. Integrators are
frozen, tensor-free dataclasses; the Butcher tableau is a class-level tuple
unrolled in Python. Noise comes from an explicit ``torch.Generator`` on the
state's device, or is injected with ``noise=``.

Fixed-grid integration is a Python loop over the grid. The embedded-pair
adaptive controller keeps its state on the device and reads "time left and
steps left" on the host before every attempted step (one device sync each,
where the JAX package runs a ``while_loop`` on the device); accept or reject
is a ``torch.where``. A DIRK stage is solved by Picard iteration: a fixed
count of drift calls by default, or with ``solver_check_every > 0`` until the
RMS residual drops below ``solver_tol`` (one sync per check).

The controller's error norm and the Picard residual are the RMS of a
tensor's entries, or what ``norm=`` returns for it. A state that holds one
process's rows of a batch sharded on dim 0 takes a ``norm`` that pools the
sum of squares over every shard, so that every process takes the same accept
or reject, step size and stop, as the unsharded call does.

State is a plain dict: ``{"x": position}`` (and ``"p"``, the momentum, for the
symplectic family).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, ClassVar, Dict, Optional, Tuple, Union

import torch

Tensor = torch.Tensor
State = Dict[str, Tensor]
DriftFn = Callable[[Tensor, Tensor], Tensor]  # f(x, t) -> dx/dt
NormFn = Callable[[Tensor], Tensor]  # the RMS of a tensor's entries (module docstring)

__all__ = [
    "BaseIntegrator",
    "BaseRungeKuttaIntegrator",
    "BaseSDERungeKuttaIntegrator",
    "BaseSymplecticIntegrator",
    "AdaptiveStats",
]


def _rms_norm(x: Tensor) -> Tensor:
    return torch.sqrt(torch.mean(torch.square(x)))


@dataclass(eq=False)
class AdaptiveStats:
    """Counters of an adaptive integration, 0-d tensors on the state's device."""

    n_accepted: Tensor
    n_attempted: Tensor
    final_h: Tensor
    exhausted: Tensor  # True if max_steps was hit before t_end


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
    r"""Butcher-tableau Runge-Kutta base.

    Subclasses define class attributes:

    - ``tableau_a``: row ``i`` holds :math:`a_{i0..}` (explicit rows have
      length ``i``; DIRK rows length ``i+1``: a non-zero diagonal entry marks
      the stage implicit and triggers a Picard solve).
    - ``tableau_b`` / ``tableau_c``: weights and nodes.
    - ``error_weights`` (optional): :math:`e_i = b_i - \hat b_i` of the
      embedded pair (``n_stages + 1`` entries for FSAL methods).
    - ``order`` (optional): order ``p`` of the higher-order solution, the
      controller's exponent is ``-1/p``.
    - ``fsal``: First-Same-As-Last stage reuse.
    """

    # adaptive controller
    atol: float = 1e-6
    rtol: float = 1e-5
    max_steps: int = 10_000
    safety: float = 0.9
    min_factor: float = 0.2
    max_factor: float = 10.0
    max_step_size: float = float("inf")
    # implicit (DIRK) Picard solver
    solver_max_iter: int = 8
    solver_tol: float = 1e-6
    solver_check_every: int = 0

    tableau_a: ClassVar[Tuple[Tuple[float, ...], ...]] = ()
    tableau_b: ClassVar[Tuple[float, ...]] = ()
    tableau_c: ClassVar[Tuple[float, ...]] = ()
    error_weights: ClassVar[Optional[Tuple[float, ...]]] = None
    order: ClassVar[Optional[int]] = None
    fsal: ClassVar[bool] = False

    @property
    def n_stages(self) -> int:
        return len(self.tableau_c)

    def _solve_implicit_stage(self, base: Tensor, t, h, a_ii: float, drift: DriftFn,
                              norm: Optional[NormFn] = None) -> Tensor:
        r"""Solve :math:`k = f(\text{base} + h a_{ii} k, t)` by Picard iteration:
        ``solver_max_iter`` drift calls in all, or fewer once the RMS change
        of ``k`` (``norm``'s, if given) is at most ``solver_tol``
        (``solver_check_every > 0``)."""
        coef = h * a_ii
        k = drift(base, t)
        for _ in range(self.solver_max_iter - 1):
            k_next = drift(base + coef * k, t)
            if self.solver_check_every > 0:
                resid = float((norm or _rms_norm)(k_next - k))
                k = k_next
                if not resid > self.solver_tol:
                    break
            else:
                k = k_next
        return k

    def _evaluate_stages(self, x: Tensor, t, h, drift: DriftFn,
                         k0: Optional[Tensor] = None, norm: Optional[NormFn] = None) -> list:
        """All stages, a list of ``s`` tensors; ``k0`` replaces the first (FSAL)."""
        a, c = self.tableau_a, self.tableau_c
        ks: list = []
        for i in range(self.n_stages):
            if i == 0 and k0 is not None:
                ks.append(k0)
                continue
            x_stage = x
            row = a[i] if i < len(a) else ()
            for j in range(min(i, len(row))):
                if row[j] != 0.0:
                    x_stage = x_stage + (h * row[j]) * ks[j]
            t_stage = t + c[i] * h
            if len(row) > i and row[i] != 0.0:  # DIRK diagonal entry
                ks.append(self._solve_implicit_stage(x_stage, t_stage, h, row[i], drift, norm))
            else:
                ks.append(drift(x_stage, t_stage))
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

    def _deterministic_step(self, x: Tensor, h, drift: DriftFn, t,
                            norm: Optional[NormFn] = None) -> Tensor:
        return self._combine(x, h, self._evaluate_stages(x, t, h, drift, norm=norm),
                             self.tableau_b)

    def step(self, state: State, step_size, *, drift: DriftFn, t=None,
             norm: Optional[NormFn] = None, **_) -> State:
        """One deterministic RK step of size ``step_size``; ``norm`` as in
        the module docstring."""
        x = state["x"]
        t = torch.as_tensor(0.0 if t is None else t, dtype=x.dtype)
        h = torch.as_tensor(step_size, dtype=x.dtype)
        return {"x": self._deterministic_step(x, h, drift, t, norm)}

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
                  drift: DriftFn, t: Optional[Tensor] = None, adaptive: Optional[bool] = None,
                  return_stats: bool = False, norm: Optional[NormFn] = None,
                  **_) -> Union[State, Tuple[State, AdaptiveStats]]:
        """Integrate an ODE over a time grid.

        Fixed mode is a Python loop over the grid; adaptive mode (the default
        when the method defines an embedded pair) runs the step-size
        controller from ``t[0]`` to ``t[-1]``. ``norm``: the error norm
        (module docstring).
        """
        if adaptive is None:
            adaptive = self.error_weights is not None
        x = state["x"]
        if not adaptive:
            grid = self._build_time_grid(x, step_size, n_steps, t)
            for i in range(grid.shape[0] - 1):
                x = self._deterministic_step(x, grid[i + 1] - grid[i], drift, grid[i], norm)
            return {"x": x}

        if self.error_weights is None or self.order is None:
            raise ValueError(
                f"{type(self).__name__} does not define error_weights/order "
                f"and cannot be used with adaptive=True."
            )
        if t is not None:
            t = torch.as_tensor(t)
            t_start, t_end = t[0], t[-1]
        else:
            t_start = 0.0
            t_end = torch.as_tensor(float(n_steps)) * torch.as_tensor(step_size)
        x_final, stats = self._adaptive_integrate(x, drift, t_start, t_end, step_size, norm)
        out: State = {"x": x_final}
        if return_stats:
            return out, stats
        return out

    def _adaptive_integrate(self, x: Tensor, drift: DriftFn, t_start, t_end,
                            h0, norm: Optional[NormFn] = None) -> Tuple[Tensor, AdaptiveStats]:
        r"""Embedded-pair adaptive loop.

        Standard controller: accept iff ``err_ratio <= 1``; then
        ``h *= clamp(safety * err^{-1/p}, min_factor, max_factor)``, with FSAL
        first-stage reuse. State, time and step size are tensors on the
        state's device and accept/reject a ``torch.where``; the host reads
        only the loop condition, once per attempted step. ``err_ratio`` is
        ``norm``'s; one pooled over every shard gives every process the same
        condition.
        """
        dtype, dev = x.dtype, x.device

        def scalar(v):
            # a 0-d tensor on the state's device, made there (no host copy)
            if isinstance(v, Tensor):
                return v.to(device=dev, dtype=dtype)
            return torch.full((), float(v), dtype=dtype, device=dev)

        p = float(self.order)
        is_fsal = self.fsal
        e = self.error_weights
        t_cur, t_end = scalar(t_start), scalar(t_end)
        tiny = 1e-12 * torch.clamp(torch.abs(t_end), min=1.0)
        max_h, max_factor = scalar(self.max_step_size), scalar(self.max_factor)
        h = torch.minimum(torch.minimum(scalar(h0), t_end - t_cur), max_h)
        k1 = drift(x, t_cur) if is_fsal else torch.zeros_like(x)
        n_acc = torch.zeros((), dtype=torch.int32, device=dev)
        n_att = 0
        while n_att < self.max_steps and bool(t_cur < t_end - tiny):
            h = torch.minimum(torch.minimum(h, t_end - t_cur), max_h)
            ks = self._evaluate_stages(x, t_cur, h, drift, k0=k1 if is_fsal else None, norm=norm)
            y_new = self._combine(x, h, ks, self.tableau_b)
            if is_fsal:
                # the tableaus store the s "real" stages (dopri5: 6); this
                # evaluation at the new point is the (s+1)-th error stage and
                # the next step's first stage
                k_fsal = drift(y_new, t_cur + h)
                ks_err = ks + [k_fsal]
            else:
                k_fsal = k1
                ks_err = ks
            err_vec = self._combine(torch.zeros_like(x), h, ks_err, e)
            scale = self.atol + self.rtol * torch.maximum(torch.abs(x), torch.abs(y_new))
            err_ratio = (norm or _rms_norm)(err_vec / scale)

            accept = err_ratio <= 1.0
            x = torch.where(accept, y_new, x)
            t_cur = torch.where(accept, t_cur + h, t_cur)
            if is_fsal:
                k1 = torch.where(accept, k_fsal, k1)
            factor = torch.where(
                err_ratio == 0.0,
                max_factor,
                torch.clamp(
                    self.safety * torch.pow(torch.clamp(err_ratio, min=1e-30), -1.0 / p),
                    self.min_factor, self.max_factor,
                ),
            )
            h = torch.minimum(h * factor, max_h)
            n_acc = n_acc + accept.to(torch.int32)
            n_att += 1
        stats = AdaptiveStats(
            n_accepted=n_acc,
            n_attempted=torch.tensor(n_att, dtype=torch.int32, device=dev),
            final_h=h,
            exhausted=t_cur < t_end - tiny,
        )
        return x, stats


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
             diffusion=None, t=None, noise: Optional[Tensor] = None,
             norm: Optional[NormFn] = None, **_) -> State:
        """One step; ``noise`` injects the normals (a shard's rows of the
        whole batch's draws), ``norm`` an implicit stage's residual norm."""
        x = state["x"]
        t = torch.as_tensor(0.0 if t is None else t, dtype=x.dtype)
        h = torch.as_tensor(step_size, dtype=x.dtype)
        x_det = self._deterministic_step(x, h, drift, t, norm)
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
