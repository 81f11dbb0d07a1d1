r"""Hamiltonian Monte Carlo with dual-averaging step-size adaptation.

Counterpart of :mod:`torchebm_tpu.samplers.hmc`. One transition: sample
momentum :math:`p \sim N(0, M)`, integrate ``n_leapfrog_steps`` of leapfrog
under the force :math:`-\nabla U`, then Metropolis-accept with probability
:math:`\min(1, e^{H_{\text{cur}} - H_{\text{prop}}})`. Energies are clamped
to ±1e10, the Hamiltonian difference to ±50, and the leapfrog runs in
``safe`` mode (force clamp, NaN scrub).

:meth:`HamiltonianMonteCarlo.warmup` adapts the step size by Nesterov dual
averaging (Hoffman & Gelman 2014, Algorithm 5) toward ``target_accept``, and
optionally a diagonal mass; it returns a Python float step size, so the
``hmc.replace(step_size=eps).sample(...)`` that follows can take the kernel.

Calls on a Gaussian mixture or a full-covariance Gaussian, with a unit,
scalar or ``(d,)`` diagonal mass, run as one whole-run CUDA kernel
(:mod:`torchebm_tpu_torch.ops.fused_hmc`) when the generator lives on a CUDA
device (``fused="auto"``); ``fused="force"`` sends CPU calls to the kernels'
plain versions, ``fused="off"`` always takes the generic loop. A sharded
batch (:mod:`.base`) runs the kernel at its ``chain_offset`` or the loop on
the whole batch's draws, and pools ``acceptance_rate`` over every shard.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..core.energies import Energy
from ..core.schedulers import BaseScheduler, sched_init, sched_value
from ..integrators import LeapfrogIntegrator, resolve_integrator
from ..parallel.mesh import is_dtensor
from ..utils.profiling import count, span
from .base import (
    BaseSampler,
    _kernel_seed,
    _metropolis_target,
    _rand,
    _randn,
    _row_draws,
    _Rows,
    _sample_impl,
)

Tensor = torch.Tensor

__all__ = ["HamiltonianMonteCarlo", "DualAveragingState", "dual_averaging_update"]


@dataclass(frozen=True)
class DualAveragingState:
    """Carry of Nesterov dual averaging of ``log step_size`` (float32 0-d tensors)."""

    log_eps: Tensor
    log_eps_bar: Tensor
    h_bar: Tensor
    t: Tensor  # adaptation step counter (float)

    @classmethod
    def init(cls, eps0: float, device=None) -> "DualAveragingState":
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return cls(log_eps=f32(math.log(eps0)), log_eps_bar=f32(0.0), h_bar=f32(0.0),
                   t=f32(0.0))


def dual_averaging_update(
    state: DualAveragingState,
    accept_prob: Tensor,
    target_accept: float,
    mu: Tensor,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    """One dual-averaging update (Hoffman & Gelman 2014, Algorithm 5)."""
    t = state.t + 1.0
    eta_h = 1.0 / (t + t0)
    h_bar = (1.0 - eta_h) * state.h_bar + eta_h * (target_accept - accept_prob)
    log_eps = mu - torch.sqrt(t) / gamma * h_bar
    eta_x = torch.pow(t, -kappa)
    log_eps_bar = eta_x * log_eps + (1.0 - eta_x) * state.log_eps_bar
    return DualAveragingState(log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar, t=t)


@dataclass(eq=False)
class HamiltonianMonteCarlo(BaseSampler):
    """HMC sampler (leapfrog trajectories and a Metropolis test).

    ``mass`` may be a scalar or a per-dimension diagonal tensor. The
    integrator must be a separable symplectic one (default ``"leapfrog"``).
    ``dual_averaging`` is kept for the JAX constructor's signature; step-size
    adaptation runs whenever :meth:`warmup` is called.
    """

    model: Energy
    step_size: Union[float, BaseScheduler] = 1e-3
    n_leapfrog_steps: int = 10
    mass: Optional[Union[float, Tensor]] = None
    integrator: Any = None
    dual_averaging: bool = False
    target_accept: float = 0.8
    fused: str = "auto"

    def __post_init__(self):
        if self.n_leapfrog_steps <= 0:
            raise ValueError("n_leapfrog_steps must be positive")
        if self.fused not in ("auto", "off", "force"):
            raise ValueError(f"fused must be 'auto', 'off' or 'force', got {self.fused!r}")
        self.integrator = resolve_integrator(
            self.integrator, default="leapfrog", families=("symplectic",)
        )
        if not self.integrator.separable:
            raise TypeError(
                "HamiltonianMonteCarlo requires a separable symplectic integrator; got "
                f"non-separable {type(self.integrator).__name__}"
            )

    # ------------------------------------------------------------------

    def _mass_like(self, x: Tensor) -> Tensor:
        """The mass as a tensor that broadcasts against ``x`` (its last axis)."""
        mass = torch.as_tensor(self.mass, dtype=x.dtype, device=x.device)
        return mass if mass.ndim == 0 else mass.reshape((1,) * (x.ndim - 1) + (-1,))

    def _momentum(self, generator: torch.Generator, x: Tensor) -> Tensor:
        p = _randn(generator, x.shape, device=x.device, dtype=x.dtype)
        return p if self.mass is None else p * torch.sqrt(self._mass_like(x))

    def _kinetic(self, p: Tensor) -> Tensor:
        sq = torch.square(p)
        if self.mass is None:
            return 0.5 * torch.sum(sq.reshape(sq.shape[0], -1), dim=-1)
        mass = self._mass_like(p)
        if mass.ndim == 0:
            return 0.5 * torch.sum(sq.reshape(sq.shape[0], -1), dim=-1) / mass
        return 0.5 * torch.sum((sq / mass).reshape(sq.shape[0], -1), dim=-1)

    def _transition(self, x: Tensor, generator: torch.Generator, eps,
                    model_kwargs) -> Tuple[Tensor, Tensor]:
        """One MH proposal; returns ``(new_x, each chain's acceptance probability)``."""
        p = self._momentum(generator, x)
        cur_h = (torch.clamp(self.energy_of(x, model_kwargs), -1e10, 1e10)
                 + torch.clamp(self._kinetic(p), 0.0, 1e10))
        proposed = self.integrator.integrate(
            {"x": x, "p": p}, eps, self.n_leapfrog_steps, self.mass,
            drift=lambda x_, t_: -self.gradient_of(x_, model_kwargs), safe=True,
        )
        prop_h = (torch.clamp(self.energy_of(proposed["x"], model_kwargs), -1e10, 1e10)
                  + torch.clamp(self._kinetic(proposed["p"]), 0.0, 1e10))
        accept_prob = torch.clamp(torch.exp(torch.clamp(cur_h - prop_h, -50.0, 50.0)), max=1.0)
        u = _rand(generator, accept_prob.shape, device=x.device, dtype=accept_prob.dtype)
        mask = (u < accept_prob).reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.where(mask, proposed["x"], x), accept_prob

    # ---------------------------------------------------------------- hooks

    def init_carry(self, x0, generator, model_kwargs) -> Dict[str, Any]:
        return {"x": x0, "accept_rate": torch.zeros((), device=x0.device)}

    def step(self, carry, i, generator, model_kwargs):
        x_new, acc = self._transition(carry["x"], generator, sched_value(self.step_size, i),
                                      model_kwargs)
        return {"x": x_new, "accept_rate": torch.mean(acc)}

    def extra_diagnostics(self, carry, model_kwargs):
        return {"acceptance_rate": carry["accept_rate"]}

    # -------------------------------------------------------- fused fast path

    def _fused_target(self, device, return_diagnostics, model_kwargs):
        """``(means, target kwargs)`` when the call may take the kernel: the
        generic Metropolis gate, the default leapfrog, and a unit, scalar or
        ``(d,)`` mass."""
        if type(self.integrator) is not LeapfrogIntegrator:
            return None
        target = _metropolis_target(self, device, return_diagnostics, model_kwargs)
        if target is None or self.mass is None:
            return target
        shape = tuple(torch.as_tensor(self.mass).shape)
        if shape not in ((), (target[0].shape[-1],)):
            return None
        return target

    def _run(self, generator, x0, n_steps, thin, return_trajectory, return_diagnostics,
             model_kwargs, rows=None):
        """Run the chain (``n_steps`` draws): the whole-run kernel where
        :meth:`_fused_target` claims the call (at the shard's ``chain_offset``
        for ``rows``), the generic loop otherwise. The kernel's Philox seed is
        drawn from ``generator`` after the initial state. The gate and the
        kernel's arguments are the span ``sampler.dispatch``."""
        with span("sampler.dispatch"):
            target = self._fused_target(generator.device, return_diagnostics, model_kwargs)
            if target is not None:
                means, target_kw = target
                if (x0.dtype == torch.float32 and x0.ndim == 2
                        and x0.shape[-1] == means.shape[-1]
                        and (not return_trajectory or n_steps // thin >= 1)):
                    args = (x0.contiguous(), means, n_steps, float(self.step_size),
                            self.n_leapfrog_steps)
                else:
                    # unsupported state shape or dtype, or n_steps < thin: the loop
                    target = None
        if target is not None:
            from ..ops import fused_hmc as ops

            kw = dict(mass=self.mass, seed=_kernel_seed(generator), **target_kw)
            if rows is not None:
                kw["chain_offset"] = rows.start
            if return_trajectory:
                traj, _, _ = ops.mixture_hmc_chain_trajectory(*args, thin=thin, **kw)
                return traj.movedim(0, 1)
            return ops.mixture_hmc_chain(*args, **kw)[0]
        return _sample_impl(self, x0, generator, n_steps, thin, return_trajectory,
                            return_diagnostics, model_kwargs, rows)

    # ---------------------------------------------------------------- warmup

    @torch.no_grad()
    def warmup(
        self,
        generator: torch.Generator,
        x: Optional[Tensor] = None,
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        n_warmup: int = 500,
        n_samples: int = 1,
        *,
        adapt_mass: bool = False,
        model_kwargs: Optional[Dict[str, Any]] = None,
    ):
        """Dual-averaging warmup on the generic loop: returns ``(warmed x,
        adapted step_size)``, the step size a Python float,
        ``exp(log_eps_bar)`` (the averaged iterate). Typical use::

            x, eps = hmc.warmup(g, dim=2, n_warmup=500, n_samples=64)
            samples = hmc.replace(step_size=eps).sample(g, x=x, n_steps=1000)

        ``adapt_mass=True`` also estimates a diagonal mass, the inverse of the
        per-dimension variance pooled over all chains and the second half of
        warmup, and returns ``(warmed x, step_size, mass)``. A sharded ``x``
        (:mod:`.base`) is warmed shard by shard on the whole batch's draws,
        dual averaging fed the acceptance over every shard's chains: the warmed
        ``x`` comes back sharded alike, and every process gets the unsharded
        call's step size and mass.
        """
        return _dual_averaging_warmup(self, self._transition, generator, x, dim, n_warmup,
                                     n_samples, adapt_mass, model_kwargs)


def _dual_averaging_warmup(sampler, transition, generator, x, dim, n_warmup, n_samples,
                          adapt_mass, model_kwargs):
    """The warmup of :meth:`HamiltonianMonteCarlo.warmup` and
    :meth:`~torchebm_tpu_torch.samplers.NoUTurnSampler.warmup` around one
    ``transition(x, generator, eps, model_kwargs) -> (x, each chain's
    acceptance)``: dual averaging of the step size toward
    ``sampler.target_accept`` from ``sampler.step_size``, fed the mean
    acceptance over the chains, and with ``adapt_mass`` the diagonal mass
    from the second half's per-dimension variance over all chains. A DTensor
    ``x`` is run shard by shard; the acceptance and the collected states are
    gathered whole (:meth:`~.base._Rows.whole`) before they are reduced, for
    dual averaging multiplies a rounding of the mean acceptance by up to
    ``√t / 0.05``: every process gets the unsharded call's bits."""
    if int(n_warmup) < 1:
        raise ValueError("n_warmup must be >= 1")
    model_kwargs = model_kwargs or {}
    rows = _Rows(x) if is_dtensor(x) else None
    if rows is not None:
        x, dim, n_samples = rows.local, None, 1
    x = sampler._start(generator, x, dim, n_samples, 1, 1)
    draws = _row_draws(generator, rows)
    eps0 = sched_init(sampler.step_size)
    mu = torch.tensor(math.log(10.0 * eps0), dtype=torch.float32, device=x.device)
    da = DualAveragingState.init(eps0, x.device)
    collect_from = int(n_warmup) // 2  # skip the transient for the variance window
    flat_d = x.reshape(x.shape[0], -1).shape[-1]
    s1 = torch.zeros(flat_d, dtype=x.dtype, device=x.device)
    s2 = torch.zeros(flat_d, dtype=x.dtype, device=x.device)
    n_collected = 0
    for i in range(int(n_warmup)):
        x, acc = transition(x, draws, torch.exp(da.log_eps), model_kwargs)
        acc = torch.mean(acc if rows is None else rows.whole(acc))
        da = dual_averaging_update(da, acc, sampler.target_accept, mu)
        if i >= collect_from and adapt_mass:
            flat = x.reshape(x.shape[0], -1)
            if rows is not None:
                flat = rows.whole(flat)
            s1 = s1 + torch.sum(flat, dim=0)
            s2 = s2 + torch.sum(flat * flat, dim=0)
            n_collected += flat.shape[0]
    count("host_reads")
    eps = float(torch.exp(da.log_eps_bar))
    x_out = x if rows is None else rows.like_this(x)
    if not adapt_mass:
        return x_out, eps
    n = float(max(n_collected, 2))
    var = s2 / n - torch.square(s1 / n)
    return x_out, eps, 1.0 / torch.clamp(var.reshape(x.shape[1:]), 1e-8, 1e8)
