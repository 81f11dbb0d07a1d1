r"""Langevin dynamics sampler (counterpart of :mod:`torchebm_tpu.samplers.langevin`).

Update rule

.. math::
    x_{t+1} = x_t - \eta\, \nabla_x U(x_t)
    + \text{noise\_scale}\cdot\sqrt{2\eta}\,\varepsilon_t

through a pluggable SDE integrator (default Euler–Maruyama). ``step_size``
and ``noise_scale`` are schedulable; ``clamp`` bounds the state per step.

Calls on analytic energies that a :data:`FUSED_DISPATCH` row claims run as
one whole-chain CUDA kernel (:mod:`torchebm_tpu_torch.ops.fused_langevin`)
when the generator, and so the state, lives on a CUDA device
(``fused="auto"``). ``fused="force"`` sends CPU calls to the row as well,
where the kernels' plain PyTorch versions run; ``fused="off"`` always takes
the generic loop. Every other energy and call takes the generic loop of
:mod:`.base` over the integrator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from ..core.energies import DoubleWellEnergy, Energy, GaussianEnergy, GaussianMixtureEnergy
from ..core.schedulers import BaseScheduler, sched_value
from ..integrators import EulerMaruyamaIntegrator, resolve_integrator
from .base import BaseSampler, _concrete_scalar, _gaussian_target, _sample_impl

Tensor = torch.Tensor

__all__ = ["LangevinDynamics", "FUSED_DISPATCH"]


def _sched_concrete(p) -> bool:
    """True if a schedulable parameter is a constant (Python number or 0-d
    tensor) or a scheduler, whose per-step table the row can build."""
    return _concrete_scalar(p) or isinstance(p, BaseScheduler)


def _sched_table_arg(p, n_steps: int, device: torch.device):
    """Chain-kernel form of a schedulable parameter: a Python float, or the
    ``(n_steps,)`` per-step value table on ``device``."""
    if _concrete_scalar(p):
        return float(p)
    return p.value(torch.arange(n_steps, device=device))


# --------------------------------------------------------------------------
# fused-dispatch table: ordered (predicate -> whole-chain kernel entry) rows
# --------------------------------------------------------------------------


class _FusedRow(NamedTuple):
    """One fused-dispatch rule.

    ``model_type``: exact model class the row handles (a subclass may override
    ``energy`` and must not inherit the kernel). ``supports(sampler)``: target
    parameter gate (the kernels' size caps). ``kernel_kwargs(sampler, x0)``:
    state-shape gate and the target's kernel arguments, or None to fall back
    to the loop. ``chain``/``trajectory``: attribute names in
    ``ops.fused_langevin``, resolved at call time.
    """

    name: str
    model_type: type
    supports: Callable[["LangevinDynamics"], bool]
    kernel_kwargs: Callable[["LangevinDynamics", Tensor], Optional[dict]]
    chain: str
    trajectory: str


def _isotropic_scale(model) -> Optional[float]:
    """σ if ``model`` is an isotropic Gaussian (cov = σ²I), else None."""
    cov = model.cov.detach().cpu()
    var = float(cov[0, 0])
    if var <= 0 or not torch.allclose(cov, var * torch.eye(cov.shape[0], dtype=cov.dtype),
                                      atol=1e-12):
        return None
    return var**0.5


def _dw_supports(s: "LangevinDynamics") -> bool:
    return isinstance(s.model.barrier_height, (int, float)) and isinstance(
        s.model.b, (int, float)
    )


def _dw_kwargs(s: "LangevinDynamics", x0: Tensor) -> Optional[dict]:
    return dict(barrier_height=float(s.model.barrier_height), b=float(s.model.b))


def _gaussian_supports(s: "LangevinDynamics") -> bool:
    iso = _isotropic_scale(s.model)
    if iso is not None and s.model.mean.ndim == 1 and s.model.mean.shape[-1] <= 64:
        return True
    return _gaussian_target(s.model) is not None


def _gaussian_kwargs(s: "LangevinDynamics", x0: Tensor) -> Optional[dict]:
    m = s.model
    if x0.ndim != 2 or x0.shape[-1] != m.mean.shape[-1]:
        return None
    iso = _isotropic_scale(m)
    if iso is not None:
        return dict(means=m.mean[None, :], scale=iso)
    return dict(means=m.mean[None, :], precision=m.cov_inv.contiguous())


def _mixture_supports(s: "LangevinDynamics") -> bool:
    k, d = s.model.means.shape
    return d <= 64 and k * d <= 1024


def _mixture_kwargs(s: "LangevinDynamics", x0: Tensor) -> Optional[dict]:
    m = s.model
    if x0.ndim != 2 or x0.shape[-1] != m.means.shape[-1]:
        return None
    return dict(means=m.means, scale=float(m.scale), log_weights=m.log_weights)


def _fused_gates_ok(sampler, device: torch.device, model_kwargs, *, schedulables,
                    integrator=None) -> bool:
    """The generic fused-dispatch gates: a CUDA state (or ``fused="force"``),
    no conditioning, constant or scheduled parameters, and the default
    Euler–Maruyama integrator where there is one."""
    if sampler.fused == "off":
        return False
    if sampler.fused != "force" and device.type != "cuda":
        return False
    if model_kwargs:
        return False
    if integrator is not None and type(integrator) is not EulerMaruyamaIntegrator:
        return False
    return all(_sched_concrete(p) for p in schedulables)


def _call_fused_row(row, x0, model, *, n_steps, thin, return_trajectory,
                    return_diagnostics, kargs, step_size, noise_scale, seed, clamp):
    """Invoke a dispatch row's chain/trajectory kernel and package outputs in
    the loop's shapes; diagnostics come from the kernel's trajectory."""
    from ..ops import fused_langevin as ops

    common = dict(
        n_steps=int(n_steps), step_size=step_size, noise_scale=noise_scale,
        seed=seed, clamp=clamp,
    )
    if return_trajectory or return_diagnostics:
        traj, final = getattr(ops, row.trajectory)(x0, thin=int(thin), **kargs, **common)
        out = traj.movedim(0, 1) if return_trajectory else final
        if not return_diagnostics:
            return out
        mean = torch.mean(traj, dim=1)
        var = torch.clamp(torch.var(traj, dim=1, correction=0), 1e-10, 1e10)
        energy = torch.func.vmap(lambda xk: torch.mean(model.energy(xk)))(traj)
        return out, {"mean": mean, "var": var, "energy": energy}
    return getattr(ops, row.chain)(x0, **kargs, **common)


#: ordered dispatch rows; the first row whose ``model_type`` and ``supports``
#: match wins.
FUSED_DISPATCH: Tuple[_FusedRow, ...] = (
    _FusedRow(
        "doublewell",
        DoubleWellEnergy,
        _dw_supports,
        _dw_kwargs,
        "doublewell_langevin_chain",
        "doublewell_langevin_chain_trajectory",
    ),
    _FusedRow(
        "gaussian",
        GaussianEnergy,
        _gaussian_supports,
        _gaussian_kwargs,
        "mixture_langevin_chain",
        "mixture_langevin_chain_trajectory",
    ),
    _FusedRow(
        "mixture",
        GaussianMixtureEnergy,
        _mixture_supports,
        _mixture_kwargs,
        "mixture_langevin_chain",
        "mixture_langevin_chain_trajectory",
    ),
)


@dataclass(eq=False)
class LangevinDynamics(BaseSampler):
    """Overdamped Langevin MCMC over a pluggable SDE integrator."""

    model: Energy
    step_size: Union[float, BaseScheduler] = 1e-3
    noise_scale: Union[float, BaseScheduler] = 1.0
    clamp: Optional[Tuple[float, float]] = None
    integrator: Any = None
    fused: str = "auto"

    def __post_init__(self):
        if self.clamp is not None and self.clamp[0] >= self.clamp[1]:
            raise ValueError(f"clamp min must be < max, got {self.clamp}")
        if self.fused not in ("auto", "off", "force"):
            raise ValueError(f"fused must be 'auto', 'off' or 'force', got {self.fused!r}")
        self.integrator = resolve_integrator(
            self.integrator, default="euler_maruyama", families=("sde",)
        )

    def step(self, carry, i, generator, model_kwargs):
        out = self.integrator.step(
            {"x": carry["x"]},
            sched_value(self.step_size, i),
            drift=lambda x_, t_: -self.gradient_of(x_, model_kwargs, step=i),
            generator=generator,
            noise_scale=sched_value(self.noise_scale, i),
        )
        x = out["x"]
        if self.clamp is not None:
            x = torch.clamp(x, self.clamp[0], self.clamp[1])
        return {"x": x}

    # -------------------------------------------------------- fused fast path

    def _fused_row(self) -> Optional[_FusedRow]:
        """The :data:`FUSED_DISPATCH` row claiming this sampler's model, if any."""
        for row in FUSED_DISPATCH:
            if type(self.model) is row.model_type and row.supports(self):
                return row
        return None

    def _dispatch_row(self, device: torch.device, model_kwargs) -> Optional[_FusedRow]:
        """Generic fused gates and row lookup in one pass (None = loop)."""
        if not _fused_gates_ok(
            self, device, model_kwargs,
            schedulables=(self.step_size, self.noise_scale),
            integrator=self.integrator,
        ):
            return None
        return self._fused_row()

    @torch.no_grad()
    def sample(
        self,
        generator: torch.Generator,
        x: Optional[Tensor] = None,
        dim=None,
        n_steps: int = 100,
        n_samples: int = 1,
        thin: int = 1,
        return_trajectory: bool = False,
        return_diagnostics: bool = False,
        *,
        model_kwargs=None,
    ):
        """Run the chain: a whole-chain kernel where a dispatch row claims the
        call, the generic loop otherwise. The kernel's Philox seed is drawn
        from ``generator`` after the initial state."""
        x0 = self._start(generator, x, dim, n_samples, n_steps, thin)
        row = self._dispatch_row(generator.device, model_kwargs)
        if row is not None:
            kargs = row.kernel_kwargs(self, x0) if x0.dtype == torch.float32 else None
            if kargs is not None and (
                not (return_trajectory or return_diagnostics) or n_steps // thin >= 1
            ):
                seed = int(torch.randint(
                    0, 2**63 - 1, (), generator=generator, device=generator.device
                ))
                return _call_fused_row(
                    row, x0.contiguous(), self.model,
                    n_steps=n_steps, thin=thin,
                    return_trajectory=return_trajectory,
                    return_diagnostics=return_diagnostics,
                    kargs=kargs,
                    step_size=_sched_table_arg(self.step_size, n_steps, x0.device),
                    noise_scale=_sched_table_arg(self.noise_scale, n_steps, x0.device),
                    seed=seed,
                    clamp=self.clamp,
                )
            # unsupported state shape or dtype, or n_steps < thin: the loop takes the call
        return _sample_impl(
            self, x0, generator, n_steps, thin,
            bool(return_trajectory), bool(return_diagnostics), model_kwargs or {},
        )
