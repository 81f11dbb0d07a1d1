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

``fused_neural`` does the same for the SiLU-MLP energy
(``WrappedEnergy(arch="silu_mlp")``, what ``as_energy(MLPEnergy(...))``
gives): the whole chain, forward and backward pass of the net included, runs
as one CUDA kernel (:mod:`torchebm_tpu_torch.ops.fused_mlp_langevin`). It is
off by default, as in the JAX package; ``"auto"`` takes the kernel for a
CUDA state, ``"force"`` its plain version on the CPU as well.

A chain batch sharded on its rows (``x`` a DTensor, e.g. from
:func:`~torchebm_tpu_torch.parallel.shard_batch`) gives a DTensor of the
same placement and the values of the unsharded call (:mod:`.base`): each
process runs its rows, the kernel rows and the neural row with
``chain_offset`` at the shard's first row (the double well's at that row
times the elements per row, its stream being per element; under FSDP2 the
neural row gathers the net's weights once per call), the generic loop with
each step's normals drawn for the whole batch and cut to the shard's rows.
``return_diagnostics`` gives the unsharded call's means over every shard's
chains on every process.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from ..core.energies import (
    DoubleWellEnergy,
    Energy,
    GaussianEnergy,
    GaussianMixtureEnergy,
    WrappedEnergy,
)
from ..core.module import tensor_memo
from ..core.schedulers import BaseScheduler, sched_value
from ..integrators import EulerMaruyamaIntegrator, resolve_integrator
from ..parallel.mesh import is_dtensor
from .base import (
    BaseSampler,
    _chain_stats,
    _concrete_scalar,
    _gaussian_target,
    _kernel_seed,
    _kernel_seed_tensor,
    _randn,
    _RowDraws,
    _sample_impl,
)

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
    ``ops.fused_langevin``, resolved at call time. ``device_seed``: the
    kernels read their Philox seed as a 0-d device tensor (no host sync);
    otherwise it is drawn and read on the host.
    """

    name: str
    model_type: type
    supports: Callable[["LangevinDynamics"], bool]
    kernel_kwargs: Callable[["LangevinDynamics", Tensor], Optional[dict]]
    chain: str
    trajectory: str
    device_seed: bool = False


def _covariance_scale(cov: Tensor) -> Optional[float]:
    """σ if ``cov`` is σ²I, else None (read on the host)."""
    cov = cov.detach().cpu()
    var = float(cov[0, 0])
    eye = torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
    if var <= 0 or not torch.allclose(cov, var * eye, atol=1e-12):
        return None
    return var**0.5


def _isotropic_scale(model) -> Optional[float]:
    """σ if ``model`` is an isotropic Gaussian (cov = σ²I), else None; read
    on the host once per state of ``model.cov`` (:func:`tensor_memo`)."""
    return tensor_memo(model.cov, _covariance_scale)


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


def _claiming_row(sampler) -> Optional[_FusedRow]:
    """The :data:`FUSED_DISPATCH` row claiming ``sampler.model``, if any."""
    for row in FUSED_DISPATCH:
        if type(sampler.model) is row.model_type and row.supports(sampler):
            return row
    return None


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
                    return_diagnostics, kargs, step_size, noise_scale, seed, clamp, rows=None):
    """Invoke a dispatch row's chain/trajectory kernel and package outputs in
    the loop's shapes; diagnostics come from the kernel's trajectory. With
    ``rows`` (a shard of a sharded batch) the kernel runs at the shard's
    ``chain_offset`` (per element for the double well) and the diagnostics
    are pooled over every shard."""
    from ..ops import fused_langevin as ops

    common = dict(
        n_steps=int(n_steps), step_size=step_size, noise_scale=noise_scale,
        seed=seed, clamp=clamp,
    )
    if rows is not None:
        per_row = x0[0].numel() if row.name == "doublewell" else 1
        common["chain_offset"] = rows.start * per_row
    if return_trajectory or return_diagnostics:
        traj, final = getattr(ops, row.trajectory)(x0, thin=int(thin), **kargs, **common)
        out = traj.movedim(0, 1) if return_trajectory else final
        if not return_diagnostics:
            return out
        return out, _chain_stats(traj, torch.func.vmap(model.energy)(traj), rows, dim=1)
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
        device_seed=True,
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
    #: the whole-chain neural kernel for arch-tagged SiLU-MLP energies;
    #: opt-in ("auto" or "force"), off by default as in the JAX package
    fused_neural: str = "off"

    def __post_init__(self):
        if self.clamp is not None and self.clamp[0] >= self.clamp[1]:
            raise ValueError(f"clamp min must be < max, got {self.clamp}")
        if self.fused not in ("auto", "off", "force"):
            raise ValueError(f"fused must be 'auto', 'off' or 'force', got {self.fused!r}")
        if self.fused_neural not in ("auto", "off", "force"):
            raise ValueError(
                f"fused_neural must be 'auto', 'off' or 'force', got {self.fused_neural!r}"
            )
        self.integrator = resolve_integrator(
            self.integrator, default="euler_maruyama", families=("sde",)
        )

    def step(self, carry, i, generator, model_kwargs):
        kw = {}
        if isinstance(generator, _RowDraws):  # a shard: its rows of the whole batch's normals
            x = carry["x"]
            kw["noise"] = _randn(generator, x.shape, device=x.device, dtype=x.dtype)
            kw["norm"] = generator.rows.rms_norm  # an implicit stage's residual, every shard's
            generator = generator.generator
        out = self.integrator.step(
            {"x": carry["x"]},
            sched_value(self.step_size, i),
            drift=lambda x_, t_: -self.gradient_of(x_, model_kwargs, step=i),
            generator=generator,
            noise_scale=sched_value(self.noise_scale, i),
            **kw,
        )
        x = out["x"]
        if self.clamp is not None:
            x = torch.clamp(x, self.clamp[0], self.clamp[1])
        return {"x": x}

    # -------------------------------------------------------- fused fast path

    def _neural_fusable(self, device: torch.device, return_trajectory, return_diagnostics,
                        thin, model_kwargs) -> bool:
        """Whether this call may take the neural SiLU-MLP chain kernel: opted
        in, a CUDA state (``"force"`` skips that check and runs the plain
        version on the CPU), no conditioning, ``thin == 1`` with no trajectory
        or diagnostics, the default Euler–Maruyama integrator, a constant
        step and noise scale, and an arch-tagged :class:`WrappedEnergy`."""
        if self.fused_neural == "off":
            return False
        if self.fused_neural != "force" and device.type != "cuda":
            return False
        if model_kwargs or thin != 1 or return_trajectory or return_diagnostics:
            return False
        if type(self.integrator) is not EulerMaruyamaIntegrator:
            return False
        if not (_concrete_scalar(self.step_size) and _concrete_scalar(self.noise_scale)):
            return False
        return isinstance(self.model, WrappedEnergy) and self.model.arch == "silu_mlp"

    def _neural_layers(self, x0: Tensor):
        """The MLP's layers when the kernel takes this state, else None: a
        shape decision made before any launch (the loop takes the call).
        Weights that FSDP2 shards (DTensors) are gathered whole, one
        all-gather each per call, for the kernel reads no gradient path."""
        from ..ops import fused_mlp_langevin as nops

        if x0.ndim != 2 or x0.dtype != torch.float32:
            return None
        layers = nops.extract_mlp_layers(self.model.fn)
        if layers is None or layers[0][0].shape[0] != x0.shape[1]:
            return None
        widths = [x0.shape[1]] + [w.shape[1] for w, _ in layers[:-1]]
        if any(w.dtype != torch.float32 for w, _ in layers) or not nops.supports(widths, x0.device):
            return None
        return [tuple(t.full_tensor() if is_dtensor(t) else t for t in layer) for layer in layers]

    def _dispatch_row(self, device: torch.device, model_kwargs) -> Optional[_FusedRow]:
        """Generic fused gates and row lookup in one pass (None = loop)."""
        if not _fused_gates_ok(
            self, device, model_kwargs,
            schedulables=(self.step_size, self.noise_scale),
            integrator=self.integrator,
        ):
            return None
        return _claiming_row(self)

    def _run(self, generator, x0, n_steps, thin, return_trajectory, return_diagnostics,
             model_kwargs, rows=None):
        """Run the chain from ``x0``: the neural chain kernel for a tagged
        SiLU-MLP energy under ``fused_neural``, a whole-chain kernel where a
        dispatch row claims the call, the generic loop otherwise. A kernel's
        Philox seed is drawn from ``generator`` after the initial state.
        ``rows``: ``x0`` is a shard of a sharded batch (:mod:`.base`)."""
        chain_offset = 0 if rows is None else rows.start
        if self._neural_fusable(generator.device, return_trajectory, return_diagnostics, thin,
                                model_kwargs):
            layers = self._neural_layers(x0)
            if layers is not None:
                from ..ops.fused_mlp_langevin import mlp_langevin_chain

                return mlp_langevin_chain(
                    x0.contiguous(), layers, int(n_steps), float(self.step_size),
                    float(self.noise_scale), seed=_kernel_seed_tensor(generator),
                    clamp=self.clamp, chain_offset=chain_offset,
                )
            # unsupported state, widths or depth: the loop takes the call
        row = self._dispatch_row(generator.device, model_kwargs)
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
                    noise_scale=_sched_table_arg(self.noise_scale, n_steps, x0.device),
                    seed=(_kernel_seed_tensor if row.device_seed else _kernel_seed)(generator),
                    clamp=self.clamp, rows=rows,
                )
            # unsupported state shape or dtype, or n_steps < thin: the loop takes the call
        return _sample_impl(self, x0, generator, n_steps, thin, return_trajectory,
                            return_diagnostics, model_kwargs, rows)
