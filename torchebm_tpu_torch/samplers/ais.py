r"""Annealed importance sampling (counterpart of :mod:`torchebm_tpu.samplers.ais`).

Neal (2001) AIS along the geometric path

.. math::
    f_\beta(x) \propto e^{-(1-\beta)U_0(x) - \beta U_1(x)},
    \qquad 0 = \beta_0 < \dots < \beta_K = 1,

with ``n_transitions`` MALA transitions per rung. Starting from exact draws
of the base :math:`U_0` (default: standard Gaussian), the importance weights
satisfy :math:`E[w] = Z_1/Z_0`, so
:math:`\widehat{\log Z_1} = \log Z_0 + \operatorname{logsumexp}(\log w) - \log n`.

Calls with an isotropic Gaussian base and a Gaussian mixture or Gaussian
target run the whole anneal as one CUDA kernel
(:func:`torchebm_tpu_torch.ops.fused_ais.mixture_ais_run`) when the generator
lives on a CUDA device (``fused="auto"``); ``fused="force"`` sends CPU calls
to the kernel's plain version, ``fused="off"`` always takes the loop over
rungs. Unlike the JAX package, an isotropic :class:`GaussianEnergy` target
on the kernel carries no mixture normalisation constant (its energy has
none), and schedules of any length stay on the kernel.

Like the JAX function, which takes sharded or replicated inputs and returns
one result, the call takes DTensor inputs (``betas``, the energies' buffers
and parameters) by their full tensors. It then splits the ``n_samples``
chains into one block per process of their mesh: each process draws the
base samples and every step's numbers of the whole batch and keeps its
block's (or runs the kernel at the block's ``chain_offset``), and the blocks'
samples, log-weights and acceptance are summed over the mesh, so that
``log_z``, ``ess`` and the acceptance are the unsharded call's on every
process.
"""

from __future__ import annotations

import copy
import itertools
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..core.energies import Energy, GaussianEnergy, GaussianMixtureEnergy
from ..core.module import tensor_memo
from ..parallel.mesh import is_dtensor
from ..utils.profiling import count
from .base import (_check_model_device, _kernel_seed_tensor, _rand, _randn, _read_float,
                   _row_draws, _Rows)
from .langevin import _isotropic_scale

Tensor = torch.Tensor

__all__ = ["AISResult", "annealed_importance_sampling"]


@dataclass
class AISResult:
    """AIS output: final samples, per-chain log-weights, log-Z estimates."""

    samples: Tensor  # (n_samples, d): approximate target draws (weighted)
    log_weights: Tensor  # (n_samples,)
    log_z: Tensor  # 0-d: estimate of log Z_target (absolute)
    log_z_ratio: Tensor  # 0-d: log(Z_target / Z_base)
    ess: Tensor  # 0-d: importance-weight effective sample size
    acceptance_rate: Tensor  # 0-d: mean MALA acceptance over all rungs


class _Block(_Rows):
    """Chains ``[start, start + n)`` of ``n_global``: this process's block of
    an AIS call split evenly (to a chain) over the processes of ``mesh``,
    in the order of their coordinates; sums run over the whole mesh."""

    def __init__(self, mesh, n_global: int):
        coord, shape = mesh.get_coordinate(), tuple(mesh.shape)
        index = 0
        for c, s in zip(coord, shape):
            index = index * s + c
        size = math.prod(shape)
        self.start = n_global * index // size
        self.n = n_global * (index + 1) // size - self.start
        self.n_global, self.mesh = n_global, mesh

    def total(self, t: Tensor) -> Tensor:
        out = t.clone()
        for i in range(self.mesh.ndim):
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.mesh.get_group(i))
        return out


def _mesh_of(*tensors):
    """The mesh of the first DTensor among ``tensors``, or None."""
    return next((t.device_mesh for t in tensors if is_dtensor(t)), None)


def _full_tensors(model):
    """``model``, or a copy of it whose DTensor buffers and parameters are
    their full tensors."""
    if not any(is_dtensor(t) for t in itertools.chain(model.buffers(), model.parameters())):
        return model
    out = copy.deepcopy(model)
    for mod in out.modules():
        for store in (mod._buffers, mod._parameters):
            for name, t in store.items():
                if is_dtensor(t):
                    full = t.full_tensor()
                    store[name] = full if store is mod._buffers else torch.nn.Parameter(
                        full, requires_grad=t.requires_grad)
    return out


def _ais_impl(target: Energy, base: GaussianEnergy, generator: torch.Generator, betas: Tensor,
              step_size: float, n_samples: int, n_transitions: int,
              block: Optional[_Block] = None) -> AISResult:
    """The loop over rungs: the weight update at the current state, then
    ``n_transitions`` MALA transitions on the blended energy; any target.
    With ``block``, this process runs its block's chains on the whole
    batch's draws."""
    x = base.sample(generator, n_samples)
    if block is not None:
        x = block.cut(x)
    draws = _row_draws(generator, block)
    dev = x.device
    eta = float(step_size)
    noise_coef = math.sqrt(2.0 * eta)

    def annealed(y, beta):
        return (1.0 - beta) * base.energy(y) + beta * target.energy(y)

    def annealed_grad(y, beta):
        return (1.0 - beta) * base.gradient(y) + beta * target.gradient(y)

    def log_q(b, a, g_a):
        return -torch.sum(torch.square(b - a + eta * g_a), dim=-1) / (4.0 * eta)

    logw = torch.zeros(x.shape[0], dtype=x.dtype, device=dev)
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    count("host_reads")
    schedule = betas.tolist()
    for beta_prev, beta in zip(schedule[:-1], schedule[1:]):
        logw = logw + (beta - beta_prev) * (base.energy(x) - target.energy(x))
        for _ in range(n_transitions):
            g_x = annealed_grad(x, beta)
            eps = _randn(draws, x.shape, device=dev, dtype=x.dtype)
            y = x - eta * g_x + noise_coef * eps
            g_y = annealed_grad(y, beta)
            log_ratio = (annealed(x, beta) - annealed(y, beta) + log_q(x, y, g_y)
                         - log_q(y, x, g_x))
            accept = torch.clamp(torch.exp(torch.clamp(log_ratio, -50.0, 50.0)), max=1.0)
            u = _rand(draws, accept.shape, device=dev, dtype=accept.dtype)
            x = torch.where((u < accept)[:, None], y, x)
            acc = acc + (torch.mean(accept) if block is None else torch.sum(accept))
    n_rungs = len(schedule) - 1
    if block is not None:
        x, logw, acc = block.whole(x), block.whole(logw), block.total(acc) / n_samples
    return _ais_statistics(base, x, logw, acc / (n_rungs * n_transitions), n_samples)


def _fused_target_kwargs(target: Energy) -> Optional[dict]:
    """The kernel's target arguments for a Gaussian mixture (d ≤ 64, K·d ≤
    1024) or a Gaussian (isotropic with d ≤ 64, else full covariance with
    d ≤ 32), or None. ``log_norm_t`` is the constant the target's energy holds
    beyond the evaluator's unnormalised log-density: the mixture's
    normalisation, and nothing for a :class:`GaussianEnergy`. The scales
    are read on the host once per state of their buffers
    (:func:`~torchebm_tpu_torch.core.module.tensor_memo`)."""
    if type(target) is GaussianMixtureEnergy:
        k, d = target.means.shape
        if d > 64 or k * d > 1024:
            return None
        scale = tensor_memo(target.scale, _read_float)
        return dict(means=target.means, scale=scale, log_weights=target.log_weights,
                    log_norm_t=d * math.log(scale) + 0.5 * d * math.log(2 * math.pi))
    if type(target) is GaussianEnergy and target.mean.ndim == 1:
        d = target.mean.shape[-1]
        iso = _isotropic_scale(target)
        if iso is not None and d <= 64:
            return dict(means=target.mean[None, :], scale=iso, log_norm_t=0.0)
        if d <= 32:
            return dict(means=target.mean[None, :], precision=target.cov_inv.contiguous(),
                        log_norm_t=0.0)
    return None


def _ais_fusable(device: torch.device, target: Energy, base: Energy, fused: str) -> bool:
    """The kernel's gate: a CUDA generator (or ``fused="force"``), an
    isotropic :class:`GaussianEnergy` base of the target's dimension and a
    target :func:`_fused_target_kwargs` takes. No cap on the schedule's
    length: the β table lives in device memory."""
    if fused == "off" or (fused != "force" and device.type != "cuda"):
        return False
    if type(base) is not GaussianEnergy or base.mean.ndim != 1:
        return False
    if _isotropic_scale(base) is None:
        return False
    kw = _fused_target_kwargs(target)
    return kw is not None and kw["means"].shape[-1] == base.mean.shape[-1]


def _ais_statistics(base: GaussianEnergy, samples: Tensor, logw: Tensor, acc_mean: Tensor,
                    n_samples: int) -> AISResult:
    lse = torch.logsumexp(logw, dim=0)
    log_z_ratio = lse - math.log(n_samples)
    ess = torch.exp(2.0 * lse - torch.logsumexp(2.0 * logw, dim=0))
    return AISResult(
        samples=samples,
        log_weights=logw,
        log_z=base.log_z() + log_z_ratio,
        log_z_ratio=log_z_ratio,
        ess=ess,
        acceptance_rate=acc_mean,
    )


@torch.no_grad()
def annealed_importance_sampling(
    generator: torch.Generator,
    target: Energy,
    base: Optional[GaussianEnergy] = None,
    dim: Optional[int] = None,
    *,
    n_samples: int = 1024,
    n_rungs: int = 200,
    n_transitions: int = 1,
    step_size: float = 0.1,
    betas: Optional[Tensor] = None,
    fused: str = "auto",
) -> AISResult:
    r"""Estimate :math:`\log Z` of ``target``'s density :math:`e^{-U}/Z`.

    ``base`` must expose exact ``sample`` and ``log_z`` (any
    :class:`GaussianEnergy`; default the standard normal on the generator's
    device, which needs ``dim``). ``betas`` overrides the linear schedule
    ``linspace(0, 1, n_rungs + 1)``. Randomness comes from ``generator`` on its
    device. Returns an :class:`AISResult`; ``ess`` near ``n_samples`` marks a
    well-mixed anneal, near 1 a collapsed one.
    """
    if fused not in ("auto", "off", "force"):
        raise ValueError(f"fused must be 'auto', 'off' or 'force', got {fused!r}")
    if not isinstance(generator, torch.Generator):
        raise TypeError(f"annealed_importance_sampling needs a torch.Generator, "
                        f"got {type(generator).__name__}")
    device = generator.device
    mesh = _mesh_of(betas, *(t for m in (target, base) if m is not None
                             for t in itertools.chain(m.buffers(), m.parameters())))
    if mesh is not None:
        betas = betas.full_tensor() if is_dtensor(betas) else betas
        target = _full_tensors(target)
        base = None if base is None else _full_tensors(base)
    if base is None:
        if dim is None:
            raise ValueError("provide either base= or dim= for the default base")
        base = GaussianEnergy.standard(dim).to(device)
    if betas is None:
        betas = torch.linspace(0.0, 1.0, int(n_rungs) + 1, device=device)
    betas = torch.as_tensor(betas, dtype=torch.float32, device=device)
    if betas.ndim != 1 or betas.shape[0] < 2:
        raise ValueError("betas must be a 1D schedule with at least 2 entries")
    for model in (target, base):
        _check_model_device(model, device)
    block = None if mesh is None else _Block(mesh, int(n_samples))
    if _ais_fusable(device, target, base, fused):
        from ..ops import fused_ais

        x0 = base.sample(generator, int(n_samples))
        kw = _fused_target_kwargs(target)
        if block is not None:
            x0, kw["chain_offset"] = block.cut(x0).contiguous(), block.start
        samples, logw, acc = fused_ais.mixture_ais_run(
            x0, base.mean, _isotropic_scale(base), betas=betas.contiguous(),
            step_size=float(step_size), n_transitions=int(n_transitions),
            seed=_kernel_seed_tensor(generator), **kw,
        )
        if block is not None:
            samples, logw, acc = block.whole(samples), block.whole(logw), block.whole(acc)
        return _ais_statistics(base, samples, logw, torch.mean(acc), int(n_samples))
    return _ais_impl(target, base, generator, betas, float(step_size), int(n_samples),
                     int(n_transitions), block)
