r"""Whole-run HMC kernels: wrappers, plain PyTorch versions, launch counts.

PyTorch counterpart of :mod:`torchebm_tpu.ops.fused_hmc`. Each wrapper runs
``n_draws`` Hamiltonian Monte Carlo draws for every chain — momentum refresh
:math:`p = \varepsilon\sqrt{m}`, ``n_leapfrog`` leapfrog steps with force
reuse (half-kick, drift :math:`q \mathrel{+}= h\,p/m`, new gradient,
half-kick), Hamiltonian :math:`H = U + \tfrac12\sum p^2/m` with
:math:`\Delta H` clipped to ±50, Metropolis test — in one launch of a
hand-written CUDA kernel (``csrc/fused_hmc.cu``) when ``x0`` lies on a CUDA
device, and in its plain PyTorch version when ``x0`` lies on the CPU; any
other device raises.

The target is a d-dim isotropic Gaussian mixture or, with ``precision=``, a
full-covariance Gaussian, under the caps of :mod:`.fused_langevin`. ``mass``
is None (unit), a scalar or a ``(d,)`` diagonal mass — the output of
``HamiltonianMonteCarlo.warmup(adapt_mass=True)``. ``noise``
(``(n_draws, n_chains, d)`` standard-normal momentum draws, scaled by
:math:`\sqrt{m}` inside) and ``uniforms`` (``(n_draws, n_chains)``) are
injected together or not at all; without them both come from the
Philox4x32-10 stream keyed by ``seed``. Each wrapper also returns the
per-chain mean acceptance probability.

Every wrapper carries an integer ``launches`` attribute, raised by one each
time it launches its kernel (never on the plain path); ``ops.launch_counts``
reads them.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from . import _build
from .fused_langevin import (
    _check_metropolis,
    _check_thin,
    _seed_words,
    _target,
    philox_normals,
    philox_uniforms,
)

Tensor = torch.Tensor
Mass = Union[None, float, Tensor]

__all__ = [
    "mixture_hmc_chain",
    "mixture_hmc_chain_trajectory",
    "mixture_hmc_chain_plain",
    "mixture_hmc_chain_trajectory_plain",
]

#: ``tebm_mixture_hmc_chain``'s argument types before the stream: x0, out, accept,
#: traj, params_a, params_b, mass, noise, uniforms, n, d, k, gaussian, n_draws,
#: thin, n_leapfrog, inv_var, step, seed lo, seed hi
_SIGNATURE = (_build.PTR,) * 9 + (_build.INT,) * 7 + (_build.FLOAT,) * 2 + (_build.U32,) * 2


def _mass_vector(mass: Mass, d: int, device: torch.device) -> Optional[Tensor]:
    """``mass`` as a contiguous float32 ``(d,)`` tensor on ``device`` (None
    stays None); a scalar broadcasts, as in the JAX wrappers."""
    if mass is None:
        return None
    m = torch.as_tensor(mass, dtype=torch.float32, device=device)
    if m.ndim > 1 or (m.ndim == 1 and m.shape[0] != d):
        raise ValueError(f"mass must be a scalar or a ({d},) diagonal, got shape {tuple(m.shape)}")
    return m.broadcast_to((d,)).contiguous()


def _hmc_args(x0, means, n_draws, step_size, n_leapfrog, scale, log_weights, precision, mass,
              noise, uniforms, seed):
    """Validate; return ``(grad_logp, params_a, params_b, gaussian, inv_var, h, mass)``."""
    _check_metropolis(x0, n_draws, noise, uniforms)
    grad_logp, pa, pb, gaussian, inv_var = _target(x0, means, scale, log_weights, precision)
    if int(n_leapfrog) < 1:
        raise ValueError(f"n_leapfrog must be >= 1, got {n_leapfrog}")
    h = float(step_size)
    if not h > 0.0:
        raise ValueError(f"step_size must be > 0, got {h}")
    _seed_words(seed)
    return grad_logp, pa, pb, gaussian, inv_var, h, _mass_vector(mass, x0.shape[1], x0.device)


def _run_plain(x0, grad_logp, h, n_leapfrog, mass, n_draws, seed, noise, uniforms, thin):
    """Plain version of both kernels: the same draw, force reuse and Philox
    stream; returns ``(traj or None, final, accept)``."""
    n, d = x0.shape
    index = torch.arange(n, device=x0.device)
    minv = None if mass is None else 1.0 / mass

    def kinetic(p):
        sq = p * p if minv is None else p * p * minv
        return torch.sum(sq, dim=-1)

    x = x0
    acc = torch.zeros(n, dtype=torch.float32, device=x0.device)
    kept = []
    for t in range(int(n_draws)):
        eps = noise[t] if noise is not None else philox_normals(index, t, d, seed)
        u = uniforms[t] if uniforms is not None else philox_uniforms(index, t, seed)
        p = eps if mass is None else eps * torch.sqrt(mass)
        g, lp0 = grad_logp(x)
        h0 = -lp0 + 0.5 * kinetic(p)
        q, lp1 = x, lp0
        for _ in range(int(n_leapfrog)):
            p = p - 0.5 * h * g
            q = q + (h * p if minv is None else h * p * minv)
            g, lp1 = grad_logp(q)
            p = p - 0.5 * h * g
        h1 = -lp1 + 0.5 * kinetic(p)
        alpha = torch.clamp(torch.exp(torch.clamp(h0 - h1, -50.0, 50.0)), max=1.0)
        x = torch.where((u < alpha)[:, None], q, x)
        acc = acc + alpha
        if thin is not None and (t + 1) % thin == 0:
            kept.append(x)
    traj = torch.stack(kept) if thin is not None else None
    return traj, x, acc * (1.0 / int(n_draws))


def _launch(x0, traj, pa, pb, gaussian, inv_var, h, n_leapfrog, mass, n_draws, thin, seed,
            noise, uniforms, k):
    n, d = x0.shape
    out = torch.empty_like(x0)
    accept = torch.empty((n,), dtype=torch.float32, device=x0.device)
    seed_lo, seed_hi = _seed_words(seed)
    _build.launch(
        "mixture_hmc_chain", _SIGNATURE, x0.device,
        _build.ptr(x0), _build.ptr(out), _build.ptr(accept), _build.ptr(traj), _build.ptr(pa),
        _build.ptr(pb), _build.ptr(mass), _build.ptr(noise), _build.ptr(uniforms), n, d, k,
        gaussian, int(n_draws), int(thin), int(n_leapfrog), inv_var, h, seed_lo, seed_hi,
    )
    return out, accept


def mixture_hmc_chain_plain(x0, means, n_draws, step_size, n_leapfrog=10, *, scale=1.0,
                            log_weights=None, precision=None, mass=None, seed=0, noise=None,
                            uniforms=None) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`mixture_hmc_chain`, on ``x0``'s device."""
    grad_logp, *_, h, m = _hmc_args(x0, means, n_draws, step_size, n_leapfrog, scale,
                                    log_weights, precision, mass, noise, uniforms, seed)
    _, final, accept = _run_plain(x0, grad_logp, h, n_leapfrog, m, n_draws, seed, noise,
                                  uniforms, None)
    return final, accept


def mixture_hmc_chain_trajectory_plain(x0, means, n_draws, step_size, n_leapfrog=10, *, thin=1,
                                       scale=1.0, log_weights=None, precision=None, mass=None,
                                       seed=0, noise=None,
                                       uniforms=None) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of :func:`mixture_hmc_chain_trajectory`."""
    _check_thin(n_draws, thin)
    grad_logp, *_, h, m = _hmc_args(x0, means, n_draws, step_size, n_leapfrog, scale,
                                    log_weights, precision, mass, noise, uniforms, seed)
    return _run_plain(x0, grad_logp, h, n_leapfrog, m, n_draws, seed, noise, uniforms, int(thin))


@_build.counted
def mixture_hmc_chain(
    x0: Tensor,
    means: Tensor,
    n_draws: int,
    step_size: float,
    n_leapfrog: int = 10,
    *,
    scale: float = 1.0,
    log_weights: Optional[Tensor] = None,
    precision: Optional[Tensor] = None,
    mass: Mass = None,
    seed: int = 0,
    noise: Optional[Tensor] = None,
    uniforms: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Full HMC run on a d-dim isotropic Gaussian mixture (or, with
    ``precision``, a full-covariance Gaussian) in one kernel.

    ``x0``: ``(n_chains, d)``; ``means``: ``(K, d)``. Returns ``(samples,
    accept)``: the final state and the per-chain mean acceptance probability
    over all draws.
    """
    grad_logp, pa, pb, gaussian, inv_var, h, m = _hmc_args(
        x0, means, n_draws, step_size, n_leapfrog, scale, log_weights, precision, mass, noise,
        uniforms, seed,
    )
    if x0.device.type == "cpu":
        _, final, accept = _run_plain(x0, grad_logp, h, n_leapfrog, m, n_draws, seed, noise,
                                      uniforms, None)
        return final, accept
    out = _launch(x0, None, pa, pb, gaussian, inv_var, h, n_leapfrog, m, n_draws, 1, seed,
                  noise, uniforms, means.shape[0])
    mixture_hmc_chain.launches += 1
    return out


@_build.counted
def mixture_hmc_chain_trajectory(
    x0: Tensor,
    means: Tensor,
    n_draws: int,
    step_size: float,
    n_leapfrog: int = 10,
    *,
    thin: int = 1,
    scale: float = 1.0,
    log_weights: Optional[Tensor] = None,
    precision: Optional[Tensor] = None,
    mass: Mass = None,
    seed: int = 0,
    noise: Optional[Tensor] = None,
    uniforms: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """:func:`mixture_hmc_chain` recording every ``thin``-th post-MH draw.

    Returns ``(traj, final, accept)``: ``traj`` ``(n_draws // thin, n_chains,
    d)`` holds the states after draws ``thin, 2·thin, …``; ``final`` the state
    after all draws; ``accept`` the per-chain mean acceptance probability.
    """
    n_kept = _check_thin(n_draws, thin)
    grad_logp, pa, pb, gaussian, inv_var, h, m = _hmc_args(
        x0, means, n_draws, step_size, n_leapfrog, scale, log_weights, precision, mass, noise,
        uniforms, seed,
    )
    if x0.device.type == "cpu":
        return _run_plain(x0, grad_logp, h, n_leapfrog, m, n_draws, seed, noise, uniforms,
                          int(thin))
    traj = torch.empty((n_kept, *x0.shape), dtype=torch.float32, device=x0.device)
    out, accept = _launch(x0, traj, pa, pb, gaussian, inv_var, h, n_leapfrog, m, n_draws, thin,
                          seed, noise, uniforms, means.shape[0])
    mixture_hmc_chain_trajectory.launches += 1
    return traj, out, accept
