r"""Whole-chain MALA kernels: wrappers, plain PyTorch versions, launch counts.

PyTorch counterpart of :mod:`torchebm_tpu.ops.fused_mala`. Each wrapper runs
an entire n-step Metropolis-adjusted Langevin chain

.. math::
    y = x - \eta \nabla U(x) + \sqrt{2\eta}\,\varepsilon, \qquad
    \log q(b \mid a) = -\lVert b - a + \eta \nabla U(a)\rVert^2 / (4\eta)

    \alpha = \min(1, e^{\,\text{clip}(\log p(y) - \log p(x)
    + \log q(x|y) - \log q(y|x),\ \pm 50)}), \qquad x \leftarrow y \text{ if } u < \alpha

in one launch of a hand-written CUDA kernel (``csrc/fused_mala.cu``) when
``x0`` lies on a CUDA device, and in its plain PyTorch version when ``x0``
lies on the CPU; any other device raises. The target is a d-dim isotropic
Gaussian mixture (``means``, ``scale``, ``log_weights``) or, with
``precision=``, a full-covariance Gaussian (one ``(1, d)`` mean row, d ≤ 32),
under the caps of :mod:`.fused_langevin`.

``noise`` (``(n_steps, n_chains, d)`` proposal normals) and ``uniforms``
(``(n_steps, n_chains)`` Metropolis draws) are injected together or not at
all; without them both come from the Philox4x32-10 stream keyed by ``seed``
(:func:`~.fused_langevin.philox_normals`, :func:`~.fused_langevin.philox_uniforms`).
Each wrapper also returns the per-chain mean acceptance probability.

Every wrapper carries an integer ``launches`` attribute, raised by one each
time it launches its kernel (never on the plain path); ``ops.launch_counts``
reads them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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

__all__ = [
    "mixture_mala_chain",
    "mixture_mala_chain_trajectory",
    "mixture_mala_chain_plain",
    "mixture_mala_chain_trajectory_plain",
]

#: ``tebm_mixture_mala_chain``'s argument types before the stream: x0, out, accept,
#: traj, params_a, params_b, noise, uniforms, n, d, k, gaussian, n_steps, thin,
#: inv_var, eta, noise_coef, four_eta, seed lo, seed hi
_SIGNATURE = (_build.PTR,) * 8 + (_build.INT,) * 6 + (_build.FLOAT,) * 4 + (_build.U32,) * 2


def _mala_args(x0, means, n_steps, step_size, scale, log_weights, precision, noise, uniforms,
               seed):
    """Validate; return ``(grad_logp, params_a, params_b, gaussian, inv_var, eta)``."""
    _check_metropolis(x0, n_steps, noise, uniforms)
    grad_logp, pa, pb, gaussian, inv_var = _target(x0, means, scale, log_weights, precision)
    eta = float(step_size)
    if not eta > 0.0:
        raise ValueError(f"step_size must be > 0, got {eta}")
    _seed_words(seed)
    return grad_logp, pa, pb, gaussian, inv_var, eta


def _run_plain(x0, grad_logp, eta, n_steps, seed, noise, uniforms, thin):
    """Plain version of both kernels: the same transition, Philox stream and
    carried gradient; returns ``(traj or None, final, accept)``."""
    n, d = x0.shape
    index = torch.arange(n, device=x0.device)
    noise_coef, four_eta = math.sqrt(2.0 * eta), 4.0 * eta
    x = x0
    g, lp = grad_logp(x)
    acc = torch.zeros(n, dtype=torch.float32, device=x0.device)
    kept = []
    for t in range(int(n_steps)):
        eps = noise[t] if noise is not None else philox_normals(index, t, d, seed)
        u = uniforms[t] if uniforms is not None else philox_uniforms(index, t, seed)
        y = x - eta * g + noise_coef * eps
        gy, lpy = grad_logp(y)
        sq_xy = torch.sum(torch.square(x - y + eta * gy), dim=-1)
        sq_yx = torch.sum(torch.square(y - x + eta * g), dim=-1)
        log_ratio = (lpy - lp) + (sq_yx - sq_xy) / four_eta
        alpha = torch.clamp(torch.exp(torch.clamp(log_ratio, -50.0, 50.0)), max=1.0)
        take = u < alpha
        x = torch.where(take[:, None], y, x)
        g = torch.where(take[:, None], gy, g)
        lp = torch.where(take, lpy, lp)
        acc = acc + alpha
        if thin is not None and (t + 1) % thin == 0:
            kept.append(x)
    traj = torch.stack(kept) if thin is not None else None
    return traj, x, acc * (1.0 / int(n_steps))


def _launch(x0, traj, pa, pb, gaussian, inv_var, eta, n_steps, thin, seed, noise, uniforms,
            k):
    n, d = x0.shape
    out = torch.empty_like(x0)
    accept = torch.empty((n,), dtype=torch.float32, device=x0.device)
    seed_lo, seed_hi = _seed_words(seed)
    _build.launch(
        "mixture_mala_chain", _SIGNATURE, x0.device,
        _build.ptr(x0), _build.ptr(out), _build.ptr(accept), _build.ptr(traj), _build.ptr(pa),
        _build.ptr(pb), _build.ptr(noise), _build.ptr(uniforms), n, d, k, gaussian,
        int(n_steps), int(thin), inv_var, eta, math.sqrt(2.0 * eta), 4.0 * eta,
        seed_lo, seed_hi,
    )
    return out, accept


def mixture_mala_chain_plain(x0, means, n_steps, step_size, *, scale=1.0, log_weights=None,
                             precision=None, seed=0, noise=None,
                             uniforms=None) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`mixture_mala_chain`, on ``x0``'s device."""
    grad_logp, *_, eta = _mala_args(x0, means, n_steps, step_size, scale, log_weights,
                                    precision, noise, uniforms, seed)
    _, final, accept = _run_plain(x0, grad_logp, eta, n_steps, seed, noise, uniforms, None)
    return final, accept


def mixture_mala_chain_trajectory_plain(x0, means, n_steps, step_size, *, thin=1, scale=1.0,
                                        log_weights=None, precision=None, seed=0, noise=None,
                                        uniforms=None) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of :func:`mixture_mala_chain_trajectory`."""
    _check_thin(n_steps, thin)
    grad_logp, *_, eta = _mala_args(x0, means, n_steps, step_size, scale, log_weights,
                                    precision, noise, uniforms, seed)
    return _run_plain(x0, grad_logp, eta, n_steps, seed, noise, uniforms, int(thin))


@_build.counted
def mixture_mala_chain(
    x0: Tensor,
    means: Tensor,
    n_steps: int,
    step_size: float,
    *,
    scale: float = 1.0,
    log_weights: Optional[Tensor] = None,
    precision: Optional[Tensor] = None,
    seed: int = 0,
    noise: Optional[Tensor] = None,
    uniforms: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Full n-step MALA chain on a d-dim isotropic Gaussian mixture (or, with
    ``precision``, a full-covariance Gaussian) in one kernel.

    ``x0``: ``(n_chains, d)``; ``means``: ``(K, d)``. Returns ``(samples,
    accept)``: the final state and the per-chain mean acceptance probability.
    """
    grad_logp, pa, pb, gaussian, inv_var, eta = _mala_args(
        x0, means, n_steps, step_size, scale, log_weights, precision, noise, uniforms, seed
    )
    if x0.device.type == "cpu":
        _, final, accept = _run_plain(x0, grad_logp, eta, n_steps, seed, noise, uniforms, None)
        return final, accept
    out = _launch(x0, None, pa, pb, gaussian, inv_var, eta, n_steps, 1, seed, noise, uniforms,
                  means.shape[0])
    mixture_mala_chain.launches += 1
    return out


@_build.counted
def mixture_mala_chain_trajectory(
    x0: Tensor,
    means: Tensor,
    n_steps: int,
    step_size: float,
    *,
    thin: int = 1,
    scale: float = 1.0,
    log_weights: Optional[Tensor] = None,
    precision: Optional[Tensor] = None,
    seed: int = 0,
    noise: Optional[Tensor] = None,
    uniforms: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """:func:`mixture_mala_chain` recording every ``thin``-th post-MH state.

    Returns ``(traj, final, accept)``: ``traj`` ``(n_steps // thin, n_chains,
    d)`` holds the states after transitions ``thin, 2·thin, …``; ``final`` the
    state after all transitions; ``accept`` the per-chain mean acceptance
    probability over the whole run.
    """
    n_kept = _check_thin(n_steps, thin)
    grad_logp, pa, pb, gaussian, inv_var, eta = _mala_args(
        x0, means, n_steps, step_size, scale, log_weights, precision, noise, uniforms, seed
    )
    if x0.device.type == "cpu":
        return _run_plain(x0, grad_logp, eta, n_steps, seed, noise, uniforms, int(thin))
    traj = torch.empty((n_kept, *x0.shape), dtype=torch.float32, device=x0.device)
    out, accept = _launch(x0, traj, pa, pb, gaussian, inv_var, eta, n_steps, thin, seed, noise,
                          uniforms, means.shape[0])
    mixture_mala_chain_trajectory.launches += 1
    return traj, out, accept
