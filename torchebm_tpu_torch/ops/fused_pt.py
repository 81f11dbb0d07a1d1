r"""Whole-ladder parallel-tempering kernels: wrappers, plain versions, launch counts.

PyTorch counterpart of :mod:`torchebm_tpu.ops.fused_pt`. Each wrapper runs an
entire n-step replica-exchange Langevin ladder, replica :math:`r` at inverse
temperature :math:`\beta_r`,

.. math::
    x^{(r)}_{t+1} = \mathrm{clip}\big(x^{(r)}_t - \eta\,\beta_r \nabla U(x^{(r)}_t)
    + \text{noise\_scale}\cdot\sqrt{2\eta}\,\varepsilon_t\big),

with an exchange sweep after every ``swap_every``-th step: adjacent pairs
``(r, r+1)`` with ``r % 2 == sweep % 2`` (the single pair every sweep for
R = 2) exchange states with probability
:math:`\min(1, e^{\,\text{clip}((\beta_r-\beta_{r+1})(\log p_{r+1}-\log p_r),\ \pm 50)})`.
It runs in one launch of a hand-written CUDA kernel (``csrc/fused_pt.cu``)
when ``replicas`` lies on a CUDA device, and in its plain PyTorch version when
it lies on the CPU; any other device raises. The target is that of
:mod:`.fused_langevin` (isotropic mixture, or ``precision=``), with at most
:data:`MAX_REPLICAS` replicas (one warp's lanes per chain).

``noise`` (``(n_steps, R, n_chains, d)``) and ``swap_uniform``
(``(n_sweeps, R-1, n_chains)``) are injected together or not at all; without
them the normals of replica r, chain c come from the Philox stream at index
``r·n_chains + c`` and the exchange uniform of pair r from the uniform stream
at the same index and the sweep's number.

The acceptance statistic is the mean accept probability over the pairs tried
in the last sweep, averaged over the real chains (0.0 without a sweep): the
generic loop's ``swap_acceptance_rate``. The JAX kernel averages it per grid
block over padded chains too, and reports 0.0 on its injected path; the port
reports the statistic on both paths.

Every wrapper carries an integer ``launches`` attribute, raised by one each
time it launches its kernel (never on the plain path); ``ops.launch_counts``
reads them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .fused_langevin import (
    _check_tensor,
    _check_thin,
    _clamp_args,
    _seed_words,
    _target,
    philox_normals,
    philox_uniforms,
)

Tensor = torch.Tensor

__all__ = [
    "MAX_REPLICAS",
    "pt_langevin_chain",
    "pt_langevin_chain_trajectory",
    "pt_langevin_chain_plain",
    "pt_langevin_chain_trajectory_plain",
]

#: the replicas of one chain share a warp, one lane each
MAX_REPLICAS = 32

#: ``tebm_pt_langevin_chain``'s argument types before the stream: x0, out, accept,
#: traj, params_a, params_b, ladder, noise, swap_u, n, d, k, gaussian, n_rep,
#: n_steps, swap_every, thin, inv_var, noise_coef, use_clamp, lo, hi, seed lo, seed hi
_SIGNATURE = ((_build.PTR,) * 9 + (_build.INT,) * 8 + (_build.FLOAT,) * 2
              + (_build.INT, _build.FLOAT, _build.FLOAT) + (_build.U32,) * 2)


def _pt_args(replicas, means, n_steps, step_size, noise_scale, betas, swap_every, scale,
             log_weights, precision, seed, noise, swap_uniform):
    """Validate; return ``(grad_logp, params_a, params_b, gaussian, inv_var,
    ladder, noise_coef)``. ``ladder`` holds ``[η·β_r; β_r − β_{r+1}]``, each
    computed in double precision and rounded once to float32, as the JAX
    kernel bakes them."""
    _check_tensor("replicas", replicas, replicas.device)
    if replicas.device.type not in ("cpu", "cuda"):
        raise ValueError(f"replicas is on {replicas.device}: only CPU (plain) and CUDA (kernel) run")
    if replicas.ndim != 3:
        raise ValueError(f"replicas must have shape (R, n_chains, d), got {tuple(replicas.shape)}")
    n_rep, n, d = replicas.shape
    betas = tuple(float(b) for b in betas)
    if len(betas) != n_rep:
        raise ValueError(f"betas has {len(betas)} entries for {n_rep} replicas")
    if n_rep < 2:
        raise ValueError("parallel tempering needs >= 2 replicas")
    if n_rep > MAX_REPLICAS:
        raise ValueError(f"the ladder kernel holds at most {MAX_REPLICAS} replicas, got {n_rep}")
    if int(swap_every) < 1:
        raise ValueError("swap_every must be >= 1")
    if int(n_steps) < 1:
        raise ValueError("n_steps must be >= 1")
    if n < 1:
        raise ValueError("replicas must hold at least one chain")
    if (noise is None) != (swap_uniform is None):
        raise ValueError("pass both noise= and swap_uniform=, or neither")
    if noise is not None:
        _check_tensor("noise", noise, replicas.device, (int(n_steps), n_rep, n, d))
        n_sweeps = int(n_steps) // int(swap_every)
        _check_tensor("swap_uniform", swap_uniform, replicas.device, (n_sweeps, n_rep - 1, n))
    grad_logp, pa, pb, gaussian, inv_var = _target(replicas[0], means, scale, log_weights,
                                                   precision)
    eta = float(step_size)
    ladder = torch.tensor([eta * b for b in betas] + [a - b for a, b in zip(betas, betas[1:])],
                          dtype=torch.float32, device=replicas.device)
    _seed_words(seed)
    return (grad_logp, pa, pb, gaussian, inv_var, ladder,
            float(noise_scale) * math.sqrt(2.0 * eta))


def _run_plain(replicas, grad_logp, ladder, noise_coef, n_steps, swap_every, seed, clamp,
               noise, swap_uniform, thin):
    """Plain version of both kernels: the same steps, exchange rule, Philox
    counters and carried gradient; returns ``(traj or None, ladder, per-chain
    acceptance of the last sweep)``."""
    n_rep, n, d = replicas.shape
    dev = replicas.device
    hb, db = ladder[:n_rep].view(n_rep, 1, 1), ladder[n_rep:]
    index = torch.arange(n_rep * n, device=dev)
    chain = torch.arange(n, device=dev)

    def evaluate(x):
        g, lp = grad_logp(x.reshape(n_rep * n, d))
        return g.view(n_rep, n, d), lp.view(n_rep, n)

    x = replicas
    g, lp = evaluate(x)
    acc = torch.zeros(n, dtype=torch.float32, device=dev)
    kept = []
    for t in range(int(n_steps)):
        eps = noise[t] if noise is not None else (
            philox_normals(index, t, d, seed).view(n_rep, n, d))
        x = x - hb * g + noise_coef * eps
        if clamp is not None:
            x = torch.clamp(x, clamp[0], clamp[1])
        g, lp = evaluate(x)
        if (t + 1) % swap_every == 0:
            s = t // swap_every
            phase = s % 2 if n_rep > 2 else 0
            xs, gs, lps = list(x), list(g), list(lp)
            p_sum, n_pairs = torch.zeros(n, dtype=torch.float32, device=dev), 0
            for r in range(phase, n_rep - 1, 2):
                delta = db[r] * (lps[r + 1] - lps[r])
                p = torch.clamp(torch.exp(torch.clamp(delta, -50.0, 50.0)), max=1.0)
                u = (swap_uniform[s, r] if swap_uniform is not None
                     else philox_uniforms(r * n + chain, s, seed))
                take = u < p
                for v in (xs, gs):
                    lo, hi = v[r], v[r + 1]
                    v[r], v[r + 1] = (torch.where(take[:, None], hi, lo),
                                      torch.where(take[:, None], lo, hi))
                lps[r], lps[r + 1] = (torch.where(take, lps[r + 1], lps[r]),
                                      torch.where(take, lps[r], lps[r + 1]))
                p_sum, n_pairs = p_sum + p, n_pairs + 1
            x, g, lp = torch.stack(xs), torch.stack(gs), torch.stack(lps)
            acc = p_sum / float(n_pairs)
        if thin is not None and (t + 1) % thin == 0:
            kept.append(x[0])
    traj = torch.stack(kept) if thin is not None else None
    return traj, x, acc


def _launch(replicas, traj, pa, pb, gaussian, inv_var, ladder, noise_coef, n_steps, swap_every,
            thin, seed, clamp, noise, swap_uniform, k):
    n_rep, n, d = replicas.shape
    out = torch.empty_like(replicas)
    accept = torch.empty((n,), dtype=torch.float32, device=replicas.device)
    seed_lo, seed_hi = _seed_words(seed)
    use_clamp, lo, hi = _clamp_args(clamp)
    p = _build.ptr
    _build.launch(
        "pt_langevin_chain", _SIGNATURE, replicas.device,
        p(replicas), p(out), p(accept), p(traj), p(pa), p(pb), p(ladder), p(noise),
        p(swap_uniform), n, d, k, gaussian, n_rep, int(n_steps), int(swap_every), int(thin),
        inv_var, noise_coef, use_clamp, lo, hi, seed_lo, seed_hi,
    )
    return out, accept


def _run(replicas, means, n_steps, step_size, noise_scale, betas, swap_every, thin, *, scale,
         log_weights, precision, seed, clamp, noise, swap_uniform, kernel):
    """Both wrappers and both plain versions: ``(traj or None, ladder,
    per-chain acceptance)`` from the kernel (``kernel`` True and a CUDA
    ``replicas``) or the plain version."""
    grad_logp, pa, pb, gaussian, inv_var, ladder, noise_coef = _pt_args(
        replicas, means, n_steps, step_size, noise_scale, betas, swap_every, scale,
        log_weights, precision, seed, noise, swap_uniform)
    if not kernel or replicas.device.type == "cpu":
        return _run_plain(replicas, grad_logp, ladder, noise_coef, n_steps, int(swap_every), seed,
                          clamp, noise, swap_uniform, thin)
    traj = None
    if thin is not None:
        traj = torch.empty((int(n_steps) // thin, *replicas.shape[1:]), dtype=torch.float32,
                           device=replicas.device)
    out, accept = _launch(replicas, traj, pa, pb, gaussian, inv_var, ladder, noise_coef, n_steps,
                          swap_every, thin or 1, seed, clamp, noise, swap_uniform,
                          means.shape[0])
    return traj, out, accept


def pt_langevin_chain_plain(replicas, means, n_steps, step_size, noise_scale, betas, swap_every,
                            *, scale=1.0, log_weights=None, precision=None, seed=0, clamp=None,
                            noise=None, swap_uniform=None) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`pt_langevin_chain`, on ``replicas``' device."""
    _, ladder, acc = _run(replicas, means, n_steps, step_size, noise_scale, betas, swap_every,
                          None, scale=scale, log_weights=log_weights, precision=precision,
                          seed=seed, clamp=clamp, noise=noise, swap_uniform=swap_uniform,
                          kernel=False)
    return ladder, acc.mean()


def pt_langevin_chain_trajectory_plain(replicas, means, n_steps, step_size, noise_scale, betas,
                                       swap_every, *, thin=1, scale=1.0, log_weights=None,
                                       precision=None, seed=0, clamp=None, noise=None,
                                       swap_uniform=None) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of :func:`pt_langevin_chain_trajectory`."""
    _check_thin(n_steps, thin)
    traj, ladder, acc = _run(replicas, means, n_steps, step_size, noise_scale, betas,
                             swap_every, int(thin), scale=scale, log_weights=log_weights,
                             precision=precision, seed=seed, clamp=clamp, noise=noise,
                             swap_uniform=swap_uniform, kernel=False)
    return traj, ladder, acc.mean()


@_build.counted
def pt_langevin_chain(
    replicas: Tensor,
    means: Tensor,
    n_steps: int,
    step_size: float,
    noise_scale: float,
    betas: Sequence[float],
    swap_every: int,
    *,
    scale: float = 1.0,
    log_weights: Optional[Tensor] = None,
    precision: Optional[Tensor] = None,
    seed: int = 0,
    clamp: Optional[Tuple[float, float]] = None,
    noise: Optional[Tensor] = None,
    swap_uniform: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Full n-step parallel-tempered Langevin ladder in one kernel.

    ``replicas``: ``(R, n_chains, d)``, replica 0 cold; ``betas``: the R
    inverse temperatures; ``means``: ``(K, d)``. Returns ``(ladder, acc)``:
    the final ``(R, n_chains, d)`` ladder and the 0-d mean accept probability
    of the last sweep over the real chains.
    """
    _, ladder, acc = _run(replicas, means, n_steps, step_size, noise_scale, betas, swap_every,
                          None, scale=scale, log_weights=log_weights, precision=precision,
                          seed=seed, clamp=clamp, noise=noise, swap_uniform=swap_uniform,
                          kernel=True)
    if replicas.device.type == "cuda":
        pt_langevin_chain.launches += 1
    return ladder, acc.mean()


@_build.counted
def pt_langevin_chain_trajectory(
    replicas: Tensor,
    means: Tensor,
    n_steps: int,
    step_size: float,
    noise_scale: float,
    betas: Sequence[float],
    swap_every: int,
    *,
    thin: int = 1,
    scale: float = 1.0,
    log_weights: Optional[Tensor] = None,
    precision: Optional[Tensor] = None,
    seed: int = 0,
    clamp: Optional[Tuple[float, float]] = None,
    noise: Optional[Tensor] = None,
    swap_uniform: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """:func:`pt_langevin_chain` recording every ``thin``-th cold state.

    Returns ``(traj, ladder, acc)``: ``traj`` ``(n_steps // thin, n_chains,
    d)`` holds replica 0 after steps ``thin, 2·thin, …``, after the exchange
    on exchange steps; ``ladder`` and ``acc`` as :func:`pt_langevin_chain`.
    """
    _check_thin(n_steps, thin)
    traj, ladder, acc = _run(replicas, means, n_steps, step_size, noise_scale, betas,
                             swap_every, int(thin), scale=scale, log_weights=log_weights,
                             precision=precision, seed=seed, clamp=clamp, noise=noise,
                             swap_uniform=swap_uniform, kernel=True)
    if replicas.device.type == "cuda":
        pt_langevin_chain_trajectory.launches += 1
    return traj, ladder, acc.mean()
