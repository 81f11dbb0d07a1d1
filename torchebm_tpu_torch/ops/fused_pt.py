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
``r·N + c`` and the exchange uniform of pair r from the uniform stream at the
same index and the sweep's number, with N the chain count of the whole batch
(``total_chains``, by default ``n_chains``) and c numbered in it from
``chain_offset``: a launch over chains ``[a, b)`` of a ladder of N chains,
one rank's shard of a ladder sharded on its chain axis, passes
``chain_offset=a`` and ``total_chains=N`` and draws what those chains draw
in the launch over the whole ladder.

The acceptance statistic is the mean accept probability over the pairs tried
in the last sweep, averaged over the real chains (0.0 without a sweep): the
generic loop's ``swap_acceptance_rate``. The JAX kernel averages it per grid
block over padded chains too, and reports 0.0 on its injected path; the port
reports the statistic on both paths.

A launch splits each replica over a group of lanes of one warp, a chain's
replicas side by side, chosen by :func:`pt_launch_plan` from the card's
timings.

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
    dispatch_groups,
    philox_normals,
    philox_uniforms,
)

Tensor = torch.Tensor

__all__ = [
    "MAX_REPLICAS",
    "pt_groups",
    "pt_launch_plan",
    "pt_langevin_chain",
    "pt_langevin_chain_trajectory",
    "pt_langevin_chain_plain",
    "pt_langevin_chain_trajectory_plain",
]

#: the replicas of one chain share a warp, at least one lane each
MAX_REPLICAS = 32

#: the ladder kernel's block size (``kPtThreads`` in csrc/fused_pt.cu)
PT_THREADS = 128

#: ``tebm_pt_langevin_chain``'s argument types before the stream: x0, out, accept,
#: traj, params_a, params_b, ladder, noise, swap_u, n, d, k, gaussian, n_rep,
#: n_steps, swap_every, thin, inv_var, noise_coef, use_clamp, lo, hi, seed lo, seed hi,
#: chain stride, chain offset, group, threads, blocks
_SIGNATURE = ((_build.PTR,) * 9 + (_build.INT,) * 8 + (_build.FLOAT,) * 2
              + (_build.INT, _build.FLOAT, _build.FLOAT) + (_build.U32,) * 2
              + (_build.I64,) * 2 + (_build.INT,) * 3)


def _padded_replicas(n_rep: int) -> int:
    """Rp: the next power of two >= ``n_rep``, the replica groups of a chain."""
    return 1 << (int(n_rep) - 1).bit_length()


def pt_groups(n_rep: int, d: int, k: int, gaussian: bool) -> Tuple[int, ...]:
    """The groups of lanes per replica the ladder kernel is built for on
    ``n_rep`` replicas of a target of ``k`` components (or the
    full-covariance Gaussian) in ``d`` dimensions: the HMC and MALA chains'
    (:func:`.fused_langevin.dispatch_groups`, one dispatch,
    ``TEBM_DISPATCH_GROUPS`` of csrc/tebm_common.cuh) that keep a chain's
    Rp · G lanes in one warp, Rp the next power of two >= ``n_rep``: up to 8
    lanes at R ≤ 4, 4 at R ≤ 8, 2 at R ≤ 16, one lane at R > 16."""
    rp = _padded_replicas(n_rep)
    return tuple(g for g in dispatch_groups(d, k, gaussian) if rp * g <= 32)


def pt_launch_plan(n: int, n_rep: int, d: int, k: int, gaussian: bool,
                   group: Optional[int] = None) -> Tuple[int, int, int]:
    """``(group, threads, blocks)`` of one ladder launch over ``n`` chains
    of ``n_rep`` replicas in ``d`` dimensions with ``k`` components:
    ``group`` lanes of one warp hold a replica (a chain's Rp · group lanes
    side by side, Rp the next power of two >= ``n_rep``), ``threads`` per
    block, ``blocks`` in the grid.

    The rule follows the card's timings of every built group
    (``chip_smoke.py``'s PT plan sweep, H100): 2 lanes per replica, which
    beat 1 and 4 at the ring (K = 8, every R from 2 to 16, swapping every
    step or every 5, 10,000 to 300,000 chains), at d = 3 and 8 and on the
    full-covariance Gaussian up to d = 8; 4 where the components outgrow two
    lanes but fill four: the mixture at d ≤ 2 with 8 < K ≤ 16 (4 per lane
    in registers, ``NJ`` of the dispatch; at K ≥ 24 two lanes win again) and
    at d > 8 with K ≥ 8; 1 for the full-covariance Gaussian above d = 8,
    whose evaluation every lane repeats. At most what the warp holds
    (:func:`pt_groups`). Unlike the MALA and HMC plans the group is not
    halved at large ``n``: at 100,000 chains on the ring with K = 16, 4
    lanes (1.6M threads) still beat 2. The sweep's exception, where another
    group beats the pick: the full-covariance Gaussian at d = 2, where one
    lane led by 1.3% and 4.9% in two runs and two lanes led in a third. One
    component and ``d > MIXTURE_GROUP_MAX_DIM`` take one lane. ``group=``
    overrides the choice with a group of :func:`pt_groups` (timings compare
    them). The block is :data:`PT_THREADS`."""
    built = pt_groups(n_rep, d, k, gaussian)
    if built == (1,):
        pick = 1
    elif gaussian:
        pick = 2 if d <= 8 else 1
    else:
        pick = 4 if (d <= 2 and 8 < k <= 16) or (d > 8 and k >= 8) else 2
    pick = min(pick, max(built))
    if group is None:
        group = pick
    elif group not in built:
        raise ValueError(f"no ladder kernel at group {group} for R={n_rep}, d={d}, K={k}, "
                         f"gaussian={bool(gaussian)}")
    return group, PT_THREADS, -(-n * _padded_replicas(n_rep) * group // PT_THREADS)


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
               noise, swap_uniform, thin, chain_offset=0, total_chains=None):
    """Plain version of both kernels: the same steps, exchange rule, Philox
    counters (replica r's chains at ``r·total_chains``, numbered from
    ``chain_offset``) and carried gradient; returns ``(traj or None, ladder,
    per-chain acceptance of the last sweep)``."""
    n_rep, n, d = replicas.shape
    dev = replicas.device
    hb, db = ladder[:n_rep].view(n_rep, 1, 1), ladder[n_rep:]
    stride = n if total_chains is None else total_chains
    chain = torch.arange(n, device=dev) + chain_offset
    index = (torch.arange(n_rep, device=dev)[:, None] * stride + chain).reshape(-1)

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
                     else philox_uniforms(r * stride + chain, s, seed))
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
            thin, seed, clamp, noise, swap_uniform, k, plan, chain_offset, total_chains):
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
        inv_var, noise_coef, use_clamp, lo, hi, seed_lo, seed_hi, total_chains, chain_offset,
        *plan,
    )
    return out, accept


def _chain_range(chain_offset: int, total_chains: Optional[int], n: int) -> Tuple[int, int]:
    """``(chain_offset, total_chains)`` checked: the launch's ``n`` chains
    lie within the whole batch's ``total_chains`` (by default ``n``), whose
    last Philox index fits the counter's 64 bits."""
    chain_offset = int(chain_offset)
    total = n if total_chains is None else int(total_chains)
    if not (0 <= chain_offset and chain_offset + n <= total
            and MAX_REPLICAS * total < 1 << 63):
        raise ValueError(f"chains [{chain_offset}, {chain_offset + n}) do not lie in a batch of "
                         f"total_chains={total}")
    return chain_offset, total


def _run(replicas, means, n_steps, step_size, noise_scale, betas, swap_every, thin, *, scale,
         log_weights, precision, seed, clamp, noise, swap_uniform, kernel, group=None,
         chain_offset=0, total_chains=None):
    """Both wrappers and both plain versions: ``(traj or None, ladder,
    per-chain acceptance)`` from the kernel (``kernel`` True and a CUDA
    ``replicas``, with :func:`pt_launch_plan`, whose group ``group``
    overrides) or the plain version."""
    grad_logp, pa, pb, gaussian, inv_var, ladder, noise_coef = _pt_args(
        replicas, means, n_steps, step_size, noise_scale, betas, swap_every, scale,
        log_weights, precision, seed, noise, swap_uniform)
    chain_offset, total_chains = _chain_range(chain_offset, total_chains, replicas.shape[1])
    if not kernel or replicas.device.type == "cpu":
        return _run_plain(replicas, grad_logp, ladder, noise_coef, n_steps, int(swap_every), seed,
                          clamp, noise, swap_uniform, thin, chain_offset, total_chains)
    n_rep, n, d = replicas.shape
    plan = pt_launch_plan(n, n_rep, d, means.shape[0], bool(gaussian), group)
    traj = None
    if thin is not None:
        traj = torch.empty((int(n_steps) // thin, *replicas.shape[1:]), dtype=torch.float32,
                           device=replicas.device)
    out, accept = _launch(replicas, traj, pa, pb, gaussian, inv_var, ladder, noise_coef, n_steps,
                          swap_every, thin or 1, seed, clamp, noise, swap_uniform,
                          means.shape[0], plan, chain_offset, total_chains)
    return traj, out, accept


def pt_langevin_chain_plain(replicas, means, n_steps, step_size, noise_scale, betas, swap_every,
                            *, scale=1.0, log_weights=None, precision=None, seed=0, clamp=None,
                            noise=None, swap_uniform=None, chain_offset=0,
                            total_chains=None) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`pt_langevin_chain`, on ``replicas``' device."""
    _, ladder, acc = _run(replicas, means, n_steps, step_size, noise_scale, betas, swap_every,
                          None, scale=scale, log_weights=log_weights, precision=precision,
                          seed=seed, clamp=clamp, noise=noise, swap_uniform=swap_uniform,
                          kernel=False, chain_offset=chain_offset, total_chains=total_chains)
    return ladder, acc.mean()


def pt_langevin_chain_trajectory_plain(replicas, means, n_steps, step_size, noise_scale, betas,
                                       swap_every, *, thin=1, scale=1.0, log_weights=None,
                                       precision=None, seed=0, clamp=None, noise=None,
                                       swap_uniform=None, chain_offset=0,
                                       total_chains=None) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of :func:`pt_langevin_chain_trajectory`."""
    _check_thin(n_steps, thin)
    traj, ladder, acc = _run(replicas, means, n_steps, step_size, noise_scale, betas,
                             swap_every, int(thin), scale=scale, log_weights=log_weights,
                             precision=precision, seed=seed, clamp=clamp, noise=noise,
                             swap_uniform=swap_uniform, kernel=False, chain_offset=chain_offset,
                             total_chains=total_chains)
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
    chain_offset: int = 0,
    total_chains: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Full n-step parallel-tempered Langevin ladder in one kernel.

    ``replicas``: ``(R, n_chains, d)``, replica 0 cold; ``betas``: the R
    inverse temperatures; ``means``: ``(K, d)``. Returns ``(ladder, acc)``:
    the final ``(R, n_chains, d)`` ladder and the 0-d mean accept probability
    of the last sweep over the real chains. ``chain_offset`` and
    ``total_chains``: these chains' place in a whole batch of
    ``total_chains`` (module docstring); injected ``noise`` and
    ``swap_uniform`` ignore them.
    """
    _, ladder, acc = _run(replicas, means, n_steps, step_size, noise_scale, betas, swap_every,
                          None, scale=scale, log_weights=log_weights, precision=precision,
                          seed=seed, clamp=clamp, noise=noise, swap_uniform=swap_uniform,
                          kernel=True, chain_offset=chain_offset, total_chains=total_chains)
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
    chain_offset: int = 0,
    total_chains: Optional[int] = None,
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
                             swap_uniform=swap_uniform, kernel=True, chain_offset=chain_offset,
                             total_chains=total_chains)
    if replicas.device.type == "cuda":
        pt_langevin_chain_trajectory.launches += 1
    return traj, ladder, acc.mean()
