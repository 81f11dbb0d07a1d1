r"""Whole-run annealed importance sampling kernel: wrapper, plain version, launch count.

PyTorch counterpart of :mod:`torchebm_tpu.ops.fused_ais`. The wrapper runs an
entire AIS anneal along :math:`E_\beta = (1-\beta)E_0 + \beta E_1`,
:math:`0 = \beta_0 < \dots < \beta_K = 1`: at each rung the weight update

.. math::
    \log w \mathrel{+}= (\beta - \beta_{\text{prev}})
    \big(\log p_1(x) - \log p_0(x) - \text{log\_norm\_t}\big),

then ``n_transitions`` MALA steps invariant for :math:`e^{-E_\beta}`, in one
launch of a hand-written CUDA kernel (``csrc/fused_ais.cu``) when ``x0`` lies
on a CUDA device, and in its plain PyTorch version when ``x0`` lies on the CPU;
any other device raises. The base is the isotropic Gaussian
:math:`N(\mu_0, \sigma_0^2 I)`; the target that of :mod:`.fused_mala`
(isotropic mixture, or ``precision=``). :math:`\log p_0`, :math:`\log p_1` are
the evaluators' unnormalised log-densities (:math:`-E_0` exactly for the
base); ``log_norm_t`` is the constant the target's energy holds beyond
:math:`-\log p_1`. By default it follows the JAX kernel:
:math:`d\log\sigma + \tfrac d2\log 2\pi` for the mixture form (the
normalised :class:`GaussianMixtureEnergy`) and 0 for ``precision=``. A caller
whose isotropic target is an unnormalised Gaussian energy passes 0, as
:func:`torchebm_tpu_torch.samplers.annealed_importance_sampling` does; the
JAX sampler does not, and its kernel path is biased by
:math:`-\text{log\_norm\_t}` there.

The β table lives in device memory: schedules of any length run in one
launch (the JAX kernel's SMEM table stops at 60,000 rungs).

``noise`` (``(n_rungs·n_transitions, n_chains, d)``) and ``uniforms``
(``(n_rungs·n_transitions, n_chains)``) are injected together or not at all;
without them both come from the Philox stream at ``(chain, rung·n_transitions
+ j)``, keyed by ``seed``: a Python int, or a 0-d int64 tensor on the state's
device that the kernel reads where it lies (no host sync); the chains are
numbered from ``chain_offset`` (a block of a batch split over processes
passes its first chain). A launch splits
each chain over a group of lanes of one warp, chosen by
:func:`ais_launch_plan` from the card's timings. The wrapper's ``launches``
attribute counts its kernel launches.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build
from .fused_langevin import (
    MIXTURE_RESIDENT_THREADS,
    _chain_offset,
    _check_metropolis,
    _check_tensor,
    _seed_arg,
    _target,
    dispatch_groups,
    philox_normals,
    philox_uniforms,
)

Tensor = torch.Tensor

__all__ = ["ais_groups", "ais_launch_plan", "mixture_ais_run", "mixture_ais_run_plain"]

#: ``tebm_mixture_ais_run``'s argument types before the stream: x0, out, logw,
#: accept, base_mean, params_a, params_b, betas, noise, uniforms, seed, n, d,
#: k, gaussian, n_rungs, n_transitions, inv_var0, inv_var, eta, noise_coef,
#: four_eta, log_norm_t, seed lo, seed hi, chain offset, group, threads, blocks
_SIGNATURE = ((_build.PTR,) * 11 + (_build.INT,) * 6 + (_build.FLOAT,) * 6 + (_build.U32,) * 2
              + (_build.INT,) * 4)

#: the AIS kernel's block size (``kAisThreads`` in csrc/fused_ais.cu)
AIS_THREADS = 128
#: the threads (lanes of all chains) up to which :func:`ais_launch_plan`
#: doubles the group: about 7.75 warps per SM of an H100
AIS_SPLIT_THREADS = 1 << 15


def _isotropic_grad_logp(x: Tensor, mean: Tensor, inv_var: float) -> Tuple[Tensor, Tensor]:
    """Energy gradient ``(x − μ)/σ²`` and log-density ``−|x − μ|²/(2σ²)`` of
    the isotropic Gaussian base in closed form: the one-component mixture
    evaluator's function (a one-term softmax weight is 1, a one-term
    logsumexp its term)."""
    diff = x - mean
    return diff * inv_var, -0.5 * inv_var * torch.sum(diff * diff, dim=-1)


def _ais_args(x0, base_mean, base_scale, means, betas, step_size, n_transitions, scale,
              log_weights, precision, seed, noise, uniforms, log_norm_t):
    """Validate; return ``(base_logp, target_logp, params_a, params_b,
    gaussian, inv_var0, inv_var, betas, eta, log_norm_t)``."""
    if not isinstance(betas, Tensor):
        betas = torch.as_tensor(betas, dtype=torch.float32, device=x0.device)
    if betas.ndim != 1 or betas.shape[0] < 2:
        raise ValueError("betas must be a 1D schedule with at least 2 entries")
    _check_tensor("betas", betas, x0.device)
    n_tr = int(n_transitions)
    if n_tr < 1:
        raise ValueError("n_transitions must be >= 1")
    _check_metropolis(x0, (betas.shape[0] - 1) * n_tr, noise, uniforms)
    target_logp, pa, pb, gaussian, inv_var = _target(x0, means, scale, log_weights, precision)
    d = x0.shape[1]
    _check_tensor("base_mean", base_mean, x0.device, (d,))
    inv_var0 = 1.0 / float(base_scale) ** 2
    eta = float(step_size)
    if not eta > 0.0:
        raise ValueError(f"step_size must be > 0, got {eta}")
    if log_norm_t is None:
        log_norm_t = (0.0 if precision is not None
                      else d * math.log(float(scale)) + 0.5 * d * math.log(2 * math.pi))
    _seed_arg(seed, x0.device)
    return ((lambda x: _isotropic_grad_logp(x, base_mean, inv_var0)), target_logp, pa, pb,
            gaussian, inv_var0, inv_var, betas, eta, float(log_norm_t))


def _run_plain(x0, base_logp, target_logp, betas, eta, n_transitions, log_norm_t, seed, noise,
               uniforms, chain_offset=0):
    """Plain version of the kernel: the same rung loop, Philox counters
    (chains numbered from ``chain_offset``) and carried endpoint gradients and
    log-densities; ``(samples, logw, accept)``."""
    n, d = x0.shape
    seed = int(seed)
    index = torch.arange(n, device=x0.device) + chain_offset
    noise_coef, four_eta = math.sqrt(2.0 * eta), 4.0 * eta
    x = x0
    g0, lp0 = base_logp(x)
    gt, lpt = target_logp(x)
    logw = torch.zeros(n, dtype=torch.float32, device=x0.device)
    acc = torch.zeros(n, dtype=torch.float32, device=x0.device)
    n_rungs = betas.shape[0] - 1
    for rung in range(n_rungs):
        bp, b = betas[rung], betas[rung + 1]
        logw = logw + (b - bp) * (lpt - lp0 - log_norm_t)
        one_m = 1.0 - b
        for j in range(n_transitions):
            t = rung * n_transitions + j
            eps = noise[t] if noise is not None else philox_normals(index, t, d, seed)
            u = uniforms[t] if uniforms is not None else philox_uniforms(index, t, seed)
            gx = one_m * g0 + b * gt
            y = x - eta * gx + noise_coef * eps
            g0y, lp0y = base_logp(y)
            gty, lpty = target_logp(y)
            gy = one_m * g0y + b * gty
            lpx = one_m * lp0 + b * lpt
            lpy = one_m * lp0y + b * lpty
            sq_xy = torch.sum(torch.square(x - y + eta * gy), dim=-1)
            sq_yx = torch.sum(torch.square(y - x + eta * gx), dim=-1)
            log_ratio = (lpy - lpx) + (sq_yx - sq_xy) / four_eta
            alpha = torch.clamp(torch.exp(torch.clamp(log_ratio, -50.0, 50.0)), max=1.0)
            take = u < alpha
            x = torch.where(take[:, None], y, x)
            g0 = torch.where(take[:, None], g0y, g0)
            gt = torch.where(take[:, None], gty, gt)
            lp0 = torch.where(take, lp0y, lp0)
            lpt = torch.where(take, lpty, lpt)
            acc = acc + alpha
    return x, logw, acc * (1.0 / (n_rungs * n_transitions))


def ais_groups(d: int, k: int, gaussian: bool) -> Tuple[int, ...]:
    """The groups of lanes per chain the AIS kernel is built for on a target
    of ``k`` components (or the full-covariance Gaussian) in ``d``
    dimensions: the shared dispatch's (:func:`.fused_langevin.dispatch_groups`),
    1, 2, 4 and 8 up to ``MIXTURE_GROUP_MAX_DIM`` and one lane above it,
    with a one-component mixture (the isotropic Gaussian target) split over
    lanes too: they share the two Philox blocks of a transition, drawn
    ahead."""
    return dispatch_groups(d, k, gaussian, split_one_component=True)


def ais_launch_plan(n: int, d: int, k: int, gaussian: bool,
                    group: Optional[int] = None) -> Tuple[int, int, int]:
    """``(group, threads, blocks)`` of one AIS launch over ``n`` chains in
    ``d`` dimensions with ``k`` components: ``group`` lanes of one warp hold
    a chain, ``threads`` per block, ``blocks`` in the grid.

    The rule follows the card's timings of every built group
    (``chip_smoke.py``'s AIS plan sweep, H100): a mixture starts at 2 lanes
    (4 at d ≤ 2 with more than 8 components, which 4 lanes hold in
    registers, 4 each), the full-covariance Gaussian and a one-component
    mixture at 1; the group is then doubled, up to 8, while the chains'
    lanes stay within :data:`AIS_SPLIT_THREADS`: below it more lanes hide
    the latency of a transition (at 16,384 chains two lanes beat one by 2.5×
    on the ring and by 20% on the Gaussians), above it the work every lane
    repeats (the base, the blend, the Metropolis test; the whole Gaussian)
    costs more than they hide (at 65,536 chains one lane beats two by 30% on
    the Gaussians, and at 16,384 two beat four by 20% on the ring). A
    mixture's group is halved while ``n * group`` exceeds the threads the
    card holds at once (:data:`.fused_langevin.MIXTURE_RESIDENT_THREADS`),
    down to 2, which beat one lane at 100,000 and 300,000 chains. The
    sweep's exceptions, where another group beats the pick by 0.1–2.5%: 4
    lanes, not 8, at 4,096 chains (the ring, K = 16, both Gaussians) and at
    8,192 (the ring), 4 not 2 at d = 3 and 4 with K = 8. One lane above
    ``MIXTURE_GROUP_MAX_DIM``. ``group=`` overrides the choice with a group
    of :func:`ais_groups` (timings compare them). The block is
    :data:`AIS_THREADS`."""
    built = ais_groups(d, k, gaussian)
    if built == (1,):
        pick = 1
    else:
        pick = 1 if gaussian or k < 2 else 4 if d <= 2 and k > 8 else 2
        while pick < 8 and n * pick * 2 <= AIS_SPLIT_THREADS:
            pick *= 2
        while pick > 2 and n * pick > MIXTURE_RESIDENT_THREADS:
            pick //= 2
    if group is None:
        group = pick
    elif group not in built:
        raise ValueError(f"no AIS kernel at group {group} for d={d}, K={k}, "
                         f"gaussian={bool(gaussian)}")
    return group, AIS_THREADS, -(-n * group // AIS_THREADS)


def mixture_ais_run_plain(x0, base_mean, base_scale, means, betas, step_size, *,
                          n_transitions=1, scale=1.0, log_weights=None, precision=None, seed=0,
                          noise=None, uniforms=None, log_norm_t=None,
                          chain_offset=0) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of :func:`mixture_ais_run`, on ``x0``'s device."""
    base_logp, target_logp, *_, betas, eta, log_norm_t = _ais_args(
        x0, base_mean, base_scale, means, betas, step_size, n_transitions, scale, log_weights,
        precision, seed, noise, uniforms, log_norm_t)
    return _run_plain(x0, base_logp, target_logp, betas, eta, int(n_transitions), log_norm_t,
                      seed, noise, uniforms, _chain_offset(chain_offset, x0.shape[0], 31))


def _run(x0, base_mean, base_scale, means, betas, step_size, *, n_transitions=1, scale=1.0,
         log_weights=None, precision=None, seed=0, noise=None, uniforms=None, log_norm_t=None,
         group=None, chain_offset=0):
    """The wrapper's body: ``(samples, logw, accept, launched)``. A CPU
    ``x0`` runs the plain version; a CUDA ``x0`` launches the kernel with
    :func:`ais_launch_plan`, whose group ``group`` overrides."""
    base_logp, target_logp, pa, pb, gaussian, inv_var0, inv_var, betas, eta, log_norm_t = (
        _ais_args(x0, base_mean, base_scale, means, betas, step_size, n_transitions, scale,
                  log_weights, precision, seed, noise, uniforms, log_norm_t))
    n_tr = int(n_transitions)
    chain_offset = _chain_offset(chain_offset, x0.shape[0], 31)
    if x0.device.type == "cpu":
        return (*_run_plain(x0, base_logp, target_logp, betas, eta, n_tr, log_norm_t, seed,
                            noise, uniforms, chain_offset), False)
    n, d = x0.shape
    k = means.shape[0]
    plan = ais_launch_plan(n, d, k, bool(gaussian), group)
    out = torch.empty_like(x0)
    logw = torch.empty((n,), dtype=torch.float32, device=x0.device)
    accept = torch.empty((n,), dtype=torch.float32, device=x0.device)
    seed_t, seed_lo, seed_hi = _seed_arg(seed, x0.device)
    p = _build.ptr
    _build.launch(
        "mixture_ais_run", _SIGNATURE, x0.device,
        p(x0), p(out), p(logw), p(accept), p(base_mean), p(pa), p(pb), p(betas), p(noise),
        p(uniforms), p(seed_t), n, d, k, gaussian, betas.shape[0] - 1, n_tr, inv_var0,
        inv_var, eta, math.sqrt(2.0 * eta), 4.0 * eta, log_norm_t, seed_lo, seed_hi,
        chain_offset, *plan,
    )
    return out, logw, accept, True


@_build.counted
def mixture_ais_run(
    x0: Tensor,
    base_mean: Tensor,
    base_scale: float,
    means: Tensor,
    betas,
    step_size: float,
    *,
    n_transitions: int = 1,
    scale: float = 1.0,
    log_weights: Optional[Tensor] = None,
    precision: Optional[Tensor] = None,
    seed=0,
    noise: Optional[Tensor] = None,
    uniforms: Optional[Tensor] = None,
    log_norm_t: Optional[float] = None,
    chain_offset: int = 0,
) -> Tuple[Tensor, Tensor, Tensor]:
    r"""Full AIS anneal in one kernel.

    ``x0``: ``(n_chains, d)`` exact base draws; ``base_mean`` ``(d,)`` and the
    scalar ``base_scale``: the base :math:`N(\mu_0, \sigma_0^2 I)`;
    ``means`` with (``scale``, ``log_weights`` | ``precision``): the target;
    ``betas``: the ``(K+1,)`` schedule from 0 to 1; ``seed``: a Python int or
    a 0-d int64 tensor on ``x0``'s device. Returns ``(samples, log_weights,
    accept)`` per chain; ``logsumexp(log_weights) − log n`` estimates
    :math:`\log Z_1 / Z_0`. ``chain_offset``: the first chain's Philox index,
    so that a launch over chains ``[a, b)`` of a batch at ``chain_offset=a``
    draws what those chains draw in the launch over the whole batch
    (``chain_offset + n_chains`` below 2^31, the chains a launch can hold);
    injected ``noise`` and ``uniforms`` ignore it.
    """
    out, logw, accept, launched = _run(
        x0, base_mean, base_scale, means, betas, step_size, n_transitions=n_transitions,
        scale=scale, log_weights=log_weights, precision=precision, seed=seed, noise=noise,
        uniforms=uniforms, log_norm_t=log_norm_t, chain_offset=chain_offset)
    if launched:
        mixture_ais_run.launches += 1
    return out, logw, accept
