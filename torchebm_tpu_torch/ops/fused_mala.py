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
``chain_offset`` numbers the chains' Philox streams from it, so that a launch
over a shard of a batch sharded on its rows draws that shard's rows of the
whole batch's stream.

A launch splits each chain over a group of lanes of one warp, chosen by
:func:`mala_launch_plan` from the card's timings.

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
    MIXTURE_RESIDENT_THREADS,
    _check_metropolis,
    _chain_offset,
    _check_thin,
    _seed_words,
    _target,
    dispatch_groups,
    philox_normals,
    philox_uniforms,
)

Tensor = torch.Tensor

__all__ = [
    "mala_groups",
    "mala_launch_plan",
    "mixture_mala_chain",
    "mixture_mala_chain_trajectory",
    "mixture_mala_chain_plain",
    "mixture_mala_chain_trajectory_plain",
]

#: ``tebm_mixture_mala_chain``'s argument types before the stream: x0, out, accept,
#: traj, params_a, params_b, noise, uniforms, n, d, k, gaussian, n_steps, thin,
#: inv_var, eta, noise_coef, four_eta, seed lo, seed hi, chain offset, group,
#: threads, blocks
_SIGNATURE = ((_build.PTR,) * 8 + (_build.INT,) * 6 + (_build.FLOAT,) * 4 + (_build.U32,) * 2
              + (_build.INT,) * 4)

#: the MALA chain kernel's block size (``kMalaThreads`` in csrc/fused_mala.cu)
MALA_THREADS = 128


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


def _run_plain(x0, grad_logp, eta, n_steps, seed, noise, uniforms, thin, chain_offset=0):
    """Plain version of both kernels: the same transition, Philox stream
    (chains numbered from ``chain_offset``) and carried gradient; returns
    ``(traj or None, final, accept)``."""
    n, d = x0.shape
    index = torch.arange(n, device=x0.device) + chain_offset
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


def mala_groups(d: int, k: int, gaussian: bool) -> Tuple[int, ...]:
    """The groups of lanes per chain the MALA chain kernel is built for on a
    target of ``k`` components (or the full-covariance Gaussian) in ``d``
    dimensions: the shared dispatch's (:func:`.fused_langevin.dispatch_groups`,
    ``TEBM_DISPATCH_GROUPS`` of csrc/tebm_common.cuh): 1, 2, 4 and 8 up to
    ``MIXTURE_GROUP_MAX_DIM``, one lane above it and for a single
    component."""
    return dispatch_groups(d, k, gaussian)


def mala_launch_plan(n: int, d: int, k: int, gaussian: bool,
                     group: Optional[int] = None) -> Tuple[int, int, int]:
    """``(group, threads, blocks)`` of one MALA chain launch over ``n``
    chains in ``d`` dimensions with ``k`` components: ``group`` lanes of one
    warp hold a chain, ``threads`` per block, ``blocks`` in the grid.

    The rule follows the card's timings of every built group
    (``chip_smoke.py``'s MALA plan sweep, H100): enough lanes, a power of
    two, that each holds some of the components in registers (4 per lane at
    d ≤ 2, 2 at d ≤ 4, 1 above: ``NJ`` of csrc/tebm_common.cuh's dispatch;
    further components are read from shared memory at every evaluation) and
    draws some of a step's ``ceil(d / 4)`` Philox blocks of normals; at
    least 4 at d ≤ 2, where a step's two Philox blocks, shared by the lanes,
    outweigh the 2-D evaluation (4 lanes at the ring, K = 8), else at least
    2; at most 8 (4 at d > 4, where a wider group's butterflies over d
    coordinates cost more than its warps give). The group is then halved
    while ``n * group`` exceeds the threads the card holds at once
    (:data:`.fused_langevin.MIXTURE_RESIDENT_THREADS`), down to 2, which
    beats one lane at every size timed (to 300,000 chains). The sweep's
    exceptions, where another group beats the pick: the full-covariance
    Gaussian at d = 4 (4 lanes, by 1.7%) and the ring at K = 2 (2 lanes, by
    0.1%). One component and ``d > MIXTURE_GROUP_MAX_DIM``
    take one lane. ``group=`` overrides the choice with a group of
    :func:`mala_groups` (timings compare them). The block is
    :data:`MALA_THREADS`."""
    built = mala_groups(d, k, gaussian)
    if built == (1,):
        pick = 1
    else:
        per_lane = 4 if d <= 2 else 2 if d <= 4 else 1
        lanes = max(-(-k // per_lane), -(-d // 4))
        pick = min(max(1 << (lanes - 1).bit_length(), 4 if d <= 2 else 2), 8 if d <= 4 else 4)
        while pick > 2 and n * pick > MIXTURE_RESIDENT_THREADS:
            pick //= 2
    if group is None:
        group = pick
    elif group not in built:
        raise ValueError(f"no MALA chain kernel at group {group} for d={d}, K={k}, "
                         f"gaussian={bool(gaussian)}")
    return group, MALA_THREADS, -(-n * group // MALA_THREADS)


def _run(x0, means, n_steps, step_size, *, thin, scale, log_weights, precision, seed, noise,
         uniforms, group=None, chain_offset=0):
    """The body of both wrappers (``thin=None``: final state only):
    ``(traj, final, accept, launched)``. A CPU ``x0`` runs the plain version;
    a CUDA ``x0`` launches the kernel with :func:`mala_launch_plan`, whose
    group ``group`` overrides."""
    grad_logp, pa, pb, gaussian, inv_var, eta = _mala_args(
        x0, means, n_steps, step_size, scale, log_weights, precision, noise, uniforms, seed
    )
    chain_offset = _chain_offset(chain_offset, x0.shape[0], 31)
    if x0.device.type == "cpu":
        return (*_run_plain(x0, grad_logp, eta, n_steps, seed, noise, uniforms, thin,
                            chain_offset), False)
    n, d = x0.shape
    k = means.shape[0]
    plan = mala_launch_plan(n, d, k, bool(gaussian), group)
    out = torch.empty_like(x0)
    accept = torch.empty((n,), dtype=torch.float32, device=x0.device)
    traj = None if thin is None else torch.empty(
        (int(n_steps) // thin, n, d), dtype=torch.float32, device=x0.device)
    seed_lo, seed_hi = _seed_words(seed)
    _build.launch(
        "mixture_mala_chain", _SIGNATURE, x0.device,
        _build.ptr(x0), _build.ptr(out), _build.ptr(accept), _build.ptr(traj), _build.ptr(pa),
        _build.ptr(pb), _build.ptr(noise), _build.ptr(uniforms), n, d, k, gaussian,
        int(n_steps), 1 if thin is None else thin, inv_var, eta, math.sqrt(2.0 * eta),
        4.0 * eta, seed_lo, seed_hi, chain_offset, *plan,
    )
    return traj, out, accept, True


def mixture_mala_chain_plain(x0, means, n_steps, step_size, *, scale=1.0, log_weights=None,
                             precision=None, seed=0, noise=None, uniforms=None,
                             chain_offset=0) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`mixture_mala_chain`, on ``x0``'s device."""
    grad_logp, *_, eta = _mala_args(x0, means, n_steps, step_size, scale, log_weights,
                                    precision, noise, uniforms, seed)
    _, final, accept = _run_plain(x0, grad_logp, eta, n_steps, seed, noise, uniforms, None,
                                  _chain_offset(chain_offset, x0.shape[0], 31))
    return final, accept


def mixture_mala_chain_trajectory_plain(x0, means, n_steps, step_size, *, thin=1, scale=1.0,
                                        log_weights=None, precision=None, seed=0, noise=None,
                                        uniforms=None,
                                        chain_offset=0) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of :func:`mixture_mala_chain_trajectory`."""
    _check_thin(n_steps, thin)
    grad_logp, *_, eta = _mala_args(x0, means, n_steps, step_size, scale, log_weights,
                                    precision, noise, uniforms, seed)
    return _run_plain(x0, grad_logp, eta, n_steps, seed, noise, uniforms, int(thin),
                      _chain_offset(chain_offset, x0.shape[0], 31))


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
    chain_offset: int = 0,
) -> Tuple[Tensor, Tensor]:
    """Full n-step MALA chain on a d-dim isotropic Gaussian mixture (or, with
    ``precision``, a full-covariance Gaussian) in one kernel.

    ``x0``: ``(n_chains, d)``; ``means``: ``(K, d)``. Returns ``(samples,
    accept)``: the final state and the per-chain mean acceptance probability.
    ``chain_offset`` numbers the chains' Philox streams from it: a launch over
    chains ``[a, b)`` of a batch with ``chain_offset=a`` draws what rows
    ``[a, b)`` of the launch over the whole batch draw (a sharded batch's
    shard; ``chain_offset + n_chains`` below 2^31, the chains a launch can
    hold). Injected ``noise`` and ``uniforms`` ignore it.
    """
    _, out, accept, launched = _run(x0, means, n_steps, step_size, thin=None, scale=scale,
                                    log_weights=log_weights, precision=precision, seed=seed,
                                    noise=noise, uniforms=uniforms, chain_offset=chain_offset)
    mixture_mala_chain.launches += launched
    return out, accept


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
    chain_offset: int = 0,
) -> Tuple[Tensor, Tensor, Tensor]:
    """:func:`mixture_mala_chain` recording every ``thin``-th post-MH state.

    Returns ``(traj, final, accept)``: ``traj`` ``(n_steps // thin, n_chains,
    d)`` holds the states after transitions ``thin, 2·thin, …``; ``final`` the
    state after all transitions; ``accept`` the per-chain mean acceptance
    probability over the whole run.
    """
    _check_thin(n_steps, thin)
    traj, out, accept, launched = _run(x0, means, n_steps, step_size, thin=int(thin),
                                       scale=scale, log_weights=log_weights,
                                       precision=precision, seed=seed, noise=noise,
                                       uniforms=uniforms, chain_offset=chain_offset)
    mixture_mala_chain_trajectory.launches += launched
    return traj, out, accept
