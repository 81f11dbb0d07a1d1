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
Philox4x32-10 stream keyed by ``seed``, the chains numbered from
``chain_offset`` (a shard's first row in a batch sharded on its rows). Each
wrapper also returns the per-chain mean acceptance probability.

A launch splits each chain over a group of lanes of one warp, chosen by
:func:`hmc_launch_plan` from the card's timings.

Every wrapper carries an integer ``launches`` attribute, raised by one each
time it launches its kernel (never on the plain path); ``ops.launch_counts``
reads them.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..utils.profiling import count
from . import _build
from .fused_langevin import (
    DISPATCH_GROUPS,
    MIXTURE_RESIDENT_THREADS,
    _chain_offset,
    _check_metropolis,
    _check_thin,
    _seed_words,
    _target,
    dispatch_groups,
    philox_normals,
    philox_uniforms,
)

Tensor = torch.Tensor
Mass = Union[None, float, Tensor]

__all__ = [
    "hmc_groups",
    "hmc_launch_plan",
    "mixture_hmc_chain",
    "mixture_hmc_chain_trajectory",
    "mixture_hmc_chain_plain",
    "mixture_hmc_chain_trajectory_plain",
]

#: ``tebm_mixture_hmc_chain``'s argument types before the stream: x0, out, accept,
#: traj, params_a, params_b, mass, noise, uniforms, n, d, k, gaussian, n_draws,
#: thin, n_leapfrog, inv_var, step, seed lo, seed hi, chain offset, group, threads,
#: blocks
_SIGNATURE = ((_build.PTR,) * 9 + (_build.INT,) * 7 + (_build.FLOAT,) * 2 + (_build.U32,) * 2
              + (_build.INT,) * 4)

#: the HMC chain kernel's block size (``kHmcThreads`` in csrc/fused_hmc.cu)
HMC_THREADS = 128
#: lanes per chain the HMC chain kernel is built for at d <= 16
HMC_GROUPS = DISPATCH_GROUPS


def _mass_vector(mass: Mass, d: int, device: torch.device) -> Optional[Tensor]:
    """``mass`` as a contiguous float32 ``(d,)`` tensor on ``device`` (None
    stays None); a scalar broadcasts, as in the JAX wrappers. A copy from the
    host is counted in ``host_reads``: on a card it waits for the stream."""
    if mass is None:
        return None
    if not (isinstance(mass, Tensor) and mass.device == torch.device(device)):
        count("host_reads")
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


def _run_plain(x0, grad_logp, h, n_leapfrog, mass, n_draws, seed, noise, uniforms, thin,
               chain_offset=0):
    """Plain version of both kernels: the same draw, force reuse and Philox
    stream (chains numbered from ``chain_offset``); returns ``(traj or None,
    final, accept)``."""
    n, d = x0.shape
    index = torch.arange(n, device=x0.device) + chain_offset
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


def hmc_groups(d: int, k: int, gaussian: bool) -> Tuple[int, ...]:
    """The groups of lanes per chain the HMC chain kernel is built for on a
    target of ``k`` components (or the full-covariance Gaussian) in ``d``
    dimensions: the shared dispatch's (:func:`.fused_langevin.dispatch_groups`),
    :data:`HMC_GROUPS` up to ``MIXTURE_GROUP_MAX_DIM``, one lane above it and
    for a single component."""
    return dispatch_groups(d, k, gaussian)


def hmc_launch_plan(n: int, d: int, k: int, gaussian: bool,
                    group: Optional[int] = None) -> Tuple[int, int, int]:
    """``(group, threads, blocks)`` of one HMC chain launch over ``n`` chains
    in ``d`` dimensions with ``k`` components: ``group`` lanes of one warp
    hold a chain, ``threads`` per block, ``blocks`` in the grid.

    The rule follows the card's timings of every built group
    (``chip_smoke.py``'s plan sweep, H100): the fewest lanes, a power of two,
    that hold every component in registers (4 per lane at d ≤ 2, 2 at d ≤ 4,
    1 above: ``NJ`` of csrc/fused_hmc.cu; further components are read from
    shared memory at every evaluation), at least 2 and at most 8 (4 at
    d > 4); 2 at the ring (K = 8, d = 2), where a draw's eight evaluations cost more
    butterfly rounds at 4 lanes than the extra warps give. The group is then
    halved while ``n * group`` exceeds the threads the card holds at once
    (:data:`.fused_langevin.MIXTURE_RESIDENT_THREADS`), down to 2, which
    beats one lane at every size timed (to 300,000 chains). The
    full-covariance Gaussian takes 2 lanes (every lane repeats its whole
    evaluation; two share the randomness drawn ahead and double the warps:
    fastest at d = 4, 8 and 16). The sweep's exceptions, where 4 lanes beat
    the pick: K = 16 at 100,000 and 300,000 chains (by 9–13%), the ESS
    protocol's 2-D Gaussian (by 1%) and one leapfrog step per draw (by
    5–17%, where the randomness, shared by more lanes, outweighs the
    evaluations; the plan does not see ``n_leapfrog``). One component and
    ``d > MIXTURE_GROUP_MAX_DIM`` take one lane.
    ``group=`` overrides the choice with a group of :func:`hmc_groups`
    (timings compare them). The block is :data:`HMC_THREADS`, as the
    mixture Langevin chain's."""
    built = hmc_groups(d, k, gaussian)
    if built == (1,):
        pick = 1
    elif gaussian:
        pick = 2
    else:
        lanes = -(-k // (4 if d <= 2 else 2 if d <= 4 else 1))
        pick = min(max(1 << (lanes - 1).bit_length(), 2), 8 if d <= 4 else 4)
        while pick > 2 and n * pick > MIXTURE_RESIDENT_THREADS:
            pick //= 2
    if group is None:
        group = pick
    elif group not in built:
        raise ValueError(f"no HMC chain kernel at group {group} for d={d}, K={k}, "
                         f"gaussian={bool(gaussian)}")
    return group, HMC_THREADS, -(-n * group // HMC_THREADS)


def _run(x0, means, n_draws, step_size, n_leapfrog, *, thin, scale, log_weights, precision,
         mass, seed, noise, uniforms, group=None, chain_offset=0):
    """The body of both wrappers (``thin=None``: final state only):
    ``(traj, final, accept, launched)``. A CPU ``x0`` runs the plain version;
    a CUDA ``x0`` launches the kernel with :func:`hmc_launch_plan`, whose
    group ``group`` overrides."""
    grad_logp, pa, pb, gaussian, inv_var, h, m = _hmc_args(
        x0, means, n_draws, step_size, n_leapfrog, scale, log_weights, precision, mass, noise,
        uniforms, seed,
    )
    chain_offset = _chain_offset(chain_offset, x0.shape[0], 31)
    if x0.device.type == "cpu":
        return (*_run_plain(x0, grad_logp, h, n_leapfrog, m, n_draws, seed, noise, uniforms,
                            thin, chain_offset), False)
    n, d = x0.shape
    k = means.shape[0]
    plan = hmc_launch_plan(n, d, k, bool(gaussian), group)
    out = torch.empty_like(x0)
    accept = torch.empty((n,), dtype=torch.float32, device=x0.device)
    traj = None if thin is None else torch.empty(
        (int(n_draws) // thin, n, d), dtype=torch.float32, device=x0.device)
    seed_lo, seed_hi = _seed_words(seed)
    _build.launch(
        "mixture_hmc_chain", _SIGNATURE, x0.device,
        _build.ptr(x0), _build.ptr(out), _build.ptr(accept), _build.ptr(traj), _build.ptr(pa),
        _build.ptr(pb), _build.ptr(m), _build.ptr(noise), _build.ptr(uniforms), n, d, k,
        gaussian, int(n_draws), 1 if thin is None else thin, int(n_leapfrog), inv_var, h,
        seed_lo, seed_hi, chain_offset, *plan,
    )
    return traj, out, accept, True


def mixture_hmc_chain_plain(x0, means, n_draws, step_size, n_leapfrog=10, *, scale=1.0,
                            log_weights=None, precision=None, mass=None, seed=0, noise=None,
                            uniforms=None, chain_offset=0) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`mixture_hmc_chain`, on ``x0``'s device."""
    grad_logp, *_, h, m = _hmc_args(x0, means, n_draws, step_size, n_leapfrog, scale,
                                    log_weights, precision, mass, noise, uniforms, seed)
    _, final, accept = _run_plain(x0, grad_logp, h, n_leapfrog, m, n_draws, seed, noise,
                                  uniforms, None, _chain_offset(chain_offset, x0.shape[0], 31))
    return final, accept


def mixture_hmc_chain_trajectory_plain(x0, means, n_draws, step_size, n_leapfrog=10, *, thin=1,
                                       scale=1.0, log_weights=None, precision=None, mass=None,
                                       seed=0, noise=None, uniforms=None,
                                       chain_offset=0) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of :func:`mixture_hmc_chain_trajectory`."""
    _check_thin(n_draws, thin)
    grad_logp, *_, h, m = _hmc_args(x0, means, n_draws, step_size, n_leapfrog, scale,
                                    log_weights, precision, mass, noise, uniforms, seed)
    return _run_plain(x0, grad_logp, h, n_leapfrog, m, n_draws, seed, noise, uniforms, int(thin),
                      _chain_offset(chain_offset, x0.shape[0], 31))


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
    chain_offset: int = 0,
) -> Tuple[Tensor, Tensor]:
    """Full HMC run on a d-dim isotropic Gaussian mixture (or, with
    ``precision``, a full-covariance Gaussian) in one kernel.

    ``x0``: ``(n_chains, d)``; ``means``: ``(K, d)``. Returns ``(samples,
    accept)``: the final state and the per-chain mean acceptance probability
    over all draws. ``chain_offset`` numbers the chains' Philox streams from
    it: a launch over chains ``[a, b)`` of a batch with ``chain_offset=a``
    draws what rows ``[a, b)`` of the launch over the whole batch draw
    (``chain_offset + n_chains`` below 2^31, the chains a launch can hold).
    Injected ``noise`` and ``uniforms`` ignore it.
    """
    _, out, accept, launched = _run(x0, means, n_draws, step_size, n_leapfrog, thin=None,
                                    scale=scale, log_weights=log_weights, precision=precision,
                                    mass=mass, seed=seed, noise=noise, uniforms=uniforms,
                                    chain_offset=chain_offset)
    mixture_hmc_chain.launches += launched
    return out, accept


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
    chain_offset: int = 0,
) -> Tuple[Tensor, Tensor, Tensor]:
    """:func:`mixture_hmc_chain` recording every ``thin``-th post-MH draw.

    Returns ``(traj, final, accept)``: ``traj`` ``(n_draws // thin, n_chains,
    d)`` holds the states after draws ``thin, 2·thin, …``; ``final`` the state
    after all draws; ``accept`` the per-chain mean acceptance probability.
    """
    _check_thin(n_draws, thin)
    traj, out, accept, launched = _run(x0, means, n_draws, step_size, n_leapfrog,
                                       thin=int(thin), scale=scale, log_weights=log_weights,
                                       precision=precision, mass=mass, seed=seed, noise=noise,
                                       uniforms=uniforms, chain_offset=chain_offset)
    mixture_hmc_chain_trajectory.launches += launched
    return traj, out, accept
