"""NUTS→HMC trajectory-length handoff (``tune_trajectory_length``).

Counterpart of :mod:`torchebm_tpu.samplers.tuning`. Batched NUTS pays, every
draw, the largest tree among its lockstep chains, so its dynamic
trajectories are worth one pilot, not a production run: NUTS finds the
trajectory length, and HMC at ``n_leapfrog ≈ 2^mean_tree_depth`` makes the
production draws, on the whole-run HMC kernel where the target has one::

    tuning = tune_trajectory_length(g, energy, dim=2, n_samples=256)
    hmc = HamiltonianMonteCarlo(
        energy,
        step_size=tuning.step_size,
        n_leapfrog_steps=tuning.n_leapfrog,
        mass=tuning.mass,
    )
    samples = hmc.sample(g, x=tuning.x, n_steps=10_000)
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..utils.profiling import count
from .hmc import HamiltonianMonteCarlo
from .nuts import NoUTurnSampler

Tensor = torch.Tensor

__all__ = ["TrajectoryTuning", "tune_trajectory_length"]


class TrajectoryTuning(NamedTuple):
    """Result of :func:`tune_trajectory_length`, to plug into
    :class:`~torchebm_tpu_torch.samplers.HamiltonianMonteCarlo`."""

    #: HMC trajectory length, ``max(2, round(2^mean_tree_depth))``.
    n_leapfrog: int
    #: the step size dual-averaged by HMC at that trajectory length (a Python
    #: float; NUTS's adapted step is its start, since HMC's acceptance
    #: statistic is one end-point test and NUTS's a trajectory average).
    step_size: float
    #: warmed chain states: start production sampling from these.
    x: Tensor
    #: mean NUTS tree depth over the pilot draws (doublings per transition).
    mean_tree_depth: float
    #: the diagonal mass (``adapt_mass=True``) or None.
    mass: Optional[Tensor] = None


def tune_trajectory_length(
    generator: torch.Generator,
    model,
    *,
    x: Optional[Tensor] = None,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
    n_samples: int = 64,
    n_warmup: int = 200,
    n_pilot: int = 100,
    step_size: float = 0.2,
    max_tree_depth: int = 8,
    target_accept: float = 0.8,
    adapt_mass: bool = False,
    model_kwargs: Optional[Dict[str, Any]] = None,
) -> TrajectoryTuning:
    """Pilot NUTS → production-HMC handoff: find the trajectory length.

    1. NUTS warmup (``n_warmup`` dual-averaging transitions, optionally a
       diagonal mass);
    2. NUTS pilot (``n_pilot`` draws), recording the mean tree depth;
    3. HMC warmup at ``n_leapfrog = max(2, round(2^mean_tree_depth))``, on
       HMC's generic loop.

    Every draw comes from ``generator``, in that order. The host reads the
    mean depth once (and the warmups read their final step sizes).
    """
    model_kwargs = model_kwargs or {}
    nuts = NoUTurnSampler(
        model, step_size=step_size, max_tree_depth=max_tree_depth, target_accept=target_accept,
    )
    mass = None
    if adapt_mass:
        x0, eps, mass = nuts.warmup(generator, x=x, dim=dim, n_warmup=n_warmup,
                                    n_samples=n_samples, adapt_mass=True,
                                    model_kwargs=model_kwargs)
    else:
        x0, eps = nuts.warmup(generator, x=x, dim=dim, n_warmup=n_warmup, n_samples=n_samples,
                              model_kwargs=model_kwargs)
    nuts = nuts.replace(step_size=eps, mass=mass)

    x1, diag = nuts.sample(generator, x=x0, n_steps=n_pilot, return_diagnostics=True,
                           model_kwargs=model_kwargs)
    count("host_reads")
    depth = float(torch.mean(diag["tree_depth"]))
    n_leapfrog = max(2, int(round(2.0 ** depth)))

    hmc = HamiltonianMonteCarlo(model, step_size=eps, n_leapfrog_steps=n_leapfrog, mass=mass,
                                dual_averaging=True, target_accept=target_accept)
    x2, eps_hmc = hmc.warmup(generator, x=x1, n_warmup=n_warmup, n_samples=n_samples,
                             model_kwargs=model_kwargs)
    return TrajectoryTuning(n_leapfrog=n_leapfrog, step_size=eps_hmc, x=x2,
                            mean_tree_depth=depth, mass=mass)
