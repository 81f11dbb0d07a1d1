r"""Energy Matching (EM) loss (Balcerak et al. 2025); counterpart of
:mod:`torchebm_tpu.losses.energy_matching`.

Trains a time-independent scalar potential :math:`V_\theta` with two terms:

- **flow term**: :math:`w(t)\,\|{-\nabla V(x_t)} - u_t\|^2` on OT-coupled
  pairs, with smoothing noise σ and the time gate
  :math:`w(t) = \mathrm{clip}((1-t)/(1-a), 0, 1)`;
- **contrastive term**: :math:`\lambda_{cd}\,(\mathbb E[V(x)] -
  \mathrm{trimmed\_mean}(V(x^-)))` floored at :math:`-c_{clamp}`, with
  negatives from two Langevin populations: a ``noise_fraction`` of chains
  sweeping the Energy-Matching temperature profile :math:`\epsilon(t): 0 \to
  \epsilon_{max}`, the rest starting at data and held at
  :math:`\sqrt{\epsilon_{max}}`.

Two-phase training flips ``lambda_cd`` (0 for warm-up: no Langevin chain
runs). The default coupling ``"ot"`` is the auction, which syncs with the
host once per bidding round. The negatives are drawn under
``torch.no_grad()`` by the port's :class:`LangevinDynamics`; on an analytic
energy that a dispatch row claims they take the whole-chain kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import torch

from ..core.energies import Energy
from ..core.schedulers import BaseScheduler, ConstantScheduler, TemperatureScheduler, sched_init
from ..couplings import BaseCoupling, resolve_coupling
from ..interpolants import BaseInterpolant, resolve_interpolant
from ..samplers.langevin import LangevinDynamics
from .base import BaseLoss, inject_params
from .equilibrium_matching import _weighted_mean
from .loss_utils import compute_flow_weight, mean_flat, trimmed_mean

Tensor = torch.Tensor

__all__ = ["EnergyMatchingLoss"]


def _batched(v, batch: int) -> bool:
    return hasattr(v, "shape") and tuple(v.shape[:1]) == (batch,)


@dataclass(eq=False)
class EnergyMatchingLoss(BaseLoss):
    """EM training loss. ``__call__(params, x1, generator, x0=None, ...)`` →
    scalar; :meth:`training_losses` → terms dict (loss / flow_loss / cd_loss /
    cd_value / negatives)."""

    model: Energy = None
    sampler: Optional[LangevinDynamics] = None
    coupling: Union[str, BaseCoupling, None] = "ot"
    interpolant: Union[str, BaseInterpolant] = "linear"
    sigma: Union[float, BaseScheduler] = 0.1
    flow_weight_cutoff: float = 0.8
    lambda_cd: Union[float, BaseScheduler] = 2.0
    epsilon_max: float = 0.15
    tau_star: float = 0.8
    n_langevin_steps: int = 200
    langevin_dt: float = 0.01
    noise_fraction: float = 0.5
    cd_trim_fraction: float = 0.1
    cd_clamp: Optional[float] = 0.02

    def __post_init__(self):
        if not 0.0 <= self.noise_fraction <= 1.0:
            raise ValueError(f"noise_fraction must be in [0, 1], got {self.noise_fraction}")
        if not 0.0 <= self.cd_trim_fraction < 1.0:
            raise ValueError(f"cd_trim_fraction must be in [0, 1), got {self.cd_trim_fraction}")
        if self.cd_clamp is not None and self.cd_clamp < 0:
            raise ValueError(f"cd_clamp must be >= 0 or None, got {self.cd_clamp}")
        if self.langevin_dt <= 0:
            raise ValueError(f"langevin_dt must be positive, got {self.langevin_dt}")
        self.coupling = resolve_coupling(self.coupling, default="ot")
        self.interpolant = resolve_interpolant(self.interpolant, default="linear")
        if self.sampler is None:
            self.sampler = LangevinDynamics(model=self.model, step_size=self.langevin_dt)

    # -------------------------------------------------------------- pieces

    @property
    def _noise_sweep(self) -> TemperatureScheduler:
        """ε(t)-sweeping noise schedule for the source-initialised chains."""
        return TemperatureScheduler(epsilon_max=self.epsilon_max, tau_star=self.tau_star,
                                    n_steps=self.n_langevin_steps, t_end=1.0)

    @property
    def _noise_const(self) -> ConstantScheduler:
        """Constant √ε_max schedule for the data-initialised chains."""
        return ConstantScheduler(math.sqrt(self.epsilon_max))

    @staticmethod
    def _slice_kwargs(mk: Dict[str, Any], idx, batch: int) -> Dict[str, Any]:
        return {k: (v[idx] if _batched(v, batch) else v) for k, v in mk.items()}

    def _sample_negatives(self, params, x1, x0, generator, model_kwargs):
        """Two Langevin populations, without a graph: ``(negatives,
        neg_model_kwargs)`` with the conditioning aligned to the
        concatenated populations."""
        mk = model_kwargs or {}
        batch = x1.shape[0]
        n_noise = int(round(batch * self.noise_fraction))
        dev = x1.device

        sampler = self.sampler
        if params is not None:
            sampler = sampler.replace(model=inject_params(sampler.model, params))
        negatives = []
        parts = []

        if n_noise > 0:
            mk_noise = self._slice_kwargs(mk, torch.arange(n_noise, device=dev), batch)
            if x0 is None:
                init = torch.randn((n_noise, *x1.shape[1:]), generator=generator, device=dev,
                                   dtype=x1.dtype)
            else:
                perm = torch.randperm(x0.shape[0], generator=generator, device=dev)
                init = x0[perm[:n_noise]]
            sweep = sampler.replace(noise_scale=self._noise_sweep)
            negatives.append(sweep.sample(generator, x=init.detach(),
                                          n_steps=self.n_langevin_steps, model_kwargs=mk_noise))
            parts.append(mk_noise)
        if batch - n_noise > 0:
            idx = torch.randperm(batch, generator=generator, device=dev)[: batch - n_noise]
            mk_data = self._slice_kwargs(mk, idx, batch)
            const = sampler.replace(noise_scale=self._noise_const)
            negatives.append(const.sample(generator, x=x1[idx].detach(),
                                          n_steps=self.n_langevin_steps, model_kwargs=mk_data))
            parts.append(mk_data)

        neg_mk = {
            k: (torch.cat([p[k] for p in parts], dim=0) if _batched(v, batch) else v)
            for k, v in mk.items()
        }
        return torch.cat(negatives, dim=0).detach(), neg_mk

    # ---------------------------------------------------------------- loss

    def training_losses(self, params: Any, x1: Tensor, generator: torch.Generator,
                        x0: Optional[Tensor] = None,
                        model_kwargs: Optional[Dict[str, Any]] = None, *,
                        t: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """The terms dict. From ``generator`` come, in order, ``x0`` (when
        not given), the coupling's draws, the times, the smoothing noise and
        the negatives' draws. ``t`` injects the ``(batch,)`` times: a hook
        for tests that compare with the JAX package on its own draws."""
        mk = model_kwargs or {}
        model = self._model(params)
        batch = x1.shape[0]
        dev = x1.device

        if x0 is None:
            x0 = torch.randn(x1.shape, generator=generator, device=dev, dtype=x1.dtype)
        elif x0.shape != x1.shape:
            raise ValueError(f"x0 shape {tuple(x0.shape)} must match x1 shape {tuple(x1.shape)}")

        coupled = self.coupling(x0, x1, generator=generator, **mk)
        x0c, x1c = coupled.x0, coupled.x1
        if t is None:
            t = torch.rand((batch,), generator=generator, device=dev, dtype=x1.dtype)
        xt, ut = self.interpolant.interpolate(x0c, x1c, t)

        sigma = sched_init(self.sigma)
        if sigma > 0:
            xt = xt + sigma * torch.randn(xt.shape, generator=generator, device=dev,
                                          dtype=xt.dtype)
        # the gradient of V at x_t, with its graph: the loss on it trains V
        grad = model.gradient(xt.detach().requires_grad_(True), **mk)
        w = compute_flow_weight(t, cutoff=self.flow_weight_cutoff)
        flow_loss = _weighted_mean(w * mean_flat(torch.square(-grad - ut)), coupled.weights)

        terms: Dict[str, Tensor] = {"flow_loss": flow_loss}

        lambda_cd = sched_init(self.lambda_cd)
        if lambda_cd > 0:
            negatives, neg_mk = self._sample_negatives(params, x1, x0, generator, mk)
            pos_energy = model.energy(x1, **mk)
            neg_energy = model.energy(negatives, **neg_mk)
            cd_value = torch.mean(pos_energy) - trimmed_mean(neg_energy, self.cd_trim_fraction)
            cd_loss = lambda_cd * cd_value
            if self.cd_clamp is not None:
                cd_loss = torch.clamp(cd_loss, min=-self.cd_clamp)
            terms["cd_value"] = cd_value
            terms["negatives"] = negatives
        else:
            cd_loss = torch.zeros((), dtype=flow_loss.dtype, device=dev)

        terms["cd_loss"] = cd_loss
        terms["loss"] = flow_loss + cd_loss
        return terms

    def __call__(self, params: Any, x: Tensor, generator: torch.Generator,
                 x0: Optional[Tensor] = None, *,
                 model_kwargs: Optional[Dict[str, Any]] = None,
                 t: Optional[Tensor] = None) -> Tensor:
        return self.training_losses(params, x, generator, x0=x0, model_kwargs=model_kwargs,
                                    t=t)["loss"]
