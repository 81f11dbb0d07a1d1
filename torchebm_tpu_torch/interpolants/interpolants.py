r"""Concrete interpolants: linear (OT / rectified flow), cosine (GVP) and
variance-preserving (counterpart of :mod:`torchebm_tpu.interpolants.interpolants`)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from .base import BaseInterpolant, _as_t, expand_t_like_x

Tensor = torch.Tensor

__all__ = ["LinearInterpolant", "CosineInterpolant", "VariancePreservingInterpolant"]


@dataclass(frozen=True)
class LinearInterpolant(BaseInterpolant):
    r"""Linear / optimal-transport path: :math:`\alpha(t)=t`, :math:`\sigma(t)=1-t`."""

    def compute_alpha_t(self, t) -> Tuple[Tensor, Tensor]:
        t = _as_t(t)
        return t, torch.ones_like(t)

    def compute_sigma_t(self, t) -> Tuple[Tensor, Tensor]:
        t = _as_t(t)
        return 1 - t, -torch.ones_like(t)

    def compute_d_alpha_alpha_ratio_t(self, t) -> Tensor:
        return 1.0 / torch.clamp(_as_t(t), min=1e-8)


@dataclass(frozen=True)
class CosineInterpolant(BaseInterpolant):
    r"""Geodesic variance-preserving (GVP) path:
    :math:`\alpha(t)=\sin(\pi t/2)`, :math:`\sigma(t)=\cos(\pi t/2)`."""

    def compute_alpha_t(self, t) -> Tuple[Tensor, Tensor]:
        t = _as_t(t)
        return torch.sin(t * math.pi / 2), (math.pi / 2) * torch.cos(t * math.pi / 2)

    def compute_sigma_t(self, t) -> Tuple[Tensor, Tensor]:
        t = _as_t(t)
        return torch.cos(t * math.pi / 2), -(math.pi / 2) * torch.sin(t * math.pi / 2)

    def compute_d_alpha_alpha_ratio_t(self, t) -> Tensor:
        t = _as_t(t)
        return math.pi / (2 * torch.clamp(torch.tan(t * math.pi / 2), min=1e-8))


@dataclass(frozen=True)
class VariancePreservingInterpolant(BaseInterpolant):
    r"""DDPM-style VP path with a linear :math:`\beta` schedule.

    .. math::
        \alpha(t) = \exp\!\big(-\tfrac14 (1-t)^2(\sigma_{max}-\sigma_{min})
        - \tfrac12 (1-t)\sigma_{min}\big), \qquad
        \sigma(t) = \sqrt{1-\alpha(t)^2}

    ``compute_drift`` uses the exact :math:`\beta(t)` parameterisation.
    """

    sigma_min: float = 0.1
    sigma_max: float = 20.0

    def _log_mean_coeff(self, t: Tensor) -> Tensor:
        return (
            -0.25 * (1 - t) ** 2 * (self.sigma_max - self.sigma_min)
            - 0.5 * (1 - t) * self.sigma_min
        )

    def _d_log_mean_coeff(self, t: Tensor) -> Tensor:
        return 0.5 * (1 - t) * (self.sigma_max - self.sigma_min) + 0.5 * self.sigma_min

    def compute_alpha_t(self, t) -> Tuple[Tensor, Tensor]:
        t = _as_t(t)
        alpha = torch.exp(self._log_mean_coeff(t))
        return alpha, alpha * self._d_log_mean_coeff(t)

    def compute_sigma_t(self, t) -> Tuple[Tensor, Tensor]:
        t = _as_t(t)
        exp_p = torch.exp(2 * self._log_mean_coeff(t))
        sigma = torch.sqrt(torch.clamp(1 - exp_p, min=1e-12))
        d_sigma = exp_p * (2 * self._d_log_mean_coeff(t)) / (-2 * sigma)
        return sigma, d_sigma

    def compute_d_alpha_alpha_ratio_t(self, t) -> Tensor:
        return self._d_log_mean_coeff(_as_t(t))

    def compute_drift(self, x: Tensor, t) -> Tuple[Tensor, Tensor]:
        te = expand_t_like_x(t, x)
        beta_t = self.sigma_min + (1 - te) * (self.sigma_max - self.sigma_min)
        return -0.5 * beta_t * x, beta_t / 2 * torch.ones_like(x)
