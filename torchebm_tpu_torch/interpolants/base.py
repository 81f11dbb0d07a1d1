r"""Stochastic interpolant contract (counterpart of :mod:`torchebm_tpu.interpolants.base`).

An interpolant defines the conditional path

.. math:: x_t = \alpha(t)\,x_1 + \sigma(t)\,x_0

between noise :math:`x_0` and data :math:`x_1`. Interpolants are stateless,
tensor-free dataclasses; every method is plain tensor code over ``t``, a
``(B,)`` tensor or a scalar.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

__all__ = ["BaseInterpolant", "expand_t_like_x", "DIFFUSION_FORMS"]

DIFFUSION_FORMS = (
    "constant",
    "SBDM",
    "sigma",
    "linear",
    "decreasing",
    "increasing-decreasing",
)


def _as_t(t, like: Tensor = None) -> Tensor:
    """``t`` as a tensor (a Python number on ``like``'s device and dtype)."""
    if isinstance(t, Tensor):
        return t
    if like is None:
        return torch.as_tensor(t, dtype=torch.get_default_dtype())
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def expand_t_like_x(t, x: Tensor) -> Tensor:
    """Expand ``(B,)`` times to ``(B, 1, ..., 1)`` for broadcasting against
    ``x``; a scalar ``t`` passes through (it broadcasts as it is)."""
    t = _as_t(t, x)
    if t.ndim == 0:
        return t
    return t.reshape(t.shape[0], *([1] * (x.ndim - 1)))


class BaseInterpolant:
    r"""Abstract interpolant: subclasses provide ``compute_alpha_t`` and
    ``compute_sigma_t``, each returning a ``(value, time-derivative)`` pair."""

    def compute_alpha_t(self, t) -> Tuple[Tensor, Tensor]:
        raise NotImplementedError

    def compute_sigma_t(self, t) -> Tuple[Tensor, Tensor]:
        raise NotImplementedError

    def compute_d_alpha_alpha_ratio_t(self, t) -> Tensor:
        r""":math:`\dot\alpha(t)/\alpha(t)`; override for better stability."""
        alpha, d_alpha = self.compute_alpha_t(t)
        return d_alpha / torch.clamp(alpha, min=1e-8)

    def interpolate(self, x0: Tensor, x1: Tensor, t) -> Tuple[Tensor, Tensor]:
        r"""``(x_t, u_t)`` with :math:`x_t = \alpha x_1 + \sigma x_0`,
        :math:`u_t = \dot\alpha x_1 + \dot\sigma x_0`."""
        te = expand_t_like_x(t, x0)
        alpha, d_alpha = self.compute_alpha_t(te)
        sigma, d_sigma = self.compute_sigma_t(te)
        return alpha * x1 + sigma * x0, d_alpha * x1 + d_sigma * x0

    def compute_drift(self, x: Tensor, t) -> Tuple[Tensor, Tensor]:
        r"""Score-parameterised probability-flow drift pieces: ``(drift_mean,
        drift_var)`` such that the PF-ODE reads ``dx = [-drift_mean +
        drift_var · score] dt`` (``drift_mean`` is returned already negated,
        as in the JAX package)."""
        te = expand_t_like_x(t, x)
        alpha_ratio = self.compute_d_alpha_alpha_ratio_t(te)
        sigma, d_sigma = self.compute_sigma_t(te)
        drift_mean = alpha_ratio * x
        drift_var = alpha_ratio * sigma**2 - sigma * d_sigma
        return -drift_mean, drift_var

    def compute_diffusion(self, x: Tensor, t, form: str = "SBDM", norm: float = 1.0) -> Tensor:
        """Diffusion coefficient for SDE sampling (the six :data:`DIFFUSION_FORMS`)."""
        te = expand_t_like_x(t, x)
        sigma, _ = self.compute_sigma_t(te)
        _, drift_var = self.compute_drift(x, t)
        if form == "constant":
            return norm * torch.ones_like(drift_var)
        if form == "SBDM":
            return norm * drift_var / (sigma + 1e-8)
        if form == "sigma":
            return norm * sigma
        if form == "linear":
            return norm * (1 - te) * torch.ones_like(drift_var)
        if form == "decreasing":
            return norm * (1 - te) ** 2 * torch.ones_like(drift_var)
        if form == "increasing-decreasing":
            return norm * 4 * te * (1 - te) * torch.ones_like(drift_var)
        raise ValueError(
            f"Unknown diffusion form '{form}'. Choose from: {', '.join(DIFFUSION_FORMS)}"
        )

    # ---------------------------------------------------------- conversions

    def velocity_to_score(self, velocity: Tensor, x: Tensor, t) -> Tensor:
        """Velocity → score."""
        te = expand_t_like_x(t, x)
        alpha, d_alpha = self.compute_alpha_t(te)
        sigma, d_sigma = self.compute_sigma_t(te)
        alpha = torch.clamp(alpha, min=1e-8)
        reverse_alpha_ratio = alpha / d_alpha
        var = sigma**2 - reverse_alpha_ratio * d_sigma * sigma
        return (reverse_alpha_ratio * velocity - x) / torch.clamp(var, min=1e-12)

    def velocity_to_noise(self, velocity: Tensor, x: Tensor, t) -> Tensor:
        """Velocity → noise, with sign-preserving clamps of the denominators."""
        te = expand_t_like_x(t, x)
        alpha, d_alpha = self.compute_alpha_t(te)
        sigma, d_sigma = self.compute_sigma_t(te)
        d_alpha = torch.where(torch.abs(d_alpha) < 1e-8, torch.full_like(d_alpha, 1e-8), d_alpha)
        reverse_alpha_ratio = alpha / d_alpha
        var = sigma - reverse_alpha_ratio * d_sigma
        tiny = torch.where(var == 0, torch.full_like(var, 1e-12), torch.sign(var) * 1e-12)
        var = torch.where(torch.abs(var) < 1e-12, tiny, var)
        return (x - reverse_alpha_ratio * velocity) / var

    def score_to_velocity(self, score: Tensor, x: Tensor, t) -> Tensor:
        drift_mean, drift_var = self.compute_drift(x, t)
        return drift_var * score - drift_mean
