r"""Shared loss utilities (counterpart of :mod:`torchebm_tpu.losses.loss_utils`)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor

__all__ = [
    "mean_flat",
    "trimmed_mean",
    "compute_flow_weight",
    "compute_eqm_ct",
    "dispersive_loss",
]


def mean_flat(tensor: Tensor) -> Tensor:
    """Mean over all non-batch dimensions: ``(B, ...) -> (B,)``."""
    return torch.mean(tensor.reshape(tensor.shape[0], -1), dim=-1)


def trimmed_mean(values: Tensor, trim_fraction: float) -> Tensor:
    """One-sided trimmed mean: drop the ``trim_fraction`` largest values."""
    if not 0.0 <= trim_fraction < 1.0:
        raise ValueError(f"trim_fraction must be in [0, 1), got {trim_fraction}")
    n = values.shape[0]
    k = int(trim_fraction * n)
    if k == 0:
        return torch.mean(values)
    return torch.mean(torch.sort(values).values[: n - k])


def compute_flow_weight(t: Tensor, cutoff: float = 0.8) -> Tensor:
    r"""Energy-Matching time gate :math:`w(t) = \mathrm{clip}((1-t)/(1-a), 0, 1)`;
    ``cutoff >= 1`` disables gating."""
    if cutoff >= 1.0:
        return torch.ones_like(t)
    return torch.clamp((1.0 - t) / (1.0 - cutoff), 0.0, 1.0)


def compute_eqm_ct(t: Tensor, threshold: float = 0.8, multiplier: float = 4.0) -> Tensor:
    r"""EqM target scaling :math:`c(t) = \lambda \min(1, (1-t)/(1-a))`."""
    ct = torch.minimum(torch.ones_like(t), 1.0 / (1.0 - threshold) - t / (1.0 - threshold))
    return ct * multiplier


def dispersive_loss(z: Tensor) -> Tensor:
    r"""InfoNCE-L2 dispersive regulariser :math:`\log \mathbb{E}_{i,j}\,
    e^{-\|z_i - z_j\|^2 / d}` over all ordered pairs, the zero diagonal included."""
    z = z.reshape(z.shape[0], -1)
    sq_norm = torch.sum(z * z, dim=1)
    sq = sq_norm[:, None] + sq_norm[None, :] - 2.0 * z @ z.T
    d = torch.clamp(sq, min=0.0) / z.shape[1]
    return torch.log(torch.mean(torch.exp(-d)))
