r"""Model wrappers (counterpart of :mod:`torchebm_tpu.models.wrappers`):
classifier-free guidance, the pairwise-repulsion interaction energy and the
EqM-field → energy adapter."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import torch
from torch import nn

from ..core.energies import Energy
from ..core.schedulers import BaseScheduler, sched_value

Tensor = torch.Tensor

__all__ = ["LabelClassifierFreeGuidance", "InteractionModel", "EqMEnergy"]


class LabelClassifierFreeGuidance(nn.Module):
    """Classifier-free guidance over a label-conditioned field.

    ``base`` is any ``model(x, t, y=..., **kw) -> (B, C, H, W)`` callable (a
    DiT field ``nn.Module``, registered as a submodule, or a plain function,
    which is wrapped in :class:`~torchebm_tpu_torch.samplers.flow.WrappedField`
    as the JAX package wraps it). Two forwards, with the labels and with the
    null label, guide the first ``guide_channels`` channels,
    ``uncond + cfg_scale·(cond − uncond)``; the other channels keep the
    unconditional values. ``cfg_scale <= 1`` short-circuits to the
    conditional pass.
    """

    def __init__(self, base: Any = None, null_label_id: int = 0, cfg_scale: float = 1.0,
                 guide_channels: int = 3):
        super().__init__()
        if (callable(base) and not isinstance(base, nn.Module)
                and not dataclasses.is_dataclass(base)):
            from ..samplers.flow import WrappedField

            base = WrappedField(fn=base)
        self.base = base
        self.null_label_id = int(null_label_id)
        self.cfg_scale = float(cfg_scale)
        self.guide_channels = int(guide_channels)

    def forward(self, x: Tensor, t: Tensor, *, y: Tensor, **kwargs: Any) -> Tensor:
        if self.cfg_scale <= 1.0:
            return self.base(x, t, y=y, **kwargs)
        y_null = torch.full_like(y, self.null_label_id)
        cond = self.base(x, t, y=y, **kwargs)
        uncond = self.base(x, t, y=y_null, **kwargs)
        c = min(self.guide_channels, cond.shape[1])
        guided = uncond[:, :c] + self.cfg_scale * (cond[:, :c] - uncond[:, :c])
        if c == cond.shape[1]:
            return guided
        return torch.cat([guided, uncond[:, c:]], dim=1)


class InteractionModel(Energy):
    r"""Potential with pairwise repulsion for diverse sampling (Balcerak et
    al. 2025).

    .. math::
        E_i = V(x_i) - \tfrac12 \frac{s}{\sigma_W^2} \sum_j \|x_i - x_j\|^2

    The squared-distance sum uses the exact :math:`O(B d)` expansion
    :math:`B\|x_i\|^2 + \sum_j \|x_j\|^2 - 2 x_i \cdot \sum_j x_j` (``cdist``
    has a NaN derivative on the zero diagonal). ``strength`` is schedulable:
    the samplers thread their step index to step-aware energies
    (``wants_step``), so a ``TemperatureScheduler(..., sqrt=False)`` scales
    the interaction in lockstep with the noise schedule.

    Stability: the repulsive drift scales as :math:`2 s B / \sigma_W^2\,(x_i -
    \bar x)`; keep :math:`2 s B \Delta t / \sigma_W^2 \ll 1`.
    """

    wants_step = True

    def __init__(self, model: Energy = None, sigma_w: float = 1.0,
                 strength: Union[float, BaseScheduler] = 1.0):
        super().__init__()
        if sigma_w <= 0:
            raise ValueError(f"sigma_w must be positive, got {sigma_w}")
        self.model = model
        self.sigma_w = float(sigma_w)
        self.strength = strength

    def energy(self, x: Tensor, step=None, **model_kwargs: Any) -> Tensor:
        s = sched_value(self.strength, 0 if step is None else step)
        batch = x.shape[0]
        flat = x.reshape(batch, -1)
        sq_norms = torch.sum(flat * flat, dim=1)
        pair_sq = batch * sq_norms + torch.sum(sq_norms) - 2.0 * flat @ torch.sum(flat, dim=0)
        w = 0.5 * (s / self.sigma_w**2) * pair_sq
        return self.model.energy(x, **model_kwargs) - w

_ENERGY_TYPES = ("dot", "mean", "l2", "implicit")


class EqMEnergy(Energy):
    r"""Scalar-energy adapter for trained Equilibrium-Matching fields.

    Turns a vector field ``field(x, t, **kw)`` into a scalar :class:`Energy`
    for the MCMC and gradient-descent samplers. The field is always evaluated
    at :math:`t = 0` (EqM time invariance). Modes, as in
    :class:`~torchebm_tpu_torch.losses.EquilibriumMatchingLoss`:

    - ``"dot"`` / ``"mean"``: :math:`g(x) = x \cdot f(x)`
    - ``"l2"``: :math:`g(x) = -\tfrac12 \|f(x)\|^2`
    - ``"implicit"``: :meth:`gradient` returns :math:`f(x, 0)` directly;
      :meth:`energy` returns the :math:`x \cdot f` surrogate for diagnostics.

    Descending this energy transports noise to data (EqM fields point from
    data to noise, the direction of ``FlowSampler(negate_velocity=True)``).
    A field that is an ``nn.Module`` is registered as a submodule.
    """

    def __init__(self, field: Callable[..., Tensor], energy_type: str = "dot"):
        super().__init__()
        if energy_type not in _ENERGY_TYPES:
            raise ValueError(
                f"energy_type must be one of {sorted(_ENERGY_TYPES)}, got {energy_type!r}"
            )
        self.field = field
        self.energy_type = energy_type

    @classmethod
    def from_loss(cls, loss: Any) -> "EqMEnergy":
        """The adapter matching a loss's ``energy_type`` (none → implicit)."""
        energy_type = "implicit" if loss.energy_type == "none" else loss.energy_type
        return cls(field=loss.model, energy_type=energy_type)

    def _field(self, x: Tensor, **model_kwargs: Any) -> Tensor:
        t0 = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        out = self.field(x, t0, **model_kwargs)
        return out[0] if isinstance(out, tuple) else out

    def energy(self, x: Tensor, **model_kwargs: Any) -> Tensor:
        f = self._field(x, **model_kwargs)
        if self.energy_type == "l2":
            return -0.5 * torch.sum(torch.square(f).reshape(x.shape[0], -1), dim=-1)
        return torch.sum((x * f).reshape(x.shape[0], -1), dim=-1)

    def gradient(self, x: Tensor, **model_kwargs: Any) -> Tensor:
        if self.energy_type == "implicit":
            return self._field(x, **model_kwargs)
        return super().gradient(x, **model_kwargs)
