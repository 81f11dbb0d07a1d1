r"""Model wrappers (counterpart of :mod:`torchebm_tpu.models.wrappers`): the
EqM-field → energy adapter. The classifier-free-guidance and interaction
wrappers come with the DiT family."""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..core.energies import Energy

Tensor = torch.Tensor

__all__ = ["EqMEnergy"]

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
