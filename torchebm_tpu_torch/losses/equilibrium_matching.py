r"""Equilibrium Matching (EqM) loss (Wang & Du 2025); counterpart of
:mod:`torchebm_tpu.losses.equilibrium_matching`.

Trains an equilibrium field or energy by regressing onto the truncated-decay
target :math:`-u_t \cdot c(t)` with :math:`c(t) = \lambda \min(1,
(1-t)/(1-a))`; supports implicit (vector field) and explicit (dot / l2 /
mean) energy formulations, velocity, score and noise prediction with velocity
or likelihood loss weights, minibatch couplings, and the dispersive
regulariser.

Model contract: ``model(x, t, **kwargs) -> field`` (the shape of ``x``), or
``(field, activations)`` when it returns features for the dispersive term.
The call keeps the JAX package's shape, ``loss(params, x1, generator,
x0=None, model_kwargs=...)``, with ``params=None`` meaning the module's own
parameters; autograd reaches them through ``loss.backward()``. The coupling's
result carries no graph. From ``generator`` come, in order, ``x0`` (when not
given), the coupling's draws and the times.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import torch

from ..core.schedulers import BaseScheduler, sched_init
from ..couplings import BaseCoupling, resolve_coupling
from ..interpolants import BaseInterpolant, expand_t_like_x, resolve_interpolant
from .base import BaseLoss
from .loss_utils import compute_eqm_ct, dispersive_loss, mean_flat

Tensor = torch.Tensor

__all__ = ["EquilibriumMatchingLoss"]


def _weighted_mean(loss: Tensor, weights: Optional[Tensor]) -> Tensor:
    """The mean of the per-pair losses, weighted by the coupling's weights
    when it attached any."""
    if weights is not None:
        return torch.sum(weights * loss) / torch.clamp(torch.sum(weights), min=1e-12)
    return torch.mean(loss)


@dataclass(eq=False)
class EquilibriumMatchingLoss(BaseLoss):
    """EqM training loss. ``__call__(params, x1, generator, x0=None,
    model_kwargs=...)`` returns the scalar loss; :meth:`training_losses`
    returns the terms dict."""

    model: Any = None
    prediction: str = "velocity"
    energy_type: str = "none"
    interpolant: Union[str, BaseInterpolant] = "linear"
    coupling: Union[str, BaseCoupling, None] = None
    loss_weight: Optional[str] = None
    train_eps: Union[float, BaseScheduler] = 0.0
    ct_threshold: float = 0.8
    ct_multiplier: float = 4.0
    apply_dispersion: bool = False
    dispersion_weight: float = 0.5
    time_invariant: bool = True

    def __post_init__(self):
        if self.prediction not in ("velocity", "score", "noise"):
            raise ValueError(f"Unknown prediction type: {self.prediction!r}")
        if self.energy_type not in ("none", "dot", "l2", "mean"):
            raise ValueError(f"Unknown energy type: {self.energy_type!r}")
        if self.loss_weight not in (None, "velocity", "likelihood"):
            raise ValueError(f"Unknown loss_weight: {self.loss_weight!r}")
        self.interpolant = resolve_interpolant(self.interpolant, default="linear")
        self.coupling = resolve_coupling(self.coupling, default="independent")

    # ------------------------------------------------------------------

    def _call_model(self, model, xt, t, model_kwargs):
        t_model = torch.zeros_like(t) if self.time_invariant else t
        return model(xt, t_model, **(model_kwargs or {}))

    def _explicit_energy(self, model, xt, t, model_kwargs):
        r"""Explicit energy :math:`g` and its input-gradient: ``dot``/``mean``:
        :math:`g(x) = x \cdot f(x)`; ``l2``: :math:`g(x) = -\tfrac12
        \|f(x)\|^2`. One forward pass, differentiated through the model with
        the graph kept, so the loss on the gradient trains the parameters;
        returns ``(grad, per-sample energies, raw field)``."""
        with torch.enable_grad():
            xx = xt.detach().requires_grad_(True)
            out = self._call_model(model, xx, t, model_kwargs)
            if isinstance(out, tuple):
                out = out[0]
            if self.energy_type in ("dot", "mean"):
                energy = torch.sum((xx * out).reshape(xx.shape[0], -1), dim=-1)
            else:  # l2
                energy = -0.5 * torch.sum(torch.square(out).reshape(xx.shape[0], -1), dim=-1)
            (grad,) = torch.autograd.grad(energy.sum(), xx, create_graph=True)
        return grad, energy, out

    def training_losses(self, params: Any, x1: Tensor, generator: torch.Generator,
                        x0: Optional[Tensor] = None,
                        model_kwargs: Optional[Dict[str, Any]] = None, *,
                        t: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """Terms dict with 'loss' (per-sample), 'pred', 'weights', optional
        'energy'. ``t`` injects the ``(batch,)`` times instead of drawing
        them: a hook for tests that compare with the JAX package on its own
        draws."""
        mk = model_kwargs or {}
        model = self._model(params)
        batch = x1.shape[0]

        if x0 is None:
            x0 = torch.randn(x1.shape, generator=generator, device=x1.device, dtype=x1.dtype)
        elif x0.shape != x1.shape:
            raise ValueError(f"x0 shape {tuple(x0.shape)} must match x1 shape {tuple(x1.shape)}")

        coupled = self.coupling(x0, x1, generator=generator, **mk)
        x0, x1c = coupled.x0, coupled.x1

        if t is None:
            eps = sched_init(self.train_eps)
            t0, t1 = eps, 1.0 - eps
            t = torch.rand((batch,), generator=generator, device=x1.device,
                           dtype=x1.dtype) * (t1 - t0) + t0

        xt, ut = self.interpolant.interpolate(x0, x1c, t)
        ct = compute_eqm_ct(t, threshold=self.ct_threshold, multiplier=self.ct_multiplier)
        ct = ct.reshape(batch, *([1] * (xt.ndim - 1)))
        target = -ut * ct

        terms: Dict[str, Tensor] = {"weights": coupled.weights}

        act = None
        if self.prediction == "velocity":
            if self.energy_type == "none":
                out = self._call_model(model, xt, t, mk)
                if isinstance(out, tuple):
                    out, act = out
                terms["pred"] = out
                terms["loss"] = mean_flat(torch.square(out - target))
            else:
                grad, energy, out = self._explicit_energy(model, xt, t, mk)
                terms["pred"] = out
                terms["loss"] = mean_flat(torch.square(grad - target))
                terms["energy"] = energy
        else:
            out = self._call_model(model, xt, t, mk)
            if isinstance(out, tuple):
                out, act = out
            terms["pred"] = out
            te = expand_t_like_x(t, xt)
            _, drift_var = self.interpolant.compute_drift(xt, t)
            sigma_t, _ = self.interpolant.compute_sigma_t(te)
            if self.loss_weight == "velocity":
                weight = torch.square(drift_var / sigma_t)
            elif self.loss_weight == "likelihood":
                weight = drift_var / torch.square(sigma_t)
            else:
                weight = 1.0
            if self.prediction == "noise":
                terms["loss"] = mean_flat(weight * torch.square(out - x0))
            else:  # score
                terms["loss"] = mean_flat(weight * torch.square(out * sigma_t + x0))

        if self.apply_dispersion and act is not None:
            feats = act[-1] if isinstance(act, (list, tuple)) and len(act) else act
            if not isinstance(feats, (list, tuple)):
                terms["loss"] = terms["loss"] + self.dispersion_weight * dispersive_loss(feats)

        return terms

    def __call__(self, params: Any, x: Tensor, generator: torch.Generator,
                 x0: Optional[Tensor] = None, *,
                 model_kwargs: Optional[Dict[str, Any]] = None,
                 t: Optional[Tensor] = None) -> Tensor:
        terms = self.training_losses(params, x, generator, x0=x0, model_kwargs=model_kwargs, t=t)
        return _weighted_mean(terms["loss"], terms.get("weights"))
