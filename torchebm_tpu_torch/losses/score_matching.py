r"""Score-matching objectives: exact and approximate Hyvärinen, denoising,
sliced (counterpart of :mod:`torchebm_tpu.losses.score_matching`).

The call keeps the port's loss contract, ``loss(params, x, generator,
model_kwargs=...)`` with ``params=None`` meaning the module's own
parameters; autograd reaches them through ``loss.backward()``. Every random
draw comes from ``generator``, and each has a keyword through which a caller
can hand it in instead: ``noise=`` (the unit normal draw of DSM and of the
approximate Hessian probe) and ``projections=`` (SSM's tiled projections).

- ``compute_score`` is :math:`\nabla_x E` by autograd with the graph kept,
  so the loss on it trains the parameters.
- Exact SM's per-sample score and Laplacian are ``torch.func.vmap`` over
  ``torch.func.grad`` / ``jacrev`` of the energy of one sample; the
  ``torch.func`` transforms compose with the outer autograd over the
  module's parameters. An energy evaluated there may not read a tensor on
  the host (``.item()``, ``.cpu()``, ``bool()``): ``vmap`` cannot batch it.
- Sliced SM takes the score and the Hessian-vector product from one
  forward-over-reverse pass, ``torch.func.jvp`` of ``torch.func.grad``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from .base import BaseLoss

Tensor = torch.Tensor

__all__ = ["BaseScoreMatching", "ScoreMatching", "DenoisingScoreMatching", "SlicedScoreMatching"]


def _normal(generator: torch.Generator, x: Tensor) -> Tensor:
    return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)


class BaseScoreMatching(BaseLoss):
    """Shared machinery: the model's score, data perturbation, regularisation."""

    def compute_score(self, model, x: Tensor, model_kwargs) -> Tensor:
        r""":math:`\nabla_x E(x)` (the JAX package's sign convention), with
        the graph kept."""
        with torch.enable_grad():
            xx = x if x.requires_grad else x.detach().requires_grad_(True)
            energy = model.energy(xx, **(model_kwargs or {}))
            (grad,) = torch.autograd.grad(energy.sum(), xx, create_graph=True)
        return grad

    def perturb_data(self, x: Tensor, noise: Tensor, noise_scale: float):
        """``(x + σ·noise, σ·noise)`` for a unit normal draw ``noise``."""
        scaled = noise_scale * noise
        return x + scaled, scaled

    def add_regularization(self, loss: Tensor, model, x: Tensor, model_kwargs) -> Tensor:
        """Default regulariser: mean ‖score‖²."""
        if self.custom_regularization is not None:
            return self.custom_regularization(loss, model, x)
        if self.regularization_strength <= 0:
            return loss
        score = self.compute_score(model, x, model_kwargs)
        return loss + self.regularization_strength * torch.mean(
            torch.sum(torch.square(score).reshape(x.shape[0], -1), dim=-1)
        )


@dataclass(eq=False)
class ScoreMatching(BaseScoreMatching):
    r"""Hyvärinen (2005) score matching.

    ``hessian_method="exact"``: the per-sample score and Laplacian by
    ``vmap(grad)`` / ``vmap(jacrev)`` on the flattened samples;
    unconditional only (per-sample conditioning cannot batch through the
    ``vmap`` trace). ``"approx"``: a finite-difference probe along a normal
    draw (ε = 1e-5), the trace divided by the data dimension; ``noise=``
    hands in that draw.

    The ``"approx"`` quotient cancels in float32: it divides a difference
    of two scores by ε = 1e-5, so a rounding of 1e-7 in the score reaches
    the trace term as 1e-2. The computation is kept as the JAX package's.
    Where float32 matters use ``hessian_method="exact"`` or
    :class:`DenoisingScoreMatching`.
    """

    model: Any = None
    hessian_method: str = "exact"
    regularization_strength: float = 0.0
    custom_regularization: Optional[Callable] = None

    def __post_init__(self):
        if self.hessian_method not in ("exact", "approx"):
            raise ValueError(
                f"hessian_method must be 'exact' or 'approx', got {self.hessian_method!r}"
            )

    def __call__(self, params: Any, x: Tensor, generator: torch.Generator, *,
                 model_kwargs: Optional[Dict[str, Any]] = None,
                 noise: Optional[Tensor] = None) -> Tensor:
        model = self._model(params)
        if self.hessian_method == "approx":
            loss = self._approx(model, x, generator, model_kwargs, noise)
        else:
            loss = self._exact(model, x, model_kwargs)
        return self.add_regularization(loss, model, x, model_kwargs)

    def _exact(self, model, x: Tensor, model_kwargs) -> Tensor:
        if model_kwargs:
            raise NotImplementedError(
                "Conditional exact score matching is not supported (per-sample "
                "conditioning cannot batch through the vmap Hessian trace). "
                "Use hessian_method='approx' or DenoisingScoreMatching."
            )
        x_flat = x.reshape(x.shape[0], -1)

        def score_fn(x_single):  # score of log p = -∇E
            return torch.func.grad(lambda xi: -model.energy(xi[None])[0])(x_single)

        def laplacian_fn(x_single):
            return torch.trace(torch.func.jacrev(score_fn)(x_single))

        score = torch.func.vmap(score_fn)(x_flat)
        laplacian = torch.func.vmap(laplacian_fn)(x_flat)
        return torch.mean(0.5 * torch.sum(torch.square(score), dim=-1) + laplacian)

    def _approx(self, model, x: Tensor, generator, model_kwargs, noise) -> Tensor:
        batch = x.shape[0]
        data_dim = math.prod(x.shape[1:])
        score = self.compute_score(model, x, model_kwargs)
        sq_term = 0.5 * torch.mean(torch.sum(torch.square(score).reshape(batch, -1), dim=-1))
        epsilon = 1e-5
        x_noise = x + epsilon * (_normal(generator, x) if noise is None else noise)
        score_noise = self.compute_score(model, x_noise, model_kwargs)
        hessian_trace = torch.mean(
            torch.sum(((score_noise - score) * (x_noise - x)).reshape(batch, -1), dim=-1)
        ) / (epsilon**2 * data_dim)
        return sq_term - hessian_trace


@dataclass(eq=False)
class DenoisingScoreMatching(BaseScoreMatching):
    r"""Vincent (2011) DSM: perturb with σ-noise and regress the model score
    :math:`-\nabla E` onto :math:`-\text{noise}/\sigma^2`. The sign is the
    JAX package's (it deliberately differs from upstream torchebm): the
    trained energy is low at the data, so the library's Langevin and HMC
    samplers draw from it directly. Conditional-capable. ``noise=`` hands in
    the unit normal draw."""

    model: Any = None
    noise_scale: float = 0.01
    regularization_strength: float = 0.0
    custom_regularization: Optional[Callable] = None

    def __call__(self, params: Any, x: Tensor, generator: torch.Generator, *,
                 model_kwargs: Optional[Dict[str, Any]] = None,
                 noise: Optional[Tensor] = None) -> Tensor:
        model = self._model(params)
        x_perturbed, scaled = self.perturb_data(
            x, _normal(generator, x) if noise is None else noise, self.noise_scale)
        score = -self.compute_score(model, x_perturbed, model_kwargs)
        target = -scaled / (self.noise_scale**2)
        loss = 0.5 * torch.mean(
            torch.sum(torch.square(score - target).reshape(x.shape[0], -1), dim=-1)
        )
        return self.add_regularization(loss, model, x, model_kwargs)


@dataclass(eq=False)
class SlicedScoreMatching(BaseScoreMatching):
    r"""Song et al. (2019) sliced score matching by random projections,

    .. math::
        \mathbb E_v\,\Big[ v^\top \nabla_x (v^\top s(x)) + \tfrac12 (v^\top s(x))^2 \Big],

    with ``n_projections`` Rademacher, sphere or Gaussian vectors tiled over
    the batch. Unconditional only (the tiling cannot carry per-sample
    conditioning). ``projections=`` hands in the ``(n_projections · B,
    prod(event))`` projections; :meth:`project` makes them from a normal
    draw.
    """

    model: Any = None
    n_projections: int = 5
    projection_type: str = "rademacher"
    regularization_strength: float = 0.0
    custom_regularization: Optional[Callable] = None

    def __post_init__(self):
        if self.projection_type not in ("rademacher", "sphere", "gaussian"):
            raise ValueError(
                f"projection_type must be rademacher/sphere/gaussian, got {self.projection_type!r}"
            )

    def project(self, v: Tensor) -> Tensor:
        """The projections of type ``projection_type`` from a unit normal
        draw ``v``: its signs, its rows scaled to norm √d, or ``v``."""
        if self.projection_type == "rademacher":
            return torch.sign(v)
        if self.projection_type == "sphere":
            norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
            return v / torch.clamp(norm, min=1e-12) * math.sqrt(v.shape[-1])
        return v

    def __call__(self, params: Any, x: Tensor, generator: torch.Generator, *,
                 model_kwargs: Optional[Dict[str, Any]] = None,
                 projections: Optional[Tensor] = None) -> Tensor:
        if model_kwargs:
            raise NotImplementedError(
                "Conditional sliced score matching is not supported (the "
                "projection tiling expands the batch); use "
                "DenoisingScoreMatching for conditional training."
            )
        model = self._model(params)
        batch = x.shape[0]
        dup_x = x.reshape(batch, -1).repeat(self.n_projections, 1)
        v = self.project(_normal(generator, dup_x)) if projections is None else projections

        def logp_sum(xx):
            return torch.sum(-model.energy(xx.reshape(-1, *x.shape[1:])))

        # one forward-over-reverse pass gives the score and the
        # Hessian-vector product Hv (H is symmetric)
        grad1, hvp = torch.func.jvp(torch.func.grad(logp_sum), (dup_x,), (v,))
        v_score = torch.sum(grad1 * v, dim=-1)
        term1 = 0.5 * torch.square(v_score)
        term2 = torch.sum(v * hvp, dim=-1)

        term1 = torch.mean(term1.reshape(self.n_projections, -1), dim=0)
        term2 = torch.mean(term2.reshape(self.n_projections, -1), dim=0)
        loss = torch.mean(term1 + term2)
        return self.add_regularization(loss, model, x, model_kwargs)
