r"""Riemannian-manifold HMC (Girolami & Calderhead 2011).

Counterpart of :mod:`torchebm_tpu.samplers.rmhmc`. Hamiltonian with a
position-dependent SPD metric :math:`G(x)`:

.. math::
    H(x, p) = U(x) + \tfrac12 p^\top G(x)^{-1} p + \tfrac12 \log|G(x)|

Trajectories use the non-separable
:class:`~torchebm_tpu_torch.integrators.GeneralisedLeapfrogIntegrator`. The
metric is factored by ``torch.linalg.cholesky_ex``, which leaves its status
on the device (``torch.linalg.cholesky`` reads it on the host, a sync in every
force), and solved by ``torch.linalg.solve_triangular``; a transition makes
no host sync. The force :math:`-\partial H/\partial x` at fixed :math:`p` is
:math:`-\nabla U` plus one vector-Jacobian product through ``metric_fn``:
with :math:`v = G^{-1}p`,

.. math::
    -\partial_{x_k} \big[\tfrac12 p^\top G^{-1} p + \tfrac12 \log|G|\big]
    = \textstyle\sum_{ij} \partial_{x_k} G_{ij}\;
      \tfrac12 \big(v v^\top - G^{-1}\big)_{ij},

so autograd runs through ``metric_fn`` alone, not through the factorisation.
The implicit momentum half-step asks for the force at one position for
every Picard iterate of the momentum: :math:`\nabla U`, :math:`G` with its
graph and :math:`G^{-1}` are computed once per position, and each momentum
costs two small matrix products and one backward pass through
``metric_fn``. A metric that does not depend on :math:`x` adds nothing, and
the force is HMC's. NaN and Inf proposals are rejected outright.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ..core.energies import Energy
from ..core.schedulers import BaseScheduler, sched_value
from ..integrators import resolve_integrator
from .base import BaseSampler

Tensor = torch.Tensor

__all__ = ["RiemannianManifoldHMC"]


def _chol(G: Tensor) -> Tensor:
    """The lower Cholesky factor, its status left on the device."""
    return torch.linalg.cholesky_ex(G).L


def _solve_metric(L: Tensor, p: Tensor) -> Tensor:
    """G⁻¹ p from the Cholesky factor (two batched triangular solves)."""
    y = torch.linalg.solve_triangular(L, p[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]


def _logdet_from_chol(L: Tensor) -> Tensor:
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


@dataclass(eq=False)
class RiemannianManifoldHMC(BaseSampler):
    """RMHMC sampler over a user-supplied differentiable metric ``x -> G(x)``.

    ``metric_fn`` must return a symmetric positive-definite ``(batch, dim,
    dim)`` tensor and be differentiable with respect to ``x``. With the
    identity metric a transition draws the same numbers as
    :class:`~torchebm_tpu_torch.samplers.HamiltonianMonteCarlo`'s loop (the
    momentum's normals, then the Metropolis uniforms) and computes the same
    trajectory. Diagnostics add ``acceptance_rate``, the mean acceptance
    probability.
    """

    model: Energy
    metric_fn: Optional[Callable[[Tensor], Tensor]] = None
    step_size: Union[float, BaseScheduler] = 1e-3
    n_leapfrog_steps: int = 10
    integrator: Any = None

    def __post_init__(self):
        if not callable(self.metric_fn):
            raise TypeError("metric_fn must be callable: x -> G(x)")
        if self.n_leapfrog_steps <= 0:
            raise ValueError("n_leapfrog_steps must be positive")
        integ = resolve_integrator(
            self.integrator, default="generalised_leapfrog", families=("symplectic",)
        )
        if integ.separable:
            raise TypeError(
                "RiemannianManifoldHMC requires a non-separable symplectic "
                f"integrator; got separable {type(integ).__name__}."
            )
        self.integrator = integ

    # -------------------------------------------------------------- physics

    def _hamiltonian(self, x: Tensor, p: Tensor, model_kwargs) -> Tensor:
        L = _chol(self.metric_fn(x))
        kinetic = 0.5 * torch.sum(p * _solve_metric(L, p), dim=-1)
        return self.energy_of(x, model_kwargs) + kinetic + 0.5 * _logdet_from_chol(L)

    def _position_terms(self, x: Tensor, model_kwargs):
        """What the force at ``x`` needs for any momentum: ``(∇U(x), None)``
        for a metric that does not depend on ``x``, else ``(∇U(x), (x', G(x'),
        G⁻¹))`` with ``x'`` the leaf that ``G`` keeps its graph to."""
        grad_u = self.gradient_of(x, model_kwargs)
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            G = self.metric_fn(xg)
        if not G.requires_grad:
            return grad_u, None
        L = _chol(G.detach())
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
        l_inv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
        return grad_u, (xg, G, l_inv.mT @ l_inv)

    def _force(self, x: Tensor, p: Tensor, model_kwargs, terms=None) -> Tensor:
        r""":math:`-\partial H/\partial x` with :math:`p` held fixed; ``terms``
        are :meth:`_position_terms` of ``x``, computed here when not given."""
        grad_u, graph = self._position_terms(x, model_kwargs) if terms is None else terms
        if graph is None:
            return -grad_u
        xg, G, g_inv = graph
        v = g_inv @ p[..., None]
        (g_metric,) = torch.autograd.grad(G, xg, 0.5 * (v @ v.mT - g_inv), retain_graph=True)
        return g_metric - grad_u

    def _velocity(self, x: Tensor, p: Tensor) -> Tensor:
        r""":math:`\partial H/\partial p = G(x)^{-1} p`."""
        return _solve_metric(_chol(self.metric_fn(x)), p)

    def _momentum(self, z: Tensor, x: Tensor) -> Tensor:
        r""":math:`p = L z \sim N(0, G(x))` for :math:`G = L L^\top`."""
        return (_chol(self.metric_fn(x)) @ z[..., None])[..., 0]

    def _transition(self, x: Tensor, generator: Optional[torch.Generator], eps, model_kwargs,
                    noise: Optional[Tensor] = None,
                    uniforms: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        """One MH proposal; returns ``(new_x, mean acceptance probability)``.

        The momentum's normals ``noise`` (shaped like ``x``) and the
        Metropolis uniforms ``uniforms`` (one per chain) are drawn from
        ``generator`` in that order, or injected."""
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        p = self._momentum(noise, x)
        cur_h = torch.clamp(self._hamiltonian(x, p, model_kwargs), -1e10, 1e10)
        # the integrator asks for the force at one position for several
        # momenta (the implicit half-step, then the next step's): the
        # position's terms are computed once per position
        cache = {}

        def force(x_, p_, t_):
            if cache.get("x") is not x_:
                cache.update(x=x_, terms=self._position_terms(x_, model_kwargs))
            return self._force(x_, p_, model_kwargs, cache["terms"])

        proposed = self.integrator.integrate(
            {"x": x, "p": p}, eps, self.n_leapfrog_steps, force=force,
            velocity=lambda x_, p_, t_: self._velocity(x_, p_),
        )
        x_prop, p_prop = proposed["x"], proposed["p"]
        prop_h = self._hamiltonian(x_prop, p_prop, model_kwargs)
        finite = torch.all(torch.isfinite(x_prop.reshape(x_prop.shape[0], -1)), dim=-1)
        finite = finite & torch.isfinite(prop_h)
        diff = torch.clamp(cur_h - torch.clamp(prop_h, -1e10, 1e10), -50.0, 50.0)
        accept_prob = torch.where(finite, torch.clamp(torch.exp(diff), max=1.0),
                                  torch.zeros_like(diff))
        if uniforms is None:
            uniforms = torch.rand(accept_prob.shape, generator=generator, device=x.device,
                                  dtype=accept_prob.dtype)
        mask = (uniforms < accept_prob).reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.where(mask, x_prop, x), torch.mean(accept_prob)

    # ---------------------------------------------------------------- hooks

    def init_carry(self, x0, generator, model_kwargs) -> Dict[str, Any]:
        return {"x": x0, "accept_rate": torch.zeros((), device=x0.device)}

    def step(self, carry, i, generator, model_kwargs):
        x_new, acc = self._transition(carry["x"], generator, sched_value(self.step_size, i),
                                      model_kwargs)
        return {"x": x_new, "accept_rate": acc}

    def extra_diagnostics(self, carry, model_kwargs):
        return {"acceptance_rate": carry["accept_rate"]}
