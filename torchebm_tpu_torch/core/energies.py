r"""Energy function contracts and analytic test energies.

PyTorch counterpart of :mod:`torchebm_tpu.core.energies`. Energies are
``nn.Module``\ s whose parameters (means, covariances, ...) are buffers, so
``.to(device)`` moves them; scalar hyper-parameters stay Python floats, as in
the JAX package where they are static fields.

The contract: ``energy(x)`` maps ``(batch, *event_dims) -> (batch,)`` scalar
energies (unnormalised negative log-density); ``gradient(x)`` is
:math:`\nabla_x E(x)` with the shape of ``x``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch
from torch import nn

from .module import tensor_memo

Tensor = torch.Tensor

__all__ = [
    "Energy",
    "WrappedEnergy",
    "as_energy",
    "DoubleWellEnergy",
    "GaussianEnergy",
    "GaussianMixtureEnergy",
    "HarmonicEnergy",
    "RosenbrockEnergy",
    "AckleyEnergy",
    "RastriginEnergy",
]


def _atleast_batch(x: Tensor) -> Tensor:
    """Promote an unbatched event ``(d,)`` to a singleton batch ``(1, d)``."""
    return x[None] if x.ndim == 1 else x


def _float_tensor(a, like: Optional[Tensor] = None) -> Tensor:
    """``a`` as a float tensor on its own device (or ``like``'s), default dtype."""
    dtype = torch.get_default_dtype() if like is None else like.dtype
    device = None if like is None else like.device
    return torch.as_tensor(a, dtype=dtype, device=device)


class Energy(nn.Module):
    """Energy function base contract.

    Subclasses implement :meth:`energy`; calling the module, the autograd
    :meth:`gradient`, :meth:`score`, :meth:`unnorm_log_prob` and
    :meth:`value_and_grad` derive from it. Conditioning flows as keyword
    arguments straight through to ``energy``.
    """

    def energy(self, x: Tensor, **kwargs: Any) -> Tensor:
        raise NotImplementedError

    def forward(self, x: Tensor, **kwargs: Any) -> Tensor:
        return self.energy(x, **kwargs)

    def value_and_grad(self, x: Tensor, **kwargs: Any) -> tuple[Tensor, Tensor]:
        """``(E(x), ∇E(x))`` from one forward and one backward pass.

        Batch rows are independent, so differentiating ``sum(E)`` gives the
        per-sample gradient. When ``x`` itself requires grad the graph is
        kept, so the gradient can be differentiated again. An energy that
        does not depend on ``x`` has a zero gradient, as under ``jax.grad``.
        """
        create = x.requires_grad
        with torch.enable_grad():
            xx = x if create else x.detach().requires_grad_(True)
            e = self.energy(xx, **kwargs)
            g = None
            if e.requires_grad:
                (g,) = torch.autograd.grad(e.sum(), xx, create_graph=create, allow_unused=True)
        return (e if create else e.detach()), (torch.zeros_like(xx) if g is None else g)

    def gradient(self, x: Tensor, **kwargs: Any) -> Tensor:
        r""":math:`\nabla_x E(x)`, same shape as ``x`` (autograd by default)."""
        return self.value_and_grad(x, **kwargs)[1]

    def score(self, x: Tensor, **kwargs: Any) -> Tensor:
        r"""Stein score :math:`\nabla_x \log p(x) = -\nabla_x E(x)`."""
        return -self.gradient(x, **kwargs)

    def unnorm_log_prob(self, x: Tensor, **kwargs: Any) -> Tensor:
        """Unnormalised log-density ``-E(x)``."""
        return -self.energy(x, **kwargs)


class WrappedEnergy(Energy):
    """Adapts a callable ``fn(x) -> (B,)`` or ``fn(params, x) -> (B,)`` into an
    :class:`Energy`. An ``nn.Module`` given as ``fn`` or ``params`` is
    registered as a submodule, so ``.to(device)`` and ``.parameters()`` reach
    its weights.

    ``arch`` optionally names the exact compute graph of ``fn`` for kernel
    fast paths: ``"silu_mlp"`` (``MLPEnergy``'s SiLU stack) lets
    ``LangevinDynamics(fused_neural=...)`` run the neural chain kernel.
    :func:`as_energy` sets it for the library's ``MLPEnergy``; set it yourself
    only if ``fn`` really is that architecture.
    """

    def __init__(self, fn: Callable[..., Tensor], params: Any = None, arch: Optional[str] = None):
        super().__init__()
        self.fn = fn
        self.params = params
        self.arch = arch

    def energy(self, x: Tensor, **kwargs: Any) -> Tensor:
        out = self.fn(x, **kwargs) if self.params is None else self.fn(self.params, x, **kwargs)
        return torch.reshape(out, (x.shape[0],) if x.ndim > 1 else out.shape)


def _module_class(model: Any) -> type:
    """``type(model)``, or the class FSDP2's ``fully_shard`` wrapped: it swaps
    a module's class for ``FSDP<name>(FSDPModule, <class>)``."""
    cls = type(model)
    if torch.distributed.is_available() and len(cls.__bases__) == 2:
        from torch.distributed.fsdp import FSDPModule

        if cls.__bases__[0] is FSDPModule:
            return cls.__bases__[1]
    return cls


def as_energy(model: Any, params: Any = None) -> Energy:
    """Coerce ``model`` into an :class:`Energy`: an :class:`Energy` is returned
    as it is, any other callable (an ``nn.Module`` included) is wrapped.

    The library's :class:`~torchebm_tpu_torch.models.MLPEnergy` gets
    ``arch="silu_mlp"``. The match is on the class itself: a user class merely
    *named* ``MLPEnergy``, or a subclass that may change the activation, gets
    no tag, since the neural chain kernel computes a SiLU gradient. An
    ``MLPEnergy`` that FSDP2's ``fully_shard`` wrapped (its class swapped for
    ``FSDPMLPEnergy``, which adds no computation) keeps the tag.
    """
    if isinstance(model, Energy):
        return model
    if callable(model):
        from ..models.nets import MLPEnergy

        arch = "silu_mlp" if _module_class(model) is MLPEnergy and params is None else None
        return WrappedEnergy(fn=model, params=params, arch=arch)
    raise TypeError(f"Cannot interpret {model!r} as an energy function.")


# ---------------------------------------------------------------------------
# Analytic energies
# ---------------------------------------------------------------------------


class DoubleWellEnergy(Energy):
    r"""Double-well potential :math:`E(x) = h \sum_i (x_i^2 - b^2)^2`; wells at
    :math:`\pm b` per dimension."""

    def __init__(self, barrier_height: float = 2.0, b: float = 1.0):
        super().__init__()
        self.barrier_height = barrier_height
        self.b = b

    def energy(self, x: Tensor) -> Tensor:
        x = _atleast_batch(x)
        return self.barrier_height * torch.sum((x * x - self.b**2) ** 2, dim=-1)

    def gradient(self, x: Tensor) -> Tensor:
        # analytic 4 h x (x² - b²), the form the double-well chain kernel inlines
        return 4.0 * self.barrier_height * x * (x * x - self.b**2)


def _log_abs_det(a: Tensor) -> Tensor:
    return torch.linalg.slogdet(a)[1]


class GaussianEnergy(Energy):
    r"""Gaussian energy :math:`E(x) = \tfrac12 (x-\mu)^\top \Sigma^{-1} (x-\mu)`.

    ``mean``, ``cov`` and ``cov_inv`` are buffers; :meth:`create` computes the
    inverse once, so no solve runs inside a sampling loop.
    """

    def __init__(self, mean: Tensor, cov: Tensor, cov_inv: Tensor):
        super().__init__()
        self.register_buffer("mean", mean)
        self.register_buffer("cov", cov)
        self.register_buffer("cov_inv", cov_inv)

    @classmethod
    def create(cls, mean, cov) -> "GaussianEnergy":
        mean = _float_tensor(mean)
        cov = _float_tensor(cov, like=mean)
        if mean.ndim != 1:
            raise ValueError("Mean must be a 1D array.")
        if cov.ndim != 2 or cov.shape[0] != cov.shape[1]:
            raise ValueError("Covariance must be a 2D square matrix.")
        if mean.shape[0] != cov.shape[0]:
            raise ValueError("Mean dimension must match covariance dimension.")
        return cls(mean, cov, torch.linalg.inv(cov))

    @classmethod
    def standard(cls, dim: int) -> "GaussianEnergy":
        return cls.create(torch.zeros(dim), torch.eye(dim))

    def energy(self, x: Tensor) -> Tensor:
        x = _atleast_batch(x)
        delta = x - self.mean
        return 0.5 * torch.einsum("bi,ij,bj->b", delta, self.cov_inv, delta)

    def gradient(self, x: Tensor) -> Tensor:
        return (x - self.mean) @ self.cov_inv.T

    def sample(self, generator: torch.Generator, n: int) -> Tensor:
        """Exact i.i.d. draws via Cholesky, on the generator's device. The
        factor is computed once per state of ``cov`` (:func:`tensor_memo`;
        not for a ``cov`` that requires grad): ``torch.linalg.cholesky``
        checks its result on the host, so each fresh factor makes the host
        wait for the device."""
        chol = (torch.linalg.cholesky(self.cov) if self.cov.requires_grad
                else tensor_memo(self.cov, torch.linalg.cholesky))
        eps = torch.randn(
            (n, self.mean.shape[0]), generator=generator,
            device=generator.device, dtype=self.mean.dtype,
        )
        return self.mean + eps @ chol.T

    def log_z(self) -> Tensor:
        r"""Exact log partition function :math:`\tfrac d2\log 2\pi +
        \tfrac12\log|\Sigma|` of :math:`e^{-E}`. The log-determinant is
        computed once per state of ``cov`` (:func:`tensor_memo`; not for a
        ``cov`` that requires grad): on the card ``slogdet`` issues several
        kernels, the host's largest cost in an AIS call."""
        d = self.mean.shape[0]
        logdet = (_log_abs_det(self.cov) if self.cov.requires_grad
                  else tensor_memo(self.cov, _log_abs_det))
        return 0.5 * d * math.log(2 * math.pi) + 0.5 * logdet


class GaussianMixtureEnergy(Energy):
    r"""Isotropic Gaussian-mixture energy
    :math:`E(x) = -\log \sum_k w_k N(x; \mu_k, \sigma^2 I)`.

    Buffers: ``means`` ``(K, d)``, ``scale`` (0-d, σ) and ``log_weights``
    ``(K,)``. :meth:`gradient` is the analytic responsibility-weighted form.
    """

    def __init__(self, means: Tensor, scale: Tensor, log_weights: Tensor):
        super().__init__()
        self.register_buffer("means", means)
        self.register_buffer("scale", scale)
        self.register_buffer("log_weights", log_weights)

    @classmethod
    def create(cls, means, scale=1.0, weights=None) -> "GaussianMixtureEnergy":
        means = _float_tensor(means)
        if means.ndim != 2:
            raise ValueError("means must have shape (n_components, dim)")
        k = means.shape[0]
        if weights is None:
            log_w = torch.full((k,), -math.log(k), dtype=means.dtype, device=means.device)
        else:
            w = _float_tensor(weights, like=means)
            log_w = torch.log(w / torch.sum(w))
        return cls(means, _float_tensor(scale, like=means), log_w)

    @classmethod
    def eight_gaussians(cls, radius: float = 4.0, scale: float = 0.4) -> "GaussianMixtureEnergy":
        """The classic ring of 8 modes."""
        ang = torch.arange(8, dtype=torch.float32) * (2 * math.pi / 8)
        means = radius * torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
        return cls.create(means, scale=scale)

    def energy(self, x: Tensor) -> Tensor:
        x = _atleast_batch(x)
        d = x.shape[-1]
        diff = x[:, None, :] - self.means[None, :, :]  # (B, K, d)
        sq = torch.sum(diff * diff, dim=-1)  # (B, K)
        log_norm = d * torch.log(self.scale) + 0.5 * d * math.log(2 * math.pi)
        comp_logp = self.log_weights - 0.5 * sq / (self.scale**2) - log_norm
        return -torch.logsumexp(comp_logp, dim=-1)

    def gradient(self, x: Tensor) -> Tensor:
        r"""Analytic :math:`\nabla E = (x - \sum_k r_k(x)\,\mu_k)/\sigma^2` with
        softmax responsibilities :math:`r_k`."""
        x = _atleast_batch(x)
        diff = x[:, None, :] - self.means[None, :, :]
        logits = self.log_weights - 0.5 * torch.sum(diff * diff, dim=-1) / (self.scale**2)
        resp = torch.softmax(logits, dim=-1)
        return (x - resp @ self.means) / (self.scale**2)

    def sample(self, generator: torch.Generator, n: int) -> Tensor:
        """Exact i.i.d. draws, on the generator's device."""
        comp = torch.multinomial(
            torch.exp(self.log_weights), n, replacement=True, generator=generator
        )
        eps = torch.randn(
            (n, self.means.shape[-1]), generator=generator,
            device=generator.device, dtype=self.means.dtype,
        )
        return self.means[comp] + self.scale * eps


class HarmonicEnergy(Energy):
    r"""Harmonic oscillator :math:`E(x) = \tfrac12 k \sum_i x_i^2`."""

    def __init__(self, k: float = 1.0):
        super().__init__()
        self.k = k

    def energy(self, x: Tensor) -> Tensor:
        x = _atleast_batch(x)
        return 0.5 * self.k * torch.sum(x * x, dim=-1)

    def gradient(self, x: Tensor) -> Tensor:
        return self.k * x


class RosenbrockEnergy(Energy):
    r"""Rosenbrock valley :math:`\sum_i b(x_{i+1}-x_i^2)^2 + (a-x_i)^2`."""

    def __init__(self, a: float = 1.0, b: float = 100.0):
        super().__init__()
        self.a = a
        self.b = b

    def energy(self, x: Tensor) -> Tensor:
        x = _atleast_batch(x)
        if x.shape[-1] < 2:
            raise ValueError("Rosenbrock energy requires at least 2 dimensions.")
        x_i, x_ip1 = x[..., :-1], x[..., 1:]
        return torch.sum((self.a - x_i) ** 2 + self.b * (x_ip1 - x_i**2) ** 2, dim=-1)


class AckleyEnergy(Energy):
    r"""Ackley function; global minimum 0 at the origin."""

    def __init__(self, a: float = 20.0, b: float = 0.2, c: float = 2 * math.pi):
        super().__init__()
        self.a = a
        self.b = b
        self.c = c

    def energy(self, x: Tensor) -> Tensor:
        x = _atleast_batch(x)
        n = x.shape[-1]
        sum1 = torch.sum(x * x, dim=-1)
        sum2 = torch.sum(torch.cos(self.c * x), dim=-1)
        term1 = -self.a * torch.exp(-self.b * torch.sqrt(sum1 / n))
        term2 = -torch.exp(sum2 / n)
        return term1 + term2 + self.a + math.e


class RastriginEnergy(Energy):
    r"""Rastrigin function :math:`a n + \sum_i x_i^2 - a\cos(2\pi x_i)`."""

    def __init__(self, a: float = 10.0):
        super().__init__()
        self.a = a

    def energy(self, x: Tensor) -> Tensor:
        x = _atleast_batch(x)
        n = x.shape[-1]
        return self.a * n + torch.sum(x * x - self.a * torch.cos(2 * math.pi * x), dim=-1)
