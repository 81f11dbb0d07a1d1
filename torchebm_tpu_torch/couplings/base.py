r"""Coupling contracts: pairing rules between noise and data minibatches
(counterpart of :mod:`torchebm_tpu.couplings.base`).

A coupling pairs a source batch :math:`x_0` with a target batch :math:`x_1`
before interpolation; cost-based families reorder or resample :math:`x_1` by
(approximately) minimising the squared-Euclidean transport cost,
model-induced families generate :math:`x_1 = \Phi(x_0)`.

The JAX package's ``key`` becomes an explicit ``generator`` (stochastic
solvers require it; deterministic ones ignore it), and its
``stop_gradient`` on the result becomes ``detach()``: a coupling's result
carries no graph. Couplings are tensor-free dataclasses; they run on the
device of the batches they are given.

The cost-based couplings take batches sharded on their rows (DTensors): the
cost matrix is batch-global, so each process gathers both batches, solves
the whole coupling (every process's generator in the same state: the same
draws, one Sinkhorn launch on each), and keeps its own rows, with the
input's placement. The result equals the unsharded call's rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..parallel.mesh import is_dtensor, like_rows, row_shard

Tensor = torch.Tensor

__all__ = ["CouplingResult", "BaseCoupling", "BaseCostCoupling", "BaseModelCoupling"]


@dataclass(eq=False)
class CouplingResult:
    """Unpacking-stable result container: iterates as ``(x0, x1)``; extras
    (per-pair ``weights`` for unbalanced OT) ride along as attributes without
    breaking ``x0, x1 = coupling(...)``."""

    x0: Tensor
    x1: Tensor
    weights: Optional[Tensor] = None

    def __iter__(self):
        return iter((self.x0, self.x1))


class BaseCoupling:
    """Abstract coupling. Subclasses implement :meth:`couple`."""

    def couple(self, x0: Tensor, x1: Optional[Tensor] = None, *,
               generator: Optional[torch.Generator] = None, **kwargs: Any) -> CouplingResult:
        raise NotImplementedError

    def __call__(self, x0, x1=None, *, generator=None, **kwargs) -> CouplingResult:
        return self.couple(x0, x1, generator=generator, **kwargs)

    @staticmethod
    def _check_batch(x0: Tensor, x1: Tensor) -> None:
        if x0.shape[0] != x1.shape[0]:
            raise ValueError(
                f"Coupling requires equal batch sizes, got {x0.shape[0]} and {x1.shape[0]}"
            )

    def _require_x1(self, x1: Optional[Tensor]) -> Tensor:
        if x1 is None:
            raise ValueError(
                f"{type(self).__name__} pairs against an existing target batch; "
                f"x1 must not be None"
            )
        return x1


class BaseCostCoupling(BaseCoupling):
    r"""Template for cost-minimising couplings: validate → cost matrix
    (:meth:`compute_cost`, max-normalised squared Euclidean by default) →
    abstract :meth:`_solve` → reindex ``x1``. The order and the marginal of
    ``x0`` are always preserved."""

    def compute_cost(self, x0: Tensor, x1: Tensor, **kwargs: Any) -> Tensor:
        """``(B, B)`` squared distances over the flattened events, divided by
        their maximum; the maximum stays on the device (no host sync)."""
        b = x0.shape[0]
        a = x0.reshape(b, -1)
        c = x1.reshape(b, -1)
        sq = torch.sum(a * a, dim=1)[:, None] + torch.sum(c * c, dim=1)[None, :] - 2.0 * a @ c.T
        cost = torch.clamp(sq, min=0.0)
        return cost / torch.clamp(torch.max(cost), min=1e-12)

    def _solve(self, cost: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def couple(self, x0, x1=None, *, generator=None, **kwargs) -> CouplingResult:
        x1 = self._require_x1(x1)
        if is_dtensor(x0) or is_dtensor(x1):
            return self._couple_sharded(x0, x1, generator, kwargs)
        self._check_batch(x0, x1)
        if x0.shape[0] == 1:
            return CouplingResult(x0.detach(), x1.detach())
        cost = self.compute_cost(x0, x1, **kwargs)
        idx = self._solve(cost, generator=generator)
        return CouplingResult(x0.detach(), x1.detach()[idx])

    def _couple_sharded(self, x0, x1, generator, kwargs) -> CouplingResult:
        """:meth:`couple` of two batches sharded alike on their rows: the
        whole batches gathered, coupled, and this process's rows kept."""
        if not (is_dtensor(x0) and is_dtensor(x1)) or x0.placements != x1.placements:
            raise ValueError("a sharded coupling takes x0 and x1 sharded alike (DTensors of "
                             "one placement)")
        local, start, _ = row_shard(x0)
        whole = self.couple(x0.full_tensor(), x1.full_tensor(), generator=generator, **kwargs)
        rows = slice(start, start + local.shape[0])
        weights = None if whole.weights is None else like_rows(whole.weights[rows], x0)
        return CouplingResult(x0.detach(), like_rows(whole.x1[rows], x1), weights=weights)


class BaseModelCoupling(BaseCoupling):
    r"""Template for model-induced couplings :math:`(x_0, \Phi(x_0))`. Any
    incoming ``x1`` is ignored."""

    def _generate(self, x0: Tensor, generator: Optional[torch.Generator] = None,
                  **kwargs: Any) -> Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def couple(self, x0, x1=None, *, generator=None, **kwargs) -> CouplingResult:
        x1_gen = self._generate(x0, generator=generator, **kwargs)
        return CouplingResult(x0.detach(), x1_gen.detach())
