r"""Adaptive Heun: embedded 2(1) Runge–Kutta pair
(counterpart of :mod:`torchebm_tpu.integrators.adaptive_heun`)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Optional, Tuple

from .base import BaseRungeKuttaIntegrator

__all__ = ["AdaptiveHeunIntegrator"]


@dataclass(frozen=True)
class AdaptiveHeunIntegrator(BaseRungeKuttaIntegrator):
    r"""Heun 2(1) embedded pair: trapezoidal 2nd-order solution with an
    embedded Euler (1st-order) estimate.

    Error weights :math:`e = b - \hat b = (\tfrac12, -\tfrac12)`; controller
    exponent :math:`-1/2`.
    """

    tableau_a: ClassVar[Tuple[Tuple[float, ...], ...]] = ((), (1.0,))
    tableau_b: ClassVar[Tuple[float, ...]] = (0.5, 0.5)
    tableau_c: ClassVar[Tuple[float, ...]] = (0.0, 1.0)
    error_weights: ClassVar[Optional[Tuple[float, ...]]] = (0.5, -0.5)
    order: ClassVar[Optional[int]] = 2
    fsal: ClassVar[bool] = False
