r"""Heun (trapezoidal, 2-stage) SDE integrator
(counterpart of :mod:`torchebm_tpu.integrators.heun`)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Tuple

from .base import BaseSDERungeKuttaIntegrator

__all__ = ["HeunIntegrator"]


@dataclass(frozen=True)
class HeunIntegrator(BaseSDERungeKuttaIntegrator):
    r"""Heun's trapezoidal predictor–corrector, order 2 deterministic part.

    .. math::
        k_1 = f(x_n, t_n), \quad k_2 = f(x_n + h k_1, t_n + h), \quad
        x_{n+1} = x_n + \tfrac h2 (k_1 + k_2) + \sqrt{2Dh}\,\varepsilon
    """

    tableau_a: ClassVar[Tuple[Tuple[float, ...], ...]] = ((), (1.0,))
    tableau_b: ClassVar[Tuple[float, ...]] = (0.5, 0.5)
    tableau_c: ClassVar[Tuple[float, ...]] = (0.0, 1.0)
