r"""Classic RK4 and the 3/8-rule RK4 variant
(counterpart of :mod:`torchebm_tpu.integrators.rk4`)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Tuple

from .base import BaseRungeKuttaIntegrator

__all__ = ["RK4Integrator", "RK438Integrator"]


@dataclass(frozen=True)
class RK4Integrator(BaseRungeKuttaIntegrator):
    r"""The classic 4-stage, 4th-order Runge–Kutta method.

    Butcher tableau: :math:`c = (0, \tfrac12, \tfrac12, 1)`,
    :math:`b = (\tfrac16, \tfrac13, \tfrac13, \tfrac16)`.
    """

    tableau_a: ClassVar[Tuple[Tuple[float, ...], ...]] = (
        (),
        (0.5,),
        (0.0, 0.5),
        (0.0, 0.0, 1.0),
    )
    tableau_b: ClassVar[Tuple[float, ...]] = (1 / 6, 1 / 3, 1 / 3, 1 / 6)
    tableau_c: ClassVar[Tuple[float, ...]] = (0.0, 0.5, 0.5, 1.0)


@dataclass(frozen=True)
class RK438Integrator(BaseRungeKuttaIntegrator):
    r"""Kutta's 3/8-rule: 4-stage, 4th-order with slightly smaller error constant.

    Butcher tableau: :math:`c = (0, \tfrac13, \tfrac23, 1)`,
    :math:`b = (\tfrac18, \tfrac38, \tfrac38, \tfrac18)`.
    """

    tableau_a: ClassVar[Tuple[Tuple[float, ...], ...]] = (
        (),
        (1 / 3,),
        (-1 / 3, 1.0),
        (1.0, -1.0, 1.0),
    )
    tableau_b: ClassVar[Tuple[float, ...]] = (1 / 8, 3 / 8, 3 / 8, 1 / 8)
    tableau_c: ClassVar[Tuple[float, ...]] = (0.0, 1 / 3, 2 / 3, 1.0)
