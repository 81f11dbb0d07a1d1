r"""Euler–Maruyama and drift-implicit (backward) Euler–Maruyama integrators
(counterpart of ``torchebm_tpu.integrators.euler_maruyama``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Tuple

from .base import BaseSDERungeKuttaIntegrator

__all__ = ["EulerMaruyamaIntegrator", "BackwardEulerMaruyamaIntegrator"]


@dataclass(frozen=True)
class EulerMaruyamaIntegrator(BaseSDERungeKuttaIntegrator):
    r"""Explicit Euler–Maruyama: :math:`x_{n+1} = x_n + h f(x_n,t_n) + \sqrt{2Dh}\,\varepsilon`.

    The Langevin default; registry names ``"euler"`` and ``"euler_maruyama"``.
    """

    tableau_a: ClassVar[Tuple[Tuple[float, ...], ...]] = ((),)
    tableau_b: ClassVar[Tuple[float, ...]] = (1.0,)
    tableau_c: ClassVar[Tuple[float, ...]] = (0.0,)


@dataclass(frozen=True)
class BackwardEulerMaruyamaIntegrator(BaseSDERungeKuttaIntegrator):
    r"""Drift-implicit Euler–Maruyama (DIRK with :math:`a = [[1]]`), noise explicit.

    The implicit equation :math:`k = f(x + h k, t+h)` is solved by Picard
    iteration (``solver_max_iter`` drift calls). Registry names
    ``"backward_euler"`` and ``"backward_euler_maruyama"``.
    """

    tableau_a: ClassVar[Tuple[Tuple[float, ...], ...]] = ((1.0,),)
    tableau_b: ClassVar[Tuple[float, ...]] = (1.0,)
    tableau_c: ClassVar[Tuple[float, ...]] = (1.0,)
