r"""Euler–Maruyama integrator (counterpart of ``torchebm_tpu.integrators.euler_maruyama``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Tuple

from .base import BaseSDERungeKuttaIntegrator

__all__ = ["EulerMaruyamaIntegrator"]


@dataclass(frozen=True)
class EulerMaruyamaIntegrator(BaseSDERungeKuttaIntegrator):
    r"""Explicit Euler–Maruyama: :math:`x_{n+1} = x_n + h f(x_n,t_n) + \sqrt{2Dh}\,\varepsilon`.

    The Langevin default; registry names ``"euler"`` and ``"euler_maruyama"``.
    """

    tableau_a: ClassVar[Tuple[Tuple[float, ...], ...]] = ((),)
    tableau_b: ClassVar[Tuple[float, ...]] = (1.0,)
    tableau_c: ClassVar[Tuple[float, ...]] = (0.0,)
