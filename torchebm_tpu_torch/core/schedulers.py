r"""Step-indexed parameter schedules as pure functions.

PyTorch counterpart of :mod:`torchebm_tpu.core.schedulers`. Each scheduler is
a frozen dataclass exposing ``value(step)``: ``step`` is a Python int (the
result is a 0-d float32 tensor) or an integer tensor (the result is a float32
tensor of the same shape and device), so a whole per-step table is one
vectorised call, ``value(torch.arange(n_steps))``.

Iteration ``i`` of a sampler loop uses ``value(i)``; ``value(0)`` is the start
value. :func:`sched_value` evaluates a parameter that may be a float or a
scheduler.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Union

import torch

Tensor = torch.Tensor
ScalarOrSchedule = Union[float, "BaseScheduler"]

__all__ = [
    "BaseScheduler",
    "ConstantScheduler",
    "ExponentialDecayScheduler",
    "LinearScheduler",
    "CosineScheduler",
    "MultiStepScheduler",
    "WarmupScheduler",
    "TemperatureScheduler",
    "sched_value",
    "sched_init",
]


def _steps(step, dtype=torch.float32) -> Tensor:
    return torch.as_tensor(step).to(dtype)


class BaseScheduler:
    """Schedule contract: ``value(step) -> float32 tensor`` for an integer ``step``."""

    def value(self, step) -> Tensor:
        raise NotImplementedError

    def __call__(self, step) -> Tensor:
        return self.value(step)


def sched_value(param: ScalarOrSchedule, step) -> Tensor:
    """Evaluate a schedulable parameter (float or scheduler) at ``step``."""
    if isinstance(param, BaseScheduler):
        return param.value(step)
    return torch.as_tensor(param, dtype=torch.float32)


def sched_init(param: ScalarOrSchedule) -> float:
    """Python float value of a schedulable parameter at step 0."""
    if isinstance(param, BaseScheduler):
        return float(param.value(0))
    return float(param)


@dataclass(frozen=True)
class ConstantScheduler(BaseScheduler):
    """:math:`v(t) = v_0`."""

    start_value: float

    def value(self, step) -> Tensor:
        return torch.full_like(_steps(step), self.start_value)


@dataclass(frozen=True)
class ExponentialDecayScheduler(BaseScheduler):
    r""":math:`v(t) = \max(v_{min}, v_0 \gamma^t)`."""

    start_value: float
    decay_rate: float
    min_value: float = 0.0

    def __post_init__(self):
        if not 0.0 < self.decay_rate <= 1.0:
            raise ValueError(f"decay_rate must be in (0, 1], got {self.decay_rate}")
        if self.min_value < 0:
            raise ValueError(f"min_value must be non-negative, got {self.min_value}")

    def value(self, step) -> Tensor:
        val = self.start_value * torch.exp(_steps(step) * math.log(self.decay_rate))
        return torch.clamp(val, min=self.min_value)


@dataclass(frozen=True)
class LinearScheduler(BaseScheduler):
    """Linear ramp from ``start_value`` to ``end_value`` over ``n_steps``, then hold."""

    start_value: float
    end_value: float
    n_steps: int

    def __post_init__(self):
        if self.n_steps <= 0:
            raise ValueError(f"n_steps must be a positive integer, got {self.n_steps}")

    def value(self, step) -> Tensor:
        frac = torch.clamp(_steps(step) / self.n_steps, 0.0, 1.0)
        return self.start_value + frac * (self.end_value - self.start_value)


@dataclass(frozen=True)
class CosineScheduler(BaseScheduler):
    """Cosine annealing from ``start_value`` to ``end_value`` over ``n_steps``, then hold."""

    start_value: float
    end_value: float
    n_steps: int

    def __post_init__(self):
        if self.n_steps <= 0:
            raise ValueError(f"n_steps must be a positive integer, got {self.n_steps}")

    def value(self, step) -> Tensor:
        frac = torch.clamp(_steps(step) / self.n_steps, 0.0, 1.0)
        cosine_factor = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return self.end_value + (self.start_value - self.end_value) * cosine_factor


@dataclass(frozen=True)
class MultiStepScheduler(BaseScheduler):
    r""":math:`v(t) = v_0 \gamma^{\#\{m_i \le t\}}`: milestone decay."""

    start_value: float
    milestones: tuple
    gamma: float = 0.1

    def __post_init__(self):
        ms = tuple(self.milestones)
        if not all(m > 0 for m in ms):
            raise ValueError("Milestone steps must be positive integers.")
        if not all(ms[i] < ms[i + 1] for i in range(len(ms) - 1)):
            raise ValueError("Milestones must be strictly increasing.")
        object.__setattr__(self, "milestones", ms)

    def value(self, step) -> Tensor:
        step = _steps(step, torch.int64)
        ms = torch.as_tensor(self.milestones, dtype=torch.int64, device=step.device)
        power = torch.sum(step[..., None] >= ms, dim=-1).to(torch.float32)
        return self.start_value * torch.exp(power * math.log(self.gamma))


@dataclass(frozen=True)
class WarmupScheduler(BaseScheduler):
    """Linear warmup into another schedule, driven in lockstep afterwards:
    ``v_init + (v_target - v_init)·t/T`` for ``t <= T`` (``v_init =
    v_target·warmup_init_factor``, ``v_target`` the main schedule's start
    value), else ``main.value(t - T)``."""

    main_scheduler: BaseScheduler
    warmup_steps: int
    warmup_init_factor: float = 0.01

    def value(self, step) -> Tensor:
        step = _steps(step, torch.int64)
        target = self.main_scheduler.value(0).to(step.device)
        init = target * self.warmup_init_factor
        frac = step.to(torch.float32) / max(self.warmup_steps, 1)
        warm = init + frac * (target - init)
        main = self.main_scheduler.value(torch.clamp(step - self.warmup_steps, min=0))
        return torch.where(step <= self.warmup_steps, warm, main)


@dataclass(frozen=True)
class TemperatureScheduler(BaseScheduler):
    r"""Energy-Matching piecewise temperature profile :math:`\epsilon(t)`:
    0 before :math:`\tau^*`, a linear ramp to :math:`\epsilon_{max}` at
    :math:`t = 1`, then held. Step ``n`` maps to virtual time
    ``t = t_start + (t_end - t_start)·min(n, N)/N``. With ``sqrt=True`` the
    value is :math:`\sqrt{\epsilon(t)}`, a drop-in Langevin ``noise_scale``.
    """

    epsilon_max: float
    tau_star: float = 0.8
    n_steps: int = 200
    t_start: float = 0.0
    t_end: float = 1.0
    sqrt: bool = True

    def __post_init__(self):
        if self.epsilon_max < 0:
            raise ValueError(f"epsilon_max must be >= 0, got {self.epsilon_max}")
        if not 0.0 <= self.tau_star < 1.0:
            raise ValueError(f"tau_star must be in [0, 1), got {self.tau_star}")
        if self.n_steps <= 0:
            raise ValueError(f"n_steps must be positive, got {self.n_steps}")
        if self.t_end < self.t_start:
            raise ValueError(f"t_end ({self.t_end}) must be >= t_start ({self.t_start})")

    def epsilon_at(self, t) -> Tensor:
        r"""Raw temperature :math:`\epsilon(t)` at virtual time ``t``."""
        t = _steps(t)
        ramp = self.epsilon_max * (t - self.tau_star) / (1.0 - self.tau_star)
        hold = torch.full_like(t, self.epsilon_max)
        return torch.where(
            t < self.tau_star, torch.zeros_like(t), torch.where(t < 1.0, ramp, hold)
        )

    def value(self, step) -> Tensor:
        frac = torch.clamp(_steps(step) / self.n_steps, 0.0, 1.0)
        t = self.t_start + (self.t_end - self.t_start) * frac
        eps = self.epsilon_at(t)
        return torch.sqrt(eps) if self.sqrt else eps
