r"""Mixed-precision policy: parameters in float32, compute in bf16
(counterpart of :mod:`torchebm_tpu.utils.precision`).

A :class:`Policy` is a dtype discipline: keep parameters and optimizer state
in ``param_dtype`` (master weights), run the network in ``compute_dtype``,
return losses and energies in ``output_dtype``. The port's networks take
``dtype=`` for the compute dtype, as the JAX package's do; ``Policy.wrap``
applies the rule to any callable::

    policy = bf16_policy()
    net = MLPEnergy(2, dtype=policy.compute_dtype)
    energy_fn = policy.wrap(net)          # float inputs -> bf16, outputs -> float32
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__all__ = ["Policy", "bf16_policy", "f32_policy", "cast_floating"]


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating-point tensor in a nest of tuples, lists and dicts
    to ``dtype``; integer and boolean tensors (labels, masks) and every other
    value pass through unchanged."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree


@dataclasses.dataclass(frozen=True)
class Policy:
    """A three-dtype precision policy: ``param_dtype`` (master parameters and
    optimizer state), ``compute_dtype`` (the network), ``output_dtype``
    (losses and energies)."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def cast_to_param(self, tree: Any) -> Any:
        return cast_floating(tree, self.param_dtype)

    def cast_to_compute(self, tree: Any) -> Any:
        return cast_floating(tree, self.compute_dtype)

    def cast_to_output(self, tree: Any) -> Any:
        return cast_floating(tree, self.output_dtype)

    def wrap(self, fn: Callable) -> Callable:
        """``fn`` with float tensor arguments cast to ``compute_dtype`` and
        float outputs to ``output_dtype``."""

        def wrapped(*args, **kwargs):
            out = fn(*self.cast_to_compute(args), **self.cast_to_compute(kwargs))
            return self.cast_to_output(out)

        return wrapped


def bf16_policy() -> Policy:
    """float32 parameters, bf16 compute, float32 outputs."""
    return Policy(torch.float32, torch.bfloat16, torch.float32)


def f32_policy() -> Policy:
    """Full precision (the default everywhere when no policy is used)."""
    return Policy(torch.float32, torch.float32, torch.float32)
