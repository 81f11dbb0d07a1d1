"""Plain references: straightforward PyTorch in float32 with TF32 off, from
the published descriptions. They import nothing of the program and take
nothing it made: the benchmark hands them the inputs and weights it drew
from the seed, and they work out again whatever the program derives."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def strict_float32():
    """Float32 products without TF32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _fp8(t, dtype, top: float):
    scale = torch.clamp(t.abs().amax(), min=1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8(torch.autograd.Function):
    """A product's operand rounded as float8 training rounds it: to e4m3 on
    the way forward, and the gradient that comes back to e5m2, each under a
    per-tensor scale that maps its largest magnitude to the format's top."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


def lowered(kind):
    """The rounding a control applies to every operand of a matrix product,
    or None: ``"fp8"`` as float8 training does (:class:`_Fp8`). Values stay
    float32 between the products."""
    if kind is None:
        return None
    if kind == "fp8":
        return _Fp8.apply
    raise ValueError(f"unknown precision {kind!r}")
