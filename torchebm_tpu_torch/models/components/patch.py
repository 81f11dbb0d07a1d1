r"""Patchify/unpatchify helpers and the patch embedding (counterpart of
:mod:`torchebm_tpu.models.components.patch`).

The patch embedding is patchify followed by one ``Linear`` over ``C·P·P``
features, the same math as a strided convolution, so a flax ``proj`` kernel
``(C·P·P, D)`` carries across by a transpose alone. Images are NCHW; token
features are ordered (ph, pw, C).
"""

from __future__ import annotations

import torch
from torch import nn

from ..nets import _lecun_init, _linear

Tensor = torch.Tensor

__all__ = ["patchify2d", "unpatchify2d", "ConvPatchEmbed2d"]


def patchify2d(x: Tensor, patch_size: int) -> Tensor:
    """``(B, C, H, W) -> (B, N, P·P·C)`` patch tokens, row-major over the
    patch grid."""
    b, c, h, w = x.shape
    p = int(patch_size)
    if h % p != 0 or w % p != 0:
        raise ValueError(f"H,W must be divisible by patch_size={p}, got {(h, w)}")
    gh, gw = h // p, w // p
    x = x.reshape(b, c, gh, p, gw, p)
    x = x.permute(0, 2, 4, 3, 5, 1)  # (B, gh, gw, p, p, C)
    return x.reshape(b, gh * gw, p * p * c)


def unpatchify2d(tokens: Tensor, patch_size: int, *, out_channels: int) -> Tensor:
    """``(B, N, P·P·C) -> (B, C, H, W)``, the inverse of :func:`patchify2d`
    on a square grid."""
    b, n, d = tokens.shape
    p = int(patch_size)
    c = int(out_channels)
    if d != p * p * c:
        raise ValueError(f"Token dim {d} != patch_size^2*out_channels ({p * p * c})")
    grid = int(round(n**0.5))
    if grid * grid != n:
        raise ValueError("Number of tokens must be a perfect square for 2D unpatchify.")
    x = tokens.reshape(b, grid, grid, p, p, c)
    x = x.permute(0, 5, 1, 3, 2, 4)  # (B, C, gh, p, gw, p)
    return x.reshape(b, c, grid * p, grid * p)


class ConvPatchEmbed2d(nn.Module):
    """Patch embedding ``(B, C, H, W) -> (B, N, D)``: patchify, then ``proj``
    (``Linear(C·P·P, D)``) computed in ``dtype``."""

    def __init__(self, in_channels: int, embed_dim: int, patch_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = int(patch_size)
        self.dtype = dtype
        self.proj = _lecun_init(nn.Linear(int(in_channels) * self.patch_size ** 2, int(embed_dim)))

    def forward(self, x: Tensor) -> Tensor:
        return _linear(self.proj, patchify2d(x, self.patch_size).to(self.dtype))
