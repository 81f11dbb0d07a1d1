r"""Output head: adaLN-Zero modulated projection to patch pixels
(counterpart of :mod:`torchebm_tpu.models.components.heads`)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nets import _linear
from .patch import unpatchify2d
from .transformer import _adaln, _zero_linear

Tensor = torch.Tensor

__all__ = ["AdaLNZeroPatchHead"]


class AdaLNZeroPatchHead(nn.Module):
    """``(B, N, D), (B, cond) -> (B, out_channels, H, W)``: a LayerNorm
    without scale or bias, modulated by ``modulation`` on ``silu(cond)``,
    then ``proj`` to the patch pixels and :func:`unpatchify2d`. Both linear
    layers start at zero, so a fresh backbone predicts zeros."""

    def __init__(self, embed_dim: int, patch_size: int, out_channels: int,
                 cond_dim: Optional[int] = None, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = int(patch_size)
        self.out_channels = int(out_channels)
        self.eps = float(eps)
        self.dtype = dtype
        self.modulation = _zero_linear(cond_dim or embed_dim, 2 * embed_dim)
        self.proj = _zero_linear(embed_dim, self.patch_size ** 2 * self.out_channels)

    def forward(self, tokens: Tensor, cond: Tensor) -> Tensor:
        shift, scale = _linear(self.modulation, F.silu(cond).to(self.dtype)).chunk(2, dim=1)
        tokens, _ = _adaln(tokens, shift, scale, self.eps)
        patches = _linear(self.proj, tokens.to(self.dtype))
        return unpatchify2d(patches, self.patch_size, out_channels=self.out_channels)
