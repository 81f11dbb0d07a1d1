r"""Conditional 2D transformer (DiT) backbone (counterpart of
:mod:`torchebm_tpu.models.conditional_transformer_2d`).

Inputs are ``(B, C, H, W)`` images and one conditioning tensor: ``(B,
cond_dim)``, or ``(B,)`` (a raw time), which is lifted to a vector. It may
arrive positionally, as ``cond=`` or as ``t=`` (the library-wide ``model(x,
t)`` convention). Parameters stay float32 and every ``Linear`` computes in
the module's ``dtype`` (``torch.bfloat16`` for the tensor cores); no global
precision flag is touched. The output is ``promote_types(x.dtype,
float32)``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .components import (
    AdaLNZeroBlock,
    AdaLNZeroPatchHead,
    ConvPatchEmbed2d,
    build_2d_sincos_pos_embed,
)

Tensor = torch.Tensor

__all__ = ["ConditionalTransformer2D"]


class ConditionalTransformer2D(nn.Module):
    """Patch embedding, a fixed sin-cos positional table (a buffer that is
    not saved), ``depth`` adaLN-Zero blocks (``blocks``) and the patch
    ``head``."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1, input_size: int = 32,
                 patch_size: int = 4, embed_dim: int = 256, depth: int = 6, num_heads: int = 4,
                 cond_dim: Optional[int] = None, mlp_ratio: float = 4.0,
                 use_sincos_pos_embed: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        if input_size % patch_size != 0:
            raise ValueError("input_size must be divisible by patch_size")
        self.embed_dim = int(embed_dim)
        self.cond_dim = cond_dim
        self.use_sincos_pos_embed = bool(use_sincos_pos_embed)
        self.dtype = dtype
        self.patch_embed = ConvPatchEmbed2d(in_channels, embed_dim, patch_size, dtype=dtype)
        self.register_buffer(
            "pos_embed", build_2d_sincos_pos_embed(self.embed_dim, input_size // patch_size),
            persistent=False)
        self.blocks = nn.ModuleList(
            AdaLNZeroBlock(embed_dim, num_heads, cond_dim=cond_dim, mlp_ratio=mlp_ratio,
                           dtype=dtype)
            for _ in range(depth))
        self.head = AdaLNZeroPatchHead(embed_dim, patch_size, out_channels, cond_dim=cond_dim,
                                       dtype=dtype)

    def forward(self, x: Tensor, cond: Optional[Tensor] = None, *,
                t: Optional[Tensor] = None) -> Tensor:
        c = cond if cond is not None else t
        if c is None:
            raise ValueError(
                "ConditionalTransformer2D requires a conditioning tensor via "
                "`cond` (positional) or the `cond=`/`t=` keyword."
            )
        if c.ndim == 1:
            # scalar-per-sample conditioning (e.g. raw time): lift to a vector
            c = c[:, None] * torch.ones((1, self.cond_dim or self.embed_dim), dtype=x.dtype,
                                        device=x.device)
        tokens = self.patch_embed(x)
        if self.use_sincos_pos_embed:
            tokens = tokens + self.pos_embed[None].to(tokens.dtype)
        for block in self.blocks:
            tokens = block(tokens, c)
        out = self.head(tokens, c)
        return out.to(torch.promote_types(x.dtype, torch.float32))
