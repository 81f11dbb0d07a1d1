r"""Joint two-stream transformer (MMDiT) of Stable Diffusion 3 (Esser et al.,
arXiv:2403.03206), a model of the port with no JAX counterpart.

Image latents ``(B, C, H, W)`` become patch tokens with a fixed sin-cos table
cropped from a larger grid; text features ``(B, Nc, context_dim)`` become
text tokens through ``context_embed``. The conditioning vector is the
timestep embedding plus the embedding of a pooled text vector. ``depth``
:class:`~torchebm_tpu_torch.models.components.JointAdaLNZeroBlock` carry
both streams, the last one ``context_pre_only``; the adaLN-Zero patch head
reads the image stream. Parameters stay float32 and every ``Linear``
computes in the module's ``dtype`` (``torch.bfloat16`` for the tensor
cores); the output is ``promote_types(x.dtype, float32)``.

Layout departures from diffusers' ``SD3Transformer2DModel``, none of which
changes what the network computes: one fused QKV ``Linear`` a stream where
diffusers has three; patch features in (ph, pw, C) order where its
convolution has (C, ph, pw); and the head's modulation chunks in (shift,
scale) order (:class:`~torchebm_tpu_torch.models.components.
AdaLNZeroPatchHead`), where diffusers' ``norm_out`` has (scale, shift). The
last block's text tokens give keys and values only; their queries, whose
outputs diffusers computes and discards, are not formed.

At SD3-medium's size and a batch of 32 an eager training step costs the
host more time than the card (about 3,600 launches); ``BaseTrainer``'s
``cuda_graph`` replays the step's loss and gradients from CUDA graphs.
"""

from __future__ import annotations

import torch
from torch import nn

from .components import (
    AdaLNZeroPatchHead,
    ConvPatchEmbed2d,
    JointAdaLNZeroBlock,
    MLPTimestepEmbedder,
    PooledTextEmbedder,
    build_2d_sincos_pos_embed,
    crop_2d_pos_embed,
)
from .nets import _lecun_init, _linear

Tensor = torch.Tensor

__all__ = ["JointTransformer2D"]


class JointTransformer2D(nn.Module):
    """``forward(x, t, *, context, pooled) -> (B, out_channels, H, W)``.

    ``t_embed`` (:class:`MLPTimestepEmbedder`, cosines then sines, max
    period 10,000), ``pooled_embed`` (:class:`PooledTextEmbedder`),
    ``context_embed`` (``Linear(context_dim, embed_dim)``), ``patch_embed``,
    the positional table (a buffer that is not saved) over a
    ``pos_embed_max_size``² grid at ``base_size = sample_size //
    patch_size``, ``blocks`` and ``head``. The defaults are SD3-medium's
    (``stabilityai/stable-diffusion-3-medium-diffusers``,
    ``transformer/config.json``)."""

    def __init__(self, in_channels: int = 16, out_channels: int = 16, sample_size: int = 128,
                 patch_size: int = 2, embed_dim: int = 1536, depth: int = 24,
                 num_heads: int = 24, context_dim: int = 4096, pooled_dim: int = 2048,
                 pos_embed_max_size: int = 192, mlp_ratio: float = 4.0,
                 frequency_embedding_size: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        if depth < 1:
            raise ValueError(f"depth must be at least 1, got {depth}")
        self.embed_dim = int(embed_dim)
        self.patch_size = int(patch_size)
        self.dtype = dtype
        self.t_embed = MLPTimestepEmbedder(embed_dim, frequency_embedding_size, dtype=dtype)
        self.pooled_embed = PooledTextEmbedder(pooled_dim, embed_dim, dtype=dtype)
        self.context_embed = _lecun_init(nn.Linear(int(context_dim), self.embed_dim))
        self.patch_embed = ConvPatchEmbed2d(in_channels, embed_dim, patch_size, dtype=dtype)
        self.register_buffer(
            "pos_embed",
            build_2d_sincos_pos_embed(self.embed_dim, pos_embed_max_size,
                                      base_size=sample_size // patch_size),
            persistent=False)
        self.blocks = nn.ModuleList(
            JointAdaLNZeroBlock(embed_dim, num_heads, mlp_ratio,
                                context_pre_only=(i == depth - 1), dtype=dtype)
            for i in range(depth))
        self.head = AdaLNZeroPatchHead(embed_dim, patch_size, out_channels, dtype=dtype)

    def forward(self, x: Tensor, t: Tensor, *, context: Tensor, pooled: Tensor) -> Tensor:
        p = self.patch_size
        cond = self.t_embed(t) + self.pooled_embed(pooled)
        tokens = self.patch_embed(x)
        table = crop_2d_pos_embed(self.pos_embed, x.shape[-2] // p, x.shape[-1] // p)
        tokens = tokens + table[None].to(tokens.dtype)
        ctx = _linear(self.context_embed, context.to(self.dtype))
        for block in self.blocks:
            tokens, ctx = block(tokens, ctx, cond)
        out = self.head(tokens, cond)
        return out.to(torch.promote_types(x.dtype, torch.float32))
