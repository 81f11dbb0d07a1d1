r"""Timestep embedder (counterpart of :mod:`torchebm_tpu.models.components.embeddings`)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

__all__ = ["MLPTimestepEmbedder"]


class MLPTimestepEmbedder(nn.Module):
    """Sinusoidal frequency embedding of a scalar timestep followed by an MLP
    (``Linear``, SiLU, ``Linear``), ``(B,) -> (B, out_dim)``."""

    def __init__(self, out_dim: int, frequency_embedding_size: int = 256):
        super().__init__()
        from ..nets import _lecun_init

        self.out_dim = int(out_dim)
        self.frequency_embedding_size = int(frequency_embedding_size)
        self.layers = nn.ModuleList([
            _lecun_init(nn.Linear(self.frequency_embedding_size, self.out_dim)),
            _lecun_init(nn.Linear(self.out_dim, self.out_dim)),
        ])

    @staticmethod
    def sinusoidal_embedding(t: Tensor, dim: int, max_period: int = 10_000) -> Tensor:
        """``(B,) -> (B, dim)`` float32: the cosines of ``t`` times ``dim // 2``
        geometrically spaced frequencies, then the sines (a zero column last
        when ``dim`` is odd)."""
        half = dim // 2
        freqs = torch.exp(
            -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
        )
        args = t[:, None].to(torch.float32) * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        if dim % 2:
            emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
        return emb

    def forward(self, t: Tensor) -> Tensor:
        t = t.reshape(t.shape[0]) if t.ndim != 1 else t
        freq = self.sinusoidal_embedding(t, self.frequency_embedding_size)
        return self.layers[1](F.silu(self.layers[0](freq)))
