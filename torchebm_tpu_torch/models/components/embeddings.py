r"""Timestep, label and pooled-text embedders (counterpart of
:mod:`torchebm_tpu.models.components.embeddings`; the pooled-text embedder
is the port's own)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

__all__ = ["MLPTimestepEmbedder", "LabelEmbedder", "PooledTextEmbedder"]


class MLPTimestepEmbedder(nn.Module):
    """Sinusoidal frequency embedding of a scalar timestep followed by an MLP
    (``Linear``, SiLU, ``Linear``), ``(B,) -> (B, out_dim)``. The two
    linear layers compute in ``dtype`` over float32 parameters, and the
    output is in ``dtype``."""

    def __init__(self, out_dim: int, frequency_embedding_size: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        from ..nets import _lecun_init

        self.out_dim = int(out_dim)
        self.frequency_embedding_size = int(frequency_embedding_size)
        self.dtype = dtype
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
        from ..nets import _linear

        t = t.reshape(t.shape[0]) if t.ndim != 1 else t
        freq = self.sinusoidal_embedding(t, self.frequency_embedding_size).to(self.dtype)
        return _linear(self.layers[1], F.silu(_linear(self.layers[0], freq)))


class LabelEmbedder(nn.Module):
    """Label embedding ``(B,) int -> (B, out_dim)`` with classifier-free
    guidance's label dropping.

    With ``dropout_prob > 0`` the table has an extra row for the null label
    (id ``num_classes``). In training (``train=True``) each label is replaced
    by the null label with probability ``dropout_prob``, drawn from
    ``generator``; ``force_drop_mask`` (``(B,)``, true where dropped) sets
    the drops instead. The table starts as flax's ``nn.Embed`` default: a
    normal of variance 1/``out_dim``.
    """

    def __init__(self, num_classes: int, out_dim: int, dropout_prob: float = 0.0):
        super().__init__()
        self.num_classes = int(num_classes)
        self.out_dim = int(out_dim)
        self.dropout_prob = float(dropout_prob)
        self.embed = nn.Embedding(self.num_classes + (1 if self.dropout_prob > 0 else 0),
                                  self.out_dim)
        nn.init.normal_(self.embed.weight, std=self.out_dim ** -0.5)

    @property
    def null_label_id(self) -> Optional[int]:
        return self.num_classes if self.dropout_prob > 0 else None

    def forward(self, labels: Tensor, *, train: bool = False,
                force_drop_mask: Optional[Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        if self.dropout_prob > 0 and (train or force_drop_mask is not None):
            if force_drop_mask is None:
                if generator is None:
                    raise ValueError("training-time label dropping draws from generator=; "
                                     "pass one, or force_drop_mask=")
                drop = torch.rand((labels.shape[0],), generator=generator,
                                  device=labels.device) < self.dropout_prob
            else:
                drop = force_drop_mask.to(torch.bool)
            labels = torch.where(drop, torch.full_like(labels, self.null_label_id), labels)
        return self.embed(labels)


class PooledTextEmbedder(nn.Module):
    """A pooled text vector through ``Linear``, SiLU, ``Linear``, ``(B,
    in_dim) -> (B, out_dim)`` (SD3's ``text_embedder``), computed in
    ``dtype`` over float32 parameters; the output is in ``dtype``."""

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        from ..nets import _lecun_init

        self.dtype = dtype
        self.layers = nn.ModuleList([
            _lecun_init(nn.Linear(int(in_dim), int(out_dim))),
            _lecun_init(nn.Linear(int(out_dim), int(out_dim))),
        ])

    def forward(self, pooled: Tensor) -> Tensor:
        from ..nets import _linear

        return _linear(self.layers[1], F.silu(_linear(self.layers[0], pooled.to(self.dtype))))
