r"""Fixed 2D sin-cos positional embeddings (counterpart of
:mod:`torchebm_tpu.models.components.positional`)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor

__all__ = ["build_2d_sincos_pos_embed"]


def _sincos_1d(embed_dim: int, pos: Tensor) -> Tensor:
    if embed_dim % 2 != 0:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    omega = torch.arange(embed_dim // 2, dtype=torch.float32, device=pos.device)
    omega = 1.0 / (10000.0 ** (omega / (embed_dim / 2)))
    out = pos[:, None].to(torch.float32) * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def build_2d_sincos_pos_embed(embed_dim: int, grid_size: int, dtype: torch.dtype = torch.float32,
                              device=None) -> Tensor:
    """``(grid_size², embed_dim)`` fixed positional table.

    The grid is built as the JAX package builds it (``meshgrid`` in ``"xy"``
    order), so its first half, which that package names ``emb_h``, embeds
    the column (w) coordinate and the second half the row: the order flax
    weights were trained with.
    """
    if embed_dim % 2 != 0:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    grid_h = torch.arange(grid_size, dtype=torch.float32, device=device)
    grid_w = torch.arange(grid_size, dtype=torch.float32, device=device)
    ww, hh = torch.meshgrid(grid_w, grid_h, indexing="xy")
    grid = torch.stack([ww, hh], dim=0).reshape(2, -1)  # (2, M)
    emb_h = _sincos_1d(embed_dim // 2, grid[0])
    emb_w = _sincos_1d(embed_dim // 2, grid[1])
    return torch.cat([emb_h, emb_w], dim=1).to(dtype)
