r"""Fixed 2D sin-cos positional embeddings (counterpart of
:mod:`torchebm_tpu.models.components.positional`)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor

__all__ = ["build_2d_sincos_pos_embed", "crop_2d_pos_embed"]


def _sincos_1d(embed_dim: int, pos: Tensor) -> Tensor:
    if embed_dim % 2 != 0:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    omega = torch.arange(embed_dim // 2, dtype=torch.float32, device=pos.device)
    omega = 1.0 / (10000.0 ** (omega / (embed_dim / 2)))
    out = pos[:, None].to(torch.float32) * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def build_2d_sincos_pos_embed(embed_dim: int, grid_size: int, dtype: torch.dtype = torch.float32,
                              device=None, *, base_size=None) -> Tensor:
    """``(grid_size², embed_dim)`` fixed positional table.

    The grid is built as the JAX package builds it (``meshgrid`` in ``"xy"``
    order), so its first half, which that package names ``emb_h``, embeds
    the column (w) coordinate and the second half the row: the order flax
    weights were trained with. The coordinates are the patch indices; with
    ``base_size`` they are ``arange(grid_size) / (grid_size / base_size)``,
    diffusers' ``get_2d_sincos_pos_embed`` at interpolation scale 1 (SD3's
    table over a 192 × 192 grid at ``base_size`` 64).
    """
    if embed_dim % 2 != 0:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    grid_h = torch.arange(grid_size, dtype=torch.float32, device=device)
    if base_size is not None:
        grid_h = grid_h / (grid_size / base_size)
    grid_w = grid_h.clone()
    ww, hh = torch.meshgrid(grid_w, grid_h, indexing="xy")
    grid = torch.stack([ww, hh], dim=0).reshape(2, -1)  # (2, M)
    emb_h = _sincos_1d(embed_dim // 2, grid[0])
    emb_w = _sincos_1d(embed_dim // 2, grid[1])
    return torch.cat([emb_h, emb_w], dim=1).to(dtype)


def crop_2d_pos_embed(table: Tensor, grid_h: int, grid_w: int) -> Tensor:
    """``(grid_h·grid_w, D)``: the centre ``grid_h × grid_w`` of a square
    ``(M², D)`` table, rows and columns from ``(M - grid) // 2`` (diffusers'
    ``PatchEmbed.cropped_pos_embed`` with ``pos_embed_max_size`` M)."""
    m = int(round(table.shape[0] ** 0.5))
    if m * m != table.shape[0] or grid_h > m or grid_w > m:
        raise ValueError(f"a {grid_h}x{grid_w} grid does not fit a table of {table.shape[0]} rows")
    top, left = (m - grid_h) // 2, (m - grid_w) // 2
    return table.view(m, m, -1)[top:top + grid_h, left:left + grid_w].reshape(grid_h * grid_w, -1)
