"""Floating-point operations of the DiT with its embedders, from the
configuration (two per multiply-add).

Per image forward: each block ``2 T (3d·d + d·d + 2·d·h)`` in its products
(QKV, output projection, the MLP of hidden width ``h``) plus ``4 T² d`` in
attention's two products, ``2·cond·6d`` for its adaLN; the patch embedding
``2 T (C P²) d``, the final adaLN ``2·cond·2d`` and projection ``2 T d (P² C_out)``,
and the timestep MLP ``2 (f d + d d)``. At DiT-B/2 on 32×32 latents
(T = 256, d = 768, L = 12) the blocks' products and attention are
``2 L T (12 d² + 2 T d)``, about 45.9 GFLOP. A training step counts three
forwards' worth (the backward pass twice the forward).
"""

from __future__ import annotations


def forward_flops(cfg: dict) -> int:
    """Operations of one image's forward pass."""
    d, p = cfg["embed_dim"], cfg["patch_size"]
    tokens = (cfg["input_size"] // p) ** 2
    hidden = int(d * cfg["mlp_ratio"])
    cond = cfg["cond_dim"]
    block = (2 * tokens * (3 * d * d + d * d + 2 * d * hidden) + 4 * tokens * tokens * d
             + 2 * cond * 6 * d)
    embed = 2 * tokens * cfg["in_channels"] * p * p * d
    head = 2 * cond * 2 * d + 2 * tokens * d * p * p * cfg["out_channels"]
    t_mlp = 2 * (cfg["frequency_embedding_size"] * d + d * d)
    return cfg["depth"] * block + embed + head + t_mlp


def train_step_flops(cfg: dict, batch: int) -> int:
    return 3 * batch * forward_flops(cfg)


def cfg_generation_flops(cfg: dict, batch: int, n_steps: int) -> int:
    """Guided generation: two forwards per Euler step."""
    return 2 * n_steps * batch * forward_flops(cfg)
