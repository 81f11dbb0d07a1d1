"""Floating-point operations of SD3's MMDiT with its embedders, from the
configuration (two per multiply-add).

Per sample forward, with ``Tx`` image tokens, ``Tc`` text tokens, ``T = Tx +
Tc``, width ``d`` and MLP width ``h``: each of the first ``L - 1`` blocks

    2·Tx·(4d² + 2dh) + 2·Tc·(4d² + 2dh) + 4·T²·d + 2·d·12d

(each stream's QKV, output projection and MLP; attention's two products over
the joined sequence; the two streams' adaLN modulations). The last block
(``context_pre_only``) keeps the image side ``2·Tx·(4d² + 2dh)``, gives the
text side its QKV alone, ``2·Tc·3d²``, queries with the image tokens alone,
``4·Tx·T·d``, and modulates with ``2·d·8d`` (six vectors for the image
stream, two for the text). Then the context embedding ``2·Tc·C_ctx·d``, the
pooled MLP ``2·(P·d + d²)``, the timestep MLP ``2·(f·d + d²)``, the patch
embedding ``2·Tx·(C p²)·d`` and the head, ``2·d·2d`` for its modulation and
``2·Tx·d·(p² C_out)`` for its projection.

At SD3-medium on 32 × 32 latents with 154 text tokens (Tx = 256, T = 410,
d = 1,536, L = 24) that is 578.44 GFLOP a sample, attention's products 4.2%
of it. A training step counts three forwards' worth (the backward pass
twice the forward).
"""

from __future__ import annotations


def forward_flops(cfg: dict) -> int:
    """Operations of one sample's forward pass."""
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    p = cfg["patch_size"]
    h = int(d * cfg["mlp_ratio"])
    tx = (cfg["latent_size"] // p) ** 2
    tc = cfg["context_tokens"]
    t = tx + tc
    stream = 4 * d * d + 2 * d * h
    block = 2 * tx * stream + 2 * tc * stream + 4 * t * t * d + 2 * d * 12 * d
    last = 2 * tx * stream + 2 * tc * 3 * d * d + 4 * tx * t * d + 2 * d * 8 * d
    embed = (2 * tc * cfg["joint_attention_dim"] * d
             + 2 * (cfg["pooled_projection_dim"] * d + d * d)
             + 2 * (cfg["frequency_embedding_size"] * d + d * d)
             + 2 * tx * cfg["in_channels"] * p * p * d)
    head = 2 * d * 2 * d + 2 * tx * d * p * p * cfg["out_channels"]
    return (cfg["num_layers"] - 1) * block + last + embed + head


def train_step_flops(cfg: dict, batch: int) -> int:
    return 3 * batch * forward_flops(cfg)
