"""Model components (counterpart of ``torchebm_tpu.models.components``): the
timestep, label and pooled-text embedders, patchify and the patch embedding,
the sin-cos positional table and its crop, the adaLN-Zero transformer block,
the joint two-stream (MMDiT) block and its attention, and the patch head."""

from .embeddings import LabelEmbedder, MLPTimestepEmbedder, PooledTextEmbedder
from .heads import AdaLNZeroPatchHead
from .patch import ConvPatchEmbed2d, patchify2d, unpatchify2d
from .positional import build_2d_sincos_pos_embed, crop_2d_pos_embed
from .transformer import (
    AdaLNZeroBlock,
    FeedForward,
    JointAdaLNZeroBlock,
    JointSelfAttention,
    MultiheadSelfAttention,
    modulate,
)

__all__ = [
    "patchify2d",
    "unpatchify2d",
    "ConvPatchEmbed2d",
    "build_2d_sincos_pos_embed",
    "MLPTimestepEmbedder",
    "LabelEmbedder",
    "modulate",
    "MultiheadSelfAttention",
    "FeedForward",
    "AdaLNZeroBlock",
    "AdaLNZeroPatchHead",
    "PooledTextEmbedder",
    "crop_2d_pos_embed",
    "JointSelfAttention",
    "JointAdaLNZeroBlock",
]
