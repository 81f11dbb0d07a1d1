"""Model components (counterpart of ``torchebm_tpu.models.components``): the
timestep and label embedders, patchify and the patch embedding, the sin-cos
positional table, the adaLN-Zero transformer block and the patch head."""

from .embeddings import LabelEmbedder, MLPTimestepEmbedder
from .heads import AdaLNZeroPatchHead
from .patch import ConvPatchEmbed2d, patchify2d, unpatchify2d
from .positional import build_2d_sincos_pos_embed
from .transformer import (
    AdaLNZeroBlock,
    FeedForward,
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
]
