"""Networks and wrappers (counterpart of ``torchebm_tpu.models``): the DiT
backbone (``ConditionalTransformer2D``) with its components, SD3's joint
two-stream MMDiT (``JointTransformer2D``, loaded on first use), the SiLU-MLP
energy, the conv energy, the time-conditioned MLP vector field with its
timestep embedder, classifier-free guidance, the interaction energy and the
EqM-field → energy adapter."""

from .components import (
    AdaLNZeroBlock,
    AdaLNZeroPatchHead,
    ConvPatchEmbed2d,
    FeedForward,
    JointAdaLNZeroBlock,
    JointSelfAttention,
    LabelEmbedder,
    MLPTimestepEmbedder,
    MultiheadSelfAttention,
    PooledTextEmbedder,
    build_2d_sincos_pos_embed,
    crop_2d_pos_embed,
    modulate,
    patchify2d,
    unpatchify2d,
)
from .conditional_transformer_2d import ConditionalTransformer2D
from .nets import ConvEnergy2D, MLPEnergy, MLPVelocityField
from .wrappers import EqMEnergy, InteractionModel, LabelClassifierFreeGuidance

__all__ = [
    "ConditionalTransformer2D",
    "LabelClassifierFreeGuidance",
    "InteractionModel",
    "EqMEnergy",
    "MLPEnergy",
    "MLPVelocityField",
    "ConvEnergy2D",
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
    "JointTransformer2D",
    "JointSelfAttention",
    "JointAdaLNZeroBlock",
    "PooledTextEmbedder",
    "crop_2d_pos_embed",
]


def __getattr__(name):
    if name == "JointTransformer2D":
        from .joint_transformer_2d import JointTransformer2D

        return JointTransformer2D
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
