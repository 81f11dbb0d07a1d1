"""Networks and wrappers (counterpart of ``torchebm_tpu.models``): the
SiLU-MLP energy, the conv energy, the time-conditioned MLP vector field with
its timestep embedder, and the EqM-field → energy adapter."""

from .components import MLPTimestepEmbedder
from .nets import ConvEnergy2D, MLPEnergy, MLPVelocityField
from .wrappers import EqMEnergy

__all__ = ["MLPEnergy", "MLPVelocityField", "ConvEnergy2D", "MLPTimestepEmbedder", "EqMEnergy"]
