"""Networks (counterpart of ``torchebm_tpu.models``): the SiLU-MLP energy
and the conv energy. ``MLPVelocityField`` comes with the flow slice."""

from .nets import ConvEnergy2D, MLPEnergy

__all__ = ["MLPEnergy", "ConvEnergy2D"]
