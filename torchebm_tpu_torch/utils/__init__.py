"""Utilities (counterpart of ``torchebm_tpu.utils``): parameter conversion from
the JAX package."""

from .convert import energy_from_arrays, scheduler_from_fields

__all__ = ["energy_from_arrays", "scheduler_from_fields"]
