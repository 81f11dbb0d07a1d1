"""Utilities (counterpart of ``torchebm_tpu.utils``): parameter and sampler
conversion from the JAX package."""

from .convert import energy_from_arrays, sampler_from_fields, scheduler_from_fields

__all__ = ["energy_from_arrays", "sampler_from_fields", "scheduler_from_fields"]
