"""Utilities (counterpart of ``torchebm_tpu.utils``): conversion from the
JAX package, EMA and checkpoints, precision policies, batch stacking and
prefetch, profiling and the library's spans and counters."""

from .convert import (
    conditional_transformer_2d_from_flax,
    conv_energy_from_flax,
    energy_from_arrays,
    label_embedder_from_flax,
    mlp_energy_from_flax,
    mlp_velocity_field_from_flax,
    sampler_from_fields,
    scheduler_from_fields,
)
from .data import prefetch_to_device, stack_batches
from .precision import Policy, bf16_policy, cast_floating, f32_policy
from .profiling import (
    SpanRecord,
    benchmark_fn,
    clear_spans,
    count,
    counters,
    profile_context,
    record_function,
    span,
    spans,
)
from .training import (
    freeze_mask,
    latest_checkpoint_step,
    load_checkpoint,
    save_checkpoint,
    update_ema,
)

__all__ = [
    "energy_from_arrays",
    "sampler_from_fields",
    "scheduler_from_fields",
    "mlp_energy_from_flax",
    "conv_energy_from_flax",
    "mlp_velocity_field_from_flax",
    "conditional_transformer_2d_from_flax",
    "label_embedder_from_flax",
    "stack_batches",
    "prefetch_to_device",
    "update_ema",
    "freeze_mask",
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint_step",
    "profile_context",
    "record_function",
    "benchmark_fn",
    "span",
    "spans",
    "clear_spans",
    "SpanRecord",
    "count",
    "counters",
    "Policy",
    "bf16_policy",
    "f32_policy",
    "cast_floating",
]
