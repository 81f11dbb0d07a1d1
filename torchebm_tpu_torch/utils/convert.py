"""Carry parameters across from the JAX package.

The JAX package's energies keep their parameters as arrays and its
schedulers as static fields. Given those as numpy arrays (or Python numbers),
these functions build the port's objects with the same values, so both
packages can be run on one set of parameters:

    energy_from_arrays("GaussianMixtureEnergy",
                       {"means": m, "scale": s, "log_weights": lw}, device)
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..core import energies, schedulers

__all__ = ["energy_from_arrays", "scheduler_from_fields"]

#: energy name -> the names of its tensor buffers; every other field is a float
_BUFFERS = {
    "GaussianMixtureEnergy": ("means", "scale", "log_weights"),
    "GaussianEnergy": ("mean", "cov", "cov_inv"),
}
_SCALAR_ENERGIES = (
    "DoubleWellEnergy", "HarmonicEnergy", "RosenbrockEnergy", "AckleyEnergy", "RastriginEnergy",
)


def energy_from_arrays(name: str, arrays: Mapping[str, Any],
                       device: Optional[torch.device] = None) -> energies.Energy:
    """The port's energy ``name`` with the JAX package's field values.

    Buffer fields (means, covariances, log-weights) become float32 tensors on
    ``device``; scalar fields (barrier height, ...) become Python floats.
    """
    if name in _BUFFERS:
        fields = _BUFFERS[name]
        missing = set(fields) - set(arrays)
        if missing:
            raise ValueError(f"{name} needs arrays {sorted(missing)}")
        tensors = {
            f: torch.tensor(np.asarray(arrays[f], dtype=np.float32), device=device)
            for f in fields
        }
        return getattr(energies, name)(**tensors)
    if name in _SCALAR_ENERGIES:
        return getattr(energies, name)(**{f: float(v) for f, v in arrays.items()})
    raise ValueError(
        f"Unknown energy '{name}'. Available: {sorted([*_BUFFERS, *_SCALAR_ENERGIES])}"
    )


def scheduler_from_fields(name: str, fields: Mapping[str, Any]) -> schedulers.BaseScheduler:
    """The port's scheduler ``name`` built from the JAX scheduler's static
    fields. A nested scheduler (``WarmupScheduler.main_scheduler``) is given
    as a ``(name, fields)`` pair."""
    cls = getattr(schedulers, name, None)
    base = schedulers.BaseScheduler
    if not (isinstance(cls, type) and issubclass(cls, base)) or cls is base:
        raise ValueError(f"Unknown scheduler '{name}'")
    kwargs = {
        f: scheduler_from_fields(*v) if isinstance(v, tuple) and len(v) == 2
        and isinstance(v[0], str) else v
        for f, v in fields.items()
    }
    return cls(**kwargs)
