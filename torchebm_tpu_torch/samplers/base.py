r"""Sampler contract and the shared sampling loop.

PyTorch counterpart of :mod:`torchebm_tpu.samplers.base`:

- ``sample(generator, x=None, dim=None, n_steps=100, n_samples=1, thin=1,
  return_trajectory=False, return_diagnostics=False, model_kwargs=None)``
- returns samples ``(n_samples, *data_shape)``, or the trajectory
  ``(n_samples, n_steps//thin, *data_shape)`` when ``return_trajectory``;
  optionally paired with a diagnostics dict of tensors of length
  ``n_steps//thin`` (keys ``mean``/``var``/``energy`` plus sampler-specific
  extras).

The device is explicit: it is the device of the ``torch.Generator`` passed
to ``sample``. The initial state and every noise draw come from that
generator on that device, and a state ``x`` or model buffer on another
device raises. Sampling runs under ``torch.no_grad()``; energies that need
autograd for their gradient enable it locally.

Subclasses implement ``init_carry`` / ``step`` / ``extra_diagnostics`` and
inherit the loop :func:`_sample_impl`.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

Tensor = torch.Tensor

__all__ = ["BaseSampler"]


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``a`` and ``b`` name the same device (an unindexed CUDA device matches any index)."""
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def _check_model_device(model: Any, device: torch.device) -> None:
    if not isinstance(model, nn.Module):
        return
    for name, t in itertools.chain(model.named_buffers(), model.named_parameters()):
        if not _same_device(t.device, device):
            raise ValueError(
                f"model tensor {name!r} is on {t.device} but the generator is on {device}; "
                "move the energy with .to(device) or pass a generator on its device"
            )


def _concrete_scalar(p) -> bool:
    """True for a Python number or a 0-d tensor: the forms a chain kernel
    takes as a constant schedule."""
    if isinstance(p, (int, float)) and not isinstance(p, bool):
        return True
    return isinstance(p, Tensor) and p.ndim == 0


def _gaussian_target(model):
    """``(mean[None, :], precision)`` when ``model`` is a full-covariance
    :class:`~torchebm_tpu_torch.core.energies.GaussianEnergy` the chain
    kernels support (d ≤ 32), else None."""
    from ..core.energies import GaussianEnergy

    if type(model) is not GaussianEnergy:
        return None
    if model.mean.ndim != 1 or model.mean.shape[-1] > 32:
        return None
    return model.mean[None, :], model.cov_inv


def _sample_impl(
    sampler: "BaseSampler",
    x0: Tensor,
    generator: torch.Generator,
    n_steps: int,
    thin: int,
    return_trajectory: bool,
    return_diagnostics: bool,
    model_kwargs: Dict[str, Any],
):
    """The shared sampling loop.

    ``n_steps // thin`` kept slots of ``thin`` transition steps each, then
    the ``n_steps % thin`` remainder steps (they run but are not recorded).
    Step index ``i`` drives the schedulers. The carry keeps the dtypes it
    started with.
    """
    n_kept = n_steps // thin
    carry = sampler.init_carry(x0, generator, model_kwargs)
    dtypes = {k: v.dtype for k, v in carry.items()}

    def one_step(i, c):
        new = sampler.step(c, i, generator, model_kwargs)
        return {k: v.to(dtypes[k]) for k, v in new.items()}

    traj, diags = [], []
    for k in range(n_kept):
        for j in range(thin):
            carry = one_step(k * thin + j, carry)
        x = carry["x"]
        if return_trajectory:
            traj.append(x)
        if return_diagnostics:
            d = {
                "mean": torch.mean(x, dim=0),
                "var": torch.clamp(torch.var(x, dim=0, correction=0), 1e-10, 1e10),
                "energy": torch.mean(sampler.energy_of(x, model_kwargs)),
            }
            d.update(sampler.extra_diagnostics(carry, model_kwargs))
            diags.append(d)
    for i in range(n_kept * thin, n_steps):
        carry = one_step(i, carry)

    x_final = carry["x"]
    if return_trajectory:
        output = torch.stack(traj, dim=1) if n_kept > 0 else x_final[:, None]
    else:
        output = x_final
    if return_diagnostics:
        keys = diags[0].keys() if diags else ()
        return output, {k: torch.stack([d[k] for d in diags]) for k in keys}
    return output


class BaseSampler:
    """Sampler base; concrete samplers carry a ``model`` (an energy).

    Hooks:

    - ``init_carry(x0, generator, model_kwargs) -> dict`` with at least ``"x"``.
    - ``step(carry, i, generator, model_kwargs) -> carry``: one transition at
      step index ``i`` (schedulers evaluate at ``i``).
    - ``extra_diagnostics(carry, model_kwargs) -> dict``: per-kept-slot extras.
    """

    # ------------------------------------------------------------------ hooks
    def init_carry(self, x0: Tensor, generator: torch.Generator, model_kwargs) -> Dict[str, Any]:
        return {"x": x0}

    def step(self, carry, i, generator, model_kwargs) -> Dict[str, Any]:
        raise NotImplementedError

    def extra_diagnostics(self, carry, model_kwargs) -> Dict[str, Tensor]:
        return {}

    def _step_kwargs(self, model_kwargs, step):
        """Thread the step index to step-aware energies (``wants_step`` models)."""
        mk = dict(model_kwargs or {})
        if step is not None and getattr(self.model, "wants_step", False):
            mk["step"] = step
        return mk

    def energy_of(self, x: Tensor, model_kwargs, step=None) -> Tensor:
        return self.model.energy(x, **self._step_kwargs(model_kwargs, step))

    def gradient_of(self, x: Tensor, model_kwargs, step=None) -> Tensor:
        return self.model.gradient(x, **self._step_kwargs(model_kwargs, step))

    # ------------------------------------------------------------------ API
    def _init_state(
        self,
        generator: torch.Generator,
        x: Optional[Tensor],
        dim: Optional[Union[int, Tuple[int, ...]]],
        n_samples: int,
    ) -> Tensor:
        """``x`` as given (on the generator's device), or ``N(0, I)`` draws."""
        if x is not None:
            x = torch.as_tensor(x)
            if not _same_device(x.device, generator.device):
                raise ValueError(
                    f"x is on {x.device} but the generator is on {generator.device}"
                )
            return x
        if dim is None:
            raise ValueError("Either `x` or `dim` must be provided.")
        shape = (dim,) if isinstance(dim, int) else tuple(dim)
        return torch.randn(
            (n_samples, *shape), generator=generator, device=generator.device,
            dtype=torch.float32,
        )

    def _start(self, generator, x, dim, n_samples, n_steps, thin) -> Tensor:
        """Validate a ``sample`` call and return its initial state."""
        if not isinstance(generator, torch.Generator):
            raise TypeError(f"sample needs a torch.Generator, got {type(generator).__name__}")
        if thin < 1:
            raise ValueError("thin must be >= 1")
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        _check_model_device(self.model, generator.device)
        return self._init_state(generator, x, dim, n_samples)

    @torch.no_grad()
    def sample(
        self,
        generator: torch.Generator,
        x: Optional[Tensor] = None,
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        n_steps: int = 100,
        n_samples: int = 1,
        thin: int = 1,
        return_trajectory: bool = False,
        return_diagnostics: bool = False,
        *,
        model_kwargs: Optional[Dict[str, Any]] = None,
    ):
        """Run the chain. See the module docstring for the shape contract."""
        x0 = self._start(generator, x, dim, n_samples, n_steps, thin)
        return _sample_impl(
            self, x0, generator, n_steps, thin,
            bool(return_trajectory), bool(return_diagnostics), model_kwargs or {},
        )
