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

A batch sharded on its rows (a DTensor ``x``, e.g. from
:func:`~torchebm_tpu_torch.parallel.shard_batch`) gives a DTensor of the same
placement holding the unsharded call's values: each process runs its rows
(:class:`_Rows`), a whole-chain kernel with ``chain_offset`` at the shard's
first row (the Philox streams of those rows in the whole batch), a loop with
each step's draws made for the whole batch and cut to the shard's rows
(:class:`_RowDraws`: O(global batch) draws per process, from generators in
one state on every process). Diagnostics, acceptance rates and the host's
reads that steer a loop (NUTS's any-tree-growing flag) are reduced over every
shard, so every process gets the unsharded call's numbers and takes the same
steps. :meth:`BaseSampler.sample` takes the DTensor and hands the local rows
to ``_run``, which samplers with kernels override.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..parallel.mesh import is_dtensor, like_rows, row_shard, sum_over_rows
from ..utils.profiling import count, span

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


def _metropolis_target(sampler, device: torch.device, return_diagnostics: bool, model_kwargs):
    """The gate of the MALA and HMC whole-chain kernels: ``(means, target
    kwargs)`` when the call may take a kernel, else None (the loop).

    A CUDA generator (or ``fused="force"``, which sends CPU calls to the
    kernels' plain versions), no diagnostics, no conditioning, a constant step
    size, and a target the kernels hold: a full-covariance
    :class:`~torchebm_tpu_torch.core.energies.GaussianEnergy` with d ≤ 32 or a
    :class:`~torchebm_tpu_torch.core.energies.GaussianMixtureEnergy` with
    d ≤ 64 and K·d ≤ 1024.
    """
    from ..core.energies import GaussianMixtureEnergy

    if sampler.fused == "off":
        return None
    if sampler.fused != "force" and device.type != "cuda":
        return None
    if return_diagnostics or model_kwargs or not _concrete_scalar(sampler.step_size):
        return None
    gt = _gaussian_target(sampler.model)
    if gt is not None:
        return gt[0], dict(precision=gt[1].contiguous())
    if type(sampler.model) is not GaussianMixtureEnergy:
        return None
    k, d = sampler.model.means.shape
    if d > 64 or k * d > 1024:
        return None
    return sampler.model.means, dict(
        scale=_read_float(sampler.model.scale), log_weights=sampler.model.log_weights
    )


def _read_float(t: Tensor) -> float:
    """``float(t)``, counted as a host read."""
    count("host_reads")
    return float(t)


def _draw_seed(generator: torch.Generator) -> Tensor:
    return torch.randint(0, 2**63 - 1, (), generator=generator, device=generator.device)


def _kernel_seed_tensor(generator: torch.Generator) -> Tensor:
    """The Philox seed of a whole-chain kernel, drawn from ``generator``: a
    0-d int64 tensor on the generator's device, which a kernel that takes a
    device seed reads there (no host sync)."""
    with span("sampler.seed"):
        return _draw_seed(generator)


def _kernel_seed(generator: torch.Generator) -> int:
    """:func:`_kernel_seed_tensor`'s draw, read on the host."""
    with span("sampler.seed"):
        count("host_reads")
        return int(_draw_seed(generator))


class _Rows:
    """Rows ``[start, start + n)`` of a batch of ``n_global`` rows sharded as
    the DTensor ``like`` (its rows on dim ``dim``): what one process of a
    sharded call holds, and the sums over the processes that hold the rest."""

    def __init__(self, like, dim: int = 0):
        self.local, self.start, self.n_global = row_shard(like, dim)
        self.n = self.local.shape[dim]
        self.like, self.dim = like, dim

    def cut(self, whole: Tensor, dim: int = 0) -> Tensor:
        """This process's rows of ``whole``, a tensor of the whole batch's
        rows on ``dim``."""
        return whole.narrow(dim, self.start, self.n)

    def total(self, t: Tensor) -> Tensor:
        """``t``, a sum over this process's rows, summed over every row."""
        return sum_over_rows(t, self.like)

    def mean(self, t: Tensor, dim: int = 0) -> Tensor:
        """The mean over every row of ``t``, which holds this process's rows on ``dim``."""
        return self.total(torch.sum(t, dim=dim)) / self.n_global

    def pool(self, local_mean: Tensor) -> Tensor:
        """The mean over every row, from ``local_mean``, the mean over this process's."""
        return self.total(local_mean * self.n) / self.n_global

    def rms_norm(self, t: Tensor) -> Tensor:
        """The root mean square of the entries of ``t`` (this process's rows on
        dim 0) over every row: the sums of squares pooled over the shards over
        the whole batch's count; a shard that holds every row (a world of
        one) reduces as the unsharded call does."""
        if self.n == self.n_global:
            return torch.sqrt(torch.mean(torch.square(t)))
        sq = self.total(torch.sum(torch.square(t)))
        return torch.sqrt(sq / (self.n_global * math.prod(t.shape[1:])))

    def whole(self, t: Tensor) -> Tensor:
        """The whole batch of ``t`` (this process's rows on dim 0) on every
        process: the rows written into zeros and summed over the shards (adding
        zeros is exact), so that a reduction over it has the unsharded call's
        bits. O(whole batch) to move: for the few values that feed back into
        the chains (a warmup's step size and mass)."""
        out = torch.zeros((self.n_global, *t.shape[1:]), dtype=t.dtype, device=t.device)
        out[self.start:self.start + self.n] = t
        return self.total(out)

    def like_this(self, local: Tensor) -> Any:
        """``local`` (this process's rows) as a DTensor laid out as the input."""
        return like_rows(local, self.like, self.dim)


class _RowDraws:
    """The generator of a sharded call's loop: :func:`_randn` and
    :func:`_rand` draw from it the numbers of the whole batch and keep this
    process's rows, so that a shard draws what its rows draw in the
    unsharded call (O(whole batch) draws on every process, from generators in
    one state on every process)."""

    def __init__(self, generator: torch.Generator, rows: _Rows):
        self.generator, self.rows = generator, rows

    @property
    def device(self) -> torch.device:
        return self.generator.device


def _row_draws(generator, rows: Optional[_Rows]):
    """``generator``, wrapped in :class:`_RowDraws` when ``rows`` is given."""
    return generator if rows is None else _RowDraws(generator, rows)


def _draw(fn, generator, shape, device, dtype, chain_dim: int) -> Tensor:
    shape = tuple(shape)
    if isinstance(generator, _RowDraws):
        rows = generator.rows
        whole = shape[:chain_dim] + (rows.n_global,) + shape[chain_dim + 1:]
        return rows.cut(fn(whole, generator=generator.generator, device=device, dtype=dtype),
                        chain_dim)
    return fn(shape, generator=generator, device=device, dtype=dtype)


def _randn(generator, shape, *, device, dtype, chain_dim: int = 0) -> Tensor:
    """Standard normals of ``shape``, its chains on ``chain_dim``, from a
    ``torch.Generator`` or a :class:`_RowDraws`."""
    return _draw(torch.randn, generator, shape, device, dtype, chain_dim)


def _rand(generator, shape, *, device, dtype, chain_dim: int = 0) -> Tensor:
    """Uniforms in [0, 1) of ``shape``, as :func:`_randn` draws normals."""
    return _draw(torch.rand, generator, shape, device, dtype, chain_dim)


def _any_chain(flag: Tensor, generator) -> bool:
    """Whether any chain's ``flag`` is set, over every shard of a
    :class:`_RowDraws` call (read on the host, the same on every process)."""
    count("host_reads")
    if isinstance(generator, _RowDraws):
        return bool(generator.rows.total(torch.sum(flag, dtype=torch.int64)) > 0)
    return bool(flag.any())


def _chain_stats(x: Tensor, energy: Tensor, rows: Optional[_Rows], dim: int = 0):
    """``{"mean", "var", "energy"}`` over the chains (``dim``) of states ``x``
    and their energies: the unsharded call's reductions, or with ``rows`` the
    means over every shard's chains (the variance in two passes)."""
    if rows is None:
        mean, var = torch.mean(x, dim=dim), torch.var(x, dim=dim, correction=0)
        energy = torch.mean(energy, dim=dim)
    else:
        mean = rows.mean(x, dim)
        var = rows.mean(torch.square(x - mean.unsqueeze(dim)), dim)
        energy = rows.mean(energy, dim)
    return {"mean": mean, "var": torch.clamp(var, 1e-10, 1e10), "energy": energy}


def _sample_impl(
    sampler: "BaseSampler",
    x0: Tensor,
    generator: torch.Generator,
    n_steps: int,
    thin: int,
    return_trajectory: bool,
    return_diagnostics: bool,
    model_kwargs: Dict[str, Any],
    rows: Optional[_Rows] = None,
):
    """The shared sampling loop.

    ``n_steps // thin`` kept slots of ``thin`` transition steps each, then
    the ``n_steps % thin`` remainder steps (they run but are not recorded).
    Step index ``i`` drives the schedulers. The carry keeps the dtypes it
    started with. With ``rows`` (a shard of a sharded batch) the steps draw
    through :class:`_RowDraws` and the diagnostics are the means over every
    shard's chains; a sampler's extras are means over chains and are pooled
    as such.
    """
    generator = _row_draws(generator, rows)
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
            d = _chain_stats(x, sampler.energy_of(x, model_kwargs), rows)
            extra = sampler.extra_diagnostics(carry, model_kwargs)
            d.update(extra if rows is None else {k: rows.pool(v) for k, v in extra.items()})
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
    def replace(self, **changes) -> "BaseSampler":
        """A copy with ``changes`` applied to its fields, validated again, as
        in ``hmc.replace(step_size=eps)`` after :meth:`warmup`."""
        return dataclasses.replace(self, **changes)

    def _init_state(
        self,
        generator: torch.Generator,
        x: Optional[Tensor],
        dim: Optional[Union[int, Tuple[int, ...]]],
        n_samples: int,
    ) -> Tensor:
        """``x`` as given (on the generator's device), or ``N(0, I)`` draws.
        A DTensor reaches here only through an entry point that does not
        shard (``sample`` takes one before it), and raises."""
        if is_dtensor(x):
            raise ValueError(f"{type(self).__name__} does not take a sharded (DTensor) batch "
                             "here; pass x.full_tensor()")
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
        """Run the chain. See the module docstring for the shape contract. A
        DTensor ``x``, a batch sharded on its rows (every process's generator
        in the same state), gives a DTensor of the same placement holding the
        unsharded call's values, and the unsharded call's diagnostics on
        every process (module docstring). The call is the span
        ``sampler.sample``, its validation and initial state ``sampler.start``
        (:func:`~torchebm_tpu_torch.utils.profiling.span`)."""
        with span("sampler.sample"):
            with span("sampler.start"):
                rows = None
                if is_dtensor(x):
                    rows = _Rows(x)
                    x, dim, n_samples = rows.local, None, 1
                x0 = self._start(generator, x, dim, n_samples, n_steps, thin)
            out = self._run(generator, x0, n_steps, thin, bool(return_trajectory),
                            bool(return_diagnostics), model_kwargs or {}, rows)
            if rows is None:
                return out
            if return_diagnostics:
                return rows.like_this(out[0]), out[1]
            return rows.like_this(out)

    def _run(self, generator, x0, n_steps, thin, return_trajectory, return_diagnostics,
             model_kwargs, rows=None):
        """:meth:`sample` from the state ``x0``; ``rows``: ``x0`` holds the
        rows of a sharded batch that :class:`_Rows` names. Samplers with
        whole-chain kernels override it."""
        return _sample_impl(self, x0, generator, n_steps, thin, return_trajectory,
                            return_diagnostics, model_kwargs, rows)
