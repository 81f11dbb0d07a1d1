r"""Flow-based sampler for trained generative models: ODE and SDE generation
(counterpart of :mod:`torchebm_tpu.samplers.flow`).

The sampler is configured at construction along the taxonomy axes: mode
(probability-flow ODE or reverse diffusion SDE), interpolant, prediction type
(velocity, score, noise), EqM ``negate_velocity``, ODE ``reverse`` (through
the :math:`s = t - t_0` change of variables), and the SDE diffusion form and
last-step correction.

- ``model`` is any callable ``model(x, t, **kwargs)`` with ``t`` of shape
  ``(batch,)``: an ``nn.Module`` such as
  :class:`~torchebm_tpu_torch.models.MLPVelocityField`, or a function
  (:class:`WrappedField` adapts ``fn(params, x, t)``).
- Fixed-step generation is a Python loop of integrator steps on the device of
  the generator; adaptive integrators (``dopri5``, the ODE default) run the
  integrator layer's controller, which reads its loop condition on the host
  once per attempted step.
- ``train_eps`` and ``sample_eps`` accept floats or schedulers, evaluated at
  step 0.
- Sampling runs under ``torch.no_grad()``. :meth:`FlowSampler.log_prob`
  takes the divergence of the drift by forward-mode ``torch.func.jvp``.
- A batch sharded on its rows (a DTensor ``x``, as
  :meth:`~torchebm_tpu_torch.samplers.base.BaseSampler.sample` takes one)
  gives a DTensor of the same placement holding the unsharded call's values:
  each process integrates its rows; the SDE's normals and the Hutchinson
  probes are drawn for the whole batch and cut to the rows; the adaptive
  controller's error norm (and an implicit stage's residual) is pooled over
  every shard, so every process takes the unsharded call's steps; the
  diagnostics' moments are pooled too.
"""

from __future__ import annotations

import enum
import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ..core.schedulers import BaseScheduler, sched_init
from ..integrators import resolve_integrator
from ..interpolants import (
    BaseInterpolant,
    CosineInterpolant,
    LinearInterpolant,
    VariancePreservingInterpolant,
    expand_t_like_x,
    resolve_interpolant,
)
from ..parallel.mesh import is_dtensor
from .base import BaseSampler, _draw, _randn, _row_draws, _Rows

Tensor = torch.Tensor

__all__ = ["FlowSampler", "PredictionType", "WrappedField"]

_LAST_STEPS = ("Mean", "Euler", "Tweedie", None)


class PredictionType(enum.Enum):
    """What the model predicts."""

    NOISE = enum.auto()
    SCORE = enum.auto()
    VELOCITY = enum.auto()


_PREDICTION_MAP = {
    "velocity": PredictionType.VELOCITY,
    "score": PredictionType.SCORE,
    "noise": PredictionType.NOISE,
}


@dataclass(eq=False)
class WrappedField:
    """Adapts ``fn(params, x, t, **kw)`` into the ``model(x, t, **kw)``
    contract (``params=None``: ``fn(x, t, **kw)``)."""

    fn: Callable[..., Tensor]
    params: Any = None

    def __call__(self, x: Tensor, t: Tensor, **kwargs: Any) -> Tensor:
        if self.params is None:
            return self.fn(x, t, **kwargs)
        return self.fn(self.params, x, t, **kwargs)


def _batch_t(t, x: Tensor) -> Tensor:
    """A scalar time as a ``(batch,)`` tensor of ``x``'s dtype and device."""
    return torch.as_tensor(t, dtype=x.dtype).to(x.device).expand(x.shape[0])


def _moments(x: Tensor, rows: Optional[_Rows] = None) -> Tuple[Tensor, Tensor]:
    """Mean and variance over the samples (dim 0); with ``rows`` over every
    shard's (the variance in two passes)."""
    if rows is None:
        mean, var = torch.mean(x, dim=0), torch.var(x, dim=0, correction=0)
    else:
        mean = rows.mean(x)
        var = rows.mean(torch.square(x - mean))
    return mean, torch.clamp(var, 1e-10, 1e10)


@dataclass(eq=False)
class FlowSampler(BaseSampler):
    """ODE/SDE sampler for trained velocity, score or noise fields."""

    model: Any = None
    mode: str = "ode"
    interpolant: Union[str, BaseInterpolant] = "linear"
    prediction: str = "velocity"
    train_eps: Union[float, BaseScheduler] = 0.0
    sample_eps: Union[float, BaseScheduler] = 0.0
    negate_velocity: bool = False
    reverse: bool = False
    diffusion_form: Optional[str] = None
    diffusion_norm: Optional[float] = None
    last_step: Any = "__unset__"
    last_step_size: Optional[float] = None
    integrator: Any = None

    def __post_init__(self):
        if self.mode not in ("ode", "sde"):
            raise ValueError(f"Unknown mode: {self.mode!r}. Choose from ['ode', 'sde']")
        if self.prediction not in _PREDICTION_MAP:
            raise ValueError(
                f"Unknown prediction: {self.prediction!r}. Choose from {list(_PREDICTION_MAP)}"
            )
        self.interpolant = resolve_interpolant(self.interpolant, default="linear")

        if self.mode == "ode":
            offenders = [
                name
                for name, value in (
                    ("diffusion_form", self.diffusion_form),
                    ("diffusion_norm", self.diffusion_norm),
                    ("last_step_size", self.last_step_size),
                )
                if value is not None
            ]
            # None also counts as unset: ``replace`` validates a sampler again
            # after last_step was normalised
            if self.last_step not in ("__unset__", None):
                offenders.append("last_step")
            if offenders:
                raise ValueError(f"{', '.join(sorted(offenders))} only apply to mode='sde'")
            self.last_step = None
            self.last_step_size = None
        else:
            if self.reverse:
                raise ValueError("reverse=True is not supported for mode='sde'")
            if self.diffusion_form is None:
                self.diffusion_form = "SBDM"
            if self.diffusion_norm is None:
                self.diffusion_norm = 1.0
            ls = "Mean" if self.last_step == "__unset__" else self.last_step
            if ls not in _LAST_STEPS:
                raise ValueError(f"Unknown last_step: {ls!r}. Choose from {list(_LAST_STEPS)}")
            self.last_step = ls
            lss = self.last_step_size if self.last_step_size is not None else 0.04
            self.last_step_size = 0.0 if ls is None else lss

        families = ("ode", "sde") if self.mode == "ode" else ("sde",)
        integ = resolve_integrator(
            self.integrator,
            default="dopri5" if self.mode == "ode" else "euler_maruyama",
            families=families,
        )
        if self.mode == "sde" and integ.error_weights is not None:
            raise ValueError(
                "Adaptive integrators are ODE-only; mode='sde' requires a "
                f"fixed-step integrator, got {type(integ).__name__}"
            )
        self.integrator = integ

    # ---------------------------------------------------------------- pieces

    @property
    def prediction_type(self) -> PredictionType:
        return _PREDICTION_MAP[self.prediction]

    @property
    def default_n_steps(self) -> int:
        return 50 if self.mode == "ode" else 250

    def _call_model(self, x: Tensor, t, model_kwargs) -> Tensor:
        return self.model(x, _batch_t(t, x), **(model_kwargs or {}))

    def _get_drift(self, model_kwargs) -> Callable[[Tensor, Tensor], Tensor]:
        """Probability-flow drift per prediction type."""
        ptype = self.prediction_type

        if ptype is PredictionType.VELOCITY:

            def drift(x, t):
                v = self._call_model(x, t, model_kwargs)
                return -v if self.negate_velocity else v

        elif ptype is PredictionType.SCORE:

            def drift(x, t):
                drift_mean, drift_var = self.interpolant.compute_drift(x, _batch_t(t, x))
                return -drift_mean + drift_var * self._call_model(x, t, model_kwargs)

        else:

            def drift(x, t):
                t_b = _batch_t(t, x)
                drift_mean, drift_var = self.interpolant.compute_drift(x, t_b)
                sigma_t, _ = self.interpolant.compute_sigma_t(expand_t_like_x(t_b, x))
                score = self._call_model(x, t, model_kwargs) / (-sigma_t + 1e-8)
                return -drift_mean + drift_var * score

        return drift

    def _get_score(self, model_kwargs) -> Callable[[Tensor, Tensor], Tensor]:
        ptype = self.prediction_type

        if ptype is PredictionType.VELOCITY:

            def score(x, t):
                return self.interpolant.velocity_to_score(
                    self._call_model(x, t, model_kwargs), x, _batch_t(t, x)
                )

        elif ptype is PredictionType.SCORE:

            def score(x, t):
                return self._call_model(x, t, model_kwargs)

        else:

            def score(x, t):
                sigma_t, _ = self.interpolant.compute_sigma_t(
                    expand_t_like_x(_batch_t(t, x), x))
                return self._call_model(x, t, model_kwargs) / (-sigma_t + 1e-8)

        return score

    def _check_interval(self) -> Tuple[float, float]:
        """Forward interval ``(t0, t1)``: the ends that the interpolant, the
        prediction type and the SDE's last step keep away from 0 and 1."""
        t0, t1 = 0.0, 1.0
        eps = sched_init(self.sample_eps)
        sde = self.mode == "sde"
        last_step_size = self.last_step_size if sde else 0.0

        is_vp = isinstance(self.interpolant, VariancePreservingInterpolant)
        is_lin_cos = isinstance(self.interpolant, (LinearInterpolant, CosineInterpolant))
        velocity = self.prediction_type is PredictionType.VELOCITY

        if is_vp:
            t1 = 1 - eps if (not sde or last_step_size == 0) else 1 - last_step_size
        elif is_lin_cos and (not velocity or sde):
            t0 = eps if (self.diffusion_form == "SBDM" and sde) or not velocity else 0.0
            t1 = 1 - eps if (not sde or last_step_size == 0) else 1 - last_step_size
        return t0, t1

    def _sde_dynamics(self, model_kwargs):
        """Reverse-SDE drift and diffusion."""
        drift_fn = self._get_drift(model_kwargs)
        score_fn = self._get_score(model_kwargs)

        def diffusion_fn(x, t):
            return self.interpolant.compute_diffusion(
                x, _batch_t(t, x), form=self.diffusion_form, norm=self.diffusion_norm
            )

        def sde_drift(x, t):
            return drift_fn(x, t) + diffusion_fn(x, t) * score_fn(x, t)

        return sde_drift, diffusion_fn

    def _apply_last_step(self, x, t, sde_drift, model_kwargs):
        """Final SDE denoising correction."""
        ls = self.last_step
        if ls == "Mean":
            return x + sde_drift(x, t) * self.last_step_size
        if ls == "Euler":
            return x + self._get_drift(model_kwargs)(x, t) * self.last_step_size
        if ls == "Tweedie":
            te = expand_t_like_x(_batch_t(t, x), x)
            alpha, _ = self.interpolant.compute_alpha_t(te)
            sigma, _ = self.interpolant.compute_sigma_t(te)
            score = self._get_score(model_kwargs)(x, t)
            return x / alpha + torch.square(sigma) / alpha * score
        return x

    def prior_logp(self, z: Tensor) -> Tensor:
        """Standard-normal prior log-density."""
        n = math.prod(z.shape[1:])
        return -n / 2.0 * math.log(2 * math.pi) - torch.sum(
            torch.square(z).reshape(z.shape[0], -1), dim=-1
        ) / 2.0

    def log_prob(self, x: Tensor, *, generator: Optional[torch.Generator] = None,
                 n_steps: int = 100, hutchinson: Optional[bool] = None, n_probes: int = 1,
                 model_kwargs: Optional[Dict[str, Any]] = None) -> Tensor:
        r"""Model log-likelihood through the probability-flow ODE.

        The instantaneous change of variables (Chen et al. 2018) integrated
        backwards from data ``x`` at :math:`t_1` to the prior at :math:`t_0`
        with RK4,

        .. math::
            \log p_{t_1}(x) = \log p_{t_0}(x_{t_0})
            - \int_{t_0}^{t_1} \nabla\!\cdot u(x_t, t)\,dt .

        The divergence is the exact Jacobian trace (``hutchinson=False``, the
        default when the event has at most 8 elements: one forward-mode pass
        per element and stage) or the unbiased Hutchinson–Rademacher
        estimator (``hutchinson=True``; requires ``generator``; ``n_probes``
        probes, fixed along the trajectory). ODE mode with ``reverse=False``.

        The exact trace probes every row of the batch with the same unit
        vector at once, one forward-mode pass per element of the event. This
        equals the JAX package's per-sample ``jacfwd`` only when the field's
        rows do not interact, i.e. row i of the output depends on row i of
        the input alone (no batch statistics, no attention across samples).
        Every field of the library meets that, the DiT included.

        A DTensor ``x`` sharded on its rows gives its rows' log-densities
        laid out as ``x``: the probes are drawn for the whole batch and cut
        to the rows, so the values are the unsharded call's.
        """
        if self.mode != "ode":
            raise ValueError("log_prob requires mode='ode' (probability-flow ODE)")
        if self.reverse:
            raise ValueError("log_prob is defined for reverse=False flows")
        d = math.prod(x.shape[1:])
        if hutchinson is None:
            hutchinson = d > 8
        if hutchinson and generator is None:
            raise ValueError("hutchinson divergence estimation requires generator=")
        rows = _Rows(x) if is_dtensor(x) else None
        out = _flow_logprob_impl(self, x if rows is None else rows.local, generator, int(n_steps),
                                 bool(hutchinson), int(n_probes), model_kwargs or {}, rows)
        return out if rows is None else rows.like_this(out)

    # ---------------------------------------------------------------- sample

    @torch.no_grad()
    def sample(
        self,
        generator: torch.Generator,
        x: Optional[Tensor] = None,
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        n_steps: Optional[int] = None,
        n_samples: int = 1,
        thin: int = 1,
        return_trajectory: bool = False,
        return_diagnostics: bool = False,
        *,
        model_kwargs: Optional[Dict[str, Any]] = None,
    ):
        """Integrate the configured ODE or SDE from ``x`` (or ``N(0, I)``
        draws) over the forward interval.

        Adaptive integrators (``dopri5``, ``dopri8``, ...) return only the
        final state; ``thin`` and ``return_trajectory`` need a fixed-step
        integrator. A DTensor ``x`` sharded on its rows gives a DTensor laid
        out as ``x`` holding the unsharded call's values (module docstring).
        """
        if n_steps is None:
            n_steps = self.default_n_steps
        if n_steps <= 0:
            raise ValueError("n_steps must be positive")
        return super().sample(generator, x, dim, n_steps, n_samples, thin, return_trajectory,
                              return_diagnostics, model_kwargs=model_kwargs)

    def _run(self, generator, x0, n_steps, thin, return_trajectory, return_diagnostics,
             model_kwargs, rows=None):
        if self.integrator.error_weights is not None and (return_trajectory or thin != 1):
            raise NotImplementedError(
                "return_trajectory/thin require a fixed-step integrator; "
                f"adaptive {type(self.integrator).__name__} returns only the "
                "final state. Construct FlowSampler(integrator='euler') or "
                "another fixed-step method."
            )
        return _flow_sample_impl(self, x0, generator, n_steps, thin, return_trajectory,
                                 return_diagnostics, model_kwargs, rows)


def _flow_sample_impl(sampler: FlowSampler, x0: Tensor, generator: torch.Generator,
                      n_steps: int, thin: int, return_trajectory: bool,
                      return_diagnostics: bool, model_kwargs: Dict[str, Any],
                      rows: Optional[_Rows] = None):
    """The generation loop from ``x0``; ``rows``: ``x0`` holds one shard's
    rows (module docstring)."""
    sde = sampler.mode == "sde"
    integ = sampler.integrator
    t0, t1 = sampler._check_interval()
    t_phys = torch.linspace(t0, t1, n_steps + 1, dtype=x0.dtype, device=x0.device)

    diffusion_fn = None
    if sde:
        drift, diffusion_fn = sampler._sde_dynamics(model_kwargs)
        grid = t_phys
    else:
        base_drift = sampler._get_drift(model_kwargs)
        if sampler.reverse:
            def drift(x_, s_):
                return -base_drift(x_, t0 + s_)

            grid = t_phys - t0
        else:
            drift = base_drift
            grid = t_phys

    # the error norm and an implicit stage's residual, over every shard's rows
    norm = None if rows is None else rows.rms_norm
    if integ.error_weights is not None:
        x = integ.integrate({"x": x0}, grid[1] - grid[0], n_steps, drift=drift, t=grid,
                            norm=norm)["x"]
        if not return_diagnostics:
            return x
        mean, var = _moments(x, rows)
        return x, {"mean": mean[None], "var": var[None], "t": t_phys[-1:]}

    draws = _row_draws(generator, rows)

    def one_step(i, xc):
        dt, ti = grid[i + 1] - grid[i], grid[i]
        if sde:
            noise = _randn(draws, xc.shape, device=xc.device, dtype=xc.dtype)
            return integ.step({"x": xc}, dt, drift=drift, diffusion=diffusion_fn(xc, ti), t=ti,
                              noise=noise, norm=norm)["x"]
        if integ.family == "sde":
            # an SDE integrator in ODE mode: the deterministic part, noise zeroed
            return integ.step({"x": xc}, dt, drift=drift, t=ti, noise=torch.zeros_like(xc),
                              norm=norm)["x"]
        return integ.step({"x": xc}, dt, drift=drift, t=ti, norm=norm)["x"]

    n_kept = n_steps // thin
    x = x0
    outs: Dict[str, list] = {"traj": [], "mean": [], "var": [], "t": []}
    for k in range(n_kept):
        for j in range(thin):
            x = one_step(k * thin + j, x)
        if return_trajectory:
            outs["traj"].append(x)
        if return_diagnostics:
            mean, var = _moments(x, rows)
            outs["mean"].append(mean)
            outs["var"].append(var)
            outs["t"].append(t_phys[(k + 1) * thin])
    for i in range(n_kept * thin, n_steps):
        x = one_step(i, x)

    if sde and sampler.last_step is not None:
        x = sampler._apply_last_step(x, t_phys[-1], drift, model_kwargs)
        # keep the recorded end state equal to the returned sample
        if n_kept > 0 and n_kept * thin == n_steps:
            if return_trajectory:
                outs["traj"][-1] = x
            if return_diagnostics:
                outs["mean"][-1], outs["var"][-1] = _moments(x, rows)
                outs["t"][-1] = t_phys[-1] + sampler.last_step_size

    output = torch.stack(outs["traj"], dim=1) if return_trajectory and n_kept > 0 else x
    if return_diagnostics:
        diag = {k: torch.stack(v) for k, v in outs.items() if k != "traj" and v}
        return output, diag
    return output


@torch.no_grad()
def _flow_logprob_impl(sampler: FlowSampler, x: Tensor, generator, n_steps: int,
                       hutchinson: bool, n_probes: int, model_kwargs: Dict[str, Any],
                       rows: Optional[_Rows] = None) -> Tensor:
    t0, t1 = sampler._check_interval()
    drift = sampler._get_drift(model_kwargs)
    batch = x.shape[0]
    d = math.prod(x.shape[1:])

    if hutchinson:
        # Rademacher probes, fixed along the whole trajectory; a shard's rows
        # of the whole batch's (its rows on dim 1)
        bits = _draw(functools.partial(torch.randint, 0, 2), _row_draws(generator, rows),
                     (n_probes, *x.shape), x.device, torch.int64, chain_dim=1)
        probes = bits.to(x.dtype) * 2.0 - 1.0
        scale = 1.0 / n_probes
    else:
        # the unit vectors: batch rows are independent, so probing every
        # sample with e_k at once reads the k-th diagonal Jacobian entries
        probes = torch.eye(d, dtype=x.dtype, device=x.device).reshape(d, 1, *x.shape[1:])
        probes = probes.expand(d, *x.shape)
        scale = 1.0

    def aug(xx, s):
        """``(-u, div u)`` at physical time ``t1 - s``."""
        t = t1 - s
        total = torch.zeros(batch, dtype=xx.dtype, device=xx.device)
        u = None
        for v in probes:
            u, jv = torch.func.jvp(lambda z: drift(z, t), (xx,), (v.contiguous(),))
            total = total + torch.sum((v * jv).reshape(batch, -1), dim=-1)
        return -u, total * scale

    # backward RK4 on the augmented state (x, ∫ div u dt): dx/ds = -u, da/ds = div u
    h = (t1 - t0) / n_steps
    xx, a = x, torch.zeros(batch, dtype=x.dtype, device=x.device)
    for i in range(n_steps):
        s = i * h
        k1x, k1a = aug(xx, s)
        k2x, k2a = aug(xx + 0.5 * h * k1x, s + 0.5 * h)
        k3x, k3a = aug(xx + 0.5 * h * k2x, s + 0.5 * h)
        k4x, k4a = aug(xx + h * k3x, s + h)
        xx = xx + h / 6.0 * (k1x + 2.0 * k2x + 2.0 * k3x + k4x)
        a = a + h / 6.0 * (k1a + 2.0 * k2a + 2.0 * k3a + k4a)
    return sampler.prior_logp(xx) - a
