"""The port's FlowSampler against the JAX package's on the same numpy inputs.

ODE generation from an injected ``x=`` agrees to 1e-5 for every fixed-step
integrator and for ``dopri5``; an SDE with zero diffusion agrees number for
number (every last-step correction), one with noise by its moments (the
random streams differ by design); the interval table and ``log_prob`` agree.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchebm_tpu.models import MLPVelocityField as JField
from torchebm_tpu.samplers import FlowSampler as JFlow
from torchebm_tpu.samplers.flow import WrappedField as JWrapped
from torchebm_tpu_torch.samplers import FlowSampler, PredictionType, WrappedField
from torchebm_tpu_torch.utils import mlp_velocity_field_from_flax, sampler_from_fields

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
FIXED = ["euler", "heun", "midpoint", "rk4", "rk438", "backward_euler"]


def _jfield(x, t):
    return -x * (0.5 + t[:, None]) + 0.3 * jnp.sin(2.0 * x)


def _tfield(x, t):
    return -x * (0.5 + t[:, None]) + 0.3 * torch.sin(2.0 * x)


def _x(seed=0, shape=(17, 3)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(**kw):
    return JFlow(model=_jfield, **kw), FlowSampler(model=_tfield, **kw)


def _g(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("integrator", FIXED + ["dopri5", "bosh3"])
def test_ode_from_injected_state_matches_jax(integrator):
    x = _x()
    a, b = _pair(integrator=integrator)
    want = a.sample(jax.random.PRNGKey(0), x=jnp.asarray(x), n_steps=12)
    got = b.sample(_g(), x=torch.from_numpy(x), n_steps=12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("prediction, interpolant", [
    ("score", "linear"), ("noise", "linear"), ("score", "cosine"), ("noise", "vp"),
    ("velocity", "cosine"), ("score", "vp")])
def test_prediction_types_match_jax(prediction, interpolant):
    x = _x(1)
    a, b = _pair(integrator="heun", prediction=prediction, interpolant=interpolant,
                 sample_eps=0.05)
    assert b.prediction_type is PredictionType[prediction.upper()]
    want = a.sample(jax.random.PRNGKey(0), x=jnp.asarray(x), n_steps=8)
    got = b.sample(_g(), x=torch.from_numpy(x), n_steps=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_reverse_and_negate_velocity_match_jax():
    x = _x(2)
    for kw in (dict(reverse=True), dict(negate_velocity=True),
               dict(reverse=True, prediction="score", sample_eps=0.1)):
        a, b = _pair(integrator="rk4", **kw)
        want = a.sample(jax.random.PRNGKey(0), x=jnp.asarray(x), n_steps=10)
        got = b.sample(_g(), x=torch.from_numpy(x), n_steps=10)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_trajectory_thin_and_diagnostics_match_jax():
    x = _x(3)
    a, b = _pair(integrator="midpoint")
    kw = dict(n_steps=11, thin=3, return_trajectory=True, return_diagnostics=True)
    want, wdiag = a.sample(jax.random.PRNGKey(0), x=jnp.asarray(x), **kw)
    got, gdiag = b.sample(_g(), x=torch.from_numpy(x), **kw)
    assert got.shape == (17, 3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sorted(gdiag) == sorted(wdiag) == ["mean", "t", "var"]
    for k in gdiag:
        np.testing.assert_allclose(gdiag[k].numpy(), np.asarray(wdiag[k]), **TOL)
    # the two remainder steps run but are not recorded
    final = b.sample(_g(), x=torch.from_numpy(x), n_steps=11)
    assert float((final - got[:, -1]).abs().max()) > 1e-4
    # adaptive: the end state's moments only
    a5, b5 = _pair()
    want, wdiag = a5.sample(jax.random.PRNGKey(0), x=jnp.asarray(x), return_diagnostics=True)
    got, gdiag = b5.sample(_g(), x=torch.from_numpy(x), return_diagnostics=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("mean", "var", "t"):
        assert gdiag[k].shape == np.asarray(wdiag[k]).shape
        np.testing.assert_allclose(gdiag[k].numpy(), np.asarray(wdiag[k]), **TOL)
    with pytest.raises(NotImplementedError, match="fixed-step"):
        b5.sample(_g(), x=torch.from_numpy(x), return_trajectory=True)
    with pytest.raises(NotImplementedError, match="fixed-step"):
        b5.sample(_g(), x=torch.from_numpy(x), thin=2)


@pytest.mark.parametrize("last_step", ["Mean", "Euler", "Tweedie", None])
@pytest.mark.parametrize("integrator", ["euler", "heun"])
def test_sde_with_zero_diffusion_matches_jax_number_for_number(last_step, integrator):
    x = _x(4)
    kw = dict(mode="sde", diffusion_form="constant", diffusion_norm=0.0, last_step=last_step,
              integrator=integrator)
    a, b = _pair(**kw)
    run = dict(n_steps=9, thin=3, return_trajectory=True, return_diagnostics=True)
    want, wdiag = a.sample(jax.random.PRNGKey(1), x=jnp.asarray(x), **run)
    got, gdiag = b.sample(_g(1), x=torch.from_numpy(x), **run)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    for k in gdiag:
        np.testing.assert_allclose(gdiag[k].numpy(), np.asarray(wdiag[k]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("form", ["SBDM", "sigma", "increasing-decreasing"])
def test_sde_with_noise_matches_jax_by_moments(form):
    # a score model of N(0, 4 I) under the linear path's SDE, which spreads
    # the samples to a variance of several hundred: both packages draw 4,000
    # samples; the means agree within 5 standard errors of their difference
    # and the variances to 12%
    def jscore(x, t):
        return -x / 4.0

    def tscore(x, t):
        return -x / 4.0

    kw = dict(mode="sde", prediction="score", diffusion_form=form, sample_eps=0.02)
    want = np.asarray(JFlow(model=jscore, **kw).sample(jax.random.PRNGKey(2), dim=2,
                                                       n_samples=4000, n_steps=60))
    got = FlowSampler(model=tscore, **kw).sample(_g(2), dim=2, n_samples=4000, n_steps=60).numpy()
    assert np.isfinite(got).all()
    se = np.sqrt((got.var(0) + want.var(0)) / 4000)
    assert (np.abs(got.mean(0) - want.mean(0)) < 5 * se).all()
    np.testing.assert_allclose(got.var(0), want.var(0), rtol=0.12)
    # and the noise really comes from the generator
    again = FlowSampler(model=tscore, **kw).sample(_g(2), dim=2, n_samples=4000, n_steps=60)
    np.testing.assert_array_equal(again.numpy(), got)
    other = FlowSampler(model=tscore, **kw).sample(_g(3), dim=2, n_samples=4000, n_steps=60)
    assert float((other - torch.from_numpy(got)).abs().max()) > 1.0


def test_check_interval_table_matches_jax():
    n = 0
    for mode, interp, pred, eps in itertools.product(
            ("ode", "sde"), ("linear", "cosine", "vp"), ("velocity", "score", "noise"),
            (0.0, 0.03)):
        extras = [{}] if mode == "ode" else [
            dict(diffusion_form=f, last_step=ls, last_step_size=lss)
            for f in ("SBDM", "sigma") for ls, lss in (("Mean", None), (None, None),
                                                        ("Euler", 0.1))]
        for extra in extras:
            kw = dict(mode=mode, interpolant=interp, prediction=pred, sample_eps=eps, **extra)
            if mode == "sde":
                kw["integrator"] = "euler"
            a, b = _pair(**kw)
            assert b._check_interval() == pytest.approx(a._check_interval()), kw
            assert (b.last_step, b.last_step_size) == (a.last_step, a.last_step_size)
            assert b.default_n_steps == a.default_n_steps
            n += 1
    assert n == 18 + 108


def test_log_prob_exact_and_hutchinson_on_a_gaussian_flow():
    # a linear, diagonal field: the flow is Gaussian, the Jacobian diagonal, so
    # Rademacher probes read its trace exactly
    scale = np.array([0.4, -0.7, 0.2], np.float32)

    def jf(x, t):
        return x * jnp.asarray(scale) * (1.0 + t[:, None])

    def tf(x, t):
        return x * torch.from_numpy(scale) * (1.0 + t[:, None])

    x = _x(5, (6, 3))
    want = np.asarray(JFlow(model=jf).log_prob(jnp.asarray(x), n_steps=40))
    b = FlowSampler(model=tf)
    got = b.log_prob(torch.from_numpy(x), n_steps=40)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    hutch = b.log_prob(torch.from_numpy(x), n_steps=40, hutchinson=True, generator=_g(),
                       n_probes=2)
    np.testing.assert_allclose(hutch.numpy(), want, rtol=1e-4, atol=1e-4)
    # in closed form: z = x exp(-1.5 s), log p = log N(z) - 1.5 sum(s)
    z = x * np.exp(-1.5 * scale)
    closed = (-0.5 * (z ** 2).sum(1) - 1.5 * np.log(2 * np.pi)) - 1.5 * scale.sum()
    np.testing.assert_allclose(got.numpy(), closed, rtol=1e-4, atol=1e-4)
    # a non-diagonal field: exact against JAX, Hutchinson close on average
    a2, b2 = _pair()
    x = _x(6, (5, 3))
    want = np.asarray(a2.log_prob(jnp.asarray(x), n_steps=30))
    np.testing.assert_allclose(b2.log_prob(torch.from_numpy(x), n_steps=30).numpy(), want,
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="generator"):
        b2.log_prob(torch.from_numpy(x), hutchinson=True)
    with pytest.raises(ValueError, match="mode='ode'"):
        FlowSampler(model=_tfield, mode="sde").log_prob(torch.from_numpy(x))
    with pytest.raises(ValueError, match="reverse=False"):
        FlowSampler(model=_tfield, reverse=True).log_prob(torch.from_numpy(x))
    np.testing.assert_allclose(b2.prior_logp(torch.from_numpy(x)).numpy(),
                               np.asarray(a2.prior_logp(jnp.asarray(x))), **TOL)


def test_generation_with_converted_weights_matches_jax():
    """The slice as a whole: a flax MLPVelocityField's weights carried
    across, then ODE generation (EqM's negated field) both ways."""
    net = JField(hidden_dims=(32, 32))
    params = net.init(jax.random.PRNGKey(3), jnp.zeros((1, 2)), jnp.zeros((1,)))
    field = mlp_velocity_field_from_flax(jax.tree_util.tree_map(np.asarray, params))
    x = _x(7, (64, 2))
    for kw in (dict(integrator="euler", negate_velocity=True), dict(negate_velocity=True)):
        want = JFlow(model=JWrapped(fn=net.apply, params=params), **kw).sample(
            jax.random.PRNGKey(0), x=jnp.asarray(x), n_steps=20)
        got = sampler_from_fields("FlowSampler", kw, field).sample(
            _g(), x=torch.from_numpy(x), n_steps=20)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    drawn = FlowSampler(model=field, integrator="euler").sample(_g(), dim=2, n_samples=5,
                                                                n_steps=3)
    assert drawn.shape == (5, 2) and drawn.device.type == "cpu"


def test_wrapped_field_and_validation_errors():
    w = WrappedField(lambda p, x, t: p * x, params=3.0)
    torch.testing.assert_close(w(torch.ones(2, 2), torch.zeros(2)), 3 * torch.ones(2, 2))
    assert WrappedField(_tfield)(torch.ones(2, 2), torch.zeros(2)).shape == (2, 2)
    for kw, match in [
        (dict(mode="pde"), "Unknown mode"),
        (dict(prediction="energy"), "Unknown prediction"),
        (dict(diffusion_form="SBDM"), "only apply to mode='sde'"),
        (dict(last_step="Mean"), "only apply to mode='sde'"),
        (dict(mode="sde", reverse=True), "reverse=True"),
        (dict(mode="sde", last_step="Median"), "Unknown last_step"),
        (dict(mode="sde", integrator="dopri5"), "family 'ode'"),
        (dict(mode="ode", integrator="leapfrog"), "family 'symplectic'"),
        (dict(interpolant="nope"), "Unknown interpolant"),
    ]:
        with pytest.raises(ValueError, match=match):
            FlowSampler(model=_tfield, **kw)
        with pytest.raises(ValueError, match=match):
            JFlow(model=_jfield, **kw)
    b = FlowSampler(model=_tfield, integrator="euler")
    assert b.replace(negate_velocity=True).negate_velocity
    sde = FlowSampler(model=_tfield, mode="sde")
    assert sde.replace(last_step=None).last_step_size == 0.0
    with pytest.raises(ValueError, match="n_steps"):
        b.sample(_g(), dim=2, n_steps=0)
    with pytest.raises(ValueError, match="thin"):
        b.sample(_g(), dim=2, thin=0)
    with pytest.raises(ValueError, match="`x` or `dim`"):
        b.sample(_g())
    with pytest.raises(TypeError, match="Generator"):
        b.sample(None, dim=2)
