"""The port's integrators and registry against the JAX package.

With the noise injected (``noise=``) one step is deterministic, so both
packages agree to atol 1e-5 (float32) on the same numpy inputs. Each
method's one-step update is also pinned to stages evaluated by hand, as in
``tests/integrators/test_manual_steps.py``, and the adaptive controller's
accepted and attempted step counts equal the JAX package's.
"""

from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torchebm_tpu.core.energies as je
import torchebm_tpu.integrators as ji
import torchebm_tpu_torch.core.energies as te
import torchebm_tpu_torch.integrators as ti

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed=0, shape=(31, 2)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize(
    "h, step_kw",
    [
        (0.05, dict(noise_scale=0.7)),
        (0.02, dict(diffusion=0.3)),
        (0.1, dict(noise_scale=0.0)),
    ],
)
def test_em_step_with_injected_noise_matches_jax(h, step_kw):
    x, noise = _inputs()
    jm, tm = je.GaussianMixtureEnergy.eight_gaussians(), te.GaussianMixtureEnergy.eight_gaussians()
    ref = ji.EulerMaruyamaIntegrator().step(
        {"x": jnp.asarray(x)}, h, drift=lambda x_, t_: -jm.gradient(x_),
        noise=jnp.asarray(noise), **step_kw,
    )["x"]
    out = ti.EulerMaruyamaIntegrator().step(
        {"x": torch.from_numpy(x)}, h, drift=lambda x_, t_: -tm.gradient(x_),
        noise=torch.from_numpy(noise), **step_kw,
    )["x"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_em_integrate_deterministic_part_matches_jax():
    x, _ = _inputs(1)
    drift_j = lambda x_, t_: -x_ * (1.0 + t_)  # noqa: E731  time-dependent on purpose
    drift_t = lambda x_, t_: -x_ * (1.0 + t_)  # noqa: E731
    ref = ji.EulerMaruyamaIntegrator().integrate(
        {"x": jnp.asarray(x)}, 0.05, 12, drift=drift_j, key=jax.random.PRNGKey(0),
        noise_scale=0.0,
    )["x"]
    out = ti.EulerMaruyamaIntegrator().integrate(
        {"x": torch.from_numpy(x)}, 0.05, 12, drift=drift_t,
        generator=torch.Generator().manual_seed(0), noise_scale=0.0,
    )["x"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_em_noise_comes_from_the_generator():
    x = torch.zeros(2000, 3)
    em = ti.EulerMaruyamaIntegrator()
    def step(g):
        return em.step({"x": x}, 0.5, drift=lambda x_, t_: 0 * x_, generator=g)["x"]

    a, b = step(torch.Generator().manual_seed(3)), step(torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    # amplitude noise_scale * sqrt(2h) = 1
    assert abs(float(a.std()) - 1.0) < 0.03
    with pytest.raises(ValueError, match="Generator"):
        em.step({"x": x}, 0.5, drift=lambda x_, t_: x_)
    with pytest.raises(ValueError, match="Generator"):
        em.integrate({"x": x}, 0.5, 2, drift=lambda x_, t_: x_)


def test_explicit_grid_integration():
    x = torch.ones(4)
    out = ti.EulerMaruyamaIntegrator().integrate(
        {"x": x}, None, t=torch.tensor([0.0, 0.1, 0.3]), drift=lambda x_, t_: -x_,
        generator=torch.Generator(), noise_scale=0.0,
    )["x"]
    torch.testing.assert_close(out, x * 0.9 * 0.8)
    with pytest.raises(ValueError, match="n_steps"):
        ti.EulerMaruyamaIntegrator().integrate({"x": x}, 0.1, 0, drift=lambda x_, t_: x_,
                                               generator=torch.Generator())


@dataclass(frozen=True)
class _OdeEuler(ti.BaseRungeKuttaIntegrator):
    tableau_a: ClassVar = ((),)
    tableau_b: ClassVar = (1.0,)
    tableau_c: ClassVar = (0.0,)


@dataclass(frozen=True)
class _ImplicitEuler(ti.BaseSDERungeKuttaIntegrator):
    tableau_a: ClassVar = ((1.0,),)
    tableau_b: ClassVar = (1.0,)
    tableau_c: ClassVar = (1.0,)


def test_registry_names_and_probes():
    for name in ("euler", "euler_maruyama", "EULER"):
        assert isinstance(ti.get_integrator(name), ti.EulerMaruyamaIntegrator)
    missing = {"generalised_leapfrog", "generalized_leapfrog"}
    assert sorted(ti.INTEGRATOR_REGISTRY) == sorted(set(ji.INTEGRATOR_REGISTRY) - missing)
    for name, cls in ti.INTEGRATOR_REGISTRY.items():
        assert cls.__name__ == ji.INTEGRATOR_REGISTRY[name].__name__
        a, b = ji.get_integrator(name), ti.get_integrator(name)
        assert b.family == a.family
        for attr in ("tableau_a", "tableau_b", "tableau_c", "error_weights", "order", "fsal"):
            assert getattr(b, attr, None) == getattr(a, attr, None), (name, attr)
    assert isinstance(ti.get_integrator("leapfrog"), ti.LeapfrogIntegrator)
    assert ti.get_integrator("dopri5", rtol=1e-3).rtol == 1e-3
    # names the JAX package knows but the port has not ported yet
    assert isinstance(ji.get_integrator("generalised_leapfrog"), ji.GeneralisedLeapfrogIntegrator)
    for name in missing:
        with pytest.raises(ValueError, match=f"Unknown integrator '{name}'"):
            ti.get_integrator(name)
    for mod in (ji, ti):
        with pytest.raises(ValueError, match="Unknown integrator 'nope'"):
            mod.resolve_integrator("nope", default="euler")
        with pytest.raises(TypeError):
            mod.get_integrator(3)
        with pytest.raises(TypeError):
            mod.resolve_integrator(3.0, default="euler")
    em = ti.EulerMaruyamaIntegrator()
    assert ti.resolve_integrator(em, default="euler", families=("sde",)) is em
    assert isinstance(ti.resolve_integrator(None, default="euler"), ti.EulerMaruyamaIntegrator)


def test_hmc_rejects_a_non_symplectic_integrator_as_jax_does():
    from torchebm_tpu.core import GaussianEnergy as JGaussian
    from torchebm_tpu.samplers import HamiltonianMonteCarlo as JHMC
    from torchebm_tpu_torch.core import GaussianEnergy as TGaussian
    from torchebm_tpu_torch.samplers import HamiltonianMonteCarlo as THMC

    with pytest.raises(ValueError, match="family 'sde'"):
        JHMC(JGaussian.standard(2), integrator="euler")
    with pytest.raises(ValueError, match="family 'sde'"):
        THMC(TGaussian.standard(2), integrator="euler")
    # the Langevin sampler refuses the symplectic leapfrog the same way
    from torchebm_tpu_torch.samplers import LangevinDynamics

    with pytest.raises(ValueError, match="family 'symplectic'"):
        LangevinDynamics(TGaussian.standard(2), integrator="leapfrog")


def test_registry_rejects_wrong_family():
    with pytest.raises(ValueError, match="family 'ode'"):
        ti.resolve_integrator(_OdeEuler(), default="euler", families=("sde",))
    with pytest.raises(ValueError, match="family 'symplectic'"):
        ji.resolve_integrator(ji.LeapfrogIntegrator(), default="euler", families=("sde",))
    # the ODE base steps without noise
    out = _OdeEuler().step({"x": torch.ones(3)}, 0.5, drift=lambda x_, t_: -x_)["x"]
    torch.testing.assert_close(out, torch.full((3,), 0.5))


def test_implicit_stages_are_not_ported():
    """The implicit (DIRK) stage of a user tableau, which used to raise, is
    solved by Picard iteration: on x' = -x the fixed point is x / (1 + h)."""
    out = _ImplicitEuler(solver_max_iter=30).step(
        {"x": torch.ones(2)}, 0.1, drift=lambda x_, t_: -x_, noise=torch.zeros(2))["x"]
    torch.testing.assert_close(out, torch.full((2,), 1.0 / 1.1))
    # with residual checks the solve stops early, at the same fixed point
    calls = []

    def drift(x_, t_):
        calls.append(1)
        return -x_

    early = _ImplicitEuler(solver_max_iter=30, solver_check_every=1, solver_tol=1e-4).step(
        {"x": torch.ones(2)}, 0.1, drift=drift, noise=torch.zeros(2))["x"]
    torch.testing.assert_close(early, out, atol=1e-4, rtol=0)
    assert 3 <= len(calls) < 30


H, X0 = 0.1, 1.0


def _f(x):
    return x * x


def _expected_euler():
    return X0 + H * _f(X0)


def _expected_heun():
    k1 = _f(X0)
    return X0 + H / 2 * (k1 + _f(X0 + H * k1))


def _expected_midpoint():
    return X0 + H * _f(X0 + H / 2 * _f(X0))


def _expected_rk4():
    k1 = _f(X0)
    k2 = _f(X0 + H / 2 * k1)
    k3 = _f(X0 + H / 2 * k2)
    k4 = _f(X0 + H * k3)
    return X0 + H / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def _expected_rk438():
    k1 = _f(X0)
    k2 = _f(X0 + H / 3 * k1)
    k3 = _f(X0 + H * (-k1 / 3 + k2))
    k4 = _f(X0 + H * (k1 - k2 + k3))
    return X0 + H / 8 * (k1 + 3 * k2 + 3 * k3 + k4)


def _expected_bosh3():
    k1 = _f(X0)
    k2 = _f(X0 + H / 2 * k1)
    k3 = _f(X0 + 3 * H / 4 * k2)
    return X0 + H * (2 / 9 * k1 + 1 / 3 * k2 + 4 / 9 * k3)


def _expected_dopri5():
    k1 = _f(X0)
    k2 = _f(X0 + H * (1 / 5 * k1))
    k3 = _f(X0 + H * (3 / 40 * k1 + 9 / 40 * k2))
    k4 = _f(X0 + H * (44 / 45 * k1 - 56 / 15 * k2 + 32 / 9 * k3))
    k5 = _f(X0 + H * (19372 / 6561 * k1 - 25360 / 2187 * k2 + 64448 / 6561 * k3
                      - 212 / 729 * k4))
    k6 = _f(X0 + H * (9017 / 3168 * k1 - 355 / 33 * k2 + 46732 / 5247 * k3 + 49 / 176 * k4
                      - 5103 / 18656 * k5))
    return X0 + H * (35 / 384 * k1 + 500 / 1113 * k3 + 125 / 192 * k4 - 2187 / 6784 * k5
                     + 11 / 84 * k6)


MANUAL = {"euler": _expected_euler, "heun": _expected_heun, "midpoint": _expected_midpoint,
          "rk4": _expected_rk4, "rk438": _expected_rk438, "bosh3": _expected_bosh3,
          "dopri5": _expected_dopri5}


@pytest.mark.parametrize("name", sorted(MANUAL))
def test_single_step_matches_hand_computed(name):
    """x' = x^2 from 1 with h = 0.1: every stage value is distinct, so a
    mis-copied tableau entry cannot cancel."""
    integ = ti.get_integrator(name)
    kw = dict(noise=torch.zeros(1, 1)) if integ.family == "sde" else {}
    out = integ.step({"x": torch.full((1, 1), X0)}, H, drift=lambda x, t: _f(x), **kw)
    np.testing.assert_allclose(float(out["x"][0, 0]), MANUAL[name](), rtol=2e-6)


def test_backward_euler_solves_implicit_equation():
    lam = 3.0
    integ = ti.get_integrator("backward_euler", solver_max_iter=40)
    out = integ.step({"x": torch.full((1, 1), X0)}, H, drift=lambda x, t: -lam * x,
                     generator=torch.Generator(), noise_scale=0.0)
    np.testing.assert_allclose(float(out["x"][0, 0]), X0 / (1 + lam * H), rtol=1e-5)


@pytest.mark.parametrize("name", ["dopri5", "dopri8", "bosh3", "adaptive_heun"])
def test_adaptive_controller_matches_jax(name):
    x = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
    a, b = ji.get_integrator(name), ti.get_integrator(name)
    want, ws = a.integrate({"x": jnp.asarray(x)}, 0.1, 10, return_stats=True,
                           drift=lambda x_, t_: -x_ * (1 + t_) + jnp.sin(x_))
    got, gs = b.integrate({"x": torch.from_numpy(x)}, 0.1, 10, return_stats=True,
                          drift=lambda x_, t_: -x_ * (1 + t_) + torch.sin(x_))
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]), **TOL)
    assert int(gs.n_accepted) == int(ws.n_accepted)
    assert int(gs.n_attempted) == int(ws.n_attempted)
    assert bool(gs.exhausted) == bool(ws.exhausted) is False
    np.testing.assert_allclose(float(gs.final_h), float(ws.final_h), rtol=0.05)
    # a grid's ends bound the interval; a fixed run of the same method ignores the controller
    grid = np.linspace(0.2, 0.9, 4).astype(np.float32)
    want = a.integrate({"x": jnp.asarray(x)}, 0.1, t=jnp.asarray(grid),
                       drift=lambda x_, t_: -x_ * (1 + t_))["x"]
    got = b.integrate({"x": torch.from_numpy(x)}, 0.1, t=torch.from_numpy(grid),
                      drift=lambda x_, t_: -x_ * (1 + t_))["x"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = a.integrate({"x": jnp.asarray(x)}, 0.1, 5, adaptive=False,
                       drift=lambda x_, t_: -x_)["x"]
    got = b.integrate({"x": torch.from_numpy(x)}, 0.1, 5, adaptive=False,
                      drift=lambda x_, t_: -x_)["x"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_adaptive_controller_gives_up_at_max_steps_and_needs_a_pair():
    b = ti.get_integrator("adaptive_heun", max_steps=3)
    _, stats = b.integrate({"x": torch.ones(2)}, 1e-3, 1000, drift=lambda x_, t_: -50 * x_,
                           return_stats=True)
    assert bool(stats.exhausted) and int(stats.n_attempted) == 3
    with pytest.raises(ValueError, match="error_weights"):
        ti.get_integrator("rk4").integrate({"x": torch.ones(2)}, 0.1, 3, adaptive=True,
                                           drift=lambda x_, t_: -x_)
