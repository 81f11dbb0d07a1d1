"""The port's Euler–Maruyama integrator and registry against the JAX package.

With the noise injected (``noise=``) one step is deterministic, so both
packages agree to atol 1e-5 (float32) on the same numpy inputs.
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
    assert sorted(ti.INTEGRATOR_REGISTRY) == ["euler", "euler_maruyama", "leapfrog"]
    assert isinstance(ti.get_integrator("leapfrog"), ti.LeapfrogIntegrator)
    assert ti.get_integrator("leapfrog").family == ji.get_integrator("leapfrog").family
    # a name the JAX package knows but the port has not ported yet
    assert isinstance(ji.get_integrator("heun"), ji.HeunIntegrator)
    with pytest.raises(ValueError, match="Unknown integrator 'heun'"):
        ti.get_integrator("heun")
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
    with pytest.raises(NotImplementedError, match="implicit"):
        _ImplicitEuler().step({"x": torch.ones(2)}, 0.1, drift=lambda x_, t_: -x_,
                              noise=torch.zeros(2))
