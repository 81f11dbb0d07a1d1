"""The port's gradient-MCMC samplers against the JAX package.

- Dispatch of MALA, HMC and gradient descent to the whole-chain kernels,
  mirroring ``tests/samplers/test_mala.py::TestFusedDispatch`` and
  ``test_hmc.py::TestFusedDispatch`` (the wrappers are stubbed here).
- Deterministic parts number for number, at atol 1e-5 (float32): the
  leapfrog step and trajectory, dual averaging, gradient descent and Nesterov.
- Noisy chains by distribution, since a ``torch.Generator`` and JAX keys give
  different streams: moments on a Gaussian against the analytic values and
  the JAX scan's (atol 0.12 on means, rtol 0.15 on variances for 2,000
  chains, the bounds of tests/samplers/test_hmc.py), and a seeded warmup
  landing in the target-acceptance band of tests/samplers/test_hmc.py:56.

Both packages' samplers are built from one set of fields through
``utils.convert.sampler_from_fields``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchebm_tpu import core as jcore
from torchebm_tpu import integrators as ji
from torchebm_tpu import samplers as js
from torchebm_tpu_torch import core as tcore
from torchebm_tpu_torch import integrators as ti
from torchebm_tpu_torch import samplers as ts
from torchebm_tpu_torch.ops import fused_hmc as thmc
from torchebm_tpu_torch.ops import fused_langevin as tfl
from torchebm_tpu_torch.ops import fused_mala as tmala
from torchebm_tpu_torch.utils import energy_from_arrays, sampler_from_fields

torch.set_num_threads(1)

ATOL = 1e-5
MEAN = np.array([1.0, -0.5], np.float32)
COV = np.array([[0.5, 0.0], [0.0, 2.0]], np.float32)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _gaussians():
    """The same Gaussian in both packages."""
    j = jcore.GaussianEnergy.create(jnp.asarray(MEAN), jnp.asarray(COV))
    t = energy_from_arrays("GaussianEnergy", {"mean": MEAN, "cov": COV,
                                              "cov_inv": np.linalg.inv(COV)})
    return j, t


def _both(name, fields, jenergy, tenergy):
    """The JAX sampler and the port's from one set of fields."""
    jfields = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in fields.items()}
    return getattr(js, name)(jenergy, **jfields), sampler_from_fields(name, fields, tenergy)


# ------------------------------------------------------------------ dispatch


def _stub(monkeypatch, module, name, calls):
    def stub(x0, means, n_steps, step_size, *args, **kw):
        calls.append((name, tuple(x0.shape), tuple(means.shape), n_steps, step_size, args,
                      sorted(kw)))
        acc = torch.ones(x0.shape[0])
        if "trajectory" in name:
            return torch.zeros((n_steps // kw["thin"], *x0.shape)), x0, acc
        return x0 + 1.0, acc

    monkeypatch.setattr(module, name, stub)


def _boom(monkeypatch, module, *names):
    def boom(*a, **k):  # pragma: no cover - must not be reached
        raise AssertionError("the loop must take this call")

    for name in names:
        monkeypatch.setattr(module, name, boom)


MALA_NAMES = ("mixture_mala_chain", "mixture_mala_chain_trajectory")
HMC_NAMES = ("mixture_hmc_chain", "mixture_hmc_chain_trajectory")


class TestMalaDispatch:
    def test_force_routes_mixture(self, monkeypatch):
        calls = []
        _stub(monkeypatch, tmala, "mixture_mala_chain", calls)
        mix = tcore.GaussianMixtureEnergy.eight_gaussians()
        s = ts.MetropolisAdjustedLangevin(mix, step_size=0.05, fused="force")
        x0 = torch.zeros(32, 2)
        out = s.sample(_gen(), x=x0, n_steps=9)
        assert calls == [("mixture_mala_chain", (32, 2), (8, 2), 9, 0.05, (),
                          ["log_weights", "scale", "seed"])]
        torch.testing.assert_close(out, x0 + 1.0)

    def test_force_routes_gaussian_with_precision(self, monkeypatch):
        calls = []
        _stub(monkeypatch, tmala, "mixture_mala_chain", calls)
        _, e = _gaussians()
        ts.MetropolisAdjustedLangevin(e, step_size=0.1, fused="force").sample(
            _gen(), dim=2, n_samples=8, n_steps=3)
        assert calls == [("mixture_mala_chain", (8, 2), (1, 2), 3, 0.1, (),
                          ["precision", "seed"])]

    def test_trajectory_routes_to_trajectory_kernel(self, monkeypatch):
        calls = []
        _stub(monkeypatch, tmala, "mixture_mala_chain_trajectory", calls)
        _boom(monkeypatch, tmala, "mixture_mala_chain")
        mix = tcore.GaussianMixtureEnergy.eight_gaussians()
        s = ts.MetropolisAdjustedLangevin(mix, step_size=0.05, fused="force")
        traj = s.sample(_gen(), dim=2, n_samples=16, n_steps=10, thin=3, return_trajectory=True)
        assert traj.shape == (16, 3, 2)
        assert calls[0][0] == "mixture_mala_chain_trajectory" and "thin" in calls[0][-1]

    def test_auto_never_dispatches_on_cpu(self, monkeypatch):
        _boom(monkeypatch, tmala, *MALA_NAMES)
        mix = tcore.GaussianMixtureEnergy.eight_gaussians()
        s = ts.MetropolisAdjustedLangevin(mix, step_size=0.05)
        assert s.sample(_gen(), dim=2, n_samples=8, n_steps=3).shape == (8, 2)

    def test_diagnostics_schedules_conditioning_and_other_energies_fall_back(self, monkeypatch):
        _boom(monkeypatch, tmala, *MALA_NAMES)
        mix = tcore.GaussianMixtureEnergy.eight_gaussians()
        s = ts.MetropolisAdjustedLangevin(mix, step_size=0.05, fused="force")
        out, diag = s.sample(_gen(), dim=2, n_samples=8, n_steps=4, thin=2,
                             return_diagnostics=True)
        assert out.shape == (8, 2) and diag["acceptance_rate"].shape == (2,)
        sched = ts.MetropolisAdjustedLangevin(
            mix, step_size=tcore.ExponentialDecayScheduler(0.05, 0.9), fused="force")
        assert sched.sample(_gen(), dim=2, n_samples=8, n_steps=3).shape == (8, 2)
        for energy, dim in ((tcore.HarmonicEnergy(), 2), (tcore.DoubleWellEnergy(), 2),
                            (tcore.GaussianMixtureEnergy.create(torch.zeros(64, 32)), 32)):
            s = ts.MetropolisAdjustedLangevin(energy, step_size=0.01, fused="force")
            assert s.sample(_gen(), dim=dim, n_samples=4, n_steps=2).shape == (4, dim)
        with pytest.raises(TypeError):  # conditioning reaches the energy: the loop took it
            s.sample(_gen(), dim=32, n_samples=4, n_steps=2, model_kwargs={"c": 1.0})

    def test_off_and_wrong_state_shape_take_the_loop(self, monkeypatch):
        _boom(monkeypatch, tmala, *MALA_NAMES)
        mix = tcore.GaussianMixtureEnergy.eight_gaussians()
        off = ts.MetropolisAdjustedLangevin(mix, step_size=0.05, fused="off")
        assert off.sample(_gen(), dim=2, n_samples=4, n_steps=2).shape == (4, 2)
        force = ts.MetropolisAdjustedLangevin(mix, step_size=0.05, fused="force")
        out = force.sample(_gen(), x=torch.zeros(4, 2, dtype=torch.bfloat16), n_steps=2)
        assert out.dtype == torch.bfloat16
        with pytest.raises(ValueError, match="fused"):
            ts.MetropolisAdjustedLangevin(mix, fused="yes")


class TestHmcDispatch:
    def test_force_routes_mixture(self, monkeypatch):
        calls = []
        _stub(monkeypatch, thmc, "mixture_hmc_chain", calls)
        mix = tcore.GaussianMixtureEnergy.eight_gaussians()
        s = ts.HamiltonianMonteCarlo(mix, step_size=0.3, n_leapfrog_steps=7, fused="force")
        assert s.sample(_gen(), dim=2, n_samples=32, n_steps=9).shape == (32, 2)
        assert calls == [("mixture_hmc_chain", (32, 2), (8, 2), 9, 0.3, (7,),
                          ["log_weights", "mass", "scale", "seed"])]

    def test_force_routes_ddim_mixture_and_gaussian(self, monkeypatch):
        calls = []
        _stub(monkeypatch, thmc, "mixture_hmc_chain", calls)
        mix = tcore.GaussianMixtureEnergy.create(torch.randn(3, 6, generator=_gen()), scale=0.5)
        ts.HamiltonianMonteCarlo(mix, step_size=0.2, fused="force").sample(
            _gen(), dim=6, n_samples=16, n_steps=4)
        _, e = _gaussians()
        ts.HamiltonianMonteCarlo(e, step_size=0.2, fused="force").sample(
            _gen(), dim=2, n_samples=16, n_steps=4)
        assert [c[1:5] for c in calls] == [((16, 6), (3, 6), 4, 0.2), ((16, 2), (1, 2), 4, 0.2)]
        assert calls[0][5] == (10,) and "precision" in calls[1][-1]

    def test_diagonal_and_scalar_mass_dispatch(self, monkeypatch):
        calls = []
        _stub(monkeypatch, thmc, "mixture_hmc_chain", calls)
        mix = tcore.GaussianMixtureEnergy.eight_gaussians()
        for mass in (2.0, torch.tensor([1.0, 2.0]), np.array([1.0, 2.0], np.float32)):
            ts.HamiltonianMonteCarlo(mix, step_size=0.3, mass=mass, fused="force").sample(
                _gen(), dim=2, n_samples=8, n_steps=3)
        assert len(calls) == 3

    def test_wrong_mass_integrator_subclass_and_diagnostics_fall_back(self, monkeypatch):
        _boom(monkeypatch, thmc, *HMC_NAMES)
        mix = tcore.GaussianMixtureEnergy.eight_gaussians()

        class MyLeapfrog(ti.LeapfrogIntegrator):
            pass

        for s in (
            ts.HamiltonianMonteCarlo(mix, step_size=0.1, mass=torch.ones(3), fused="force"),
            ts.HamiltonianMonteCarlo(mix, step_size=0.1, integrator=MyLeapfrog(), fused="force"),
            ts.HamiltonianMonteCarlo(mix, step_size=tcore.ConstantScheduler(0.1),
                                     fused="force"),
            ts.HamiltonianMonteCarlo(tcore.HarmonicEnergy(), step_size=0.1, fused="force"),
            ts.HamiltonianMonteCarlo(mix, step_size=0.1),  # auto on a CPU generator
        ):
            if s.mass is not None:
                # a (3,) mass on a 2-D state broadcasts nowhere: the loop raises
                with pytest.raises(RuntimeError):
                    s.sample(_gen(), dim=2, n_samples=4, n_steps=2)
                continue
            assert s.sample(_gen(), dim=2, n_samples=4, n_steps=2).shape == (4, 2)
        s = ts.HamiltonianMonteCarlo(mix, step_size=0.1, fused="force")
        out, diag = s.sample(_gen(), dim=2, n_samples=4, n_steps=2, return_diagnostics=True)
        assert set(diag) == {"mean", "var", "energy", "acceptance_rate"}

    def test_trajectory_routes_to_trajectory_kernel(self, monkeypatch):
        calls = []
        _stub(monkeypatch, thmc, "mixture_hmc_chain_trajectory", calls)
        _boom(monkeypatch, thmc, "mixture_hmc_chain")
        mix = tcore.GaussianMixtureEnergy.eight_gaussians()
        s = ts.HamiltonianMonteCarlo(mix, step_size=0.3, mass=torch.tensor([1.0, 2.0]),
                                     fused="force")
        traj = s.sample(_gen(), dim=2, n_samples=8, n_steps=7, thin=2, return_trajectory=True)
        assert traj.shape == (8, 3, 2)
        assert calls[0][0] == "mixture_hmc_chain_trajectory" and "mass" in calls[0][-1]

    def test_validation_and_replace(self):
        mix = tcore.GaussianMixtureEnergy.eight_gaussians()
        with pytest.raises(ValueError, match="n_leapfrog_steps"):
            ts.HamiltonianMonteCarlo(mix, n_leapfrog_steps=0)
        with pytest.raises(ValueError, match="fused"):
            ts.HamiltonianMonteCarlo(mix, fused="always")
        hmc = ts.HamiltonianMonteCarlo(mix, step_size=0.3, n_leapfrog_steps=4)
        tuned = hmc.replace(step_size=0.125, mass=2.0)
        assert (tuned.step_size, tuned.mass, tuned.n_leapfrog_steps) == (0.125, 2.0, 4)
        assert hmc.step_size == 0.3 and tuned.model is mix
        assert isinstance(tuned.integrator, ti.LeapfrogIntegrator)
        with pytest.raises(ValueError, match="n_leapfrog_steps"):
            hmc.replace(n_leapfrog_steps=0)
        with pytest.raises(ValueError, match="n_warmup"):
            hmc.warmup(_gen(), dim=2, n_warmup=0)


class TestGradientDescent:
    @pytest.mark.parametrize("energy", ["mixture", "doublewell", "gaussian"])
    def test_row_equals_the_loop(self, energy):
        model = {
            "mixture": tcore.GaussianMixtureEnergy.eight_gaussians(),
            "doublewell": tcore.DoubleWellEnergy(),
            "gaussian": _gaussians()[1],
        }[energy]
        x0 = torch.randn(40, 2, generator=_gen(1))
        kw = dict(x=x0, n_steps=30)
        row = ts.GradientDescentSampler(model, step_size=0.02, fused="force")
        loop = row.replace(fused="off")
        torch.testing.assert_close(row.sample(_gen(), **kw), loop.sample(_gen(), **kw),
                                   rtol=0, atol=ATOL)
        a, da = row.sample(_gen(), thin=4, return_trajectory=True, return_diagnostics=True, **kw)
        b, db = loop.sample(_gen(), thin=4, return_trajectory=True, return_diagnostics=True,
                            **kw)
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL)
        for k in ("mean", "var", "energy"):
            torch.testing.assert_close(da[k], db[k], rtol=1e-5, atol=ATOL)

    def test_row_launches_the_langevin_chain_at_zero_noise(self, monkeypatch):
        calls = []

        def stub(x0, **kw):
            calls.append(kw)
            return x0

        monkeypatch.setattr(tfl, "mixture_langevin_chain", stub)
        mix = tcore.GaussianMixtureEnergy.eight_gaussians()
        g = _gen()
        ts.GradientDescentSampler(mix, step_size=0.05, fused="force").sample(
            g, dim=2, n_samples=4, n_steps=3)
        assert calls[0]["noise_scale"] == 0.0 and calls[0]["seed"] == 0
        ts.GradientDescentSampler(mix, step_size=0.05).sample(_gen(), dim=2, n_samples=4,
                                                               n_steps=3)
        assert len(calls) == 1  # auto on a CPU generator takes the loop

    def test_gd_and_nesterov_loops_equal_jax(self):
        jmix = jcore.GaussianMixtureEnergy.eight_gaussians()
        tmix = tcore.GaussianMixtureEnergy.eight_gaussians()
        x0 = np.random.default_rng(4).standard_normal((30, 2)).astype(np.float32)
        for name, fields in (("GradientDescentSampler", {"step_size": 0.05, "fused": "off"}),
                             ("NesterovSampler", {"step_size": 0.02, "momentum": 0.8})):
            jfields = dict(fields)
            j = getattr(js, name)(jmix, **jfields)
            t = getattr(ts, name)(tmix, **fields)
            ref = j.sample(jax.random.PRNGKey(0), x=jnp.asarray(x0), n_steps=25)
            out = t.sample(_gen(), x=torch.from_numpy(x0), n_steps=25)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
        with pytest.raises(ValueError, match="momentum"):
            ts.NesterovSampler(tmix, momentum=1.0)


# ------------------------------------------------------------------ deterministic parity


@pytest.mark.parametrize("mass", [None, 2.0, "diag"], ids=["unit", "scalar", "diag"])
@pytest.mark.parametrize("safe", [False, True])
def test_leapfrog_step_and_integrate_equal_jax(mass, safe):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((17, 2)).astype(np.float32)
    p = rng.standard_normal((17, 2)).astype(np.float32)
    if safe:
        x[0, 0] = np.nan  # scrubbed to 0 in safe mode
    m = np.array([0.5, 3.0], np.float32) if mass == "diag" else mass
    jm = jnp.asarray(m) if isinstance(m, np.ndarray) else m
    tm = torch.from_numpy(m) if isinstance(m, np.ndarray) else m
    je, te = _gaussians()
    jdrift = lambda x_, t_: -je.gradient(x_)  # noqa: E731
    tdrift = lambda x_, t_: -te.gradient(x_)  # noqa: E731
    scale = 1e7 if safe else 1.0  # one step under a force beyond the safe clamp
    jint, tint = ji.LeapfrogIntegrator(), ti.get_integrator("leapfrog")
    js_ = jint.step({"x": jnp.asarray(x), "p": jnp.asarray(p)}, 0.1, jm,
                    drift=lambda x_, t_: scale * jdrift(x_, t_), safe=safe)
    ts_ = tint.step({"x": torch.from_numpy(x), "p": torch.from_numpy(p)}, 0.1, tm,
                    drift=lambda x_, t_: scale * tdrift(x_, t_), safe=safe)
    for k in ("x", "p", "force"):
        np.testing.assert_allclose(ts_[k].numpy(), np.asarray(js_[k]), rtol=1e-5, atol=ATOL)
    jout = jint.integrate({"x": jnp.asarray(x), "p": jnp.asarray(p)}, 0.1, 7, jm, drift=jdrift,
                          safe=safe)
    tout = tint.integrate({"x": torch.from_numpy(x), "p": torch.from_numpy(p)}, 0.1, 7, tm,
                          drift=tdrift, safe=safe)
    for k in ("x", "p"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=1e-5, atol=ATOL)
        assert np.isfinite(tout[k].numpy()).all() or not safe
    with pytest.raises(ValueError, match="n_steps"):
        tint.integrate({"x": torch.zeros(2), "p": torch.zeros(2)}, 0.1, 0, drift=tdrift)


def test_leapfrog_keeps_the_state_dtype():
    out = ti.LeapfrogIntegrator().step(
        {"x": torch.ones(3, 2, dtype=torch.bfloat16), "p": torch.zeros(3, 2, dtype=torch.bfloat16)},
        0.1, drift=lambda x_, t_: -x_.float())
    assert out["x"].dtype == out["p"].dtype == torch.bfloat16


def test_dual_averaging_sequence_equals_jax():
    acc = np.random.default_rng(9).uniform(0.2, 1.0, 60).astype(np.float32)
    jst, tst = js.DualAveragingState.init(0.3), ts.DualAveragingState.init(0.3)
    mu = float(np.log(3.0))
    for a in acc:
        jst = js.hmc.dual_averaging_update(jst, jnp.float32(a), 0.8, jnp.float32(mu))
        tst = ts.dual_averaging_update(tst, torch.tensor(a), 0.8, torch.tensor(mu))
        for f in ("log_eps", "log_eps_bar", "h_bar", "t"):
            np.testing.assert_allclose(float(getattr(tst, f)), float(getattr(jst, f)),
                                       rtol=1e-5, atol=ATOL)


def test_sampler_fields_carry_a_numpy_mass_across():
    je, te = _gaussians()
    fields = {"step_size": 0.2, "n_leapfrog_steps": 5, "mass": np.array([0.5, 2.0], np.float32)}
    j, t = _both("HamiltonianMonteCarlo", fields, je, te)
    assert isinstance(t.mass, torch.Tensor) and t.mass.dtype == torch.float32
    p = np.random.default_rng(10).standard_normal((9, 2)).astype(np.float32)
    np.testing.assert_allclose(t._kinetic(torch.from_numpy(p)).numpy(),
                               np.asarray(j._kinetic(jnp.asarray(p))), rtol=1e-6)
    mala_fields = {"step_size": ("ExponentialDecayScheduler",
                                 {"start_value": 0.1, "decay_rate": 0.9})}
    _, tm = _both("MetropolisAdjustedLangevin", {"step_size": 0.1}, je, te)
    tm2 = sampler_from_fields("MetropolisAdjustedLangevin", mala_fields, te)
    assert isinstance(tm2.step_size, tcore.ExponentialDecayScheduler)
    assert tm.step_size == 0.1
    with pytest.raises(ValueError, match="Unknown sampler"):
        sampler_from_fields("NoSuchSampler", {}, te)


# ------------------------------------------------------------------ distribution


@pytest.mark.parametrize("name, fields", [
    ("MetropolisAdjustedLangevin", {"step_size": 0.3, "fused": "off"}),
    ("HamiltonianMonteCarlo", {"step_size": 0.25, "n_leapfrog_steps": 6, "fused": "off",
                               "mass": np.array([2.0, 0.5], np.float32)}),
])
def test_loop_moments_match_analytic_and_jax(name, fields):
    je, te = _gaussians()
    j, t = _both(name, fields, je, te)
    n, steps = 2000, 150
    ref = np.asarray(j.sample(jax.random.PRNGKey(0), dim=2, n_samples=n, n_steps=steps))
    out, diag = t.sample(_gen(3), dim=2, n_samples=n, n_steps=steps, thin=steps,
                         return_diagnostics=True)
    out = out.numpy()
    np.testing.assert_allclose(out.mean(0), MEAN, atol=0.12)
    np.testing.assert_allclose(out.var(0), np.diag(COV), rtol=0.15)
    np.testing.assert_allclose(out.mean(0), ref.mean(0), atol=0.15)
    np.testing.assert_allclose(out.var(0), ref.var(0), rtol=0.2)
    assert 0.3 < float(diag["acceptance_rate"][0]) <= 1.0


def test_seeded_warmup_adapts_into_the_target_band():
    """As tests/samplers/test_hmc.py::test_dual_averaging_hits_target: from a
    too-large start the adapted step shrinks and the tuned chain accepts in
    (0.6, 1.0]; the step size comes back as a Python float."""
    e = tcore.GaussianEnergy.standard(2)
    hmc = ts.HamiltonianMonteCarlo(e, step_size=1.9, n_leapfrog_steps=5, dual_averaging=True,
                                   target_accept=0.8)
    x, eps = hmc.warmup(_gen(4), dim=2, n_warmup=150, n_samples=256)
    assert isinstance(eps, float) and 0.05 < eps < 1.9
    _, diag = hmc.replace(step_size=eps).sample(_gen(5), x=x, n_steps=60,
                                                return_diagnostics=True)
    assert 0.6 < float(diag["acceptance_rate"].mean()) <= 1.0
    x2, eps2, mass = hmc.warmup(_gen(4), dim=2, n_warmup=60, n_samples=256, adapt_mass=True)
    assert x2.shape == (256, 2) and isinstance(eps2, float) and mass.shape == (2,)
    assert torch.all((mass > 0.5) & (mass < 2.0))  # 1 / var of a standard normal
