"""The Langevin slice of the port: ``LangevinDynamics.sample`` end to end.

- shapes of samples, trajectories and diagnostics on the loop and on the
  dispatch rows (``fused="force"`` runs the rows' plain versions on the CPU);
- the dispatch table, mirroring tests/samplers/test_langevin.py::TestFusedDispatch;
- parity with the JAX package's ``LangevinDynamics(fused="off")`` at
  ``noise_scale=0`` (deterministic, so the same x0 gives the same chain), to
  atol 1e-5 plus rtol 1e-5 (float32);
- a statistical check of the noisy chain against exact mixture draws;
- ``import torchebm_tpu_torch`` loads no JAX.
"""

import math
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torchebm_tpu.core as jcore
import torchebm_tpu.samplers as jsamp
import torchebm_tpu_torch.core as tcore
import torchebm_tpu_torch.ops.fused_langevin as tfl
from torchebm_tpu_torch.samplers import FUSED_DISPATCH, LangevinDynamics

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------------ shapes


@pytest.mark.parametrize("fused", ["off", "force"])
def test_sample_shapes(fused):
    s = LangevinDynamics(tcore.GaussianMixtureEnergy.eight_gaussians(), step_size=0.05,
                         fused=fused)
    assert s.sample(_gen(), dim=2, n_samples=16, n_steps=7).shape == (16, 2)
    traj = s.sample(_gen(), dim=2, n_samples=16, n_steps=7, thin=2, return_trajectory=True)
    assert traj.shape == (16, 3, 2)
    out, diag = s.sample(_gen(), dim=2, n_samples=16, n_steps=7, thin=3,
                         return_diagnostics=True)
    assert out.shape == (16, 2)
    assert diag["mean"].shape == (2, 2) and diag["var"].shape == (2, 2)
    assert diag["energy"].shape == (2,)
    assert torch.all(diag["var"] >= 1e-10)
    traj, diag = s.sample(_gen(), dim=2, n_samples=4, n_steps=4, thin=2,
                          return_trajectory=True, return_diagnostics=True)
    assert traj.shape == (4, 2, 2) and diag["energy"].shape == (2,)


def test_loop_shapes_when_nothing_is_kept():
    s = LangevinDynamics(tcore.HarmonicEnergy(), step_size=0.1)
    traj, diag = s.sample(_gen(), dim=3, n_samples=5, n_steps=2, thin=4,
                          return_trajectory=True, return_diagnostics=True)
    assert traj.shape == (5, 1, 3) and diag == {}


def test_sample_validation():
    s = LangevinDynamics(tcore.HarmonicEnergy(), step_size=0.1)
    with pytest.raises(ValueError, match="thin"):
        s.sample(_gen(), dim=2, thin=0)
    with pytest.raises(ValueError, match="n_steps"):
        s.sample(_gen(), dim=2, n_steps=0)
    with pytest.raises(ValueError, match="dim"):
        s.sample(_gen())
    with pytest.raises(TypeError, match="Generator"):
        s.sample(0, dim=2)
    with pytest.raises(ValueError, match="clamp"):
        LangevinDynamics(tcore.HarmonicEnergy(), clamp=(1.0, -1.0))
    with pytest.raises(ValueError, match="fused"):
        LangevinDynamics(tcore.HarmonicEnergy(), fused="yes")
    with pytest.raises(ValueError, match="Unknown integrator"):
        LangevinDynamics(tcore.HarmonicEnergy(), integrator="rk5")
    with pytest.raises(ValueError, match="family 'ode'"):
        LangevinDynamics(tcore.HarmonicEnergy(), integrator="rk4")


def test_device_follows_the_generator():
    mix = tcore.GaussianMixtureEnergy.eight_gaussians().to("meta")
    with pytest.raises(ValueError, match="generator is on cpu"):
        LangevinDynamics(mix, step_size=0.05).sample(_gen(), dim=2, n_samples=4, n_steps=2)
    s = LangevinDynamics(tcore.HarmonicEnergy(), step_size=0.05)
    with pytest.raises(ValueError, match="x is on meta"):
        s.sample(_gen(), x=torch.zeros(4, 2, device="meta"), n_steps=2)


def test_bf16_state_keeps_its_dtype_on_the_loop():
    s = LangevinDynamics(tcore.GaussianMixtureEnergy.eight_gaussians(), step_size=0.05,
                         fused="force")
    out = s.sample(_gen(), x=torch.zeros(8, 2, dtype=torch.bfloat16), n_steps=3)
    assert out.dtype == torch.bfloat16


# ------------------------------------------------------------------ dispatch


def _record(monkeypatch, name, calls):
    def stub(x0, *args, **kw):
        calls.append((x0.shape, args, kw))
        if "trajectory" in name:
            n_kept = kw["n_steps"] // kw["thin"]
            return torch.zeros((n_kept, *x0.shape)), x0 + 1.0
        return x0

    monkeypatch.setattr(tfl, name, stub)


def _boom(monkeypatch, *names):
    def boom(*a, **k):  # pragma: no cover - must not be reached
        raise AssertionError("the loop must take this call")

    for name in names:
        monkeypatch.setattr(tfl, name, boom)


class TestFusedDispatch:
    def test_rows(self):
        assert [r.name for r in FUSED_DISPATCH] == ["doublewell", "gaussian", "mixture"]

    def test_force_routes_doublewell(self, monkeypatch):
        calls = []
        _record(monkeypatch, "doublewell_langevin_chain", calls)
        s = LangevinDynamics(tcore.DoubleWellEnergy(), step_size=0.01, fused="force")
        assert s.sample(_gen(), dim=4, n_samples=32, n_steps=7).shape == (32, 4)
        ((shape, args, kw),) = calls
        assert shape == (32, 4) and args == ()
        assert (kw["n_steps"], kw["step_size"], kw["noise_scale"]) == (7, 0.01, 1.0)
        assert (kw["barrier_height"], kw["b"], kw["clamp"]) == (2.0, 1.0, None)
        # the row's seed stays on the device: a 0-d int64 tensor the kernel reads
        seed = kw["seed"]
        assert isinstance(seed, torch.Tensor) and seed.dtype == torch.int64 and seed.ndim == 0
        assert seed.device == _gen().device and 0 <= int(seed) < 2**63

    def test_force_routes_mixture(self, monkeypatch):
        calls = []
        _record(monkeypatch, "mixture_langevin_chain", calls)
        mix = tcore.GaussianMixtureEnergy.eight_gaussians(scale=0.4)
        s = LangevinDynamics(mix, step_size=0.05, fused="force")
        assert s.sample(_gen(), dim=2, n_samples=64, n_steps=5).shape == (64, 2)
        ((shape, _, kw),) = calls
        assert shape == (64, 2) and kw["means"].shape == (8, 2)
        assert kw["scale"] == pytest.approx(0.4) and kw["log_weights"].shape == (8,)

    def test_force_routes_ddim_mixture(self, monkeypatch):
        calls = []
        _record(monkeypatch, "mixture_langevin_chain", calls)
        mix = tcore.GaussianMixtureEnergy.create(torch.randn(4, 5, generator=_gen()), scale=0.7)
        LangevinDynamics(mix, step_size=0.05, fused="force").sample(
            _gen(), dim=5, n_samples=16, n_steps=3
        )
        assert [(c[0], c[2]["means"].shape) for c in calls] == [((16, 5), (4, 5))]

    def test_force_routes_isotropic_gaussian(self, monkeypatch):
        calls = []
        _record(monkeypatch, "mixture_langevin_chain", calls)
        e = tcore.GaussianEnergy.create(torch.tensor([1.0, 2.0, 3.0]), 4.0 * torch.eye(3))
        LangevinDynamics(e, step_size=0.05, fused="force").sample(
            _gen(), dim=3, n_samples=16, n_steps=3
        )
        ((shape, _, kw),) = calls
        assert kw["means"].shape == (1, 3) and kw["scale"] == pytest.approx(2.0)
        assert "precision" not in kw

    def test_anisotropic_gaussian_routes_with_precision(self, monkeypatch):
        calls = []
        _record(monkeypatch, "mixture_langevin_chain", calls)
        cov = torch.tensor([[2.0, 0.5], [0.5, 1.0]])
        e = tcore.GaussianEnergy.create(torch.zeros(2), cov)
        LangevinDynamics(e, step_size=0.05, fused="force").sample(
            _gen(), dim=2, n_samples=8, n_steps=3
        )
        ((shape, _, kw),) = calls
        assert kw["means"].shape == (1, 2) and kw["precision"].is_contiguous()
        torch.testing.assert_close(kw["precision"] @ cov, torch.eye(2), atol=1e-6, rtol=0)

    def test_oversize_gaussian_falls_back(self, monkeypatch):
        _boom(monkeypatch, "mixture_langevin_chain")
        d = 40
        a = torch.randn(d, d, generator=_gen()) / math.sqrt(d)
        e = tcore.GaussianEnergy.create(torch.zeros(d), a @ a.T + torch.eye(d))
        s = LangevinDynamics(e, step_size=0.05, fused="force")
        assert s.sample(_gen(), dim=d, n_samples=8, n_steps=2).shape == (8, d)

    def test_oversize_mixture_falls_back(self, monkeypatch):
        _boom(monkeypatch, "mixture_langevin_chain")
        mix = tcore.GaussianMixtureEnergy.create(torch.randn(64, 32, generator=_gen()))
        s = LangevinDynamics(mix, step_size=0.01, fused="force")
        assert s.sample(_gen(), dim=32, n_samples=8, n_steps=2).shape == (8, 32)

    def test_auto_never_dispatches_on_cpu(self, monkeypatch):
        _boom(monkeypatch, "doublewell_langevin_chain", "mixture_langevin_chain")
        s = LangevinDynamics(tcore.DoubleWellEnergy(), step_size=0.01)
        assert s.sample(_gen(), dim=2, n_samples=16, n_steps=10).shape == (16, 2)
        s = LangevinDynamics(tcore.GaussianMixtureEnergy.eight_gaussians(), step_size=0.05)
        assert s.sample(_gen(), dim=2, n_samples=16, n_steps=10).shape == (16, 2)

    def test_off_conditioning_and_subclasses_take_the_loop(self, monkeypatch):
        _boom(monkeypatch, "doublewell_langevin_chain")

        class MyWell(tcore.DoubleWellEnergy):
            def energy(self, x, **kw):
                return super().energy(x) + 0.0 * kw.get("shift", 0.0)

            def gradient(self, x, **kw):
                return super().gradient(x)

        for s, mk in (
            (LangevinDynamics(tcore.DoubleWellEnergy(), step_size=0.01, fused="off"), None),
            (LangevinDynamics(MyWell(), step_size=0.01, fused="force"), None),
            (LangevinDynamics(MyWell(), step_size=0.01, fused="force"), {"shift": 1.0}),
        ):
            assert s.sample(_gen(), dim=2, n_samples=4, n_steps=3,
                            model_kwargs=mk).shape == (4, 2)

    def test_other_integrators_take_the_loop(self, monkeypatch):
        from torchebm_tpu_torch.integrators import EulerMaruyamaIntegrator

        _boom(monkeypatch, "doublewell_langevin_chain")

        class MyEM(EulerMaruyamaIntegrator):
            pass

        s = LangevinDynamics(tcore.DoubleWellEnergy(), step_size=0.01, integrator=MyEM(),
                             fused="force")
        assert s.sample(_gen(), dim=2, n_samples=4, n_steps=3).shape == (4, 2)

    def test_wrong_state_shape_falls_back(self, monkeypatch):
        _boom(monkeypatch, "mixture_langevin_chain")
        s = LangevinDynamics(tcore.GaussianEnergy.standard(2), step_size=0.05, fused="force")
        assert s.sample(_gen(), dim=(3, 2), n_samples=4, n_steps=2).shape == (4, 3, 2)

    def test_diagnostics_route_to_trajectory_kernel(self, monkeypatch):
        recorded = {}

        def stub(x0, *, n_steps, thin, **kw):
            traj = torch.arange((n_steps // thin) * x0.numel(), dtype=torch.float32)
            recorded["traj"] = traj = traj.reshape(n_steps // thin, *x0.shape)
            return traj, x0 + 1.0

        monkeypatch.setattr(tfl, "doublewell_langevin_chain_trajectory", stub)
        model = tcore.DoubleWellEnergy()
        s = LangevinDynamics(model, step_size=0.01, fused="force")
        out, diag = s.sample(_gen(), dim=3, n_samples=8, n_steps=6, thin=2,
                             return_diagnostics=True)
        traj = recorded["traj"]
        assert out.shape == (8, 3)
        torch.testing.assert_close(diag["mean"], traj.mean(dim=1))
        torch.testing.assert_close(
            diag["energy"], torch.stack([model.energy(t).mean() for t in traj])
        )

    def test_trajectory_routes_to_trajectory_kernel(self, monkeypatch):
        calls = []
        _record(monkeypatch, "doublewell_langevin_chain_trajectory", calls)
        s = LangevinDynamics(tcore.DoubleWellEnergy(), step_size=0.01, fused="force")
        out = s.sample(_gen(), dim=4, n_samples=16, n_steps=9, thin=3, return_trajectory=True)
        assert [(c[0], c[2]["n_steps"], c[2]["thin"]) for c in calls] == [((16, 4), 9, 3)]
        assert out.shape == (16, 3, 4)

    def test_trajectory_shorter_than_thin_takes_the_loop(self, monkeypatch):
        _boom(monkeypatch, "doublewell_langevin_chain_trajectory")
        s = LangevinDynamics(tcore.DoubleWellEnergy(), step_size=0.01, fused="force")
        out = s.sample(_gen(), dim=2, n_samples=4, n_steps=2, thin=3, return_trajectory=True)
        assert out.shape == (4, 1, 2)

    def test_clamp_forwarded(self, monkeypatch):
        calls = []
        _record(monkeypatch, "doublewell_langevin_chain", calls)
        s = LangevinDynamics(tcore.DoubleWellEnergy(), step_size=0.1, clamp=(-0.5, 0.5),
                             fused="force")
        s.sample(_gen(), dim=2, n_samples=8, n_steps=5)
        assert [c[2]["clamp"] for c in calls] == [(-0.5, 0.5)]

    def test_scheduled_params_dispatch_with_tables(self, monkeypatch):
        calls = []
        _record(monkeypatch, "mixture_langevin_chain", calls)
        step = tcore.CosineScheduler(0.05, 0.01, 12)
        temp = tcore.TemperatureScheduler(epsilon_max=0.25, tau_star=0.5, n_steps=12)
        s = LangevinDynamics(tcore.GaussianMixtureEnergy.eight_gaussians(), step_size=step,
                             noise_scale=temp, fused="force")
        s.sample(_gen(), dim=2, n_samples=16, n_steps=12)
        ((_, _, kw),) = calls
        torch.testing.assert_close(kw["step_size"], step.value(torch.arange(12)))
        torch.testing.assert_close(kw["noise_scale"], temp.value(torch.arange(12)))

    def test_zero_d_tensor_step_is_a_constant(self, monkeypatch):
        calls = []
        _record(monkeypatch, "doublewell_langevin_chain", calls)
        s = LangevinDynamics(tcore.DoubleWellEnergy(), step_size=torch.tensor(0.02),
                             fused="force")
        s.sample(_gen(), dim=2, n_samples=4, n_steps=3)
        assert calls[0][2]["step_size"] == pytest.approx(0.02)


# ------------------------------------------------------------------ JAX parity


def _jax_and_port(kind):
    rng = np.random.default_rng(7)
    if kind == "mixture":
        means = (2.5 * rng.standard_normal((5, 2))).astype(np.float32)
        w = rng.uniform(0.5, 2.0, 5)
        return (jcore.GaussianMixtureEnergy.create(means, scale=0.7, weights=w),
                tcore.GaussianMixtureEnergy.create(means, scale=0.7, weights=w), 2)
    if kind == "gaussian":
        a = (0.4 * rng.standard_normal((3, 3))).astype(np.float32)
        mean, cov = rng.standard_normal(3).astype(np.float32), a @ a.T + np.eye(3, dtype=np.float32)
        return (jcore.GaussianEnergy.create(mean, cov), tcore.GaussianEnergy.create(mean, cov), 3)
    return jcore.DoubleWellEnergy(1.5, 0.9), tcore.DoubleWellEnergy(1.5, 0.9), 3


@pytest.mark.parametrize("fused", ["off", "force"])
@pytest.mark.parametrize("kind", ["mixture", "gaussian", "doublewell"])
@pytest.mark.parametrize("schedule", [False, True], ids=["const", "linear"])
def test_noiseless_chain_matches_jax(kind, schedule, fused):
    jmodel, tmodel, d = _jax_and_port(kind)
    x0 = np.random.default_rng(11).standard_normal((23, d)).astype(np.float32)
    n_steps, thin, clamp = 14, 3, (-2.5, 2.5)
    step = (jcore.LinearScheduler(0.04, 0.01, 10), tcore.LinearScheduler(0.04, 0.01, 10)) \
        if schedule else (0.03, 0.03)
    kw = dict(n_steps=n_steps, thin=thin, return_trajectory=True, return_diagnostics=True)
    ref_traj, ref_diag = jsamp.LangevinDynamics(
        jmodel, step_size=step[0], noise_scale=0.0, clamp=clamp, fused="off"
    ).sample(jax.random.PRNGKey(0), x=jnp.asarray(x0), **kw)
    traj, diag = LangevinDynamics(
        tmodel, step_size=step[1], noise_scale=0.0, clamp=clamp, fused=fused
    ).sample(_gen(), x=torch.from_numpy(x0), **kw)
    assert traj.shape == (23, n_steps // thin, d)
    np.testing.assert_allclose(traj.numpy(), np.asarray(ref_traj), **TOL)
    for key in ("mean", "var", "energy"):
        np.testing.assert_allclose(diag[key].numpy(), np.asarray(ref_diag[key]), **TOL)
    final = LangevinDynamics(
        tmodel, step_size=step[1], noise_scale=0.0, clamp=clamp, fused=fused
    ).sample(_gen(), x=torch.from_numpy(x0), n_steps=n_steps)
    ref_final = jsamp.LangevinDynamics(
        jmodel, step_size=step[0], noise_scale=0.0, clamp=clamp, fused="off"
    ).sample(jax.random.PRNGKey(0), x=jnp.asarray(x0), n_steps=n_steps)
    np.testing.assert_allclose(final.numpy(), np.asarray(ref_final), **TOL)


# ------------------------------------------------------------------ statistics


@pytest.mark.parametrize("fused", ["off", "force"])
def test_noisy_chain_samples_the_ring(fused):
    """2,000 chains x 300 steps of the headline configuration against 20,000
    exact draws: mean radius within 0.1 (the step-size bias of the
    unadjusted chain is about 0.01 at η=0.05, σ=0.4) and each of the 8 modes
    holding 1/8 of the chains within 0.05 (about 6 standard errors)."""
    mix = tcore.GaussianMixtureEnergy.eight_gaussians()
    out = LangevinDynamics(mix, step_size=0.05, fused=fused).sample(
        _gen(1), dim=2, n_samples=2000, n_steps=300
    )
    exact = mix.sample(_gen(2), 20_000)
    assert torch.isfinite(out).all()
    radius = out.norm(dim=-1).mean()
    assert abs(float(radius - exact.norm(dim=-1).mean())) < 0.1
    nearest = torch.cdist(out, mix.means).argmin(dim=-1)
    occupancy = torch.bincount(nearest, minlength=8).float() / len(out)
    assert float((occupancy - 1 / 8).abs().max()) < 0.05


def test_force_row_uses_the_philox_stream_of_its_seed():
    """On the CPU the row's plain version draws the kernel's Philox stream,
    so the same generator state gives the same chain."""
    mix = tcore.GaussianMixtureEnergy.eight_gaussians()
    s = LangevinDynamics(mix, step_size=0.05, fused="force")
    a = s.sample(_gen(5), dim=2, n_samples=32, n_steps=6)
    b = s.sample(_gen(5), dim=2, n_samples=32, n_steps=6)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    g = _gen(5)
    x0 = torch.randn((32, 2), generator=g)
    seed = int(torch.randint(0, 2**63 - 1, (), generator=g))
    want = tfl.mixture_langevin_chain(x0, mix.means, 6, 0.05, scale=0.4,
                                      log_weights=mix.log_weights, seed=seed)
    torch.testing.assert_close(a, want, rtol=0, atol=0)


# ------------------------------------------------------------------ packaging


def test_port_imports_without_jax():
    code = (
        "import sys, torchebm_tpu_torch as t\n"
        "t.LangevinDynamics, t.GaussianMixtureEnergy, t.ops.mixture_langevin_chain\n"
        "import torchebm_tpu_torch.utils\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'torchebm_tpu.'))"
        " or m in ('torchebm_tpu', 'triton')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
