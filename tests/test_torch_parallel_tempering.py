"""The port's parallel-tempered Langevin sampler against the JAX package.

Mirrors tests/samplers/test_parallel_tempering.py: validation, shapes and
trajectory, the swap-acceptance diagnostic, cold-chain moments, the mixing
win on a double well, the ``run_replicas`` contract, reproducibility, and the
dispatch rules (kernel wrappers stubbed). A ``torch.Generator`` and JAX keys
give different streams, so noisy chains are compared by distribution: the
loop against the JAX scan on one Gaussian, means within 0.1 and variances
within 12% for 2,000 chains (each side about 4-sigma of its own sampling
error). The ladder kernels' numbers are pinned in test_torch_fused_pt.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchebm_tpu import core as jcore
from torchebm_tpu import samplers as js
from torchebm_tpu_torch import core as tcore
from torchebm_tpu_torch import samplers as ts
from torchebm_tpu_torch.ops import fused_pt as tpt
from torchebm_tpu_torch.utils import energy_from_arrays, sampler_from_fields

torch.set_num_threads(1)

PT = ts.ParallelTemperingLangevin


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_ctor_validation():
    e = tcore.GaussianEnergy.standard(2)
    with pytest.raises(ValueError, match="increasing"):
        PT(e, temperatures=(1.0, 0.5))
    with pytest.raises(ValueError, match=">= 2"):
        PT(e, temperatures=(1.0,))
    with pytest.raises(ValueError, match="positive"):
        PT(e, temperatures=(-1.0, 2.0))
    with pytest.raises(ValueError, match="swap_every"):
        PT(e, temperatures=(1.0, 2.0), swap_every=0)
    with pytest.raises(ValueError, match="clamp"):
        PT(e, clamp=(1.0, -1.0))
    with pytest.raises(ValueError, match="fused"):
        PT(e, fused="yes")
    assert PT(e, temperatures=[1, 2]).temperatures == (1.0, 2.0)


def test_sample_shapes_and_trajectory():
    pt = PT(tcore.GaussianEnergy.standard(2), temperatures=(1.0, 2.0, 4.0), step_size=0.05)
    assert pt.sample(_gen(), dim=2, n_samples=16, n_steps=20).shape == (16, 2)
    traj = pt.sample(_gen(), dim=2, n_samples=16, n_steps=20, thin=5, return_trajectory=True)
    assert traj.shape == (16, 4, 2)


def test_swap_acceptance_diagnostic():
    pt = PT(tcore.GaussianEnergy.standard(2), temperatures=(1.0, 1.5, 2.25), step_size=0.05,
            swap_every=2)
    _, diag = pt.sample(_gen(), dim=2, n_samples=64, n_steps=40, return_diagnostics=True)
    acc = diag["swap_acceptance_rate"]
    assert acc.shape == (40,)
    # before the first sweep the statistic is 0; after it a real probability,
    # and a mild ladder on a Gaussian swaps most of the time
    assert float(acc[0]) == 0.0
    assert 0.2 < float(acc[-1]) <= 1.0
    assert bool(torch.all(torch.isfinite(acc)))


def test_cold_chain_gaussian_moments():
    pt = PT(tcore.GaussianEnergy.standard(2), temperatures=(1.0, 2.0, 4.0), step_size=0.05)
    samples = pt.sample(_gen(), dim=2, n_samples=2048, n_steps=300)
    assert float(torch.abs(torch.mean(samples))) < 0.15
    assert float(torch.abs(torch.var(samples) - 1.0)) < 0.2


def test_pt_mixes_double_well_where_langevin_cannot():
    """Chains started in the left well: cold Langevin stays trapped, replica
    exchange ferries mass over the barrier to both wells."""
    e = tcore.DoubleWellEnergy(barrier_height=8.0, b=1.0)
    x0 = -torch.ones(256, 1)
    stuck = ts.LangevinDynamics(e, step_size=0.005).sample(_gen(), x=x0, n_steps=800)
    assert float(torch.mean((stuck > 0).float())) < 0.05
    pt = PT(e, temperatures=(1.0, 3.0, 9.0, 27.0, 81.0), step_size=0.005, swap_every=5)
    right = float(torch.mean((pt.sample(_gen(), x=x0, n_steps=800) > 0).float()))
    assert 0.2 < right < 0.8


def test_run_replicas_contract():
    pt = PT(tcore.GaussianEnergy.standard(2), temperatures=(1.0, 2.0), step_size=0.05)
    ladder = torch.zeros(2, 8, 2)
    out, acc = pt.run_replicas(_gen(), ladder, n_steps=10)
    assert out.shape == (2, 8, 2) and acc.shape == ()
    assert bool(torch.all(out[0] != ladder[0]))
    assert 0.0 < float(acc) <= 1.0
    with pytest.raises(ValueError, match="n_replicas"):
        pt.run_replicas(_gen(), torch.zeros(3, 8, 2), n_steps=5)
    with pytest.raises(ValueError, match="generator"):
        pt.run_replicas(_gen(), torch.zeros(2, 8, 2, device="meta"), n_steps=5)


def test_reproducible_and_decorrelated():
    pt = PT(tcore.GaussianEnergy.standard(2), temperatures=(1.0, 2.0), step_size=0.05)
    a = pt.sample(_gen(0), dim=2, n_samples=8, n_steps=25)
    b = pt.sample(_gen(0), dim=2, n_samples=8, n_steps=25)
    c = pt.sample(_gen(1), dim=2, n_samples=8, n_steps=25)
    assert torch.equal(a, b) and not torch.equal(a, c)


MEAN = np.array([1.0, -0.5], np.float32)
COV = np.array([[0.5, 0.0], [0.0, 2.0]], np.float32)


@pytest.mark.parametrize("fused", ["off", "force"])
def test_cold_chain_matches_the_jax_scan_in_distribution(fused):
    """One set of fields through ``utils.convert.sampler_from_fields`` into
    both packages; the port's loop (``"off"``) and its kernel's plain version
    (``"force"``) against the JAX scan on a Gaussian."""
    fields = dict(temperatures=(1.0, 1.6, 2.56), step_size=0.04, swap_every=4)
    jpt = js.ParallelTemperingLangevin(jcore.GaussianEnergy.create(jnp.asarray(MEAN),
                                                                   jnp.asarray(COV)), **fields)
    tenergy = energy_from_arrays("GaussianEnergy", {"mean": MEAN, "cov": COV,
                                                    "cov_inv": np.linalg.inv(COV)})
    tpt_ = sampler_from_fields("ParallelTemperingLangevin", dict(fields, fused=fused), tenergy)
    assert tpt_.temperatures == fields["temperatures"] and tpt_.swap_every == 4
    ref = np.asarray(jpt.sample(jax.random.PRNGKey(0), dim=2, n_samples=2000, n_steps=250))
    out = tpt_.sample(_gen(), dim=2, n_samples=2000, n_steps=250).numpy()
    for got in (ref, out):
        np.testing.assert_allclose(got.mean(0), MEAN, atol=0.1)
        np.testing.assert_allclose(got.var(0), np.diag(COV), rtol=0.12)
    np.testing.assert_allclose(out.mean(0), ref.mean(0), atol=0.1)
    np.testing.assert_allclose(out.var(0), ref.var(0), rtol=0.12)


# ------------------------------------------------------------------ dispatch


def _stub(monkeypatch, name, calls, acc=0.5):
    def stub(replicas, means, *, n_steps, step_size, noise_scale, betas, swap_every, seed,
             clamp, thin=None, **kw):
        calls.append((name, tuple(replicas.shape), tuple(means.shape), n_steps, betas,
                      swap_every, thin, sorted(kw)))
        ladder = replicas + 1.0
        if thin is not None:
            return torch.zeros((n_steps // thin, *replicas.shape[1:])), ladder, torch.tensor(acc)
        return ladder, torch.tensor(acc)

    monkeypatch.setattr(tpt, name, stub)


def _boom(monkeypatch):
    def boom(*a, **k):  # pragma: no cover - must not be reached
        raise AssertionError("the loop must take this call")

    for name in ("pt_langevin_chain", "pt_langevin_chain_trajectory"):
        monkeypatch.setattr(tpt, name, boom)


class TestFusedDispatch:
    def test_force_routes_mixture(self, monkeypatch):
        calls = []
        _stub(monkeypatch, "pt_langevin_chain", calls)
        pt = PT(tcore.GaussianMixtureEnergy.eight_gaussians(scale=0.4),
                temperatures=(1.0, 2.0, 4.0), step_size=0.05, swap_every=3, fused="force")
        x0 = torch.zeros(32, 2)
        out = pt.sample(_gen(), x=x0, n_steps=12)
        torch.testing.assert_close(out, x0 + 1.0)
        assert calls == [("pt_langevin_chain", (3, 32, 2), (8, 2), 12, (1.0, 0.5, 0.25), 3,
                          None, ["log_weights", "scale"])]

    def test_force_routes_gaussian_precision_and_isotropic(self, monkeypatch):
        calls = []
        _stub(monkeypatch, "pt_langevin_chain", calls)
        full = tcore.GaussianEnergy.create(torch.zeros(2), torch.tensor([[2.0, 0.5], [0.5, 1.0]]))
        iso = tcore.GaussianEnergy.create(torch.zeros(2), 0.25 * torch.eye(2))
        for e in (full, iso):
            pt = PT(e, temperatures=(1.0, 2.0), step_size=0.05, fused="force")
            assert pt.sample(_gen(), dim=2, n_samples=8, n_steps=4).shape == (8, 2)
        assert [c[-1] for c in calls] == [["precision"], ["scale"]]

    def test_trajectory_routes_to_trajectory_kernel(self, monkeypatch):
        calls = []
        _stub(monkeypatch, "pt_langevin_chain_trajectory", calls)
        pt = PT(tcore.GaussianMixtureEnergy.eight_gaussians(), temperatures=(1.0, 2.0),
                step_size=0.05, fused="force")
        out = pt.sample(_gen(), dim=2, n_samples=16, n_steps=12, thin=3, return_trajectory=True)
        assert out.shape == (16, 4, 2)
        assert [c[:7] for c in calls] == [("pt_langevin_chain_trajectory", (2, 16, 2), (8, 2),
                                           12, (1.0, 0.5), 5, 3)]

    def test_run_replicas_dispatches_the_kernel(self, monkeypatch):
        calls = []
        _stub(monkeypatch, "pt_langevin_chain", calls, acc=0.25)
        pt = PT(tcore.GaussianMixtureEnergy.eight_gaussians(), temperatures=(1.0, 2.0),
                step_size=0.05, fused="force")
        ladder, acc = pt.run_replicas(_gen(), torch.zeros(2, 16, 2), 7)
        assert [c[1:5] for c in calls] == [((2, 16, 2), (8, 2), 7, (1.0, 0.5))]
        torch.testing.assert_close(ladder, torch.ones(2, 16, 2))
        assert float(acc) == 0.25

    def test_doublewell_diagnostics_schedules_and_conditioning_take_the_loop(self, monkeypatch):
        _boom(monkeypatch)
        dw = PT(tcore.DoubleWellEnergy(), temperatures=(1.0, 2.0), step_size=0.01,
                fused="force")
        assert dw.sample(_gen(), dim=2, n_samples=8, n_steps=6).shape == (8, 2)
        mix = tcore.GaussianMixtureEnergy.eight_gaussians()
        pt = PT(mix, temperatures=(1.0, 2.0), step_size=0.05, fused="force")
        out, diag = pt.sample(_gen(), dim=2, n_samples=8, n_steps=6, return_diagnostics=True)
        assert out.shape == (8, 2) and "swap_acceptance_rate" in diag
        sched = PT(mix, temperatures=(1.0, 2.0), fused="force",
                   step_size=tcore.CosineScheduler(0.05, 0.01, 6))
        assert sched.sample(_gen(), dim=2, n_samples=8, n_steps=6).shape == (8, 2)
        with pytest.raises(TypeError):  # conditioning reaches the energy: the loop took it
            pt.sample(_gen(), dim=2, n_samples=8, n_steps=2, model_kwargs={"c": 1.0})
        many = PT(mix, temperatures=tuple(1.1 ** r for r in range(33)), step_size=0.05,
                  fused="force")
        assert many.sample(_gen(), dim=2, n_samples=4, n_steps=2).shape == (4, 2)

    def test_auto_never_dispatches_on_cpu_and_off_is_honoured(self, monkeypatch):
        _boom(monkeypatch)
        mix = tcore.GaussianMixtureEnergy.eight_gaussians()
        for fused in ("auto", "off"):
            pt = PT(mix, step_size=0.05, fused=fused)
            assert pt.sample(_gen(), dim=2, n_samples=8, n_steps=6).shape == (8, 2)
            assert pt.run_replicas(_gen(), torch.zeros(4, 8, 2), 6)[0].shape == (4, 8, 2)

    def test_force_runs_the_plain_ladder_on_cpu(self):
        """Without stubs, ``"force"`` on the CPU runs the kernels' plain
        versions: the ring's cold chain lands on the ring."""
        mix = tcore.GaussianMixtureEnergy.eight_gaussians()
        pt = PT(mix, step_size=0.05, fused="force")
        out = pt.sample(_gen(), dim=2, n_samples=500, n_steps=200)
        assert 3.6 < float(out.norm(dim=-1).mean()) < 4.4
        traj = pt.sample(_gen(), dim=2, n_samples=50, n_steps=20, thin=5,
                         return_trajectory=True)
        assert traj.shape == (50, 4, 2)
        ladder, acc = pt.run_replicas(_gen(), torch.zeros(4, 50, 2), 20)
        assert ladder.shape == (4, 50, 2) and 0.0 < float(acc) <= 1.0
