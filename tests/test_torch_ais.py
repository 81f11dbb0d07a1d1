"""The port's annealed importance sampling against the JAX package.

Mirrors tests/samplers/test_ais.py: log Z of Gaussian, Harmonic and
normalised-mixture targets against their closed forms (within 0.1, the JAX
tests' bound, for 1,000–2,000 chains), the identity anneal, custom betas and
validation, reproducibility, and the kernel dispatch gates (the wrapper
stubbed). A ``torch.Generator`` and JAX keys give different streams, so the
loop is held to the JAX scan by its estimate: both within 0.1 of the truth
and of each other. The kernel's numbers are pinned in test_torch_fused_ais.py.

One divergence from the JAX package is pinned here: a schedule of more than
60,000 rungs stays on the kernel (the JAX kernel's SMEM β table stops there
and its sampler falls back to the scan); the port's β table lives in device
memory.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchebm_tpu import core as jcore
from torchebm_tpu import samplers as js
from torchebm_tpu_torch import core as tcore
from torchebm_tpu_torch import samplers as ts
from torchebm_tpu_torch.ops import fused_ais as tais

torch.set_num_threads(1)

AIS = ts.annealed_importance_sampling


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("fused", ["off", "force"])
def test_gaussian_log_z(fused):
    cov = torch.tensor([[2.0, 0.5], [0.5, 1.0]])
    t = tcore.GaussianEnergy.create(torch.tensor([1.0, -2.0]), cov)
    res = AIS(_gen(), t, dim=2, n_samples=1000, n_rungs=100, fused=fused)
    assert abs(float(res.log_z) - float(t.log_z())) < 0.1
    assert float(res.ess) > 100  # the anneal did not collapse
    assert 0.5 < float(res.acceptance_rate) <= 1.0


@pytest.mark.parametrize("fused", ["off", "force"])
def test_normalized_mixture_log_z_is_zero(fused):
    mix = tcore.GaussianMixtureEnergy.eight_gaussians(radius=2.0, scale=0.5)
    res = AIS(_gen(), mix, dim=2, n_samples=2000, n_rungs=150, step_size=0.2, fused=fused)
    assert abs(float(res.log_z)) < 0.1


def test_harmonic_log_z_on_the_loop():
    res = AIS(_gen(), tcore.HarmonicEnergy(k=4.0), dim=3, n_samples=1000, n_rungs=80)
    assert abs(float(res.log_z) - 1.5 * math.log(2 * math.pi / 4)) < 0.1


@pytest.mark.parametrize("fused", ["off", "force"])
def test_identity_anneal_has_zero_weights(fused):
    """base == target: every weight is exactly 0 and log_z == base.log_z()."""
    base = tcore.GaussianEnergy.standard(2)
    res = AIS(_gen(), base, base=base, n_samples=64, n_rungs=10, fused=fused)
    assert float(torch.max(torch.abs(res.log_weights))) < 1e-5
    assert abs(float(res.log_z) - float(base.log_z())) < 1e-5
    assert abs(float(res.ess) - 64.0) < 1e-3


def test_custom_betas_and_validation():
    t = tcore.GaussianEnergy.standard(2)
    res = AIS(_gen(), t, dim=2, n_samples=32, betas=torch.tensor([0.0, 0.5, 1.0]))
    assert res.samples.shape == (32, 2) and res.log_weights.shape == (32,)
    assert res.log_z.shape == () and res.ess.shape == () and res.acceptance_rate.shape == ()
    with pytest.raises(ValueError, match="betas"):
        AIS(_gen(), t, dim=2, betas=torch.tensor([1.0]))
    with pytest.raises(ValueError, match="base"):
        AIS(_gen(), t)
    with pytest.raises(ValueError, match="fused"):
        AIS(_gen(), t, dim=2, fused="y")
    with pytest.raises(TypeError, match="Generator"):
        AIS(0, t, dim=2)
    with pytest.raises(ValueError, match="generator"):
        AIS(_gen(), t.to("meta"), dim=2)


def test_reproducible():
    t = tcore.GaussianMixtureEnergy.eight_gaussians()
    for fused in ("off", "force"):
        a = AIS(_gen(), t, dim=2, n_samples=32, n_rungs=20, fused=fused)
        b = AIS(_gen(), t, dim=2, n_samples=32, n_rungs=20, fused=fused)
        c = AIS(_gen(1), t, dim=2, n_samples=32, n_rungs=20, fused=fused)
        assert torch.equal(a.log_weights, b.log_weights)
        assert not torch.equal(a.log_weights, c.log_weights)


def test_loop_matches_the_jax_scan_in_estimate():
    cov = np.array([[1.5, -0.4], [-0.4, 0.8]], np.float32)
    mean = np.array([1.0, -0.5], np.float32)
    jt = jcore.GaussianEnergy.create(jnp.asarray(mean), jnp.asarray(cov))
    tt = tcore.GaussianEnergy.create(torch.from_numpy(mean), torch.from_numpy(cov))
    kw = dict(dim=2, n_samples=1000, n_rungs=100, step_size=0.1)
    ref = js.annealed_importance_sampling(jax.random.PRNGKey(0), jt, **kw)
    out = AIS(_gen(), tt, fused="off", **kw)
    truth = float(tt.log_z())
    assert abs(float(ref.log_z) - truth) < 0.1 and abs(float(out.log_z) - truth) < 0.1
    assert abs(float(out.log_z) - float(ref.log_z)) < 0.1
    assert abs(float(out.acceptance_rate) - float(ref.acceptance_rate)) < 0.05


# ------------------------------------------------------------------ dispatch


def _stub(monkeypatch, calls, acc=0.7):
    def stub(x0, base_mean, base_scale, *, means, betas, step_size, n_transitions, seed,
             **kw):
        calls.append((tuple(x0.shape), tuple(means.shape), tuple(betas.shape), base_scale,
                      sorted(kw), kw.get("log_norm_t")))
        n = x0.shape[0]
        return x0, torch.zeros(n), torch.full((n,), acc)

    monkeypatch.setattr(tais, "mixture_ais_run", stub)


def _boom(monkeypatch):
    def boom(*a, **k):  # pragma: no cover - must not be reached
        raise AssertionError("the loop must take this call")

    monkeypatch.setattr(tais, "mixture_ais_run", boom)


class TestFusedDispatch:
    def test_force_routes_mixture_with_its_normalisation(self, monkeypatch):
        calls = []
        _stub(monkeypatch, calls)
        res = AIS(_gen(), tcore.GaussianMixtureEnergy.eight_gaussians(scale=0.4), dim=2,
                  n_samples=64, n_rungs=10, fused="force")
        norm = 2 * math.log(0.4) + math.log(2 * math.pi)
        assert len(calls) == 1
        assert calls[0][:5] == ((64, 2), (8, 2), (11,), 1.0,
                                ["log_norm_t", "log_weights", "scale"])
        assert calls[0][5] == pytest.approx(norm, abs=1e-6)  # σ is a float32 buffer
        assert res.samples.shape == (64, 2)
        assert float(res.acceptance_rate) == pytest.approx(0.7)
        assert float(res.log_z_ratio) == pytest.approx(0.0, abs=1e-5)

    def test_gaussian_targets_carry_no_constant(self, monkeypatch):
        """The repair of the JAX package's isotropic-Gaussian bias: the
        sampler passes ``log_norm_t=0`` for every Gaussian energy."""
        calls = []
        _stub(monkeypatch, calls)
        iso = tcore.GaussianEnergy.create(torch.zeros(2), 0.36 * torch.eye(2))
        full = tcore.GaussianEnergy.create(torch.zeros(2), torch.tensor([[1.0, 0.3], [0.3, 1.0]]))
        for t in (iso, full):
            AIS(_gen(), t, dim=2, n_samples=16, n_rungs=4, fused="force")
        assert [c[4:] for c in calls] == [(["log_norm_t", "scale"], 0.0),
                                          (["log_norm_t", "precision"], 0.0)]

    def test_long_schedule_stays_on_the_kernel(self, monkeypatch):
        """More than 60,000 rungs: the JAX sampler falls back to its scan
        (``ais.py:154``); the port's kernel takes the schedule."""
        calls = []
        _stub(monkeypatch, calls)
        AIS(_gen(), tcore.GaussianMixtureEnergy.eight_gaussians(), dim=2, n_samples=8,
            n_rungs=60_010, step_size=0.1, fused="force")
        assert calls[0][2] == (60_011,)

    def test_anisotropic_base_harmonic_target_and_mismatched_dims_take_the_loop(self, monkeypatch):
        _boom(monkeypatch)
        mix = tcore.GaussianMixtureEnergy.eight_gaussians()
        aniso = tcore.GaussianEnergy.create(torch.zeros(2), torch.diag(torch.tensor([1.0, 4.0])))
        assert AIS(_gen(), mix, base=aniso, n_samples=32, n_rungs=5,
                   fused="force").samples.shape == (32, 2)
        assert AIS(_gen(), tcore.HarmonicEnergy(), dim=2, n_samples=8, n_rungs=3,
                   fused="force").samples.shape == (8, 2)
        big = tcore.GaussianMixtureEnergy.create(torch.zeros(33, 32))
        assert AIS(_gen(), big, dim=32, n_samples=4, n_rungs=2,
                   fused="force").samples.shape == (4, 32)

    def test_auto_never_dispatches_on_cpu_and_off_is_honoured(self, monkeypatch):
        _boom(monkeypatch)
        mix = tcore.GaussianMixtureEnergy.eight_gaussians()
        for fused in ("auto", "off"):
            assert AIS(_gen(), mix, dim=2, n_samples=32, n_rungs=5,
                       fused=fused).samples.shape == (32, 2)


# ------------------------------------------------------------------ host reads


def test_sampler_passes_the_kernel_seed_as_a_tensor(monkeypatch):
    """The sampler hands the kernel the generator's draw as a 0-d int64
    tensor (read by the kernel on the card, no host sync), the draw
    ``_kernel_seed`` reads on the host, taken after the base's draws."""
    from torchebm_tpu_torch.samplers import base as sbase

    seeds = []
    real = tais.mixture_ais_run

    def spy(*args, **kwargs):
        seeds.append(kwargs["seed"])
        return real(*args, **kwargs)

    monkeypatch.setattr(tais, "mixture_ais_run", spy)
    mix = tcore.GaussianMixtureEnergy.eight_gaussians()
    res = AIS(_gen(5), mix, dim=2, n_samples=16, n_rungs=4, fused="force")
    (seed,) = seeds
    assert isinstance(seed, torch.Tensor) and seed.dtype == torch.int64 and seed.ndim == 0
    g = _gen(5)
    tcore.GaussianEnergy.standard(2).sample(g, 16)
    assert int(seed) == sbase._kernel_seed(g)
    monkeypatch.setattr(tais, "mixture_ais_run", real)
    again = AIS(_gen(5), mix, dim=2, n_samples=16, n_rungs=4, fused="force")
    assert torch.equal(res.log_weights, again.log_weights)


class _CountingCpu:
    """Counts ``Tensor.cpu`` calls (the gates' host reads of ``cov``)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = torch.Tensor.cpu

        def cpu(t, *a, **k):
            self.calls += 1
            return real(t, *a, **k)

        monkeypatch.setattr(torch.Tensor, "cpu", cpu)


def test_isotropic_gate_ignores_the_default_device():
    """The gate compares ``cov`` with a multiple of the identity on the
    host whatever the default device (under ``torch.set_default_device``
    on a card, as a sharded run's processes set it, the identity was made
    there and the comparison raised)."""
    from torchebm_tpu_torch.samplers.langevin import _isotropic_scale

    e = tcore.GaussianEnergy.create(torch.zeros(2), 4.0 * torch.eye(2))
    with torch.device("meta"):
        assert _isotropic_scale(e) == pytest.approx(2.0)


def test_isotropic_gate_reads_cov_once_per_state(monkeypatch):
    """``_isotropic_scale`` reads ``cov`` on the host once per state of the
    buffer: the same answer twice with no second ``.cpu()``; a new answer
    after an in-place edit of ``cov`` and after ``.to()`` (a new tensor)."""
    from torchebm_tpu_torch.samplers.langevin import _isotropic_scale

    counter = _CountingCpu(monkeypatch)
    e = tcore.GaussianEnergy.create(torch.zeros(2), 4.0 * torch.eye(2))
    assert _isotropic_scale(e) == pytest.approx(2.0)
    assert _isotropic_scale(e) == pytest.approx(2.0)
    assert counter.calls == 1
    e.cov.mul_(0.25)  # in place: cov = I
    assert _isotropic_scale(e) == pytest.approx(1.0)
    assert counter.calls == 2
    e.cov[0, 1] = 0.5  # no longer isotropic
    assert _isotropic_scale(e) is None
    assert counter.calls == 3
    e.cov[0, 1] = 0.0
    e = e.to(torch.float64)  # new buffers
    assert _isotropic_scale(e) == pytest.approx(1.0)
    assert counter.calls == 4
    assert _isotropic_scale(e) == pytest.approx(1.0)
    assert counter.calls == 4


def test_fused_target_gate_reads_the_scale_once_per_state(monkeypatch):
    """``_fused_target_kwargs`` reads the mixture's ``scale`` on the host
    once per state of the buffer: its ``scale`` and ``log_norm_t`` come back
    equal with no second read, and anew after an in-place edit."""
    from torchebm_tpu_torch.samplers.ais import _fused_target_kwargs

    reads = []
    real = torch.Tensor.__float__

    def counting_float(t):
        reads.append(1)
        return real(t)

    monkeypatch.setattr(torch.Tensor, "__float__", counting_float)
    mix = tcore.GaussianMixtureEnergy.eight_gaussians(scale=0.5)
    a = _fused_target_kwargs(mix)
    b = _fused_target_kwargs(mix)
    assert len(reads) == 1
    assert (a["scale"], a["log_norm_t"]) == (b["scale"], b["log_norm_t"]) == (
        0.5, pytest.approx(2 * math.log(0.5) + math.log(2 * math.pi)))
    mix.scale.fill_(0.25)
    c = _fused_target_kwargs(mix)
    assert len(reads) == 2 and c["scale"] == 0.25


def test_base_cholesky_factor_is_computed_once_per_state(monkeypatch):
    """``GaussianEnergy.sample`` factors ``cov`` once per state of the
    buffer (``torch.linalg.cholesky`` checks its result on the host): the
    same draws as a fresh factor, and a new factor after an in-place edit."""
    calls = []
    real = torch.linalg.cholesky

    def counting(a, *args, **kw):
        calls.append(1)
        return real(a, *args, **kw)

    from torchebm_tpu_torch.core import energies

    e = tcore.GaussianEnergy.create(torch.tensor([1.0, -1.0]), torch.tensor([[2.0, 0.3],
                                                                             [0.3, 1.0]]))
    fresh = e.mean + torch.randn((8, 2), generator=_gen(3)) @ real(e.cov).T
    monkeypatch.setattr(energies.torch.linalg, "cholesky", counting)
    first = e.sample(_gen(3), 8)
    assert torch.equal(e.sample(_gen(3), 8), first)
    assert len(calls) == 1
    torch.testing.assert_close(first, fresh, rtol=0, atol=0)
    e.cov.mul_(2.0)
    e.sample(_gen(3), 8)
    assert len(calls) == 2


def test_base_log_z_is_computed_once_per_state(monkeypatch):
    """``GaussianEnergy.log_z`` takes the log-determinant once per state of
    ``cov`` (on the card ``slogdet`` is the AIS call's largest host cost):
    the same value as a fresh ``slogdet``, computed anew after an in-place
    edit."""
    from torchebm_tpu_torch.core import energies

    calls = []
    real = torch.linalg.slogdet

    def counting(a, *args, **kw):
        calls.append(1)
        return real(a, *args, **kw)

    e = tcore.GaussianEnergy.create(torch.zeros(2), torch.tensor([[2.0, 0.3], [0.3, 1.0]]))
    want = math.log(2 * math.pi) + 0.5 * float(real(e.cov)[1])
    monkeypatch.setattr(energies.torch.linalg, "slogdet", counting)
    assert float(e.log_z()) == pytest.approx(want, abs=1e-6)
    assert float(e.log_z()) == pytest.approx(want, abs=1e-6)
    assert len(calls) == 1
    e.cov.mul_(2.0)
    assert float(e.log_z()) == pytest.approx(want + math.log(2.0), abs=1e-5)
    assert len(calls) == 2
