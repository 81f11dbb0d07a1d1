"""The port's energies against the JAX package's on the same numpy inputs.

Energy and gradient agree to atol 1e-5 plus rtol 1e-5 (float32; the relative
part covers the Rosenbrock and Rastrigin values, which reach the hundreds).
Parameters go across through ``torchebm_tpu_torch.utils.convert``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchebm_tpu.core.energies as je
import torchebm_tpu_torch.core.energies as te
from torchebm_tpu_torch.utils import energy_from_arrays

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(name, **params):
    """The JAX energy built from numpy params and its port through convert."""
    j = getattr(je, name)
    if name == "GaussianEnergy":
        jen = j.create(params["mean"], params["cov"])
    elif name == "GaussianMixtureEnergy":
        jen = j.create(params["means"], scale=params["scale"], weights=params["weights"])
    else:
        jen = j(**params)
    arrays = {f.name: np.asarray(getattr(jen, f.name)) for f in dataclasses.fields(jen)}
    return jen, energy_from_arrays(name, arrays)


def _cases():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 3)).astype(np.float32)
    return [
        ("DoubleWellEnergy", dict(barrier_height=1.5, b=0.9), 3),
        ("HarmonicEnergy", dict(k=0.7), 4),
        ("RosenbrockEnergy", dict(a=1.2, b=10.0), 3),
        ("AckleyEnergy", dict(), 5),
        ("RastriginEnergy", dict(a=7.0), 3),
        ("GaussianEnergy", dict(mean=rng.standard_normal(3).astype(np.float32),
                                cov=(a @ a.T + np.eye(3)).astype(np.float32)), 3),
        ("GaussianMixtureEnergy", dict(means=2 * rng.standard_normal((5, 2)).astype(np.float32),
                                       scale=0.6, weights=rng.uniform(0.5, 2, 5)), 2),
    ]


@pytest.mark.parametrize("name, params, d", _cases(), ids=[c[0] for c in _cases()])
def test_energy_and_gradient_match_jax(name, params, d):
    jen, ten = _pair(name, **params)
    x = np.random.default_rng(1).standard_normal((29, d)).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(
        ten.energy(xt).numpy(), np.asarray(jen.energy(jnp.asarray(x))), **TOL
    )
    np.testing.assert_allclose(
        ten.gradient(xt).numpy(), np.asarray(jen.gradient(jnp.asarray(x))), **TOL
    )
    # the autograd default agrees with the analytic overrides
    np.testing.assert_allclose(
        te.Energy.gradient(ten, xt).numpy(), ten.gradient(xt).numpy(), **TOL
    )
    # unbatched (d,) inputs give one energy
    assert ten.energy(xt[0]).shape == (1,)


def test_eight_gaussians_matches_jax():
    jen = je.GaussianMixtureEnergy.eight_gaussians()
    ten = te.GaussianMixtureEnergy.eight_gaussians()
    np.testing.assert_allclose(ten.means.numpy(), np.asarray(jen.means), atol=1e-6)
    np.testing.assert_allclose(ten.log_weights.numpy(), np.asarray(jen.log_weights), atol=1e-7)
    assert float(ten.scale) == pytest.approx(float(jen.scale))
    assert [b for b, _ in ten.named_buffers()] == ["means", "scale", "log_weights"]


def test_contract_helpers():
    ten = te.GaussianMixtureEnergy.eight_gaussians()
    x = torch.randn(7, 2, generator=torch.Generator().manual_seed(0))
    e, g = ten.value_and_grad(x)
    torch.testing.assert_close(e, ten(x))
    torch.testing.assert_close(g, ten.gradient(x), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ten.score(x), -g, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ten.unnorm_log_prob(x), -e)
    # with x requiring grad, the gradient keeps its graph
    xg = x.clone().requires_grad_(True)
    (gg,) = torch.autograd.grad(te.Energy.gradient(ten, xg).sum(), xg)
    assert gg.shape == x.shape and torch.isfinite(gg).all()


def test_wrapped_energy_and_as_energy():
    fn_j = lambda x: jnp.sum(x**4 - x, axis=-1)  # noqa: E731
    fn_t = lambda x: torch.sum(x**4 - x, dim=-1)  # noqa: E731
    x = np.random.default_rng(2).standard_normal((6, 3)).astype(np.float32)
    jen, ten = je.as_energy(fn_j), te.as_energy(fn_t)
    assert isinstance(ten, te.WrappedEnergy) and te.as_energy(ten) is ten
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(ten(xt).numpy(), np.asarray(jen(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        ten.gradient(xt).numpy(), np.asarray(jen.gradient(jnp.asarray(x))), **TOL
    )
    net = torch.nn.Linear(3, 1)
    wrapped = te.as_energy(net)
    assert wrapped(xt).shape == (6,)
    assert "fn.weight" in dict(wrapped.named_parameters())
    scaled = te.WrappedEnergy(lambda p, x: p * torch.sum(x, -1), params=2.0)
    torch.testing.assert_close(scaled(xt), 2.0 * xt.sum(-1))
    with pytest.raises(TypeError):
        te.as_energy(3)


def test_gaussian_log_z_and_sampling():
    mean = np.array([1.0, -2.0], np.float32)
    cov = np.array([[2.0, 0.6], [0.6, 1.0]], np.float32)
    jen, ten = je.GaussianEnergy.create(mean, cov), te.GaussianEnergy.create(mean, cov)
    assert float(ten.log_z()) == pytest.approx(float(jen.log_z()), rel=1e-6)
    s = ten.sample(torch.Generator().manual_seed(0), 40_000)
    assert s.shape == (40_000, 2)
    # 5-sigma bounds on the sample mean and covariance of 40k draws
    np.testing.assert_allclose(s.mean(0).numpy(), mean, atol=5 * math.sqrt(2.0 / 40_000))
    np.testing.assert_allclose(np.cov(s.numpy().T), cov, atol=0.05)
    std = te.GaussianEnergy.standard(3)
    torch.testing.assert_close(std.cov_inv, torch.eye(3))


def test_mixture_sampling_covers_the_modes():
    ten = te.GaussianMixtureEnergy.create([[0.0, 0.0], [5.0, 0.0]], scale=0.5, weights=[1.0, 3.0])
    s = ten.sample(torch.Generator().manual_seed(1), 20_000)
    frac_right = float((s[:, 0] > 2.5).float().mean())
    assert abs(frac_right - 0.75) < 5 * math.sqrt(0.75 * 0.25 / 20_000)


def test_create_validation_matches_jax():
    for bad in (
        lambda m: m.GaussianEnergy.create(np.zeros((2, 2)), np.eye(2)),
        lambda m: m.GaussianEnergy.create(np.zeros(2), np.zeros((2, 3))),
        lambda m: m.GaussianEnergy.create(np.zeros(3), np.eye(2)),
        lambda m: m.GaussianMixtureEnergy.create(np.zeros(3)),
        lambda m: m.RosenbrockEnergy().energy(np.zeros((2, 1), np.float32)
                                              if m is je else torch.zeros(2, 1)),
    ):
        for mod in (je, te):
            with pytest.raises(ValueError):
                bad(mod)


def test_energies_move_with_to():
    ten = te.GaussianEnergy.create(np.zeros(2), np.eye(2)).to(torch.float64)
    assert ten.mean.dtype == torch.float64 and ten.cov_inv.dtype == torch.float64


def test_convert_rejects_unknown_and_incomplete():
    with pytest.raises(ValueError, match="Unknown energy"):
        energy_from_arrays("MLPEnergy", {})
    with pytest.raises(ValueError, match="needs arrays"):
        energy_from_arrays("GaussianEnergy", {"mean": np.zeros(2)})


def test_convert_places_buffers_on_device():
    arrays = {"means": np.zeros((2, 3)), "scale": np.float32(1.0), "log_weights": np.zeros(2)}
    ten = energy_from_arrays("GaussianMixtureEnergy", arrays, device=torch.device("cpu"))
    assert all(b.dtype == torch.float32 for b in ten.buffers())
    assert ten.energy(torch.zeros(4, 3)).shape == (4,)

