"""The port's datasets against the JAX package's.

The deterministic parts agree number for number: the grid and two moons at
zero noise (float32 ``linspace``, cos and sin: atol 1e-6) and the digits
fallback of ``load_mnist`` (the bilinear upsampling 8 → 28 pixels: atol 1e-5
on values in [-1, 1]). The random draws come from a ``torch.Generator``
where JAX uses a key, so the rest is compared by moments over 20,000 points,
to about five standard errors.
"""

import numpy as np
import pytest
import torch

import jax

from torchebm_tpu import datasets as jd
from torchebm_tpu_torch import datasets as td
from torchebm_tpu_torch.core import default_device

torch.set_num_threads(1)

N = 20_000


def _g(seed=0):
    return torch.Generator().manual_seed(seed)


def test_grid_and_moons_without_noise_match_jax():
    key = jax.random.PRNGKey(0)
    for n in (10, 7):
        want = np.asarray(jd.make_grid(key, n, range_limit=2.0, noise=0.0))
        got = td.make_grid(_g(), n, range_limit=2.0, noise=0.0)
        assert got.dtype == torch.float32 and got.shape == (n * n, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    for n in (100, 101):
        want = np.asarray(jd.make_two_moons(key, n, noise=0.0))
        np.testing.assert_allclose(td.make_two_moons(_g(), n, noise=0.0).numpy(), want,
                                   rtol=0, atol=1e-6)


def test_digits_fallback_matches_jax_resize():
    pytest.importorskip("sklearn")
    for split in ("train", "test"):
        want_x, want_y = jd.load_mnist(split)
        got_x, got_y = td.load_mnist(split)
        assert got_x.shape == (want_x.shape[0], 1, 28, 28) and got_x.dtype == torch.float32
        assert got_x.device == got_y.device == default_device()
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    flat, _ = td.load_mnist("test", flatten=True)
    assert flat.shape == (297, 784)
    with pytest.raises(ValueError, match="split"):
        td.load_mnist("val")


MOMENT_CASES = {
    "gaussian_mixture": dict(n_components=8, std=0.05, radius=1.0),
    "8gaussians": dict(std=0.02, scale=2.0),
    "two_moons": dict(noise=0.05),
    "swiss_roll": dict(noise=0.05, arclength=3.0),
    "circle": dict(noise=0.05, radius=1.0),
    "checkerboard": dict(range_limit=4.0, noise=0.01),
    "pinwheel": dict(n_classes=5, noise=0.05),
}
MAKERS = {
    "gaussian_mixture": "make_gaussian_mixture", "8gaussians": "make_8gaussians",
    "two_moons": "make_two_moons", "swiss_roll": "make_swiss_roll", "circle": "make_circle",
    "checkerboard": "make_checkerboard", "pinwheel": "make_pinwheel",
}


@pytest.mark.parametrize("name", sorted(MOMENT_CASES))
def test_random_sets_match_jax_by_moments(name):
    cfg = MOMENT_CASES[name]
    want = np.asarray(getattr(jd, MAKERS[name])(jax.random.PRNGKey(3), N, **cfg), np.float64)
    got = getattr(td, MAKERS[name])(_g(3), N, **cfg)
    assert got.shape == (N, 2) and got.dtype == torch.float32
    got = got.double().numpy()
    sd = want.std(axis=0)
    # means within ~5 standard errors of the difference of two sample means
    np.testing.assert_array_less(np.abs(got.mean(0) - want.mean(0)), 5 * sd * np.sqrt(2 / N))
    np.testing.assert_allclose(got.std(0), sd, rtol=0.03)
    # radii: mean distance from the origin
    r_got, r_want = np.linalg.norm(got, axis=1), np.linalg.norm(want, axis=1)
    assert abs(r_got.mean() - r_want.mean()) < 5 * r_want.std() * np.sqrt(2 / N)


def test_checkerboard_keeps_only_dark_squares():
    x = td.make_checkerboard(_g(4), 5000, noise=0.0)
    assert bool(((torch.floor(x[:, 0]) + torch.floor(x[:, 1])) % 2 != 0).all())


def test_entry_points_default_to_the_card_when_there_is_one(monkeypatch):
    """Handed no device, the dataset classes and ``load_mnist`` put their
    data on ``default_device()``: the CPU here, the current CUDA device on a
    machine with one."""
    assert default_device() == torch.device("cpu")
    for cls in td.DATASET_REGISTRY.values():
        assert cls(seed=1).device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")
    asked = []
    monkeypatch.setattr(td.generators, "default_device",
                        lambda: asked.append("generators") or torch.device("cpu"))
    monkeypatch.setattr(td.images, "default_device",
                        lambda: asked.append("images") or torch.device("cpu"))
    monkeypatch.setattr(td.images, "_try_local_mnist",
                        lambda split: (np.zeros((2, 28, 28), np.float32), np.zeros(2, np.int64)))
    td.GridDataset(4)
    x, y = td.load_mnist("test")
    assert asked == ["generators", "images"] and x.shape == (2, 1, 28, 28)
    td.GridDataset(4, device="cpu")
    td.load_mnist("test", device="cpu")
    assert len(asked) == 2  # an explicit device is not overridden


def test_dataset_classes_and_registry():
    assert sorted(td.DATASET_REGISTRY) == sorted(jd.DATASET_REGISTRY)
    ds = td.EightGaussiansDataset(n_samples=512, seed=5)
    same = td.EightGaussiansDataset(n_samples=512, seed=5)
    assert torch.equal(ds.get_data(), same.get_data()) and len(ds) == 512
    first = ds.get_data().clone()
    ds.regenerate()
    assert ds.seed == 6 and not torch.equal(ds.get_data(), first)
    batches = list(ds.batches(_g(6), 100))
    assert len(batches) == 5 and all(b.shape == (100, 2) for b in batches)
    assert len(list(ds.batches(_g(6), 100, drop_last=False))) == 6
    grid = td.GridDataset(n_samples_per_dim=4, noise=0.0)
    assert grid.get_data().shape == (16, 2) and grid[0].shape == (2,)
    for cls in td.DATASET_REGISTRY.values():
        data = cls(seed=1).get_data()
        assert data.dtype == torch.float32 and torch.isfinite(data).all()
    with pytest.raises(ValueError):
        td.TwoMoonsDataset(n_samples=0)
    with pytest.raises(ValueError):
        td.make_gaussian_mixture(_g(), 10, n_components=0)
