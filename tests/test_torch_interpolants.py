"""The port's interpolants against the JAX package's on the same numpy inputs (1e-6)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchebm_tpu.interpolants as ji
import torchebm_tpu_torch.interpolants as ti

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=1e-6)
NAMES = ["linear", "cosine", "vp"]


def _inputs(shape=(9, 3)):
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal(shape).astype(np.float32)
    x1 = rng.standard_normal(shape).astype(np.float32)
    t = rng.uniform(0.05, 0.95, shape[0]).astype(np.float32)
    return x0, x1, t


def _np(v):
    return np.asarray(v) if not isinstance(v, torch.Tensor) else v.numpy()


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", [(9, 3), (4, 2, 3, 3)])
def test_paths_and_drifts_match_jax(name, shape):
    x0, x1, t = _inputs(shape)
    a, b = ji.get_interpolant(name), ti.get_interpolant(name)
    j = [jnp.asarray(v) for v in (x0, x1, t)]
    p = [torch.from_numpy(v) for v in (x0, x1, t)]
    for got, want in zip(b.interpolate(*p), a.interpolate(*j)):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for fn in ("compute_alpha_t", "compute_sigma_t"):
        for got, want in zip(getattr(b, fn)(p[2]), getattr(a, fn)(j[2])):
            np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(b.compute_d_alpha_alpha_ratio_t(p[2])),
                               _np(a.compute_d_alpha_alpha_ratio_t(j[2])), **TOL)
    for got, want in zip(b.compute_drift(p[0], p[2]), a.compute_drift(j[0], j[2])):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("form", ti.DIFFUSION_FORMS)
def test_diffusion_forms_match_jax(name, form):
    x0, _, t = _inputs()
    want = ji.get_interpolant(name).compute_diffusion(jnp.asarray(x0), jnp.asarray(t), form, 0.7)
    got = ti.get_interpolant(name).compute_diffusion(torch.from_numpy(x0), torch.from_numpy(t),
                                                     form, 0.7)
    np.testing.assert_allclose(_np(got), np.broadcast_to(_np(want), got.shape), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_conversions_match_jax(name):
    x0, x1, t = _inputs()
    a, b = ji.get_interpolant(name), ti.get_interpolant(name)
    for fn in ("velocity_to_score", "velocity_to_noise", "score_to_velocity"):
        want = getattr(a, fn)(jnp.asarray(x1), jnp.asarray(x0), jnp.asarray(t))
        got = getattr(b, fn)(torch.from_numpy(x1), torch.from_numpy(x0), torch.from_numpy(t))
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-5)
    # velocity -> score -> velocity is the identity away from the ends
    v = torch.from_numpy(x1)
    back = b.score_to_velocity(b.velocity_to_score(v, torch.from_numpy(x0), torch.from_numpy(t)),
                               torch.from_numpy(x0), torch.from_numpy(t))
    np.testing.assert_allclose(back.numpy(), x1, rtol=1e-3, atol=1e-3)


def test_scalar_times_and_expand():
    x = torch.zeros(5, 2, 3)
    assert ti.expand_t_like_x(torch.arange(5.0), x).shape == (5, 1, 1)
    assert ti.expand_t_like_x(0.3, x).ndim == 0
    lin = ti.LinearInterpolant()
    xt, ut = lin.interpolate(torch.ones(5, 2), 3 * torch.ones(5, 2), 0.25)
    torch.testing.assert_close(xt, torch.full((5, 2), 1.5))
    torch.testing.assert_close(ut, torch.full((5, 2), 2.0))
    # the ends: t = 0 is the noise, t = 1 the data
    for name in NAMES[:2]:
        b = ti.get_interpolant(name)
        x0, x1 = torch.randn(4, 2), torch.randn(4, 2)
        torch.testing.assert_close(b.interpolate(x0, x1, torch.zeros(4))[0], x0)
        torch.testing.assert_close(b.interpolate(x0, x1, torch.ones(4))[0], x1,
                                   atol=1e-6, rtol=1e-6)


def test_registry():
    assert sorted(ti.INTERPOLANT_REGISTRY) == sorted(ji.INTERPOLANT_REGISTRY)
    assert isinstance(ti.resolve_interpolant(None), ti.LinearInterpolant)
    vp = ti.get_interpolant("VP", sigma_max=10.0)
    assert vp.sigma_max == 10.0 and ti.resolve_interpolant(vp) is vp
    for mod in (ji, ti):
        with pytest.raises(ValueError, match="Unknown interpolant"):
            mod.get_interpolant("nope")
        with pytest.raises(TypeError):
            mod.get_interpolant(1)
        with pytest.raises(TypeError):
            mod.resolve_interpolant(1.0)
    with pytest.raises(ValueError, match="Unknown diffusion form"):
        ti.LinearInterpolant().compute_diffusion(torch.zeros(2, 2), torch.ones(2) * 0.5, "nope")
