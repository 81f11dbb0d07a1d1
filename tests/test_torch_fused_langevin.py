"""Parity of the port's whole-chain Langevin kernels with the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX Pallas kernels' injected-noise path in interpret mode
on the same numpy inputs, at atol 1e-5 (float32, the tolerance of
tests/ops/test_chain_parity.py). The Philox twin is checked against the
Random123 known-answer vectors. The CUDA kernels themselves are held against
the plain versions in tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torchebm_tpu.ops import fused_langevin as jfl
from torchebm_tpu_torch.ops import _build
from torchebm_tpu_torch.ops import fused_langevin as tfl

torch.set_num_threads(1)

ATOL = 1e-5
N_CHAINS = 37  # not a multiple of any block size


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _schedule(rng, n_steps, lo, hi):
    return rng.uniform(lo, hi, n_steps).astype(np.float32)


def _jax(a):
    return a if isinstance(a, float) else jnp.asarray(a)


def _torch(a):
    return a if isinstance(a, float) else torch.from_numpy(a)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


# (d, K, n_steps, thin, schedule, clamp, log_weights, precision)
MIXTURE_CASES = [
    pytest.param(2, 8, 12, None, False, None, True, False, id="8gauss-const"),
    pytest.param(3, 4, 11, None, False, (-1.5, 1.5), False, False, id="d3-clamp-uniform-w"),
    pytest.param(2, 3, 10, None, True, None, True, False, id="sched"),
    pytest.param(3, 1, 10, None, False, None, False, True, id="precision-d3"),
    pytest.param(2, 8, 17, 3, False, (-3.0, 3.0), True, False, id="traj-thin3-rem2-clamp"),
    pytest.param(3, 1, 14, 4, True, None, False, True, id="traj-sched-precision"),
]


@pytest.mark.parametrize("d, k, n_steps, thin, sched, clamp, weights, precision", MIXTURE_CASES)
def test_mixture_chain_plain_matches_jax_interpret(d, k, n_steps, thin, sched, clamp,
                                                   weights, precision):
    rng = _rng(1000 * n_steps + 10 * d + k)
    x0 = _normal(rng, N_CHAINS, d)
    means = _normal(rng, k, d, scale=2.0)
    noise = _normal(rng, n_steps, N_CHAINS, d)
    h = _schedule(rng, n_steps, 0.01, 0.05) if sched else 0.03
    ns = _schedule(rng, n_steps, 0.5, 1.0) if sched else 0.8
    kw_np = dict(scale=0.9, clamp=clamp)
    if weights:
        w = rng.uniform(0.5, 2.0, k)
        kw_np["log_weights"] = np.log(w / w.sum()).astype(np.float32)
    if precision:
        a = _normal(rng, d, d, scale=0.3)
        kw_np["precision"] = (a @ a.T + np.eye(d)).astype(np.float32)

    jkw = {key: _jax(v) if isinstance(v, np.ndarray) else v for key, v in kw_np.items()}
    tkw = {key: _torch(v) if isinstance(v, np.ndarray) else v for key, v in kw_np.items()}
    jargs = (jnp.asarray(x0), jnp.asarray(means), n_steps, _jax(h), _jax(ns))
    counts = tfl.launch_counts()
    targs = (torch.from_numpy(x0), torch.from_numpy(means), n_steps, _torch(h), _torch(ns))
    if thin is None:
        ref = jfl.mixture_langevin_chain(
            *jargs, noise=jnp.asarray(noise), interpret=True, **jkw
        )
        out = tfl.mixture_langevin_chain(*targs, noise=torch.from_numpy(noise), **tkw)
        _close(out, ref)
    else:
        ref_traj, ref_final = jfl.mixture_langevin_chain_trajectory(
            *jargs, thin=thin, noise=jnp.asarray(noise), interpret=True, **jkw
        )
        traj, final = tfl.mixture_langevin_chain_trajectory(
            *targs, thin=thin, noise=torch.from_numpy(noise), **tkw
        )
        assert traj.shape == (n_steps // thin, N_CHAINS, d)
        _close(traj, ref_traj)
        _close(final, ref_final)
    assert tfl.launch_counts() == counts  # the CPU path launches no kernel


# (shape, n_steps, thin, schedule, clamp)
DOUBLEWELL_CASES = [
    pytest.param((N_CHAINS, 3), 17, None, False, (-1.5, 1.5), id="const-clamp"),
    pytest.param((N_CHAINS, 2), 13, None, True, None, id="sched"),
    pytest.param((N_CHAINS, 3), 17, 3, False, None, id="traj-thin3-rem2"),
    pytest.param((5, 4, 3), 16, 5, True, (-1.2, 1.2), id="traj-sched-clamp-3d"),
]


@pytest.mark.parametrize("shape, n_steps, thin, sched, clamp", DOUBLEWELL_CASES)
def test_doublewell_chain_plain_matches_jax_interpret(shape, n_steps, thin, sched, clamp):
    rng = _rng(100 * n_steps + len(shape))
    x0 = _normal(rng, *shape)
    noise = _normal(rng, n_steps, *shape)
    h = _schedule(rng, n_steps, 0.005, 0.02) if sched else 0.01
    ns = _schedule(rng, n_steps, 0.5, 1.0) if sched else 0.8
    kw = dict(barrier_height=1.5, b=0.9, clamp=clamp)
    jargs = (jnp.asarray(x0), n_steps, _jax(h), _jax(ns))
    targs = (torch.from_numpy(x0), n_steps, _torch(h), _torch(ns))
    if thin is None:
        ref = jfl.doublewell_langevin_chain(
            *jargs, noise=jnp.asarray(noise), interpret=True, **kw
        )
        _close(tfl.doublewell_langevin_chain(*targs, noise=torch.from_numpy(noise), **kw), ref)
    else:
        ref_traj, ref_final = jfl.doublewell_langevin_chain_trajectory(
            *jargs, thin=thin, noise=jnp.asarray(noise), interpret=True, **kw
        )
        traj, final = tfl.doublewell_langevin_chain_trajectory(
            *targs, thin=thin, noise=torch.from_numpy(noise), **kw
        )
        assert traj.shape == (n_steps // thin, *shape)
        _close(traj, ref_traj)
        _close(final, ref_final)


# ------------------------------------------------------------------ Philox


M32 = 0xFFFFFFFF


@pytest.mark.parametrize(
    "ctr, key, expected",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ],
)
def test_philox_known_answers(ctr, key, expected):
    """Random123's Philox4x32-10 known-answer vectors, on int64 tensors."""
    words = [torch.tensor([c], dtype=torch.int64) for c in ctr]
    out = tfl.philox4x32_10(*words, *key)
    assert tuple(int(o) for o in out) == expected


def test_philox_normals_are_standard_and_keyed():
    index = torch.arange(50_000)
    z = tfl.philox_normals(index, step=3, n_coords=6, seed=(7 << 32) | 11)
    assert z.shape == (50_000, 6) and z.dtype == torch.float32
    # 4-sigma bounds for the mean and variance of 300k normals
    assert abs(float(z.mean())) < 4 / np.sqrt(z.numel())
    assert abs(float(z.var()) - 1.0) < 4 * np.sqrt(2 / z.numel())
    corr = np.corrcoef(z.numpy().T)
    assert np.max(np.abs(corr - np.eye(6))) < 0.03
    # the stream depends on the step and on both halves of the seed
    again = tfl.philox_normals(index[:8], step=3, n_coords=6, seed=(7 << 32) | 11)
    torch.testing.assert_close(again, z[:8], rtol=0, atol=0)
    for step, seed in ((4, (7 << 32) | 11), (3, (8 << 32) | 11), (3, (7 << 32) | 12)):
        other = tfl.philox_normals(index[:8], step=step, n_coords=6, seed=seed)
        assert not torch.equal(other, z[:8])


def test_plain_philox_chain_is_reproducible_and_seeded():
    x0 = torch.zeros(64, 2)
    means = torch.tensor([[1.0, 0.0], [-1.0, 0.0]])
    a = tfl.mixture_langevin_chain(x0, means, 5, 0.05, seed=123)
    b = tfl.mixture_langevin_chain(x0, means, 5, 0.05, seed=123)
    c = tfl.mixture_langevin_chain(x0, means, 5, 0.05, seed=124)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


# ------------------------------------------------------------------ guards


def test_wrappers_reject_bad_inputs():
    x0 = torch.zeros(8, 2)
    means = torch.zeros(3, 2)
    with pytest.raises(TypeError, match="float32"):
        tfl.mixture_langevin_chain(x0.double(), means, 2, 0.1)
    with pytest.raises(ValueError, match="noise must have shape"):
        tfl.mixture_langevin_chain(x0, means, 2, 0.1, noise=torch.zeros(3, 8, 2))
    with pytest.raises(ValueError, match="means must have shape"):
        tfl.mixture_langevin_chain(x0, torch.zeros(3, 5), 2, 0.1)
    with pytest.raises(ValueError, match="supported sizes"):
        tfl.mixture_langevin_chain(torch.zeros(4, 65), torch.zeros(1, 65), 2, 0.1)
    with pytest.raises(ValueError, match="precision= requires"):
        tfl.mixture_langevin_chain(x0, means, 2, 0.1, precision=torch.eye(2))
    with pytest.raises(ValueError, match="d=33"):
        tfl.mixture_langevin_chain(
            torch.zeros(4, 33), torch.zeros(1, 33), 2, 0.1, precision=torch.eye(33)
        )
    with pytest.raises(ValueError, match="per-step schedule"):
        tfl.mixture_langevin_chain(x0, means, 2, torch.full((3,), 0.1))
    with pytest.raises(ValueError, match="thin"):
        tfl.doublewell_langevin_chain_trajectory(x0, 3, 0.1, thin=4)
    with pytest.raises(ValueError, match="contiguous"):
        tfl.doublewell_langevin_chain(torch.zeros(2, 8).T, 3, 0.1)
    with pytest.raises(ValueError, match="only CPU"):
        tfl.doublewell_langevin_chain(torch.zeros(4, device="meta"), 3, 0.1)


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library()


def test_library_path_is_keyed_by_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("torchebm_kernels_") and path.suffix == ".so"
    assert path == _build.library_path()
