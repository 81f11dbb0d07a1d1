"""The port's R̂/ESS diagnostics against the JAX package.

Every function and option is fed the same numpy trajectories on both sides
and compared at rtol 1e-5 (float32; both sides sort, rank and FFT the same
draws, so they differ by summation order only).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torchebm_tpu.samplers import diagnostics as jd
from torchebm_tpu_torch.samplers import diagnostics as td

torch.set_num_threads(1)

RTOL = 1e-5


def _trajectory(shape, seed, ar=0.0):
    """``(chains, draws, dim)`` (or 2-D) float32 draws; ``ar`` makes an AR(1)
    chain with that coefficient, so the autocorrelations are not trivial."""
    rng = np.random.default_rng(seed)
    eps = rng.standard_normal(shape).astype(np.float32)
    if ar:
        for t in range(1, shape[1]):
            eps[:, t] = ar * eps[:, t - 1] + eps[:, t]
    return eps


TRAJECTORIES = [
    pytest.param((4, 101, 3), 0.7, id="ar-odd-draws"),
    pytest.param((6, 80, 2), -0.4, id="antithetic"),
    pytest.param((3, 64, 2), 0.0, id="iid"),
    pytest.param((1, 64, 2), 0.5, id="one-chain"),
    pytest.param((5, 50), 0.3, id="2d-input"),
]


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("shape, ar", TRAJECTORIES)
@pytest.mark.parametrize("split", [True, False], ids=["split", "whole"])
@pytest.mark.parametrize("rank", [False, True], ids=["raw", "rank"])
def test_rhat_and_ess_equal_jax(shape, ar, split, rank):
    x = _trajectory(shape, seed=len(shape) * 100 + shape[1], ar=ar)
    for name in ("potential_scale_reduction", "effective_sample_size"):
        ref = getattr(jd, name)(jnp.asarray(x), split=split, rank_normalized=rank)
        out = getattr(td, name)(torch.from_numpy(x), split=split, rank_normalized=rank)
        assert out.shape == (x.shape[-1] if x.ndim == 3 else 1,)
        _close(out, ref)


@pytest.mark.parametrize("shape, ar", TRAJECTORIES)
@pytest.mark.parametrize("split", [True, False], ids=["split", "whole"])
def test_tail_ess_equals_jax(shape, ar, split):
    x = _trajectory(shape, seed=7 + shape[1], ar=ar)
    _close(td.tail_effective_sample_size(torch.from_numpy(x), split=split),
           jd.tail_effective_sample_size(jnp.asarray(x), split=split))


@pytest.mark.parametrize("rank", [False, True])
def test_summarize_chains_equals_jax(rank):
    x = _trajectory((4, 90, 2), seed=11, ar=0.6)
    ref = jd.summarize_chains(jnp.asarray(x), rank_normalized=rank)
    out = td.summarize_chains(torch.from_numpy(x), rank_normalized=rank)
    assert set(out) == set(ref)
    for k, v in ref.items():
        if isinstance(v, int):
            assert out[k] == v
        else:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(v), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("n", [10, 11, 4])
def test_quantile_and_median_follow_numpy(n):
    """The even-count median averages the two middle values, as ``jnp.median``
    does and ``torch.median`` does not."""
    x = np.random.default_rng(n).standard_normal((n, 3)).astype(np.float32)
    t = torch.from_numpy(x)
    for q in (0.05, 0.5, 0.95):
        np.testing.assert_allclose(td._quantile(t, q).numpy(),
                                   np.asarray(jnp.quantile(jnp.asarray(x), q, axis=0)),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(td._quantile(t, 0.5).numpy(), np.median(x, axis=0), rtol=1e-6)
    if n % 2 == 0:
        assert not torch.equal(td._quantile(t, 0.5), torch.median(t, dim=0).values)


def test_quantile_takes_inputs_beyond_the_torch_quantile_limit():
    """10,000 chains x 1,000 draws pool 1e7 draws per dimension and 2e7 in
    all; ``torch.quantile`` refuses a column of more than 2^24 draws, the
    sort-based helper does not."""
    x = torch.rand((2**24 + 5, 1), generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(x[:, 0], 0.5)
    med = td._quantile(x, 0.5)
    np.testing.assert_allclose(med.numpy(), np.median(x.numpy(), axis=0), rtol=1e-6)


def test_converged_and_stuck_chains_are_told_apart():
    ok = torch.from_numpy(_trajectory((8, 200, 2), seed=1))
    stuck = ok + torch.arange(8.0)[:, None, None]  # chains disagree in location
    assert torch.all(td.potential_scale_reduction(ok) < 1.05)
    assert torch.all(td.potential_scale_reduction(stuck) > 1.5)
    assert torch.all(td.effective_sample_size(ok) > 800)
