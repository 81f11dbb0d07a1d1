"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; they skip without a CUDA device. This file imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -m gpu

The tolerance is atol 1e-4 (float32): the kernels contract multiply-adds and
take the mixture softmax online in one pass, the plain versions do neither;
the chains contract at these step sizes, so rounding does not grow.
"""

import numpy as np
import pytest
import torch

from torchebm_tpu_torch.ops import fused_langevin as tfl


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _schedule(rng, n_steps, lo, hi):
    return rng.uniform(lo, hi, n_steps).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _kernel_and_plain(fn, cuda, *args, **kwargs):
    """Run ``fn`` on the card (kernel) and on the same inputs through the plain
    version on the card, checking that exactly one launch was counted."""
    before = fn.launches
    got = fn(*args, **kwargs)
    assert fn.launches == before + 1
    cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    cpu_kwargs = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in kwargs.items()}
    want = fn(*cpu_args, **cpu_kwargs)
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("inject", [True, False], ids=["noise", "philox"])
@pytest.mark.parametrize("precision", [False, True], ids=["mixture", "gaussian"])
def test_mixture_kernels_match_plain_on_card(cuda, inject, precision):
    rng = _rng(0)
    n, n_steps, d, k = 4096, 20, (32 if precision else 2), (1 if precision else 8)
    x0 = torch.from_numpy(_normal(rng, n, d)).to(cuda)
    means = torch.from_numpy(_normal(rng, k, d, scale=2.0)).to(cuda)
    kw = dict(scale=0.9, seed=99, clamp=(-4.0, 4.0))
    if precision:
        a = _normal(rng, d, d, scale=0.1)
        kw["precision"] = torch.from_numpy((a @ a.T + np.eye(d)).astype(np.float32)).to(cuda)
    if inject:
        kw["noise"] = torch.from_numpy(_normal(rng, n_steps, n, d)).to(cuda)
    sched = torch.from_numpy(_schedule(rng, n_steps, 0.01, 0.05)).to(cuda)
    got, want = _kernel_and_plain(tfl.mixture_langevin_chain, cuda, x0, means, n_steps, 0.03, **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    (gt, gf), (wt, wf) = _kernel_and_plain(
        tfl.mixture_langevin_chain_trajectory, cuda, x0, means, n_steps, sched, thin=3, **kw
    )
    torch.testing.assert_close(gt.cpu(), wt, rtol=0, atol=1e-4)
    torch.testing.assert_close(gf.cpu(), wf, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("inject", [True, False], ids=["noise", "philox"])
def test_doublewell_kernels_match_plain_on_card(cuda, inject):
    rng = _rng(1)
    shape, n_steps = (1000, 7), 20
    x0 = torch.from_numpy(_normal(rng, *shape, scale=0.5)).to(cuda)
    kw = dict(seed=5, clamp=(-2.0, 2.0))
    if inject:
        kw["noise"] = torch.from_numpy(_normal(rng, n_steps, *shape)).to(cuda)
    got, want = _kernel_and_plain(tfl.doublewell_langevin_chain, cuda, x0, n_steps, 0.01, **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    (gt, gf), (wt, wf) = _kernel_and_plain(
        tfl.doublewell_langevin_chain_trajectory, cuda, x0, n_steps, 0.01, 0.7, thin=6, **kw
    )
    torch.testing.assert_close(gt.cpu(), wt, rtol=0, atol=1e-4)
    torch.testing.assert_close(gf.cpu(), wf, rtol=0, atol=1e-4)
