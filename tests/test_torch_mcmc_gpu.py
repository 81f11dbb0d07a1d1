"""The port's RMHMC and NUTS on the card, against HMC's loop and the CPU port.

Marked ``gpu``; they skip without a CUDA device. This file imports neither
JAX nor the JAX package (the card's machine has no JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mcmc_gpu.py -m gpu

- RMHMC with the identity metric draws the normals and uniforms that
  ``HamiltonianMonteCarlo(fused="off")`` draws from one generator seed and
  computes the same trajectory, so the two agree to 1e-5 on the card.
- One NUTS transition and one RMHMC transition on the card and on the CPU
  port, fed the same injected draws (numpy, from a seed): every chain's
  tree depth and divergence flag equal, positions and accept statistics
  within 1e-5.
"""

import numpy as np
import pytest
import torch

from torchebm_tpu_torch.core import GaussianEnergy
from torchebm_tpu_torch.samplers import (
    HamiltonianMonteCarlo,
    NoUTurnSampler,
    RiemannianManifoldHMC,
)

ATOL = 1e-5
COV = [[1.0, 0.8], [0.8, 1.0]]

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _corr(dev):
    return GaussianEnergy.create(torch.zeros(2), torch.tensor(COV)).to(dev)


def _identity(x):
    d = x.shape[-1]
    return torch.eye(d, dtype=x.dtype, device=x.device).expand(x.shape[0], d, d)


def _radial(x):
    d = x.shape[-1]
    scale = 1.0 + torch.sum(x**2, -1)[..., None, None]
    return scale * torch.eye(d, dtype=x.dtype, device=x.device).expand(x.shape[0], d, d)


def test_identity_rmhmc_equals_hmc_loop_on_the_card(cuda):
    kw = dict(step_size=0.3, n_leapfrog_steps=5)
    rm = RiemannianManifoldHMC(_corr(cuda), metric_fn=_identity, **kw)
    hmc = HamiltonianMonteCarlo(_corr(cuda), fused="off", **kw)
    a = rm.sample(torch.Generator(cuda).manual_seed(3), dim=2, n_samples=4096, n_steps=20,
                  return_trajectory=True)
    b = hmc.sample(torch.Generator(cuda).manual_seed(3), dim=2, n_samples=4096, n_steps=20,
                   return_trajectory=True)
    assert float((a - b).abs().max()) <= ATOL


@pytest.mark.parametrize("metric", [_identity, _radial], ids=["identity", "radial"])
def test_rmhmc_transition_card_equals_cpu(cuda, metric):
    rng = np.random.default_rng(0)
    n = 1024
    x0, z = (rng.standard_normal((n, 2)).astype(np.float32) for _ in range(2))
    u = rng.random(n).astype(np.float32)
    out = []
    for dev in (torch.device("cpu"), cuda):
        rm = RiemannianManifoldHMC(_corr(dev), metric_fn=metric, step_size=0.3,
                                   n_leapfrog_steps=4)
        out.append(rm._transition(torch.tensor(x0, device=dev), None, 0.3, {},
                                  noise=torch.tensor(z, device=dev),
                                  uniforms=torch.tensor(u, device=dev)))
    (x_c, acc_c), (x_g, acc_g) = out
    assert float((x_g.cpu() - x_c).abs().max()) <= ATOL
    assert abs(float(acc_g) - float(acc_c)) <= ATOL


@pytest.mark.parametrize("mass", [None, [1.5, 0.7]], ids=["unit", "diag"])
def test_nuts_transition_card_equals_cpu(cuda, mass):
    rng = np.random.default_rng(1)
    n, depth = 256, 6
    draws = {
        "momentum": rng.standard_normal((n, 2)).astype(np.float32),
        "direction": rng.random((n, depth)) < 0.5,
        "leaf": rng.random((n, depth, 2 ** (depth - 1))).astype(np.float32),
        "merge": rng.random((n, depth)).astype(np.float32),
    }
    x0 = rng.standard_normal((n, 2)).astype(np.float32)
    out = []
    for dev in (torch.device("cpu"), cuda):
        nuts = NoUTurnSampler(_corr(dev), step_size=0.3, max_tree_depth=depth,
                              mass=None if mass is None else torch.tensor(mass, device=dev))
        out.append([t.cpu() for t in nuts._transition(
            torch.tensor(x0, device=dev), None, torch.tensor(0.3), {},
            draws={k: torch.tensor(v, device=dev) for k, v in draws.items()})])
    (x_c, acc_c, depth_c, div_c), (x_g, acc_g, depth_g, div_g) = out
    assert torch.equal(depth_g, depth_c) and torch.equal(div_g, div_c)
    assert float((x_g - x_c).abs().max()) <= ATOL
    assert float((acc_g - acc_c).abs().max()) <= ATOL
    assert len(set(depth_c.tolist())) > 1
