"""The port's NUTS→HMC trajectory tuning (``tune_trajectory_length``).

The counterpart of ``tests/samplers/test_tuning.py``: the three phases
return ``n_leapfrog = max(2, round(2^depth))`` for the pilot's mean depth, a
finite Python float step, the warmed chains and, with ``adapt_mass``, a
``(d,)`` mass; the handoff's HMC configuration is one the whole-run HMC
kernel takes (here its plain version, through ``fused="force"``). The JAX
call runs beside it on the same target, and both land on trajectory
lengths within the same bounds (the streams differ, so not number for
number). That comparison and the moment test of the handoff are marked
``slow``.
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
from torchebm_tpu_torch.ops import fused_hmc as thmc

torch.set_num_threads(1)

COV = [[1.0, 0.8], [0.8, 1.0]]
SMALL = dict(dim=2, n_samples=32, n_warmup=40, n_pilot=20, max_tree_depth=5)


def _corr():
    return tcore.GaussianEnergy.create(torch.zeros(2), torch.tensor(COV))


def test_returns_the_pilot_depth_and_a_finite_step():
    t = ts.tune_trajectory_length(torch.Generator().manual_seed(0), _corr(), **SMALL)
    assert isinstance(t, ts.TrajectoryTuning)
    assert t.n_leapfrog == max(2, int(round(2.0 ** t.mean_tree_depth)))
    assert 2 <= t.n_leapfrog <= 2 ** 5 and 0.0 < t.mean_tree_depth <= 5.0
    assert isinstance(t.step_size, float) and np.isfinite(t.step_size) and t.step_size > 0
    assert t.x.shape == (32, 2) and torch.isfinite(t.x).all()
    assert t.mass is None
    # seeded: the same generator seed gives the same tuning
    again = ts.tune_trajectory_length(torch.Generator().manual_seed(0), _corr(), **SMALL)
    assert (again.n_leapfrog, again.step_size, again.mean_tree_depth) == (
        t.n_leapfrog, t.step_size, t.mean_tree_depth)
    assert torch.equal(again.x, t.x)


def test_n_leapfrog_is_the_rounded_power_of_the_pilot_depth(monkeypatch):
    """The pilot's per-draw mean depths are read once, averaged over the
    draws and rounded as ``max(2, round(2^depth))``."""
    seen = {}
    original = ts.NoUTurnSampler.sample

    def pilot(self, *a, **kw):
        out = original(self, *a, **kw)
        if kw.get("return_diagnostics"):
            seen["depths"] = out[1]["tree_depth"].clone()
        return out

    monkeypatch.setattr(ts.NoUTurnSampler, "sample", pilot)
    t = ts.tune_trajectory_length(torch.Generator().manual_seed(1), _corr(), **SMALL)
    depth = float(torch.mean(seen["depths"]))
    assert seen["depths"].shape == (SMALL["n_pilot"],)
    assert t.mean_tree_depth == depth
    assert t.n_leapfrog == max(2, int(round(2.0 ** depth)))


def test_adapt_mass_gives_a_diagonal_mass_the_kernel_takes(monkeypatch):
    t = ts.tune_trajectory_length(torch.Generator().manual_seed(2), _corr(), adapt_mass=True,
                                  **SMALL)
    assert t.mass is not None and t.mass.shape == (2,) and bool((t.mass > 0).all())
    calls = []
    original = thmc.mixture_hmc_chain_trajectory

    def counted(*a, **kw):
        calls.append(kw["mass"])
        return original(*a, **kw)

    counted.launches = 0  # the wrapper adds its launches to the module's name
    monkeypatch.setattr(thmc, "mixture_hmc_chain_trajectory", counted)
    hmc = ts.HamiltonianMonteCarlo(_corr(), step_size=t.step_size, n_leapfrog_steps=t.n_leapfrog,
                                   mass=t.mass, fused="force")
    traj = hmc.sample(torch.Generator().manual_seed(3), x=t.x, n_steps=8, thin=2,
                      return_trajectory=True)
    assert len(calls) == 1 and calls[0] is t.mass
    assert traj.shape == (32, 4, 2) and torch.isfinite(traj).all()


@pytest.mark.slow
def test_jax_and_port_find_trajectories_in_the_same_range():
    """The JAX call and the port's on one target and settings: both give
    ``n_leapfrog`` from their own pilot depth, within [2, 2^D], and step
    sizes in the same band."""
    kw = dict(SMALL)
    jt = js.tune_trajectory_length(
        jax.random.PRNGKey(0), jcore.GaussianEnergy.create(jnp.zeros(2), jnp.asarray(COV)), **kw)
    tt = ts.tune_trajectory_length(torch.Generator().manual_seed(0), _corr(), **kw)
    for t in (jt, tt):
        assert t.n_leapfrog == max(2, int(round(2.0 ** t.mean_tree_depth)))
        assert 2 <= t.n_leapfrog <= 2 ** kw["max_tree_depth"]
        assert 0.05 < float(t.step_size) < 2.0
    assert abs(jt.mean_tree_depth - tt.mean_tree_depth) < 1.0


@pytest.mark.slow
def test_handoff_hmc_explores_target():
    t = ts.tune_trajectory_length(torch.Generator().manual_seed(4), _corr(), dim=2, n_samples=64,
                                  n_warmup=150, n_pilot=60, max_tree_depth=6)
    hmc = ts.HamiltonianMonteCarlo(_corr(), step_size=t.step_size, n_leapfrog_steps=t.n_leapfrog,
                                   fused="off")
    traj, diag = hmc.sample(torch.Generator().manual_seed(5), x=t.x, n_steps=300,
                            return_trajectory=True, return_diagnostics=True)
    assert 0.5 < float(diag["acceptance_rate"][-1]) <= 1.0
    assert float(ts.summarize_chains(traj)["ess"].min()) > 64 * 0.5
    cov = torch.cov(traj.reshape(-1, 2).T)
    assert abs(float(cov[0, 1]) - 0.8) < 0.15
