"""The port's generalised leapfrog and Riemannian-manifold HMC against the JAX package.

- ``GeneralisedLeapfrogIntegrator.integrate`` on a non-separable
  Hamiltonian, number for number against the JAX integrator from one numpy
  state, with the Picard stop off and on (``solver_check_every`` 0 and 1, a
  tolerance that stops early and one that does not), at atol 1e-5; on a
  separable Hamiltonian it equals ``LeapfrogIntegrator`` (the counterpart of
  ``tests/integrators/test_leapfrog.py:69-102``).
- One RMHMC ``step`` against JAX's ``step(carry, i, key, {})``: the port's
  injected path takes the momentum normals ``normal(split(key)[0])`` and the
  Metropolis uniforms ``uniform(split(key)[1])`` drawn here with
  ``jax.random``; positions and acceptance at atol 1e-5, for the identity
  metric and for G(x) = (1 + |x|²)·I.
- NaN and Inf proposals are rejected; with the identity metric RMHMC draws
  and computes what HMC's loop does from one generator seed.
- The moment test of ``tests/samplers/test_rmhmc_moments.py:102-120`` is
  marked ``slow``, as the reference marks it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchebm_tpu import core as jcore
from torchebm_tpu import integrators as ji
from torchebm_tpu import samplers as js
from torchebm_tpu_torch import core as tcore
from torchebm_tpu_torch import integrators as ti
from torchebm_tpu_torch import samplers as ts
from torchebm_tpu_torch.utils import energy_from_arrays, sampler_from_fields

torch.set_num_threads(1)

ATOL = 1e-5
MEAN = np.array([1.0, -0.5], np.float32)
COV = np.array([[1.0, 0.6], [0.6, 1.5]], np.float32)


def _gaussians(mean=MEAN, cov=COV):
    j = jcore.GaussianEnergy.create(jnp.asarray(mean), jnp.asarray(cov))
    t = energy_from_arrays("GaussianEnergy", {"mean": mean, "cov": cov,
                                              "cov_inv": np.linalg.inv(cov)})
    return j, t


def _state(seed, shape, scale=0.5):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(shape)).astype(np.float32) for _ in range(2)]


# -------------------------------------------------------- generalised leapfrog


def _toy(lib):
    """The 1-D non-separable toy of ``tests/integrators/test_leapfrog.py``:
    H = x²/2 + p²/(2M) + log(M)/2 with M(x) = 1 + x², elementwise."""
    def force(x, p, t):
        inv_m = 1.0 / (1.0 + x**2)
        return -(x + 0.5 * p**2 * (-2.0 * x * inv_m**2) + 0.5 * 2.0 * x * inv_m)

    def velocity(x, p, t):
        return p / (1.0 + x**2)

    return force, velocity


@pytest.mark.parametrize("check_every, tol, safe", [
    (0, 1e-6, False), (1, 1e-6, False), (1, 1e-3, False), (0, 1e-6, True), (1, 1e-3, True),
], ids=["fixed", "check-tight", "check-early-stop", "fixed-safe", "check-safe"])
def test_generalised_leapfrog_integrate_equals_jax(check_every, tol, safe):
    x, p = _state(0, (8, 2), scale=1.0)
    kw = dict(solver_max_iter=8, solver_tol=tol, solver_check_every=check_every)
    jf, jv = _toy(jnp)
    tf, tv = _toy(torch)
    want = ji.GeneralisedLeapfrogIntegrator(**kw).integrate(
        {"x": jnp.asarray(x), "p": jnp.asarray(p)}, 0.1, 20, force=jf, velocity=jv, safe=safe)
    got = ti.GeneralisedLeapfrogIntegrator(**kw).integrate(
        {"x": torch.tensor(x), "p": torch.tensor(p)}, 0.1, 20, force=tf, velocity=tv, safe=safe)
    for k in ("x", "p"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0)


def test_picard_stop_freezes_on_the_device():
    """With the check on, the iterate stops changing at the first update
    whose RMS change is at most the tolerance, as the JAX loop stops; a
    count of the updates shows that every one of them still runs."""
    gl = ti.GeneralisedLeapfrogIntegrator(solver_max_iter=6, solver_tol=1.5,
                                          solver_check_every=1)
    calls = []

    def update(y):
        calls.append(y)
        return y * 0.5

    # iterates 8, 4, 2, 1: the change 1 <= 1.5 stops the loop at 1, and the
    # two updates left still run, frozen
    y = gl._picard(torch.full((4,), 16.0), update)
    assert len(calls) == 6
    assert torch.equal(y, torch.full((4,), 1.0))
    assert torch.equal(ti.GeneralisedLeapfrogIntegrator(solver_max_iter=3)._picard(
        torch.full((2,), 16.0), lambda y: y * 0.5), torch.full((2,), 2.0))


def test_generalised_reduces_to_separable():
    x, p = _state(1, (8, 2), scale=1.0)
    x, p = torch.tensor(x), torch.tensor(p)
    a = ti.LeapfrogIntegrator().integrate({"x": x, "p": p}, 0.02, 50, drift=lambda x, t: -x)
    b = ti.GeneralisedLeapfrogIntegrator().integrate(
        {"x": x, "p": p}, 0.02, 50, force=lambda x, p, t: -x, velocity=lambda x, p, t: p)
    for k in ("x", "p"):
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=ATOL, rtol=0)


def test_generalised_leapfrog_validation_and_registry():
    with pytest.raises(ValueError, match="solver_max_iter"):
        ti.GeneralisedLeapfrogIntegrator(solver_max_iter=0)
    gl = ti.GeneralisedLeapfrogIntegrator()
    state = {"x": torch.ones((1, 1)), "p": torch.ones((1, 1))}
    with pytest.raises(ValueError, match="n_steps"):
        gl.integrate(state, 0.1, 0, force=lambda x, p, t: -x, velocity=lambda x, p, t: p)
    assert gl.family == "symplectic" and not gl.separable
    for name in ("generalised_leapfrog", "generalized_leapfrog", "Generalised_Leapfrog"):
        assert type(ti.get_integrator(name)) is ti.GeneralisedLeapfrogIntegrator


# -------------------------------------------------------------------- RMHMC


def _identity(lib):
    def metric(x):
        d = x.shape[-1]
        if lib is jnp:
            return jnp.broadcast_to(jnp.eye(d), (x.shape[0], d, d))
        return torch.eye(d, dtype=x.dtype, device=x.device).expand(x.shape[0], d, d)
    return metric


def _radial(lib):
    """G(x) = (1 + |x|²)·I, the metric of ``test_rmhmc_moments.py:102-120``."""
    def metric(x):
        d = x.shape[-1]
        scale = 1.0 + lib.sum(x**2, -1)[..., None, None]
        if lib is jnp:
            return scale * jnp.broadcast_to(jnp.eye(d), (x.shape[0], d, d))
        return scale * torch.eye(d, dtype=x.dtype, device=x.device).expand(x.shape[0], d, d)
    return metric


@pytest.mark.parametrize("metric", [_identity, _radial], ids=["identity", "radial"])
def test_rmhmc_step_equals_jax(metric):
    step = 1.0
    je, te = _gaussians()
    n = 16
    x0 = _state(2, (n, 2), scale=1.5)[0]
    jr = js.RiemannianManifoldHMC(je, metric_fn=metric(jnp), step_size=step,
                                  n_leapfrog_steps=4)
    tr = ts.RiemannianManifoldHMC(te, metric_fn=metric(torch), step_size=step,
                                  n_leapfrog_steps=4)
    key = jax.random.PRNGKey(7)
    carry = jr.init_carry(jnp.asarray(x0), key, {})
    want = jr.step(carry, 0, key, {})
    k_mom, k_acc = jax.random.split(key)
    z = np.asarray(jax.random.normal(k_mom, (n, 2)))
    u = np.asarray(jax.random.uniform(k_acc, (n,)))
    x, acc = tr._transition(torch.tensor(x0), None, tcore.sched_value(step, 0), {},
                            noise=torch.tensor(z), uniforms=torch.tensor(u))
    np.testing.assert_allclose(x.numpy(), np.asarray(want["x"]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(acc), float(want["accept_rate"]), atol=ATOL)
    # chains moved and chains stayed, so both sides of the test are held
    moved = np.any(np.asarray(want["x"]) != x0, axis=-1)
    assert 0 < moved.sum() < n


@pytest.mark.parametrize("metric", [_identity, _radial], ids=["identity", "radial"])
def test_rmhmc_hamiltonian_and_force_equal_jax(metric):
    je, te = _gaussians()
    x, p = _state(3, (16, 2), scale=1.2)
    jr = js.RiemannianManifoldHMC(je, metric_fn=metric(jnp))
    tr = ts.RiemannianManifoldHMC(te, metric_fn=metric(torch))
    jx, jp, tx, tp = jnp.asarray(x), jnp.asarray(p), torch.tensor(x), torch.tensor(p)
    for got, want in ((tr._hamiltonian(tx, tp, {}), jr._hamiltonian(jx, jp, {})),
                      (tr._force(tx, tp, {}), jr._force(jx, jp, {})),
                      (tr._velocity(tx, tp), jr._velocity(jx, jp))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-6)


def test_rmhmc_rejects_nan_and_inf_proposals():
    """An energy that is NaN beyond x₀ = 2 and +∞ below x₀ = -2: every proposal
    that lands there is rejected with acceptance probability 0."""
    def fn(x):
        e = 0.5 * torch.sum(x * x, dim=-1)
        e = torch.where(x[:, 0] > 2.0, torch.full_like(e, float("nan")), e)
        return torch.where(x[:, 0] < -2.0, torch.full_like(e, float("inf")), e)

    energy = tcore.as_energy(fn)
    rm = ts.RiemannianManifoldHMC(energy, metric_fn=_identity(torch), step_size=0.9,
                                  n_leapfrog_steps=3)
    x0 = torch.tensor([[1.9, 0.0], [-1.9, 0.0], [0.0, 0.0], [1.8, 0.3]])
    noise = torch.tensor([[3.0, 0.0], [-3.0, 0.0], [0.1, 0.1], [2.5, 0.0]])
    x, acc = rm._transition(x0, None, 0.9, {}, noise=noise, uniforms=torch.zeros(4))
    assert torch.isfinite(x).all()
    # the chains pushed past ±2 stay where they were, the centre one moves
    assert torch.equal(x[[0, 1, 3]], x0[[0, 1, 3]])
    assert not torch.equal(x[2], x0[2])
    assert float(acc) <= 0.25 + 1e-6


def test_identity_rmhmc_equals_hmc_loop():
    """From one generator seed, RMHMC with the identity metric and HMC's
    generic loop (unit mass) draw the same numbers and agree to 1e-5."""
    _, te = _gaussians()
    kw = dict(step_size=0.3, n_leapfrog_steps=5)
    rm = ts.RiemannianManifoldHMC(te, metric_fn=_identity(torch), **kw)
    hmc = ts.HamiltonianMonteCarlo(te, fused="off", **kw)
    a, da = rm.sample(torch.Generator().manual_seed(3), dim=2, n_samples=64, n_steps=20,
                      return_trajectory=True, return_diagnostics=True)
    b, db = hmc.sample(torch.Generator().manual_seed(3), dim=2, n_samples=64, n_steps=20,
                       return_trajectory=True, return_diagnostics=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(da["acceptance_rate"].numpy(), db["acceptance_rate"].numpy(),
                               atol=ATOL)


def test_rmhmc_validation():
    _, te = _gaussians()
    with pytest.raises(TypeError, match="metric_fn"):
        ts.RiemannianManifoldHMC(te)
    with pytest.raises(TypeError, match="non-separable"):
        ts.RiemannianManifoldHMC(te, metric_fn=_identity(torch), integrator="leapfrog")
    with pytest.raises(ValueError, match="n_leapfrog_steps"):
        ts.RiemannianManifoldHMC(te, metric_fn=_identity(torch), n_leapfrog_steps=0)
    with pytest.raises(ValueError, match="family"):
        ts.RiemannianManifoldHMC(te, metric_fn=_identity(torch), integrator="euler")
    rm = ts.RiemannianManifoldHMC(te, metric_fn=_identity(torch),
                                  integrator=ti.GeneralisedLeapfrogIntegrator(solver_max_iter=3))
    assert rm.integrator.solver_max_iter == 3
    assert type(ts.RiemannianManifoldHMC(te, metric_fn=_identity(torch),
                                         integrator="generalized_leapfrog").integrator) \
        is ti.GeneralisedLeapfrogIntegrator


def test_sampler_from_fields_builds_rmhmc():
    je, te = _gaussians()
    fields = dict(step_size=0.25, n_leapfrog_steps=6, integrator="generalised_leapfrog")
    jr = js.RiemannianManifoldHMC(je, metric_fn=_radial(jnp), **fields)
    tr = sampler_from_fields("RiemannianManifoldHMC", dict(fields, metric_fn=_radial(torch)), te)
    assert type(tr) is ts.RiemannianManifoldHMC
    assert (tr.step_size, tr.n_leapfrog_steps) == (jr.step_size, jr.n_leapfrog_steps)
    assert type(tr.integrator).__name__ == type(jr.integrator).__name__
    out, diag = tr.sample(torch.Generator().manual_seed(0), dim=2, n_samples=8, n_steps=3,
                          return_diagnostics=True)
    assert out.shape == (8, 2) and set(diag) == {"mean", "var", "energy", "acceptance_rate"}


@pytest.mark.slow
def test_position_dependent_metric_preserves_target():
    """G(x) = (1 + |x|²)·I keeps N(0, I) invariant (the moment bounds of
    ``tests/samplers/test_rmhmc_moments.py:102-120``)."""
    rm = ts.RiemannianManifoldHMC(tcore.GaussianEnergy.standard(2), metric_fn=_radial(torch),
                                  step_size=0.15, n_leapfrog_steps=5)
    s, diag = rm.sample(torch.Generator().manual_seed(0), dim=2, n_samples=512, n_steps=600,
                        return_diagnostics=True)
    assert float(diag["acceptance_rate"][-1]) > 0.5
    np.testing.assert_allclose(s.mean(0).numpy(), np.zeros(2), atol=0.15)
    np.testing.assert_allclose(s.var(0).numpy(), np.ones(2), rtol=0.3)
