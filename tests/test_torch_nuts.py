"""The port's batched NUTS against the JAX package.

- One transition against JAX's vmapped ``_transition`` and its
  ``_transition_batch`` from one key: the test draws JAX's own randomness
  (``split(key, n)``, each chain's key split into momentum and tree keys; per
  doubling ``split(·, 4)`` into direction, subtree, merge and next keys; one
  ``uniform(fold_in(key_sub, i))`` per leaf) and hands it to the port's
  ``draws=``. 16 chains, d = 2 and 3, ``max_tree_depth=4``, unit and diagonal
  mass, and a stiff target that diverges: every chain's depth and
  divergence flag equal, positions and accept statistics within 1e-5.
- ``_trailing_ones`` against the closed form of
  ``tests/samplers/test_nuts.py::test_trailing_ones_closed_form``;
  ``max_tree_depth`` outside [1, 12] is rejected.
- Reference fault R-b is not copied: the JAX sampler lets an unknown
  ``shared_kwargs`` name pass when ``model_kwargs`` is empty, the port raises.
- The statistical tests (moments, warmup acceptance) are marked ``slow``, as
  ``tests/samplers/test_nuts.py:16`` is.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchebm_tpu import core as jcore
from torchebm_tpu import samplers as js
from torchebm_tpu.samplers import nuts as jnuts
from torchebm_tpu_torch import core as tcore
from torchebm_tpu_torch import samplers as ts
from torchebm_tpu_torch.samplers import nuts as tnuts
from torchebm_tpu_torch.utils import energy_from_arrays, sampler_from_fields

torch.set_num_threads(1)

ATOL = 1e-5
N, DEPTH = 16, 4


def _gaussians(mean, cov):
    mean, cov = np.asarray(mean, np.float32), np.asarray(cov, np.float32)
    j = jcore.GaussianEnergy.create(jnp.asarray(mean), jnp.asarray(cov))
    t = energy_from_arrays("GaussianEnergy", {"mean": mean, "cov": cov,
                                              "cov_inv": np.linalg.inv(cov)})
    return j, t


@jax.jit
def _chain_draws(key_i):
    """One chain's draws, as ``NoUTurnSampler._transition`` makes them."""
    k_mom, k_tree = jax.random.split(key_i)

    def doubling(key, _):
        key_dir, key_sub, key_merge, key_next = jax.random.split(key, 4)
        leaf = jax.vmap(lambda i: jax.random.uniform(jax.random.fold_in(key_sub, i)))(
            jnp.arange(2 ** (DEPTH - 1)))
        return key_next, (jax.random.bernoulli(key_dir), leaf, jax.random.uniform(key_merge))

    _, (direction, leaf, merge) = jax.lax.scan(doubling, k_tree, None, length=DEPTH)
    return k_mom, direction, leaf, merge


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_draw_arrays(key, n, d):
    k_mom, direction, leaf, merge = jax.vmap(_chain_draws)(jax.random.split(key, n))
    momentum = jax.vmap(lambda k: jax.random.normal(k, (d,), jnp.float32))(k_mom)
    return momentum, direction, leaf, merge


def _jax_draws(key, n, d):
    """The draws of JAX's ``_transition_batch(x, key, ...)`` for ``n`` chains
    in ``d`` dimensions, as the port's ``draws=``."""
    return {k: torch.tensor(np.asarray(v)) for k, v in zip(
        ("momentum", "direction", "leaf", "merge"), _jax_draw_arrays(key, n, d))}


CASES = {
    "d2-unit": (2, [0.5, -0.5], [[1.0, 0.8], [0.8, 1.0]], None, 0.3),
    "d2-diag-mass": (2, [0.5, -0.5], [[1.0, 0.8], [0.8, 1.0]], [1.5, 0.7], 0.3),
    "d3-unit": (3, [0.0, 1.0, -1.0], [[1.0, 0.5, 0.0], [0.5, 2.0, 0.3], [0.0, 0.3, 0.5]],
                None, 0.25),
    "d3-diag-mass": (3, [0.0, 1.0, -1.0], [[1.0, 0.5, 0.0], [0.5, 2.0, 0.3], [0.0, 0.3, 0.5]],
                     [0.8, 0.5, 2.0], 0.25),
    "d2-stiff-diverging": (2, [0.0, 0.0], [[1.0, 0.0], [0.0, 1e-4]], None, 0.5),
}


def _pair(case):
    """The JAX sampler and the port's for ``case``, a start and the step."""
    d, mean, cov, mass, eps = CASES[case]
    je, te = _gaussians(mean, cov)
    jkw = dict(step_size=eps, max_tree_depth=DEPTH)
    tkw = dict(jkw)
    if mass is not None:
        jkw["mass"] = jnp.asarray(mass, jnp.float32)
        tkw["mass"] = torch.tensor(mass, dtype=torch.float32)
    x0 = (1.2 * np.random.default_rng(d).standard_normal((N, d))).astype(np.float32)
    x0 += np.asarray(mean, np.float32)
    return js.NoUTurnSampler(je, **jkw), ts.NoUTurnSampler(te, **tkw), x0, eps


@pytest.mark.parametrize("case", list(CASES))
def test_transition_equals_jax(case):
    jn, tn, x0, eps = _pair(case)
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(key, N)
    want = jax.jit(jax.vmap(lambda xi, ki: jn._transition(xi, ki, eps, {})))(
        jnp.asarray(x0), keys)
    want_x, want_acc, want_depth, want_div = (np.asarray(w) for w in want)
    got = tn._transition(torch.tensor(x0), None, tcore.sched_value(eps, 0), {},
                         draws=_jax_draws(key, N, x0.shape[1]))
    got_x, got_acc, got_depth, got_div = (g.numpy() for g in got)

    np.testing.assert_array_equal(got_depth, want_depth)
    np.testing.assert_array_equal(got_div, want_div)
    np.testing.assert_allclose(got_x, want_x, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_acc, want_acc, atol=ATOL, rtol=0)
    if case == "d2-stiff-diverging":
        assert want_div.all()
    else:
        # trees of several depths, some stopped by a U-turn before DEPTH
        assert len(set(want_depth.tolist())) > 1 and not want_div.any()


def test_transition_batch_means_equal_jax():
    """``_transition_batch`` from one key: positions and the means over
    chains (accept statistic, depth, divergence rate)."""
    jn, tn, x0, eps = _pair("d2-unit")
    key = jax.random.PRNGKey(11)
    want = jax.jit(lambda x, k: jn._transition_batch(x, k, eps, {}))(jnp.asarray(x0), key)
    got = tn._transition_batch(torch.tensor(x0), None, tcore.sched_value(eps, 0), {},
                               draws=_jax_draws(key, N, x0.shape[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=ATOL, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(float(g), float(w), atol=ATOL)


def test_trailing_ones_closed_form():
    def ref(n):
        c = 0
        while n & 1:
            n >>= 1
            c += 1
        return c

    vals = list(range(0, 4097)) + [~v for v in range(2, 4097)]
    want = np.asarray([ref(v & 0xFFFFFFFF) if v >= 0 else ref(v + (1 << 32)) for v in vals])
    got = tnuts._trailing_ones(torch.tensor(vals, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jnuts._trailing_ones)(jnp.asarray(vals, jnp.int32))), want)
    # the host's form, for the lockstep leaf indices and their complements
    assert [tnuts._trailing_ones(v) for v in vals[:4097]] == want[:4097].tolist()
    assert [tnuts._trailing_ones(~v) for v in range(2, 4097, 2)] == [
        ref(v + (1 << 32)) for v in (~np.arange(2, 4097, 2)).tolist()]


@pytest.mark.parametrize("depth", [0, 13, -1])
def test_max_tree_depth_outside_range_is_rejected(depth):
    e = tcore.GaussianEnergy.standard(2)
    with pytest.raises(ValueError, match="max_tree_depth"):
        ts.NoUTurnSampler(e, max_tree_depth=depth)
    with pytest.raises(ValueError, match="max_tree_depth"):
        js.NoUTurnSampler(jcore.GaussianEnergy.standard(2), max_tree_depth=depth)


def test_max_tree_depth_bounds_are_accepted():
    e = tcore.GaussianEnergy.standard(2)
    for depth in (1, 12):
        assert ts.NoUTurnSampler(e, max_tree_depth=depth).max_tree_depth == depth
    out, diag = ts.NoUTurnSampler(e, step_size=0.05, max_tree_depth=1).sample(
        torch.Generator().manual_seed(0), dim=2, n_samples=8, n_steps=3,
        return_diagnostics=True)
    assert torch.isfinite(out).all() and torch.all(diag["tree_depth"] == 1.0)


def test_unknown_shared_kwargs_name_raises_with_empty_model_kwargs():
    """R-b: the JAX sampler checks ``shared_kwargs`` only when ``model_kwargs``
    is not empty, so a misspelt name passes silently; the port raises."""
    def jfn(x):
        return 0.5 * jnp.sum(x * x, -1)

    jn = js.NoUTurnSampler(jcore.WrappedEnergy(fn=jfn), step_size=0.2, shared_kwargs=("typo",))
    # the JAX transition traces through its check (abstractly, no compile)
    out = jax.eval_shape(lambda x, k: jn._transition_batch(x, k, 0.2, {}),
                         jnp.zeros((4, 2)), jax.random.PRNGKey(0))
    assert out[0].shape == (4, 2)
    tn = ts.NoUTurnSampler(tcore.as_energy(lambda x: 0.5 * torch.sum(x * x, -1)),
                           step_size=0.2, shared_kwargs=("typo",))
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="shared_kwargs"):
        tn.sample(g, dim=2, n_samples=4, n_steps=2)
    with pytest.raises(ValueError, match="shared_kwargs"):
        tn.sample(g, dim=2, n_samples=4, n_steps=2, model_kwargs={"z": torch.ones(3)})
    with pytest.raises(ValueError, match="shared_kwargs"):
        tn.warmup(g, dim=2, n_samples=4, n_warmup=2)


def test_model_kwargs_pass_whole_to_the_batched_energy():
    """A (n, d) matrix whose leading dimension equals the chain count reaches
    the energy whole, pinned by ``shared_kwargs`` or not: the chains equal
    those of an energy that closes over it (the port's form of
    ``test_shared_kwargs_pins_coincident_leading_dim``)."""
    A = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, -1.0]])

    def cond(x, A):
        return 0.5 * torch.sum((x @ A.T) ** 2, dim=-1)

    kw = dict(dim=2, n_samples=4, n_steps=10)
    closed = ts.NoUTurnSampler(tcore.as_energy(lambda x: cond(x, A)), step_size=0.2).sample(
        torch.Generator().manual_seed(1), **kw)
    for shared in ((), ("A",)):
        out = ts.NoUTurnSampler(tcore.as_energy(cond), step_size=0.2,
                                shared_kwargs=shared).sample(
            torch.Generator().manual_seed(1), model_kwargs={"A": A}, **kw)
        assert torch.equal(out, closed)


def test_per_chain_kwargs_are_aligned_with_the_chains():
    """A per-chain conditioning leaf ``(n, d)`` gives each chain its own row:
    chains centred on their own rows, as the JAX sampler's vmap slices them."""
    centres = torch.tensor([[-6.0, 0.0], [6.0, 0.0], [0.0, 6.0], [0.0, -6.0]]).repeat(16, 1)
    energy = tcore.as_energy(lambda x, c: 0.5 * torch.sum((x - c) ** 2, dim=-1))
    x0 = centres.clone()
    out = ts.NoUTurnSampler(energy, step_size=0.4, max_tree_depth=5).sample(
        torch.Generator().manual_seed(2), x=x0, n_steps=30, model_kwargs={"c": centres})
    assert float((out - centres).norm(dim=-1).mean()) < 2.5


def test_contract_shapes_and_reproducible():
    nuts = ts.NoUTurnSampler(tcore.GaussianEnergy.standard(2), step_size=0.5)
    traj, diag = nuts.sample(torch.Generator().manual_seed(0), dim=2, n_samples=4, n_steps=9,
                             thin=3, return_trajectory=True, return_diagnostics=True)
    assert traj.shape == (4, 3, 2)
    assert set(diag) == {"mean", "var", "energy", "acceptance_rate", "tree_depth",
                         "divergence_rate"}
    assert diag["tree_depth"].shape == (3,)
    again = nuts.sample(torch.Generator().manual_seed(0), dim=2, n_samples=4, n_steps=9,
                        thin=3, return_trajectory=True)
    assert torch.equal(traj, again)


def test_divergences_surface_and_stay_finite():
    e = tcore.GaussianEnergy.standard(2)
    g = torch.Generator().manual_seed(3)
    out, bad = ts.NoUTurnSampler(e, step_size=50.0).sample(
        g, dim=2, n_samples=32, n_steps=10, return_diagnostics=True)
    _, ok = ts.NoUTurnSampler(e, step_size=0.3).sample(
        g, dim=2, n_samples=32, n_steps=10, return_diagnostics=True)
    assert torch.isfinite(out).all()
    assert float(bad["divergence_rate"].mean()) > 0.5
    assert float(ok["divergence_rate"].mean()) < 0.05


def test_warmup_adapt_mass_returns_a_diagonal_mass():
    nuts = ts.NoUTurnSampler(tcore.GaussianEnergy.create(torch.zeros(2),
                                                         torch.diag(torch.tensor([1.0, 9.0]))),
                             step_size=0.5, max_tree_depth=5)
    x, eps, mass = nuts.warmup(torch.Generator().manual_seed(4), dim=2, n_warmup=40,
                               n_samples=64, adapt_mass=True)
    assert isinstance(eps, float) and 0.05 < eps < 5.0
    assert x.shape == (64, 2) and mass.shape == (2,) and bool((mass > 0).all())
    assert float(mass[1]) < float(mass[0])
    out = nuts.replace(step_size=eps, mass=mass).sample(torch.Generator().manual_seed(5), x=x,
                                                       n_steps=3)
    assert torch.isfinite(out).all()


def test_sampler_from_fields_builds_nuts():
    je, te = _gaussians([0.0, 0.0], [[1.0, 0.0], [0.0, 4.0]])
    fields = dict(step_size=0.4, max_tree_depth=6, target_accept=0.7,
                  divergence_threshold=500.0, mass=np.array([1.0, 0.25], np.float32))
    jn = js.NoUTurnSampler(je, **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                  for k, v in fields.items()})
    tn = sampler_from_fields("NoUTurnSampler", fields, te)
    assert type(tn) is ts.NoUTurnSampler
    for f in ("step_size", "max_tree_depth", "target_accept", "divergence_threshold"):
        assert getattr(tn, f) == getattr(jn, f), f
    assert tn.mass.dtype == torch.float32
    np.testing.assert_array_equal(tn.mass.numpy(), np.asarray(jn.mass))


@pytest.mark.slow
def test_correlated_gaussian_moments():
    cov = torch.tensor([[1.0, 0.8], [0.8, 1.0]])
    nuts = ts.NoUTurnSampler(tcore.GaussianEnergy.create(torch.tensor([1.0, -1.0]), cov),
                             step_size=0.3)
    out = nuts.sample(torch.Generator().manual_seed(0), dim=2, n_samples=800, n_steps=400)
    np.testing.assert_allclose(out.mean(0).numpy(), [1.0, -1.0], atol=0.1)
    np.testing.assert_allclose(torch.cov(out.T).numpy(), cov.numpy(), atol=0.15)


@pytest.mark.slow
def test_warmup_targets_acceptance():
    e = tcore.GaussianEnergy.create(torch.zeros(2), torch.tensor([[1.0, 0.5], [0.5, 1.0]]))
    accs = {}
    for target in (0.6, 0.9):
        nuts = ts.NoUTurnSampler(e, step_size=0.4, target_accept=target)
        g = torch.Generator().manual_seed(int(target * 10))
        x, eps = nuts.warmup(g, dim=2, n_warmup=400, n_samples=256)
        _, diag = nuts.replace(step_size=eps).sample(g, x=x, n_steps=300,
                                                     return_diagnostics=True)
        accs[target] = float(diag["acceptance_rate"].mean())
    assert abs(accs[0.9] - 0.9) < 0.09, accs
    assert accs[0.6] - 0.6 > -0.12, accs
    assert accs[0.9] > accs[0.6], accs
