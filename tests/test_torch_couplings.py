"""The port's couplings against the JAX package's on the same numpy inputs.

Cost matrices agree to 1e-6; the auction and greedy permutations are equal on
distinct costs; the Sinkhorn draws (another random stream than JAX's by
design) are held by row frequency against ``exp(log plan)``; the unbalanced
weights agree to 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torchebm_tpu.couplings as jc
import torchebm_tpu_torch.couplings as tc
from torchebm_tpu_torch.couplings.ot import _row_conditional_draw

torch.set_num_threads(1)


def _batches(seed, n, shape=(2,)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, *shape)).astype(np.float32),
            (rng.standard_normal((n, *shape)) * 0.7 + 1.5).astype(np.float32))


@pytest.mark.parametrize("n, shape", [(2, (2,)), (33, (2,)), (16, (3, 4, 4))])
def test_cost_matrix_matches_jax(n, shape):
    x0, x1 = _batches(0, n, shape)
    want = np.asarray(jc.SinkhornCoupling().compute_cost(jnp.asarray(x0), jnp.asarray(x1)))
    got = tc.SinkhornCoupling().compute_cost(torch.from_numpy(x0), torch.from_numpy(x1))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert float(got.max()) == pytest.approx(1.0) and float(got.min()) >= 0.0
    # identical batches: the maximum is clamped on the device, not divided by zero
    same = tc.GreedyCoupling().compute_cost(torch.ones(3, 2), torch.ones(3, 2))
    assert torch.isfinite(same).all() and float(same.abs().max()) == 0.0


@pytest.mark.parametrize("n", [1, 2, 7, 64, 130])
def test_auction_and_greedy_permutations_match_jax(n):
    cost = np.random.default_rng(n).random((n, n)).astype(np.float32)
    for name in ("auction_assignment", "greedy_assignment"):
        want = np.asarray(getattr(jc, name)(jnp.asarray(cost)))
        got = getattr(tc, name)(torch.from_numpy(cost))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        assert sorted(got.tolist()) == list(range(n))


def test_auction_is_optimal_on_a_small_problem():
    import itertools

    cost = np.random.default_rng(5).random((6, 6)).astype(np.float32)
    perm = tc.auction_assignment(torch.from_numpy(cost)).numpy()
    best = min(cost[np.arange(6), list(p)].sum() for p in itertools.permutations(range(6)))
    assert cost[np.arange(6), perm].sum() <= best + 1e-4


def test_greedy_survives_non_finite_costs():
    cost = torch.full((4, 4), float("inf"))
    cost[0, 1] = 1.0
    perm = tc.greedy_assignment(cost)
    assert int(perm[0]) == 1 and sorted(perm.tolist()) == [0, 1, 2, 3]
    want = np.asarray(jc.greedy_assignment(jnp.asarray(cost.numpy())))
    np.testing.assert_array_equal(perm.numpy(), want)


@pytest.mark.parametrize("name", ["ot", "exact_ot", "greedy", "independent"])
def test_deterministic_couplings_match_jax(name):
    x0, x1 = _batches(1, 48)
    want = jc.get_coupling(name)(jnp.asarray(x0), jnp.asarray(x1))
    got = tc.get_coupling(name)(torch.from_numpy(x0), torch.from_numpy(x1))
    a, b = got  # unpacks as (x0, x1)
    np.testing.assert_array_equal(a.numpy(), np.asarray(want.x0))
    np.testing.assert_array_equal(b.numpy(), np.asarray(want.x1))
    assert got.weights is None and not b.requires_grad


def test_row_conditional_draw_follows_the_plan():
    x0, x1 = _batches(2, 12)
    coupling = tc.SinkhornCoupling(reg=0.5, n_iters=50)
    log_plan = tc.sinkhorn_log(coupling.compute_cost(torch.from_numpy(x0), torch.from_numpy(x1)),
                               reg=0.5, n_iters=50, tol=1e-3)
    g = torch.Generator().manual_seed(0)
    draws = 4000
    idx = torch.stack([_row_conditional_draw(log_plan, g) for _ in range(draws)])
    freq = torch.stack([torch.bincount(idx[:, i], minlength=12) for i in range(12)]) / draws
    want = torch.softmax(log_plan, dim=1)
    # 4,000 draws: a frequency's standard deviation is at most 0.008
    assert float((freq - want).abs().max()) < 0.04
    # the JAX draw follows the same conditional
    keys = jax.random.split(jax.random.PRNGKey(0), 1000)
    jidx = np.asarray(jax.vmap(lambda k: jax.random.categorical(
        k, jnp.asarray(log_plan.numpy()), axis=1))(keys))
    jfreq = np.stack([np.bincount(jidx[:, i], minlength=12) for i in range(12)]) / 1000
    assert np.abs(jfreq - want.numpy()).max() < 0.08


def test_sinkhorn_coupling_contract():
    x0, x1 = _batches(3, 40)
    g = torch.Generator().manual_seed(1)
    t0, t1 = torch.from_numpy(x0), torch.from_numpy(x1).requires_grad_(True)
    out = tc.SinkhornCoupling(fused="force")(t0, t1, generator=g)
    assert out.x0 is not None and out.x1.shape == t1.shape and not out.x1.requires_grad
    # every paired target is a row of x1, and sharp plans pair near neighbours
    assert bool((out.x1[:, None, :] == t1.detach()[None]).all(-1).any(1).all())
    paired = ((out.x1 - t0) ** 2).sum(-1).mean()
    shuffled = ((t1.detach()[torch.randperm(40, generator=g)] - t0) ** 2).sum(-1).mean()
    assert float(paired) < float(shuffled)
    with pytest.raises(ValueError, match="Generator"):
        tc.SinkhornCoupling()(t0, t1)
    # one sample: nothing to solve, no generator needed
    one = tc.SinkhornCoupling()(t0[:1], t1[:1])
    assert one.x1.shape == (1, 2)


def test_unbalanced_weights_match_jax():
    x0, x1 = _batches(4, 32)
    x1[:4] += 6.0  # outliers: the relaxed marginal gives them less mass
    kw = dict(reg=0.05, reg_marginal=0.5, n_iters=80, tol=0.0)
    want = jc.UnbalancedSinkhornCoupling(fused="off", **kw)(
        jnp.asarray(x0), jnp.asarray(x1), key=jax.random.PRNGKey(0))
    for fused in ("off", "force"):
        got = tc.UnbalancedSinkhornCoupling(fused=fused, **kw)(
            torch.from_numpy(x0), torch.from_numpy(x1),
            generator=torch.Generator().manual_seed(0))
        np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                                   rtol=1e-5, atol=1e-5)
        assert float(got.weights.mean()) == pytest.approx(1.0, abs=1e-5)
    with pytest.raises(ValueError, match="Generator"):
        tc.UnbalancedSinkhornCoupling()(torch.from_numpy(x0), torch.from_numpy(x1))


def test_reflow_coupling_takes_samplers_and_callables():
    x0 = torch.randn(5, 2)

    class Sampler:
        def sample(self, generator, x, shift=0.0):
            return x + 1.0 + shift

    g = torch.Generator().manual_seed(0)
    out = tc.ReflowCoupling(model=Sampler(), sample_kwargs=dict(shift=1.0))(x0, generator=g)
    torch.testing.assert_close(out.x1, x0 + 2.0)
    torch.testing.assert_close(tc.ReflowCoupling(model=lambda x: 2 * x)(x0).x1, 2 * x0)
    torch.testing.assert_close(tc.ReflowCoupling(model=lambda gen, x: -x)(x0, generator=g).x1, -x0)
    with pytest.raises(ValueError, match="Unknown coupling 'reflow'"):
        tc.get_coupling("reflow")


def test_registry_and_validation_errors():
    assert sorted(tc.COUPLING_REGISTRY) == sorted(jc.COUPLING_REGISTRY)
    for name, cls in tc.COUPLING_REGISTRY.items():
        assert type(tc.get_coupling(name.upper())) is cls
        assert cls.__name__ == jc.COUPLING_REGISTRY[name].__name__
    assert isinstance(tc.resolve_coupling(None), tc.IndependentCoupling)
    inst = tc.GreedyCoupling()
    assert tc.resolve_coupling(inst) is inst
    assert tc.resolve_coupling("sinkhorn", reg=0.1).reg == 0.1
    for mod in (jc, tc):
        with pytest.raises(ValueError, match="Unknown coupling"):
            mod.get_coupling("nope")
        with pytest.raises(TypeError):
            mod.get_coupling(3)
        with pytest.raises(TypeError):
            mod.resolve_coupling(3.0)
        for cls in (mod.SinkhornCoupling, mod.UnbalancedSinkhornCoupling):
            with pytest.raises(ValueError, match="reg must be positive"):
                cls(reg=0.0)
            with pytest.raises(ValueError, match="n_iters must be positive"):
                cls(n_iters=0)
            with pytest.raises(ValueError, match="tol must be non-negative"):
                cls(tol=-1.0)
        with pytest.raises(ValueError, match="reg_marginal must be positive"):
            mod.UnbalancedSinkhornCoupling(reg_marginal=0.0)
    with pytest.raises(ValueError, match="fused"):
        tc.SinkhornCoupling(fused="on")
    x = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="equal batch sizes"):
        tc.GreedyCoupling()(x, torch.zeros(4, 2))
    with pytest.raises(ValueError, match="x1 must not be None"):
        tc.IndependentCoupling()(x)
