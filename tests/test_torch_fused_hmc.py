"""Parity of the port's whole-run HMC kernels with the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX Pallas kernels' injected-randomness path (``noise``
momenta and ``uniforms``) in interpret mode on the same numpy inputs.
Tolerance: atol 1e-5 on the states, the trajectories and the per-chain
acceptance (float32; tighter than the 2e-4 of tests/ops/test_chain_parity.py,
which compares the Pallas kernel with a loop in another accumulation order —
here both sides take the same accept decisions and leapfrog order). The CUDA
kernels are held against the plain versions in tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torchebm_tpu.ops import fused_hmc as jhmc
from torchebm_tpu_torch import ops as tops
from torchebm_tpu_torch.ops import fused_hmc as thmc

torch.set_num_threads(1)

ATOL = 1e-5
N_CHAINS = 41


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


# (d, K, n_draws, n_leapfrog, thin, log_weights, precision, mass)
CASES = [
    pytest.param(2, 8, 6, 4, None, False, False, None, id="8gauss"),
    pytest.param(3, 4, 5, 3, None, True, False, None, id="d3-K4-weights"),
    pytest.param(3, 1, 5, 4, None, False, True, None, id="precision-d3"),
    pytest.param(3, 4, 5, 3, None, True, False, 0.3, id="mass-scalar"),
    pytest.param(3, 4, 5, 3, None, True, False, "diag", id="mass-diag"),
    pytest.param(2, 4, 8, 3, 3, True, False, None, id="traj-thin3-rem2"),
    pytest.param(3, 1, 7, 2, 3, False, True, "diag", id="traj-thin3-precision-mass"),
]


@pytest.mark.parametrize("d, k, n_draws, n_lf, thin, weights, precision, mass", CASES)
def test_hmc_plain_matches_jax_interpret(d, k, n_draws, n_lf, thin, weights, precision, mass):
    rng = np.random.default_rng(1000 * d + 10 * k + n_draws)
    x0 = _normal(rng, N_CHAINS, d)
    means = _normal(rng, k, d, scale=2.5)
    noise = _normal(rng, n_draws, N_CHAINS, d)
    unif = rng.uniform(size=(n_draws, N_CHAINS)).astype(np.float32)
    kw = {"scale": 0.8}
    if weights:
        w = rng.uniform(0.5, 2.0, k)
        kw["log_weights"] = np.log(w / w.sum()).astype(np.float32)
    if precision:
        a = _normal(rng, d, d, scale=0.3)
        kw["precision"] = (a @ a.T + np.eye(d)).astype(np.float32)
    if mass == "diag":
        kw["mass"] = np.array([1.0, 4.0, 0.25][:d], np.float32)
    elif mass is not None:
        kw["mass"] = mass
    jkw = {key: jnp.asarray(v) if isinstance(v, np.ndarray) else v for key, v in kw.items()}
    tkw = {key: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for key, v in kw.items()}
    h = 0.3
    jargs = (jnp.asarray(x0), jnp.asarray(means), n_draws, h, n_lf)
    targs = (torch.from_numpy(x0), torch.from_numpy(means), n_draws, h, n_lf)
    jinj = dict(noise=jnp.asarray(noise), uniforms=jnp.asarray(unif))
    tinj = dict(noise=torch.from_numpy(noise), uniforms=torch.from_numpy(unif))
    counts = tops.launch_counts()
    if thin is None:
        ref = jhmc.mixture_hmc_chain(*jargs, interpret=True, **jinj, **jkw)
        out = thmc.mixture_hmc_chain(*targs, **tinj, **tkw)
    else:
        ref = jhmc.mixture_hmc_chain_trajectory(*jargs, thin=thin, interpret=True, **jinj, **jkw)
        out = thmc.mixture_hmc_chain_trajectory(*targs, thin=thin, **tinj, **tkw)
        assert out[0].shape == (n_draws // thin, N_CHAINS, d)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        _close(o, r)
    # some proposals are taken and some refused, so both branches are compared
    assert 0.05 < float(out[-1].mean()) < 0.99
    assert tops.launch_counts() == counts  # the CPU path launches no kernel


def test_plain_functions_equal_the_cpu_wrappers():
    rng = np.random.default_rng(7)
    x0, means = torch.from_numpy(_normal(rng, 16, 2)), torch.from_numpy(_normal(rng, 3, 2))
    t = (x0, means, 6, 0.2, 3)
    kw = dict(scale=0.9, mass=torch.tensor([1.0, 2.0]), seed=5)
    a = thmc.mixture_hmc_chain(*t, **kw)
    b = thmc.mixture_hmc_chain_plain(*t, **kw)
    c = thmc.mixture_hmc_chain_trajectory(*t, thin=4, **kw)
    d = thmc.mixture_hmc_chain_trajectory_plain(*t, thin=4, **kw)
    for u, v in zip((*a, *c), (*b, *d)):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    torch.testing.assert_close(c[1:], a, rtol=0, atol=0)


def test_scalar_mass_equals_its_broadcast_diagonal():
    rng = np.random.default_rng(8)
    x0, means = torch.from_numpy(_normal(rng, 16, 3)), torch.from_numpy(_normal(rng, 2, 3))
    a = thmc.mixture_hmc_chain(x0, means, 5, 0.2, 3, mass=2.5, seed=1)
    b = thmc.mixture_hmc_chain(x0, means, 5, 0.2, 3, mass=torch.full((3,), 2.5), seed=1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_philox_run_is_reproducible_seeded_and_correct_in_distribution():
    """The Philox path has no JAX run to match number for number, so it is
    held to the target: HMC on an isotropic Gaussian keeps N(μ, σ²) to
    4-sigma bounds, with and without a diagonal mass."""
    n = 4000
    mu = torch.tensor([[0.5, -1.0]])
    x0 = mu.repeat(n, 1)
    for mass in (None, torch.tensor([1.0, 3.0])):
        a = thmc.mixture_hmc_chain(x0, mu, 40, 0.25, 5, scale=0.6, mass=mass, seed=21)
        b = thmc.mixture_hmc_chain(x0, mu, 40, 0.25, 5, scale=0.6, mass=mass, seed=21)
        c = thmc.mixture_hmc_chain(x0, mu, 40, 0.25, 5, scale=0.6, mass=mass, seed=22)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.equal(a[0], c[0])
        x, acc = a
        assert torch.all(torch.abs(x.mean(0) - mu[0]) < 4 * 0.6 / np.sqrt(n))
        assert torch.all(torch.abs(x.var(0) / 0.36 - 1.0) < 4 * np.sqrt(2 / n) + 0.02)
        assert 0.7 < float(acc.mean()) <= 1.0


def test_wrappers_reject_bad_inputs():
    x0, means = torch.zeros(8, 2), torch.zeros(3, 2)
    noise, unif = torch.zeros(2, 8, 2), torch.zeros(2, 8)
    with pytest.raises(ValueError, match="together"):
        thmc.mixture_hmc_chain(x0, means, 2, 0.1, noise=noise)
    with pytest.raises(ValueError, match="together"):
        thmc.mixture_hmc_chain_trajectory(x0, means, 2, 0.1, uniforms=unif)
    with pytest.raises(ValueError, match="noise must have shape"):
        thmc.mixture_hmc_chain(x0, means, 2, 0.1, noise=torch.zeros(2, 8, 3), uniforms=unif)
    with pytest.raises(ValueError, match="uniforms must have shape"):
        thmc.mixture_hmc_chain(x0, means, 2, 0.1, noise=noise, uniforms=torch.zeros(3, 8))
    with pytest.raises(ValueError, match="mass must be"):
        thmc.mixture_hmc_chain(x0, means, 2, 0.1, mass=torch.ones(3))
    with pytest.raises(ValueError, match="mass must be"):
        thmc.mixture_hmc_chain(x0, means, 2, 0.1, mass=torch.ones(2, 2))
    with pytest.raises(ValueError, match="n_leapfrog"):
        thmc.mixture_hmc_chain(x0, means, 2, 0.1, 0)
    with pytest.raises(ValueError, match="step_size"):
        thmc.mixture_hmc_chain(x0, means, 2, -0.1)
    with pytest.raises(ValueError, match="supported sizes"):
        thmc.mixture_hmc_chain(torch.zeros(4, 65), torch.zeros(1, 65), 2, 0.1)
    with pytest.raises(ValueError, match="supported sizes"):
        thmc.mixture_hmc_chain(torch.zeros(4, 4), torch.zeros(257, 4), 2, 0.1)
    with pytest.raises(ValueError, match="precision= requires"):
        thmc.mixture_hmc_chain(x0, means, 2, 0.1, precision=torch.eye(2))
    with pytest.raises(ValueError, match="thin"):
        thmc.mixture_hmc_chain_trajectory(x0, means, 3, 0.1, thin=0)
    with pytest.raises(ValueError, match="contiguous"):
        thmc.mixture_hmc_chain(torch.zeros(2, 8).T, means, 2, 0.1)
    with pytest.raises(ValueError, match="seed"):
        thmc.mixture_hmc_chain(x0, means, 2, 0.1, seed=-1)


# (d, K, gaussian, n chains, group): the ring's pick, K past the lanes'
# registers (4 components per lane at d <= 2, 2 at d <= 4, 1 above), each
# bucket's cap (8 lanes at d <= 4, 4 above), one lane for one component and
# for d > 16, two for the full-covariance Gaussian at d <= 16, and the
# halving at large n (down to 2)
PLAN_CASES = [
    (2, 8, False, 10_000, 2), (2, 2, False, 10_000, 2), (2, 3, False, 10_000, 2),
    (2, 12, False, 10_000, 4), (2, 16, False, 10_000, 4), (2, 24, False, 10_000, 8),
    (2, 33, False, 10_000, 8), (3, 4, False, 10_000, 2), (4, 8, False, 10_000, 4),
    (3, 16, False, 10_000, 8), (5, 2, False, 10_000, 2), (8, 4, False, 10_000, 4),
    (16, 8, False, 10_000, 4), (16, 33, False, 10_000, 4), (2, 8, False, 31, 2),
    (2, 1, False, 10_000, 1), (2, 1, True, 10_000, 2), (16, 1, True, 10_000, 2),
    (2, 1, True, 1_000_000, 2), (32, 1, True, 10_000, 1), (17, 8, False, 10_000, 1),
    (64, 8, False, 10_000, 1),
    (2, 12, False, 100_000, 2), (2, 33, False, 40_000, 4), (2, 33, False, 100_000, 2),
    (2, 8, False, 1_000_000, 2), (2, 33, False, 1_000_000, 2),
]


@pytest.mark.parametrize("d, k, gaussian, n, group", PLAN_CASES,
                         ids=[f"d{d}-k{k}-n{n}" + ("-gauss" if g else "")
                              for d, k, g, n, _ in PLAN_CASES])
def test_hmc_launch_plan(d, k, gaussian, n, group):
    """The group the card's timings pick, a grid that holds every chain's
    group and no block past the last chain, and the same plan when the
    group is passed back as the override."""
    got, threads, blocks = thmc.hmc_launch_plan(n, d, k, gaussian)
    assert got == group and got in thmc.HMC_GROUPS
    assert threads == thmc.HMC_THREADS and threads % 32 == 0
    assert blocks * threads >= n * group > (blocks - 1) * threads
    assert thmc.hmc_launch_plan(n, d, k, gaussian, group=group) == (group, threads, blocks)
    if group > 2:  # halving stops where the chains' lanes fit the card
        assert n * group <= tops.fused_langevin.MIXTURE_RESIDENT_THREADS


def test_hmc_launch_plan_overrides_only_built_groups():
    """Every built group may be forced (timings compare them): 1, 2, 4, 8 on
    the mixture and the full-covariance Gaussian at d <= 16; one component
    and d > 16 have one lane."""
    for d, k, gaussian, built in ((2, 8, False, (1, 2, 4, 8)), (16, 8, False, (1, 2, 4, 8)),
                                  (2, 1, True, (1, 2, 4, 8)), (16, 1, True, (1, 2, 4, 8)),
                                  (2, 1, False, (1,)), (17, 8, False, (1,)), (32, 1, True, (1,))):
        assert thmc.hmc_groups(d, k, gaussian) == built
        for group in built:
            assert thmc.hmc_launch_plan(10_000, d, k, gaussian, group=group)[0] == group
    for d, k, gaussian, group in ((2, 8, False, 3), (2, 8, False, 16), (2, 1, True, 3),
                                  (16, 1, True, 16), (32, 1, True, 2), (17, 8, False, 2),
                                  (2, 1, False, 4)):
        with pytest.raises(ValueError, match="no HMC chain kernel"):
            thmc.hmc_launch_plan(100, d, k, gaussian, group=group)


def _halves(fn, x0, split, *args, noise=None, uniforms=None, **kw):
    """``fn`` over chains ``[0, split)`` and ``[split, n)``, each at its first
    chain as ``chain_offset`` and with its rows of the injected draws, the
    outputs concatenated along the chains (a trajectory's dim 1)."""
    parts = []
    for a, b in ((0, split), (split, x0.shape[0])):
        inj = {} if noise is None else dict(noise=noise[:, a:b].contiguous(),
                                             uniforms=uniforms[:, a:b].contiguous())
        parts.append(fn(x0[a:b], *args, chain_offset=a, **inj, **kw))
    return [torch.cat(p, dim=1 if p[0].ndim == 3 else 0) for p in zip(*parts)]


def _offset_inputs(seed, d, k, n_draws, precision):
    rng = np.random.default_rng(seed)
    x0 = _normal(rng, N_CHAINS, d)
    means = _normal(rng, k, d, scale=2.5)
    noise = _normal(rng, n_draws, N_CHAINS, d)
    unif = rng.uniform(size=(n_draws, N_CHAINS)).astype(np.float32)
    kw = {"scale": 0.8, "mass": np.array([1.0, 4.0, 0.25][:d], np.float32)}
    if precision:
        a = _normal(rng, d, d, scale=0.3)
        kw["precision"] = (a @ a.T + np.eye(d)).astype(np.float32)
    return x0, means, noise, unif, kw


@pytest.mark.parametrize("trajectory", [False, True], ids=["final", "trajectory"])
@pytest.mark.parametrize("precision", [False, True], ids=["mixture", "precision"])
def test_offset_halves_match_jax_interpret(trajectory, precision):
    """Two shards of one batch, each through the plain version at its chain
    offset with its rows of the injected draws, together equal the JAX
    kernel on the whole batch (diagonal mass)."""
    d, k, n_draws = (3, 1, 6) if precision else (2, 4, 7)
    x0, means, noise, unif, kw = _offset_inputs(3 + precision, d, k, n_draws, precision)
    jkw = {key: jnp.asarray(v) if isinstance(v, np.ndarray) else v for key, v in kw.items()}
    tkw = {key: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for key, v in kw.items()}
    jargs = (jnp.asarray(x0), jnp.asarray(means), n_draws, 0.3, 3)
    jinj = dict(noise=jnp.asarray(noise), uniforms=jnp.asarray(unif))
    if trajectory:
        ref = jhmc.mixture_hmc_chain_trajectory(*jargs, thin=2, interpret=True, **jinj, **jkw)
        fn, tkw = thmc.mixture_hmc_chain_trajectory_plain, dict(tkw, thin=2)
    else:
        ref = jhmc.mixture_hmc_chain(*jargs, interpret=True, **jinj, **jkw)
        fn = thmc.mixture_hmc_chain_plain
    out = _halves(fn, torch.from_numpy(x0), 17, torch.from_numpy(means), n_draws, 0.3, 3,
                  noise=torch.from_numpy(noise), uniforms=torch.from_numpy(unif), **tkw)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        _close(o, r)


@pytest.mark.parametrize("trajectory", [False, True], ids=["final", "trajectory"])
def test_philox_offset_halves_equal_the_whole_launch(trajectory):
    """On the Philox stream (the plain version's bit-exact int64 twin) two
    launches at chain offsets 0 and ``split`` equal one over every chain,
    bitwise; a shard at offset 0 draws other numbers."""
    x0, means, _, _, kw = _offset_inputs(12, 2, 4, 8, False)
    tkw = {key: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for key, v in kw.items()}
    tkw = dict(tkw, seed=2**40 + 9, **({"thin": 3} if trajectory else {}))
    fn = (thmc.mixture_hmc_chain_trajectory_plain if trajectory
          else thmc.mixture_hmc_chain_plain)
    x, m = torch.from_numpy(x0), torch.from_numpy(means)
    whole = fn(x, m, 8, 0.3, 3, **tkw)
    for split in (6, 30):
        for got, want in zip(_halves(fn, x, split, m, 8, 0.3, 3, **tkw), whole):
            assert torch.equal(got, want)
    final = fn(x[30:], m, 8, 0.3, 3, **tkw)[-2]
    assert not torch.equal(final, whole[-2][30:])
    with pytest.raises(ValueError, match="chain_offset"):
        fn(x, m, 8, 0.3, 3, chain_offset=-1, **tkw)
