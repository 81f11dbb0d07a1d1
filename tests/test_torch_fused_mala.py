"""Parity of the port's whole-chain MALA kernels with the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX Pallas kernels' injected-randomness path (``noise`` and
``uniforms``) in interpret mode on the same numpy inputs. Tolerance: atol
1e-5 on the states, the trajectories and the per-chain acceptance (float32;
both sides take the same accept decisions on these inputs, so states agree to
rounding). The CUDA kernels are held against the plain versions in
tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torchebm_tpu.ops import fused_mala as jmala
from torchebm_tpu_torch import ops as tops
from torchebm_tpu_torch.ops import fused_langevin as tfl
from torchebm_tpu_torch.ops import fused_mala as tmala

torch.set_num_threads(1)

ATOL = 1e-5
N_CHAINS = 37


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def _inputs(seed, d, k, n_steps, weights, precision):
    """Numpy draws for one case: ``(x0, means, noise, uniforms, target kwargs)``."""
    rng = np.random.default_rng(seed)
    x0 = _normal(rng, N_CHAINS, d)
    means = _normal(rng, k, d, scale=2.0)
    noise = _normal(rng, n_steps, N_CHAINS, d)
    unif = rng.uniform(size=(n_steps, N_CHAINS)).astype(np.float32)
    kw = {"scale": 0.8}
    if weights:
        w = rng.uniform(0.5, 2.0, k)
        kw["log_weights"] = np.log(w / w.sum()).astype(np.float32)
    if precision:
        a = _normal(rng, d, d, scale=0.3)
        kw["precision"] = (a @ a.T + np.eye(d)).astype(np.float32)
    return x0, means, noise, unif, kw


def _both(kw):
    conv = lambda f: {k: f(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}  # noqa: E731
    return conv(jnp.asarray), conv(torch.from_numpy)


# (d, K, n_steps, thin, log_weights, precision)
CASES = [
    pytest.param(2, 8, 7, None, False, False, id="8gauss"),
    pytest.param(3, 4, 7, None, True, False, id="d3-K4-weights"),
    pytest.param(3, 1, 6, None, False, True, id="precision-d3"),
    pytest.param(2, 4, 11, 3, True, False, id="traj-thin3-rem2"),
    pytest.param(3, 1, 8, 3, False, True, id="traj-thin3-precision"),
]


@pytest.mark.parametrize("d, k, n_steps, thin, weights, precision", CASES)
def test_mala_plain_matches_jax_interpret(d, k, n_steps, thin, weights, precision):
    x0, means, noise, unif, kw = _inputs(100 * d + k + n_steps, d, k, n_steps, weights,
                                         precision)
    jkw, tkw = _both(kw)
    eta = 0.35
    jargs = (jnp.asarray(x0), jnp.asarray(means), n_steps, eta)
    targs = (torch.from_numpy(x0), torch.from_numpy(means), n_steps, eta)
    jinj = dict(noise=jnp.asarray(noise), uniforms=jnp.asarray(unif))
    tinj = dict(noise=torch.from_numpy(noise), uniforms=torch.from_numpy(unif))
    counts = tops.launch_counts()
    if thin is None:
        ref = jmala.mixture_mala_chain(*jargs, interpret=True, **jinj, **jkw)
        out = tmala.mixture_mala_chain(*targs, **tinj, **tkw)
    else:
        ref = jmala.mixture_mala_chain_trajectory(*jargs, thin=thin, interpret=True, **jinj,
                                                  **jkw)
        out = tmala.mixture_mala_chain_trajectory(*targs, thin=thin, **tinj, **tkw)
        assert out[0].shape == (n_steps // thin, N_CHAINS, d)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        _close(o, r)
    # some proposals are taken and some refused, so both branches are compared
    assert 0.05 < float(out[-1].mean()) < 0.98
    assert tops.launch_counts() == counts  # the CPU path launches no kernel


def test_plain_functions_equal_the_cpu_wrappers():
    x0, means, noise, unif, kw = _inputs(5, 2, 3, 9, True, False)
    _, tkw = _both(kw)
    t = (torch.from_numpy(x0), torch.from_numpy(means), 9, 0.1)
    for inj in ({}, dict(noise=torch.from_numpy(noise), uniforms=torch.from_numpy(unif))):
        a = tmala.mixture_mala_chain(*t, seed=3, **inj, **tkw)
        b = tmala.mixture_mala_chain_plain(*t, seed=3, **inj, **tkw)
        c = tmala.mixture_mala_chain_trajectory(*t, thin=2, seed=3, **inj, **tkw)
        d = tmala.mixture_mala_chain_trajectory_plain(*t, thin=2, seed=3, **inj, **tkw)
        for u, v in zip((*a, *c), (*b, *d)):
            torch.testing.assert_close(u, v, rtol=0, atol=0)
        # the trajectory kernel's final state and acceptance are the chain's
        torch.testing.assert_close(c[1:], a, rtol=0, atol=0)


def test_philox_chain_is_reproducible_seeded_and_correct_in_distribution():
    """The Philox path has no JAX run to match number for number (the Pallas
    PRNG path runs only on a TPU), so it is held to the target: MALA at a
    small step on a 1D-product Gaussian keeps N(μ, σ²) to 4-sigma bounds."""
    n, d = 4000, 2
    x0 = torch.zeros(n, d) + torch.tensor([1.0, -2.0])
    means = torch.tensor([[1.0, -2.0]])
    a = tmala.mixture_mala_chain(x0, means, 60, 0.3, scale=0.7, seed=11)
    b = tmala.mixture_mala_chain(x0, means, 60, 0.3, scale=0.7, seed=11)
    c = tmala.mixture_mala_chain(x0, means, 60, 0.3, scale=0.7, seed=12)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a[0], c[0])
    x, acc = a
    assert torch.all(torch.abs(x.mean(0) - means[0]) < 4 * 0.7 / np.sqrt(n))
    assert torch.all(torch.abs(x.var(0) / 0.49 - 1.0) < 4 * np.sqrt(2 / n))
    assert 0.5 < float(acc.mean()) < 1.0


def test_wrappers_reject_bad_inputs():
    x0, means = torch.zeros(8, 2), torch.zeros(3, 2)
    noise, unif = torch.zeros(2, 8, 2), torch.zeros(2, 8)
    with pytest.raises(ValueError, match="together"):
        tmala.mixture_mala_chain(x0, means, 2, 0.1, noise=noise)
    with pytest.raises(ValueError, match="together"):
        tmala.mixture_mala_chain_trajectory(x0, means, 2, 0.1, uniforms=unif)
    with pytest.raises(ValueError, match="noise must have shape"):
        tmala.mixture_mala_chain(x0, means, 2, 0.1, noise=torch.zeros(3, 8, 2), uniforms=unif)
    with pytest.raises(ValueError, match="uniforms must have shape"):
        tmala.mixture_mala_chain(x0, means, 2, 0.1, noise=noise, uniforms=torch.zeros(2, 9))
    with pytest.raises(ValueError, match="means must have shape"):
        tmala.mixture_mala_chain(x0, torch.zeros(3, 5), 2, 0.1)
    with pytest.raises(ValueError, match="supported sizes"):
        tmala.mixture_mala_chain(torch.zeros(4, 65), torch.zeros(1, 65), 2, 0.1)
    with pytest.raises(ValueError, match="supported sizes"):
        tmala.mixture_mala_chain(torch.zeros(4, 8), torch.zeros(129, 8), 2, 0.1)
    with pytest.raises(ValueError, match="d=33"):
        tmala.mixture_mala_chain(torch.zeros(4, 33), torch.zeros(1, 33), 2, 0.1,
                                 precision=torch.eye(33))
    with pytest.raises(ValueError, match="step_size"):
        tmala.mixture_mala_chain(x0, means, 2, 0.0)
    with pytest.raises(ValueError, match="thin"):
        tmala.mixture_mala_chain_trajectory(x0, means, 3, 0.1, thin=4)
    with pytest.raises(TypeError, match="float32"):
        tmala.mixture_mala_chain(x0.double(), means, 2, 0.1)
    with pytest.raises(ValueError, match="only CPU"):
        tmala.mixture_mala_chain(torch.zeros(4, 2, device="meta"),
                                 torch.zeros(1, 2, device="meta"), 2, 0.1)


# (d, K, gaussian, n chains, group): at least 4 lanes at d <= 2 (the ring's
# pick), 8 where a lane's registers (4 components at d <= 2, 2 at d <= 4, 1
# above) leave components over at 4, 2 at d > 2 where two lanes hold every
# component and every normals block, 4 where the d = 16 blocks need them, the
# cap of 4 at d > 4, one lane for one component and for d > 16, the
# full-covariance Gaussian by its normals blocks, and the halving at large n
# (down to 2)
PLAN_CASES = [
    (2, 8, False, 10_000, 4), (2, 2, False, 10_000, 4), (2, 16, False, 10_000, 4),
    (2, 24, False, 10_000, 8), (2, 33, False, 10_000, 8), (3, 2, False, 10_000, 2),
    (3, 4, False, 10_000, 2), (3, 8, False, 10_000, 4), (3, 16, False, 10_000, 8),
    (5, 2, False, 10_000, 2), (8, 4, False, 10_000, 4), (8, 16, False, 10_000, 4),
    (16, 2, False, 10_000, 4), (16, 33, False, 10_000, 4), (2, 8, False, 31, 4),
    (2, 1, False, 10_000, 1), (17, 8, False, 10_000, 1), (64, 8, False, 10_000, 1),
    (2, 1, True, 10_000, 4), (4, 1, True, 10_000, 2), (8, 1, True, 10_000, 2),
    (16, 1, True, 10_000, 4), (32, 1, True, 10_000, 1), (2, 1, True, 1_000_000, 2),
    (2, 8, False, 60_000, 4), (2, 8, False, 100_000, 2), (2, 33, False, 40_000, 4),
    (2, 33, False, 300_000, 2),
]


@pytest.mark.parametrize("d, k, gaussian, n, group", PLAN_CASES,
                         ids=[f"d{d}-k{k}-n{n}" + ("-gauss" if g else "")
                              for d, k, g, n, _ in PLAN_CASES])
def test_mala_launch_plan(d, k, gaussian, n, group):
    """The group the card's timings pick, a grid that holds every chain's
    group and no block past the last chain, and the same plan when the
    group is passed back as the override."""
    got, threads, blocks = tmala.mala_launch_plan(n, d, k, gaussian)
    assert got == group and got in tmala.mala_groups(d, k, gaussian)
    assert threads == tmala.MALA_THREADS and threads % 32 == 0
    assert blocks * threads >= n * group > (blocks - 1) * threads
    assert tmala.mala_launch_plan(n, d, k, gaussian, group=group) == (group, threads, blocks)
    if group > 2:  # halving stops where the chains' lanes fit the card
        assert n * group <= tfl.MIXTURE_RESIDENT_THREADS


def test_mala_launch_plan_overrides_only_built_groups():
    """Every built group may be forced (timings compare them): 1, 2, 4, 8 on
    the mixture and the full-covariance Gaussian at d <= 16; one component
    and d > 16 have one lane."""
    for d, k, gaussian, built in ((2, 8, False, (1, 2, 4, 8)), (16, 8, False, (1, 2, 4, 8)),
                                  (2, 1, True, (1, 2, 4, 8)), (16, 1, True, (1, 2, 4, 8)),
                                  (2, 1, False, (1,)), (17, 8, False, (1,)), (32, 1, True, (1,))):
        assert tmala.mala_groups(d, k, gaussian) == built
        for group in built:
            assert tmala.mala_launch_plan(10_000, d, k, gaussian, group=group)[0] == group
    for d, k, gaussian, group in ((2, 8, False, 3), (2, 8, False, 16), (2, 1, True, 3),
                                  (16, 1, True, 16), (32, 1, True, 2), (17, 8, False, 2),
                                  (2, 1, False, 4)):
        with pytest.raises(ValueError, match="no MALA chain kernel"):
            tmala.mala_launch_plan(100, d, k, gaussian, group=group)


# ------------------------------------------------------------------ Philox uniform


def test_philox_uniforms_are_deterministic_uniform_and_keyed():
    index = torch.arange(200_000)
    u = tfl.philox_uniforms(index, step=5, seed=(3 << 32) | 9)
    assert u.shape == (200_000,) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    # top 24 bits: every value is a multiple of 2^-24
    assert torch.equal(u * 2.0**24, torch.floor(u * 2.0**24))
    assert abs(float(u.mean()) - 0.5) < 4 * np.sqrt(1 / 12 / u.numel())
    assert abs(float(u.var()) - 1 / 12) < 4 * np.sqrt(1 / 180 / u.numel())
    torch.testing.assert_close(tfl.philox_uniforms(index[:16], 5, (3 << 32) | 9), u[:16],
                               rtol=0, atol=0)
    for step, seed in ((6, (3 << 32) | 9), (5, (4 << 32) | 9), (5, (3 << 32) | 10)):
        assert not torch.equal(tfl.philox_uniforms(index[:16], step, seed), u[:16])


def test_uniform_counters_are_disjoint_from_the_normals():
    """The uniform's Philox block (0xFFFFFFFF) is none of the normals' blocks
    0..15 (d <= 64), and its first word is the one the kernels read."""
    assert tfl.UNIFORM_BLOCK == 0xFFFFFFFF
    index = torch.arange(64, dtype=torch.int64)
    seed = 77
    words = tfl.philox4x32_10(index, 3, tfl.UNIFORM_BLOCK, index >> 32, seed, 0)
    torch.testing.assert_close(tfl.philox_uniforms(index, 3, seed),
                               (words[0] >> 8).to(torch.float32) * 2.0**-24, rtol=0, atol=0)
    for j in range(16):
        normals_words = tfl.philox4x32_10(index, 3, j, index >> 32, seed, 0)
        assert not torch.equal(normals_words[0], words[0])


def _halves(fn, x0, split, *args, noise=None, uniforms=None, **kw):
    """``fn`` over chains ``[0, split)`` and ``[split, n)``, each at its first
    chain as ``chain_offset`` and with its rows of the injected draws, the
    outputs concatenated along the chains (a trajectory's dim 1)."""
    parts = []
    for a, b in ((0, split), (split, x0.shape[0])):
        inj = {} if noise is None else dict(noise=noise[:, a:b].contiguous(),
                                             uniforms=uniforms[:, a:b].contiguous())
        out = fn(x0[a:b], *args, chain_offset=a, **inj, **kw)
        parts.append(out)
    return [torch.cat(p, dim=p[0].ndim - 2 if p[0].ndim == 3 else 0) for p in zip(*parts)]


@pytest.mark.parametrize("trajectory", [False, True], ids=["final", "trajectory"])
@pytest.mark.parametrize("precision", [False, True], ids=["mixture", "precision"])
def test_offset_halves_match_jax_interpret(trajectory, precision):
    """Two shards of one batch, each through the plain version at its chain
    offset with its rows of the injected draws, together equal the JAX
    kernel on the whole batch."""
    d, k, n_steps = (3, 1, 6) if precision else (2, 8, 7)
    x0, means, noise, unif, kw = _inputs(7 + precision, d, k, n_steps, not precision, precision)
    jkw, tkw = _both(kw)
    jargs = (jnp.asarray(x0), jnp.asarray(means), n_steps, 0.35)
    jinj = dict(noise=jnp.asarray(noise), uniforms=jnp.asarray(unif))
    if trajectory:
        ref = jmala.mixture_mala_chain_trajectory(*jargs, thin=2, interpret=True, **jinj, **jkw)
        fn, tkw = tmala.mixture_mala_chain_trajectory_plain, dict(tkw, thin=2)
    else:
        ref = jmala.mixture_mala_chain(*jargs, interpret=True, **jinj, **jkw)
        fn = tmala.mixture_mala_chain_plain
    out = _halves(fn, torch.from_numpy(x0), 15, torch.from_numpy(means), n_steps, 0.35,
                  noise=torch.from_numpy(noise), uniforms=torch.from_numpy(unif), **tkw)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        _close(o, r)


@pytest.mark.parametrize("trajectory", [False, True], ids=["final", "trajectory"])
def test_philox_offset_halves_equal_the_whole_launch(trajectory):
    """On the Philox stream (the plain version's bit-exact int64 twin) two
    launches at chain offsets 0 and ``split`` equal one over every chain,
    bitwise; a shard at offset 0 draws other numbers."""
    x0, means, _, _, kw = _inputs(11, 2, 8, 9, True, False)
    _, tkw = _both(kw)
    tkw = dict(tkw, seed=2**40 + 5, **({"thin": 3} if trajectory else {}))
    fn = (tmala.mixture_mala_chain_trajectory_plain if trajectory
          else tmala.mixture_mala_chain_plain)
    x, m = torch.from_numpy(x0), torch.from_numpy(means)
    whole = fn(x, m, 9, 0.2, **tkw)
    for split in (5, 20):
        for got, want in zip(_halves(fn, x, split, m, 9, 0.2, **tkw), whole):
            assert torch.equal(got, want)
    assert not torch.equal(fn(x[20:], m, 9, 0.2, **tkw)[0], whole[0][..., 20:, :]
                           if trajectory else whole[0][20:])
    with pytest.raises(ValueError, match="chain_offset"):
        fn(x, m, 9, 0.2, chain_offset=-1, **tkw)
