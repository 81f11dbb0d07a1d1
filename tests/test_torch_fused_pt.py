"""Parity of the port's whole-ladder parallel-tempering kernels with the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX Pallas kernels' injected-randomness path (``noise`` and
``swap_uniform``) in interpret mode on the same numpy inputs. Tolerance: atol
2e-5 on the ladder and the cold trajectory (float32; the tolerance of
tests/ops/test_pt_parity.py: both sides take the same exchange decisions on
these inputs, and a ladder of several replicas sums more rounding than one
chain).

The acceptance statistic is not compared with JAX: its injected path reports
0.0 (``fused_pt.py:412``, no tracking), and its PRNG path averages per grid
block over padded chains (``fused_pt.py:34-37``). The port reports the mean
accept probability of the last sweep over the real chains on both paths, and
it is held here to the generic loop's ``swap_acceptance_rate`` at atol 1e-5.
The CUDA kernels are held against the plain versions in
tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torchebm_tpu.ops import fused_pt as jpt
from torchebm_tpu_torch import core as tcore
from torchebm_tpu_torch import ops as tops
from torchebm_tpu_torch import samplers as ts
from torchebm_tpu_torch.ops import fused_pt as tpt

torch.set_num_threads(1)

ATOL = 2e-5
MEANS = np.array([[2.0, 0.0], [-2.0, 0.0], [0.0, 2.0]], np.float32)
LOGW = np.log(np.array([0.5, 0.3, 0.2])).astype(np.float32)
SCALE = 0.7


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def _inputs(seed, n_rep, n, d, n_steps, swap_every):
    rng = np.random.default_rng(seed)
    reps = rng.standard_normal((n_rep, n, d)).astype(np.float32)
    noise = rng.standard_normal((n_steps, n_rep, n, d)).astype(np.float32)
    swap_u = rng.uniform(size=(n_steps // swap_every, n_rep - 1, n)).astype(np.float32)
    return reps, noise, swap_u


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


# (R, n_chains, n_steps, swap_every, thin, clamp, precision)
CASES = [
    pytest.param(2, 41, 17, 5, None, None, False, id="R2-rem2"),
    pytest.param(3, 41, 17, 5, None, (-5.0, 5.0), False, id="R3-clamp"),
    pytest.param(4, 41, 17, 5, None, None, False, id="R4"),
    pytest.param(2, 16, 6, 3, None, None, True, id="R2-precision"),
    pytest.param(3, 33, 12, 4, 2, None, False, id="traj-R3-thin2"),
    pytest.param(2, 21, 11, 3, 4, (-4.0, 4.0), True, id="traj-R2-precision-rem"),
    pytest.param(2, 16, 3, 5, None, None, False, id="zero-sweeps"),
]


@pytest.mark.parametrize("n_rep, n, n_steps, swap_every, thin, clamp, precision", CASES)
def test_pt_plain_matches_jax_interpret(n_rep, n, n_steps, swap_every, thin, clamp, precision):
    reps, noise, swap_u = _inputs(10 * n_rep + n_steps, n_rep, n, 2, n_steps, swap_every)
    betas = tuple(1.6 ** -r for r in range(n_rep))
    if precision:
        cov = np.array([[2.0, 0.6], [0.6, 1.0]])
        mean = np.array([[1.0, -1.0]], np.float32)
        (jm, jp), (tm, tp) = _both(mean, np.linalg.inv(cov).astype(np.float32))
        jkw, tkw = dict(precision=jp), dict(precision=tp)
    else:
        (jm, jlw), (tm, tlw) = _both(MEANS, LOGW)
        jkw, tkw = dict(scale=SCALE, log_weights=jlw), dict(scale=SCALE, log_weights=tlw)
    (jr, jn, ju), (tr, tn, tu) = _both(reps, noise, swap_u)
    common = (n_steps, 0.04, 1.0, betas, swap_every)
    counts = tops.launch_counts()
    if thin is None:
        ref = jpt.pt_langevin_chain(jr, jm, *common, clamp=clamp, noise=jn, swap_uniform=ju,
                                    interpret=True, **jkw)
        out = tpt.pt_langevin_chain(tr, tm, *common, clamp=clamp, noise=tn, swap_uniform=tu,
                                    **tkw)
    else:
        ref = jpt.pt_langevin_chain_trajectory(jr, jm, *common, thin=thin, clamp=clamp, noise=jn,
                                               swap_uniform=ju, interpret=True, **jkw)
        out = tpt.pt_langevin_chain_trajectory(tr, tm, *common, thin=thin, clamp=clamp, noise=tn,
                                               swap_uniform=tu, **tkw)
        assert out[0].shape == (n_steps // thin, n, 2)
        _close(out[0], ref[0])
    ladder, acc = out[-2:]
    assert ladder.shape == (n_rep, n, 2) and acc.shape == ()
    _close(ladder, ref[-2])
    # the JAX injected path does not track the statistic; the port does
    assert float(ref[-1]) == 0.0
    if n_steps < swap_every:
        assert float(acc) == 0.0
    else:
        assert 0.0 < float(acc) <= 1.0
    assert tops.launch_counts() == counts  # the CPU path launches no kernel


def test_pt_swaps_actually_fire():
    """A cold/hot pair in opposite modes of a symmetric target, with uniforms
    0: the single sweep must exchange them (p = 1), in the JAX package and in
    the port alike."""
    b, d = 8, 2
    means = np.array([[4.0, 0.0], [-4.0, 0.0]], np.float32)
    reps = np.stack([np.tile([4.0, 0.0], (b, 1)), np.tile([-4.0, 0.0], (b, 1))]).astype(np.float32)
    noise = np.zeros((5, 2, b, d), np.float32)
    swap_u = np.zeros((1, 1, b), np.float32)
    (jr, jm, jn, ju), (tr, tm, tn, tu) = _both(reps, means, noise, swap_u)
    args = (5, 1e-6, 0.0, (1.0, 0.5), 5)
    ref, _ = jpt.pt_langevin_chain(jr, jm, *args, scale=0.5, noise=jn, swap_uniform=ju,
                                   interpret=True)
    ladder, acc = tpt.pt_langevin_chain(tr, tm, *args, scale=0.5, noise=tn, swap_uniform=tu)
    _close(ladder, ref)
    np.testing.assert_allclose(ladder[0, :, 0].numpy(), -4.0, atol=1e-3)
    np.testing.assert_allclose(ladder[1, :, 0].numpy(), 4.0, atol=1e-3)
    assert float(acc) == pytest.approx(1.0)


@pytest.mark.parametrize("n_rep", [4, 5])
def test_acceptance_is_the_loop_statistic_over_real_chains(n_rep):
    """The port's acceptance is the last sweep's mean accept probability over
    the real chains: the same number as the generic loop's
    ``swap_acceptance_rate`` (mean over chains, then over the pairs tried),
    for a sweep of each phase. The JAX kernel instead averages per grid
    block, padded chains included (``fused_pt.py:34-37``)."""
    n, d, swap_every = 41, 2, 1
    reps, noise, swap_u = _inputs(3, n_rep, n, d, 2, swap_every)
    _, (tr, tn, tu) = _both(reps, noise, swap_u)
    betas = tuple(1.6 ** -r for r in range(n_rep))
    temps = tuple(1.6 ** r for r in range(n_rep))
    mix = tcore.GaussianMixtureEnergy.create(torch.from_numpy(MEANS), scale=SCALE,
                                             weights=torch.tensor([0.5, 0.3, 0.2]))
    tkw = dict(scale=SCALE, log_weights=mix.log_weights)
    loop = ts.ParallelTemperingLangevin(mix, temperatures=temps, step_size=0.04, fused="off")
    state, tm = tr, mix.means
    for sweep in range(2):
        # the ladder just before sweep `sweep`: one Langevin step, no exchange
        pre, _ = tpt.pt_langevin_chain(state, tm, 1, 0.04, 1.0, betas, 2,
                                       noise=tn[sweep:sweep + 1],
                                       swap_uniform=tu[:0], **tkw)
        _, want = loop._swap(pre, sweep % 2, torch.Generator().manual_seed(0), {})
        state, acc = tpt.pt_langevin_chain(tr, tm, sweep + 1, 0.04, 1.0, betas, swap_every,
                                           noise=tn[:sweep + 1], swap_uniform=tu[:sweep + 1],
                                           **tkw)
        torch.testing.assert_close(acc, want, rtol=0, atol=1e-5)
        assert 0.0 < float(acc) < 1.0


def test_plain_functions_equal_the_cpu_wrappers():
    reps, noise, swap_u = _inputs(5, 3, 19, 2, 9, 2)
    _, (tr, tn, tu) = _both(reps, noise, swap_u)
    tm, tlw = torch.from_numpy(MEANS), torch.from_numpy(LOGW)
    args = (tr, tm, 9, 0.05, 0.8, (1.0, 0.6, 0.3), 2)
    for inj in ({}, dict(noise=tn, swap_uniform=tu)):
        kw = dict(scale=SCALE, log_weights=tlw, seed=3, **inj)
        a = tpt.pt_langevin_chain(*args, **kw)
        b = tpt.pt_langevin_chain_plain(*args, **kw)
        c = tpt.pt_langevin_chain_trajectory(*args, thin=3, **kw)
        e = tpt.pt_langevin_chain_trajectory_plain(*args, thin=3, **kw)
        for u, v in zip((*a, *c), (*b, *e)):
            torch.testing.assert_close(u, v, rtol=0, atol=0)
        # the trajectory kernel's ladder and acceptance are the chain kernel's
        torch.testing.assert_close(c[1:], a, rtol=0, atol=0)
        torch.testing.assert_close(c[0][-1], a[0][0], rtol=0, atol=0)


def test_philox_ladder_is_reproducible_seeded_and_correct_in_distribution():
    """The Philox path has no JAX run to match number for number (the Pallas
    PRNG path runs only on a TPU), so it is held to the target: on a Gaussian
    N(μ, 0.7² I) the cold replica keeps μ to 4-sigma and the variance to 15%
    (Langevin's O(η) bias at η = 0.02 is under 2%)."""
    n, d = 3000, 2
    mean = torch.tensor([[1.0, -2.0]])
    reps = mean + torch.zeros(3, n, d)
    args = (reps, mean, 150, 0.02, 1.0, (1.0, 0.5, 0.25), 5)
    a = tpt.pt_langevin_chain(*args, scale=0.7, seed=11)
    b = tpt.pt_langevin_chain(*args, scale=0.7, seed=11)
    c = tpt.pt_langevin_chain(*args, scale=0.7, seed=12)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a[0], c[0])
    cold = a[0][0]
    assert torch.all(torch.abs(cold.mean(0) - mean[0]) < 4 * 0.7 / np.sqrt(n))
    assert torch.all(torch.abs(cold.var(0) / 0.49 - 1.0) < 0.15)
    # hot replicas are wider: variance ~ 0.49 / β
    assert float(a[0][2].var(0).mean()) > 1.5
    assert 0.3 < float(a[1]) <= 1.0


def test_wrappers_reject_bad_inputs():
    reps, means = torch.zeros(2, 8, 2), torch.zeros(1, 2)
    with pytest.raises(ValueError, match="betas"):
        tpt.pt_langevin_chain(reps, means, 4, 0.01, 1.0, (1.0,), 2)
    with pytest.raises(ValueError, match=">= 2 replicas"):
        tpt.pt_langevin_chain(torch.zeros(1, 8, 2), means, 4, 0.01, 1.0, (1.0,), 2)
    with pytest.raises(ValueError, match="swap_every"):
        tpt.pt_langevin_chain(reps, means, 4, 0.01, 1.0, (1.0, 0.5), 0)
    with pytest.raises(ValueError, match="both"):
        tpt.pt_langevin_chain(reps, means, 4, 0.01, 1.0, (1.0, 0.5), 2,
                              noise=torch.zeros(4, 2, 8, 2))
    with pytest.raises(ValueError, match="noise must have shape"):
        tpt.pt_langevin_chain(reps, means, 4, 0.01, 1.0, (1.0, 0.5), 2,
                              noise=torch.zeros(3, 2, 8, 2), swap_uniform=torch.zeros(2, 1, 8))
    with pytest.raises(ValueError, match="swap_uniform must have shape"):
        tpt.pt_langevin_chain(reps, means, 4, 0.01, 1.0, (1.0, 0.5), 2,
                              noise=torch.zeros(4, 2, 8, 2), swap_uniform=torch.zeros(1, 1, 8))
    with pytest.raises(ValueError, match="at most 32"):
        tpt.pt_langevin_chain(torch.zeros(33, 4, 2), means, 4, 0.01, 1.0, [1.0] * 33, 2)
    with pytest.raises(ValueError, match=r"\(R, n_chains, d\)"):
        tpt.pt_langevin_chain(torch.zeros(2, 8), means, 4, 0.01, 1.0, (1.0, 0.5), 2)
    with pytest.raises(ValueError, match="thin"):
        tpt.pt_langevin_chain_trajectory(reps, means, 3, 0.01, 1.0, (1.0, 0.5), 2, thin=4)
    with pytest.raises(TypeError, match="float32"):
        tpt.pt_langevin_chain(reps.double(), means, 4, 0.01, 1.0, (1.0, 0.5), 2)
    with pytest.raises(ValueError, match="only CPU"):
        tpt.pt_langevin_chain(torch.zeros(2, 4, 2, device="meta"),
                              torch.zeros(1, 2, device="meta"), 4, 0.01, 1.0, (1.0, 0.5), 2)


# ------------------------------------------------------------------ launch plan


@pytest.mark.parametrize("n_rep", range(2, 33))
def test_pt_groups_keep_a_chain_in_one_warp(n_rep):
    """Every built group keeps a chain's Rp · G lanes in one warp, Rp the
    next power of two >= R: 1, 2, 4 and 8 lanes per replica up to 4
    replicas, 1, 2 and 4 up to 8, 1 and 2 up to 16, one lane above, and one
    lane wherever the dispatch builds no group (d > 16, one component).
    Every plan, picked or forced, launches one of them with a grid that
    holds every chain and no block past the last."""
    rp = 1 << (n_rep - 1).bit_length()
    in_warp = ((1, 2, 4, 8) if n_rep <= 4 else (1, 2, 4) if n_rep <= 8
               else (1, 2) if n_rep <= 16 else (1,))
    for d, k, gaussian, want in ((2, 8, False, in_warp), (16, 8, False, in_warp),
                                 (4, 1, True, in_warp), (32, 1, True, (1,)),
                                 (2, 1, False, (1,))):
        built = tpt.pt_groups(n_rep, d, k, gaussian)
        assert built == want
        assert 1 in built and all(rp * g <= 32 for g in built)
        for group in (None, *built):
            got, threads, blocks = tpt.pt_launch_plan(1001, n_rep, d, k, gaussian, group=group)
            assert got in built and (group is None or got == group)
            assert threads % 32 == 0 and threads == tpt.PT_THREADS
            assert blocks * threads >= 1001 * rp * got > (blocks - 1) * threads


# (n chains, R, d, K, gaussian, the plan's group): the main shape and the
# ring's other ladders (2 lanes), the warp's bound at R = 16 and R > 16,
# rings whose components fill 4 lanes but not 2 (K = 12, 16; at R = 8 too),
# rings past that (K = 24, 33), mixtures at d = 3, 8, 16, full-covariance
# Gaussians (1 lane above d = 8), one component, and no halving at 100,000
# and 300,000 chains
PT_PLAN_CASES = [
    (10_000, 4, 2, 8, False, 2), (10_000, 2, 2, 8, False, 2), (10_000, 3, 2, 8, False, 2),
    (10_000, 8, 2, 8, False, 2), (10_000, 16, 2, 8, False, 2), (10_000, 17, 2, 8, False, 1),
    (10_000, 4, 2, 12, False, 4), (10_000, 4, 2, 16, False, 4), (10_000, 8, 2, 16, False, 4),
    (10_000, 16, 2, 16, False, 2), (10_000, 4, 2, 24, False, 2), (10_000, 4, 2, 33, False, 2),
    (10_000, 4, 3, 8, False, 2), (10_000, 4, 8, 16, False, 2), (10_000, 4, 16, 2, False, 2),
    (10_000, 4, 16, 8, False, 4), (10_000, 4, 2, 1, True, 2), (10_000, 4, 8, 1, True, 2),
    (10_000, 4, 16, 1, True, 1), (10_000, 4, 32, 1, True, 1), (10_000, 4, 2, 1, False, 1),
    (100_000, 4, 2, 16, False, 4), (300_000, 4, 2, 8, False, 2),
]


@pytest.mark.parametrize("n, n_rep, d, k, gaussian, group", PT_PLAN_CASES,
                         ids=[f"n{n}-R{r}-d{d}-k{k}" + ("-gauss" if g else "")
                              for n, r, d, k, g, _ in PT_PLAN_CASES])
def test_pt_launch_plan(n, n_rep, d, k, gaussian, group):
    """The group the card's timings pick, with no halving at large ``n``,
    and the same plan when the group is passed back as the override."""
    got, threads, blocks = tpt.pt_launch_plan(n, n_rep, d, k, gaussian)
    assert got == group
    assert tpt.pt_launch_plan(n, n_rep, d, k, gaussian, group=group) == (got, threads, blocks)


@pytest.mark.parametrize("n_rep, d, k, gaussian, group", [
    (4, 2, 8, False, 3), (4, 2, 8, False, 16), (8, 2, 8, False, 8), (16, 2, 8, False, 4),
    (17, 2, 8, False, 2), (32, 2, 8, False, 2), (4, 17, 8, False, 2), (4, 32, 1, True, 2),
    (4, 2, 1, False, 2), (2, 2, 8, False, 16),
])
def test_pt_launch_plan_refuses_groups_not_built(n_rep, d, k, gaussian, group):
    """``group=`` takes only a built group that keeps the chain in one warp."""
    with pytest.raises(ValueError, match="no ladder kernel"):
        tpt.pt_launch_plan(100, n_rep, d, k, gaussian, group=group)


def _pt_halves(fn, reps, split, *args, noise=None, swap_uniform=None, **kw):
    """``fn`` over chains ``[0, split)`` and ``[split, n)`` of the ladder, each
    at its place in the whole ladder (``chain_offset``, ``total_chains``) and
    with its chains of the injected draws (their chain axis, not dim 0): the
    trajectories and ladders concatenated along the chains, the per-chain
    acceptance as the mean over every chain."""
    n = reps.shape[1]
    parts = []
    for a, b in ((0, split), (split, n)):
        inj = {} if noise is None else dict(noise=noise[:, :, a:b].contiguous(),
                                             swap_uniform=swap_uniform[:, :, a:b].contiguous())
        out = fn(reps[:, a:b].contiguous(), *args, chain_offset=a, total_chains=n, **inj, **kw)
        parts.append((out, b - a))
    *tensors, acc = zip(*[p for p, _ in parts])
    pooled = sum(float(a) * m for a, (_, m) in zip(acc, parts)) / n
    return [torch.cat(t, dim=1) for t in tensors], pooled


@pytest.mark.parametrize("trajectory", [False, True], ids=["final", "trajectory"])
@pytest.mark.parametrize("n_rep", [2, 3])
def test_offset_halves_match_jax_interpret(trajectory, n_rep):
    """Two shards of one ladder, each through the plain version at its place
    in the whole batch with its chains of the injected normals and exchange
    uniforms, together equal the JAX kernel on the whole ladder."""
    n, n_steps, swap_every = 33, 12, 4
    reps, noise, swap_u = _inputs(40 + n_rep, n_rep, n, 2, n_steps, swap_every)
    betas = tuple(1.6 ** -r for r in range(n_rep))
    (jm, jlw), (tm, tlw) = _both(MEANS, LOGW)
    (jr, jn, ju), (tr, tn, tu) = _both(reps, noise, swap_u)
    common = (n_steps, 0.04, 1.0, betas, swap_every)
    jkw = dict(scale=SCALE, log_weights=jlw, noise=jn, swap_uniform=ju, interpret=True)
    if trajectory:
        ref = jpt.pt_langevin_chain_trajectory(jr, jm, *common, thin=3, **jkw)[:2]
        fn, kw = tpt.pt_langevin_chain_trajectory_plain, dict(thin=3)
    else:
        ref = jpt.pt_langevin_chain(jr, jm, *common, **jkw)[:1]
        fn, kw = tpt.pt_langevin_chain_plain, {}
    out, acc = _pt_halves(fn, tr, 14, tm, *common, noise=tn, swap_uniform=tu, scale=SCALE,
                          log_weights=tlw, **kw)
    for o, r in zip(out, ref):
        _close(o, r)
    whole_acc = fn(tr, tm, *common, noise=tn, swap_uniform=tu, scale=SCALE, log_weights=tlw,
                   **kw)[-1]
    assert abs(acc - float(whole_acc)) <= 1e-6


@pytest.mark.parametrize("trajectory", [False, True], ids=["final", "trajectory"])
def test_philox_offset_halves_equal_the_whole_launch(trajectory):
    """On the Philox stream two launches over chains ``[0, a)`` and ``[a, n)``
    at ``chain_offset`` a and ``total_chains`` n equal one over every chain,
    bitwise, exchange uniforms included (index ``r·n + c``, not ``r·n_local +
    c``); a shard numbered as a whole batch draws other numbers."""
    n, n_rep = 37, 4
    reps, _, _ = _inputs(51, n_rep, n, 2, 10, 2)
    tr, tm, tlw = torch.from_numpy(reps), torch.from_numpy(MEANS), torch.from_numpy(LOGW)
    betas = tuple(1.6 ** -r for r in range(n_rep))
    common = (10, 0.04, 1.0, betas, 2)
    kw = dict(scale=SCALE, log_weights=tlw, seed=2**33 + 1, **({"thin": 2} if trajectory else {}))
    fn = tpt.pt_langevin_chain_trajectory_plain if trajectory else tpt.pt_langevin_chain_plain
    whole = fn(tr, tm, *common, **kw)
    for split in (9, 20):
        out, acc = _pt_halves(fn, tr, split, tm, *common, **kw)
        for got, want in zip(out, whole[:-1]):
            assert torch.equal(got, want)
        assert abs(acc - float(whole[-1])) <= 1e-6
    alone = fn(tr[:, 20:].contiguous(), tm, *common, **kw)[-2]
    assert not torch.equal(alone, whole[-2][:, 20:])
    with pytest.raises(ValueError, match="total_chains"):
        fn(tr[:, 20:].contiguous(), tm, *common, chain_offset=20, total_chains=36, **kw)
