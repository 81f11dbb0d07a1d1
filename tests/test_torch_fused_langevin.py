"""Parity of the port's whole-chain Langevin kernels with the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX Pallas kernels' injected-noise path in interpret mode
on the same numpy inputs, at atol 1e-5 (float32, the tolerance of
tests/ops/test_chain_parity.py). The Philox twin is checked against the
Random123 known-answer vectors. The CUDA kernels themselves are held against
the plain versions in tests/test_torch_kernels_gpu.py.
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torchebm_tpu.ops import fused_langevin as jfl
from torchebm_tpu_torch.ops import _build
from torchebm_tpu_torch.ops import fused_langevin as tfl

torch.set_num_threads(1)

ATOL = 1e-5
N_CHAINS = 37  # not a multiple of any block size


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _schedule(rng, n_steps, lo, hi):
    return rng.uniform(lo, hi, n_steps).astype(np.float32)


def _jax(a):
    return a if isinstance(a, float) else jnp.asarray(a)


def _torch(a):
    return a if isinstance(a, float) else torch.from_numpy(a)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


# (d, K, n_steps, thin, schedule, clamp, log_weights, precision)
MIXTURE_CASES = [
    pytest.param(2, 8, 12, None, False, None, True, False, id="8gauss-const"),
    pytest.param(3, 4, 11, None, False, (-1.5, 1.5), False, False, id="d3-clamp-uniform-w"),
    pytest.param(2, 3, 10, None, True, None, True, False, id="sched"),
    pytest.param(3, 1, 10, None, False, None, False, True, id="precision-d3"),
    pytest.param(2, 8, 17, 3, False, (-3.0, 3.0), True, False, id="traj-thin3-rem2-clamp"),
    pytest.param(3, 1, 14, 4, True, None, False, True, id="traj-sched-precision"),
]


@pytest.mark.parametrize("d, k, n_steps, thin, sched, clamp, weights, precision", MIXTURE_CASES)
def test_mixture_chain_plain_matches_jax_interpret(d, k, n_steps, thin, sched, clamp,
                                                   weights, precision):
    rng = _rng(1000 * n_steps + 10 * d + k)
    x0 = _normal(rng, N_CHAINS, d)
    means = _normal(rng, k, d, scale=2.0)
    noise = _normal(rng, n_steps, N_CHAINS, d)
    h = _schedule(rng, n_steps, 0.01, 0.05) if sched else 0.03
    ns = _schedule(rng, n_steps, 0.5, 1.0) if sched else 0.8
    kw_np = dict(scale=0.9, clamp=clamp)
    if weights:
        w = rng.uniform(0.5, 2.0, k)
        kw_np["log_weights"] = np.log(w / w.sum()).astype(np.float32)
    if precision:
        a = _normal(rng, d, d, scale=0.3)
        kw_np["precision"] = (a @ a.T + np.eye(d)).astype(np.float32)

    jkw = {key: _jax(v) if isinstance(v, np.ndarray) else v for key, v in kw_np.items()}
    tkw = {key: _torch(v) if isinstance(v, np.ndarray) else v for key, v in kw_np.items()}
    jargs = (jnp.asarray(x0), jnp.asarray(means), n_steps, _jax(h), _jax(ns))
    counts = _build.launch_counts()
    targs = (torch.from_numpy(x0), torch.from_numpy(means), n_steps, _torch(h), _torch(ns))
    if thin is None:
        ref = jfl.mixture_langevin_chain(
            *jargs, noise=jnp.asarray(noise), interpret=True, **jkw
        )
        out = tfl.mixture_langevin_chain(*targs, noise=torch.from_numpy(noise), **tkw)
        _close(out, ref)
    else:
        ref_traj, ref_final = jfl.mixture_langevin_chain_trajectory(
            *jargs, thin=thin, noise=jnp.asarray(noise), interpret=True, **jkw
        )
        traj, final = tfl.mixture_langevin_chain_trajectory(
            *targs, thin=thin, noise=torch.from_numpy(noise), **tkw
        )
        assert traj.shape == (n_steps // thin, N_CHAINS, d)
        _close(traj, ref_traj)
        _close(final, ref_final)
    assert _build.launch_counts() == counts  # the CPU path launches no kernel


@pytest.mark.parametrize("trajectory", [False, True], ids=["final", "trajectory"])
@pytest.mark.parametrize("precision", [False, True], ids=["ring", "precision"])
def test_mixture_chain_offset_reproduces_the_whole_launch(trajectory, precision):
    """The plain version over chains ``[a, b)`` at ``chain_offset=a`` equals
    rows ``[a, b)`` of the launch over every chain (a sharded batch's
    shards); at offset 0 it is the call without the argument; injected noise
    ignores it. The whole launch's own stream is held to the JAX kernel by
    the tests above. Tolerance 1e-6: the CPU's products round by batch size
    (a wrong stream would differ by O(1))."""
    rng = _rng(7 + precision)
    d, k = (3, 1) if precision else (2, 8)
    x0 = torch.from_numpy(_normal(rng, N_CHAINS, d))
    means = torch.from_numpy(_normal(rng, k, d, scale=2.0))
    kw = dict(scale=0.7, seed=2**40 + 3)
    if precision:
        a = _normal(rng, d, d, scale=0.3)
        kw["precision"] = torch.from_numpy((a @ a.T + np.eye(d)).astype(np.float32))
    wrapper = tfl.mixture_langevin_chain_trajectory if trajectory else tfl.mixture_langevin_chain
    plain = (tfl.mixture_langevin_chain_trajectory_plain if trajectory
             else tfl.mixture_langevin_chain_plain)
    if trajectory:
        kw["thin"] = 3

    def run(fn, x, **more):
        out = fn(x, means, 10, 0.05, 0.9, **kw, **more)
        return torch.cat([out[0].movedim(1, 0).flatten(1), out[1]], dim=1) if trajectory else out

    def close(got, want):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)

    whole = run(wrapper, x0)
    for a, b in ((0, 5), (5, 20), (20, N_CHAINS)):
        for fn in (wrapper, plain):
            close(run(fn, x0[a:b], chain_offset=a), whole[a:b])
    assert torch.equal(run(wrapper, x0, chain_offset=0), whole)
    assert (run(wrapper, x0[5:], chain_offset=5) - run(wrapper, x0[5:])).abs().max() > 0.1
    noise = torch.from_numpy(_normal(rng, 10, N_CHAINS - 5, d))
    assert torch.equal(run(wrapper, x0[5:], noise=noise, chain_offset=5),
                       run(wrapper, x0[5:], noise=noise))
    with pytest.raises(ValueError, match="chain_offset"):
        run(wrapper, x0, chain_offset=-1)


# (d, K, gaussian): K at d = 2 (the ring is K = 8), a d in every bucket 1-64
# at K = 8, the full-covariance Gaussian
PLAN_TARGETS = (
    [(2, k, False) for k in (1, 2, 3, 5, 8, 9, 33, 512)]
    + [(d, 8, False) for d in (1, 3, 4, 5, 8, 9, 16, 17, 32, 33, 64)]
    + [(2, 1, True), (16, 1, True), (32, 1, True)]
)


@pytest.mark.parametrize("n", [1, 31, 10_000])
@pytest.mark.parametrize("d, k, gaussian", PLAN_TARGETS,
                         ids=[f"d{d}-k{k}" + ("-gauss" if g else "") for d, k, g in PLAN_TARGETS])
def test_mixture_launch_plan(n, d, k, gaussian):
    """Up to 16 components the group is the power of two that covers them, at
    most 4 lanes; above, 8; one lane for the full-covariance Gaussian, one
    component and d > 16; the grid holds every chain's group and no block
    past the last chain."""
    group, threads, blocks = tfl.mixture_launch_plan(n, d, k, gaussian)
    if gaussian or k == 1 or d > 16:
        assert group == 1
    elif k <= 16:
        assert group == min(4, 2 ** int(np.ceil(np.log2(k))))
        assert k <= 4 * group and group // 2 < k
    else:
        assert group == 8
    assert group in tfl.MIXTURE_GROUPS
    assert threads == tfl.MIXTURE_THREADS and threads % 32 == 0 and 128 <= threads <= 256
    assert blocks * threads // group >= n > (blocks - 1) * threads // group
    assert tfl.mixture_launch_plan(n, d, k, gaussian, group=group) == (group, threads, blocks)


@pytest.mark.parametrize("n, k, group", [(65_000, 8, 4), (100_000, 8, 2), (100_000, 33, 2),
                                          (140_000, 33, 1), (1_000_000, 8, 1)])
def test_mixture_launch_plan_stops_at_the_resident_threads(n, k, group):
    """Past the threads the card holds at once more lanes only add work: the
    group halves until ``n * group`` fits (or one lane is left)."""
    assert tfl.mixture_launch_plan(n, 2, k, False)[0] == group
    assert group == 1 or n * group <= tfl.MIXTURE_RESIDENT_THREADS < 2 * n * group


def test_mixture_launch_plan_rejects_groups_without_a_kernel():
    assert tfl.mixture_launch_plan(10_000, 2, 8, False, group=2)[0] == 2
    for d, k, gaussian, group in ((2, 8, False, 3), (2, 8, False, 16), (2, 1, True, 2),
                                  (17, 8, False, 2), (2, 1, False, 4)):
        with pytest.raises(ValueError, match="no mixture chain kernel"):
            tfl.mixture_launch_plan(100, d, k, gaussian, group=group)


# (shape, n_steps, thin, schedule, clamp)
DOUBLEWELL_CASES = [
    pytest.param((N_CHAINS, 3), 17, None, False, (-1.5, 1.5), id="const-clamp"),
    pytest.param((N_CHAINS, 2), 13, None, True, None, id="sched"),
    pytest.param((N_CHAINS, 3), 17, 3, False, None, id="traj-thin3-rem2"),
    pytest.param((5, 4, 3), 16, 5, True, (-1.2, 1.2), id="traj-sched-clamp-3d"),
    pytest.param((N_CHAINS, 5), 19, 6, True, (-1.4, 1.4), id="traj-thin6-rem3-sched-clamp"),
]


@pytest.mark.parametrize("shape, n_steps, thin, sched, clamp", DOUBLEWELL_CASES)
def test_doublewell_chain_plain_matches_jax_interpret(shape, n_steps, thin, sched, clamp):
    rng = _rng(100 * n_steps + len(shape))
    x0 = _normal(rng, *shape)
    noise = _normal(rng, n_steps, *shape)
    h = _schedule(rng, n_steps, 0.005, 0.02) if sched else 0.01
    ns = _schedule(rng, n_steps, 0.5, 1.0) if sched else 0.8
    kw = dict(barrier_height=1.5, b=0.9, clamp=clamp)
    jargs = (jnp.asarray(x0), n_steps, _jax(h), _jax(ns))
    targs = (torch.from_numpy(x0), n_steps, _torch(h), _torch(ns))
    if thin is None:
        ref = jfl.doublewell_langevin_chain(
            *jargs, noise=jnp.asarray(noise), interpret=True, **kw
        )
        _close(tfl.doublewell_langevin_chain(*targs, noise=torch.from_numpy(noise), **kw), ref)
    else:
        ref_traj, ref_final = jfl.doublewell_langevin_chain_trajectory(
            *jargs, thin=thin, noise=jnp.asarray(noise), interpret=True, **kw
        )
        traj, final = tfl.doublewell_langevin_chain_trajectory(
            *targs, thin=thin, noise=torch.from_numpy(noise), **kw
        )
        assert traj.shape == (n_steps // thin, *shape)
        _close(traj, ref_traj)
        _close(final, ref_final)


def _quad_stream_by_hand(n_elems, n_steps, seed):
    """Step t's normals of elements 0..n_elems-1, built from the Philox words:
    counter (e lo, t // 4, 0, e hi), normal t % 4 of the block's two
    Box-Muller pairs; and each (element, step)'s (counter, word)."""
    e = torch.arange(n_elems, dtype=torch.int64)
    steps, keys = [], []
    for t in range(n_steps):
        o = tfl.philox4x32_10(e & M32, t // 4, 0, e >> 32, seed, seed >> 32)
        steps.append((tfl._box_muller(o[0], o[1]) + tfl._box_muller(o[2], o[3]))[t % 4])
        keys += [(i & M32, t // 4, 0, i >> 32, t % 4) for i in e.tolist()]
    return torch.stack(steps), keys


@pytest.mark.parametrize("n_steps", [4, 5, 6, 7])
def test_doublewell_plain_draws_the_quad_stream(n_steps):
    """The plain twin's normals are the quad stream bit for bit: with no
    barrier, unit noise coefficient (η = 1/2, noise scale 1) and x0 = 0 each
    kept state is the running float32 sum of the steps' normals."""
    seed = (3 << 32) | 9
    shape = (3, 5)
    z, _ = _quad_stream_by_hand(15, n_steps, seed)
    for fn in (tfl.doublewell_langevin_chain_trajectory,
               tfl.doublewell_langevin_chain_trajectory_plain):
        traj, final = fn(torch.zeros(shape), n_steps, 0.5, 1.0, barrier_height=0.0, seed=seed)
        x = torch.zeros(15)
        for t in range(n_steps):
            x = x + z[t]
            assert torch.equal(traj[t].reshape(-1), x), t
        assert torch.equal(final.reshape(-1), x)
    assert torch.equal(torch.stack(list(tfl.doublewell_normals(torch.arange(15), n_steps, seed))),
                       z)


def test_doublewell_stream_is_sound():
    """4,096 elements x 64 steps of the quad stream: standard normals, no
    correlation between consecutive steps of an element (within a quad and
    across quads) or between neighbouring elements, and no two (element,
    step) pairs reading the same Philox (counter, word)."""
    n, n_steps, seed = 4096, 64, 2024
    z = torch.stack(list(tfl.doublewell_normals(torch.arange(n), n_steps, seed))).double()
    want, keys = _quad_stream_by_hand(n, n_steps, seed)
    assert torch.equal(z.float(), want)
    assert len(set(keys)) == n * n_steps
    assert abs(float(z.mean())) < 0.02 and abs(float(z.var()) - 1.0) < 0.03

    def corr(a, b):
        a, b = a - a.mean(), b - b.mean()
        return float((a * b).sum() / (a.norm() * b.norm()))

    t = torch.arange(n_steps - 1)
    within, across = t[t % 4 != 3], t[t % 4 == 3]
    assert abs(corr(z[within], z[within + 1])) < 0.02
    assert abs(corr(z[across], z[across + 1])) < 0.02
    assert abs(corr(z[:, :-1], z[:, 1:])) < 0.02


def test_doublewell_constant_schedule_equals_its_table():
    """A constant (step size, noise scale) pair, which the kernels take as
    two floats, runs the chain the same (n_steps,) schedule runs from its
    table: η = 2^-7 and noise scale 0.7 give the same float32 coefficient
    both ways."""
    rng = _rng(5)
    x0 = torch.from_numpy(_normal(rng, 37, 3, scale=0.5))
    n_steps, h, ns = 11, 2.0**-7, 0.7
    const = tfl._constant_schedule(h, ns)
    table = tfl._schedule_table(torch.full((n_steps,), h), torch.full((n_steps,), ns), n_steps,
                                x0.device)
    assert torch.equal(table, torch.tensor(const, dtype=torch.float32)[:, None].expand(2, n_steps))
    kw = dict(seed=41, clamp=(-1.5, 1.5))
    torch.testing.assert_close(
        tfl.doublewell_langevin_chain(x0, n_steps, h, ns, **kw),
        tfl.doublewell_langevin_chain(x0, n_steps, torch.full((n_steps,), h),
                                      torch.full((n_steps,), ns), **kw), rtol=0, atol=0)
    a = tfl.doublewell_langevin_chain_trajectory(x0, n_steps, h, ns, thin=3, **kw)
    b = tfl.doublewell_langevin_chain_trajectory(x0, n_steps, torch.full((n_steps,), h), ns,
                                                 thin=3, **kw)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


def test_doublewell_seed_as_int_or_tensor():
    """A 0-d int64 seed tensor keys the same stream as its int; a seed of
    another type or shape raises."""
    x0 = torch.zeros(6, 2)
    a = tfl.doublewell_langevin_chain(x0, 6, 0.1, seed=(5 << 32) | 3)
    b = tfl.doublewell_langevin_chain(x0, 6, 0.1, seed=torch.tensor((5 << 32) | 3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for bad in (torch.tensor([3]), torch.tensor(3, dtype=torch.int32)):
        with pytest.raises(ValueError, match="0-d int64"):
            tfl.doublewell_langevin_chain(x0, 6, 0.1, seed=bad)


# ------------------------------------------------------------------ one step


@pytest.mark.parametrize("shape", [(4096, 32), (5, 7, 3), (13,)], ids=["4096x32", "5x7x3", "13"])
@pytest.mark.parametrize("clamp", [None, (-1.0, 1.0)], ids=["free", "clamp"])
def test_fused_step_plain_matches_jax_interpret(shape, clamp):
    """``fused_langevin_step`` with injected noise: the JAX kernel's
    self-test shape (4,096 x 32, ``fused_langevin.py:1617-1625``) and shapes
    whose size is not a multiple of 4, at atol 1e-6 (one multiply-add)."""
    rng = _rng(sum(shape))
    x, g, eps = (_normal(rng, *shape) for _ in range(3))
    ref = jfl.fused_langevin_step(jnp.asarray(x), jnp.asarray(g), 0.01, 0.8, clamp=clamp,
                                  noise=jnp.asarray(eps), interpret=True)
    counts = _build.launch_counts()
    out = tfl.fused_langevin_step(torch.from_numpy(x), torch.from_numpy(g), 0.01, 0.8,
                                  clamp=clamp, noise=torch.from_numpy(eps))
    assert out.shape == shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    # the update the JAX self-test holds its kernel to, in float64
    want = np.asarray(x, np.float64) - 0.01 * g + 0.8 * np.sqrt(0.02) * eps
    if clamp is not None:
        want = np.clip(want, *clamp)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-6)
    assert _build.launch_counts() == counts


def test_fused_step_philox_layout_is_reproducible_and_seeded():
    """Elements 4q..4q+3 take the four normals of counter (q, 0, 0), whatever
    the shape; the stream depends on the seed."""
    x, g = torch.zeros(6, 5), torch.zeros(6, 5)
    a = tfl.fused_langevin_step(x, g, 0.5, seed=9)
    torch.testing.assert_close(a, tfl.fused_langevin_step(x, g, 0.5, seed=9), rtol=0, atol=0)
    assert not torch.equal(a, tfl.fused_langevin_step(x, g, 0.5, seed=10))
    z = tfl.philox_normals(torch.arange(8), 0, 4, 9).reshape(-1)[:30]
    torch.testing.assert_close(a.reshape(-1), z, rtol=0, atol=0)  # √(2·0.5) = 1
    torch.testing.assert_close(tfl.fused_langevin_step_plain(x, g, 0.5, seed=9), a,
                               rtol=0, atol=0)
    # noise_scale 0 is plain gradient descent
    big = torch.randn(1000)
    torch.testing.assert_close(tfl.fused_langevin_step(big, big, 0.1, 0.0), big - 0.1 * big,
                               rtol=0, atol=0)


def test_fused_step_rejects_bad_inputs():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="grad must have shape"):
        tfl.fused_langevin_step(x, torch.zeros(3, 4), 0.1)
    with pytest.raises(ValueError, match="noise must have shape"):
        tfl.fused_langevin_step(x, x, 0.1, noise=torch.zeros(12))
    with pytest.raises(TypeError, match="float32"):
        tfl.fused_langevin_step(x.double(), x, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        tfl.fused_langevin_step(x.T, x.T, 0.1)
    with pytest.raises(ValueError, match="at least one"):
        tfl.fused_langevin_step(torch.zeros(0), torch.zeros(0), 0.1)
    with pytest.raises(ValueError, match="only CPU"):
        tfl.fused_langevin_step(torch.zeros(4, device="meta"), torch.zeros(4, device="meta"), 0.1)


# ------------------------------------------------------------------ Philox


M32 = 0xFFFFFFFF


@pytest.mark.parametrize(
    "ctr, key, expected",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ],
)
def test_philox_known_answers(ctr, key, expected):
    """Random123's Philox4x32-10 known-answer vectors, on int64 tensors."""
    words = [torch.tensor([c], dtype=torch.int64) for c in ctr]
    out = tfl.philox4x32_10(*words, *key)
    assert tuple(int(o) for o in out) == expected


def test_philox_normals_are_standard_and_keyed():
    index = torch.arange(50_000)
    z = tfl.philox_normals(index, step=3, n_coords=6, seed=(7 << 32) | 11)
    assert z.shape == (50_000, 6) and z.dtype == torch.float32
    # 4-sigma bounds for the mean and variance of 300k normals
    assert abs(float(z.mean())) < 4 / np.sqrt(z.numel())
    assert abs(float(z.var()) - 1.0) < 4 * np.sqrt(2 / z.numel())
    corr = np.corrcoef(z.numpy().T)
    assert np.max(np.abs(corr - np.eye(6))) < 0.03
    # the stream depends on the step and on both halves of the seed
    again = tfl.philox_normals(index[:8], step=3, n_coords=6, seed=(7 << 32) | 11)
    torch.testing.assert_close(again, z[:8], rtol=0, atol=0)
    for step, seed in ((4, (7 << 32) | 11), (3, (8 << 32) | 11), (3, (7 << 32) | 12)):
        other = tfl.philox_normals(index[:8], step=step, n_coords=6, seed=seed)
        assert not torch.equal(other, z[:8])


def test_plain_philox_chain_is_reproducible_and_seeded():
    x0 = torch.zeros(64, 2)
    means = torch.tensor([[1.0, 0.0], [-1.0, 0.0]])
    a = tfl.mixture_langevin_chain(x0, means, 5, 0.05, seed=123)
    b = tfl.mixture_langevin_chain(x0, means, 5, 0.05, seed=123)
    c = tfl.mixture_langevin_chain(x0, means, 5, 0.05, seed=124)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


# ------------------------------------------------------------------ guards


def test_wrappers_reject_bad_inputs():
    x0 = torch.zeros(8, 2)
    means = torch.zeros(3, 2)
    with pytest.raises(TypeError, match="float32"):
        tfl.mixture_langevin_chain(x0.double(), means, 2, 0.1)
    with pytest.raises(ValueError, match="noise must have shape"):
        tfl.mixture_langevin_chain(x0, means, 2, 0.1, noise=torch.zeros(3, 8, 2))
    with pytest.raises(ValueError, match="means must have shape"):
        tfl.mixture_langevin_chain(x0, torch.zeros(3, 5), 2, 0.1)
    with pytest.raises(ValueError, match="supported sizes"):
        tfl.mixture_langevin_chain(torch.zeros(4, 65), torch.zeros(1, 65), 2, 0.1)
    with pytest.raises(ValueError, match="precision= requires"):
        tfl.mixture_langevin_chain(x0, means, 2, 0.1, precision=torch.eye(2))
    with pytest.raises(ValueError, match="d=33"):
        tfl.mixture_langevin_chain(
            torch.zeros(4, 33), torch.zeros(1, 33), 2, 0.1, precision=torch.eye(33)
        )
    with pytest.raises(ValueError, match="per-step schedule"):
        tfl.mixture_langevin_chain(x0, means, 2, torch.full((3,), 0.1))
    with pytest.raises(ValueError, match="thin"):
        tfl.doublewell_langevin_chain_trajectory(x0, 3, 0.1, thin=4)
    with pytest.raises(ValueError, match="contiguous"):
        tfl.doublewell_langevin_chain(torch.zeros(2, 8).T, 3, 0.1)
    with pytest.raises(ValueError, match="only CPU"):
        tfl.doublewell_langevin_chain(torch.zeros(4, device="meta"), 3, 0.1)


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library()


def test_library_path_is_keyed_by_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("torchebm_kernels_") and path.suffix == ".so"
    assert path == _build.library_path()


def test_library_path_follows_every_source_and_header(monkeypatch, tmp_path):
    """The library's name hashes the ``*.cuh`` headers too: editing the shared
    header alone names a new library, so it is rebuilt; a file of another
    kind does not."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path()
    assert sorted(p.name for p in _build._sources()) == [
        "fused_adaln.cu", "fused_ais.cu", "fused_gated_residual.cu", "fused_hmc.cu",
        "fused_langevin.cu", "fused_mala.cu", "fused_mlp_langevin.cu", "fused_pt.cu",
        "fused_sinkhorn.cu", "fused_step.cu"]
    (csrc / "notes.txt").write_text("not a source")
    assert _build.library_path() == before
    header = csrc / "tebm_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = _build.library_path()
    assert edited != before
    (csrc / "fused_mala.cu").write_text((csrc / "fused_mala.cu").read_text() + "\n")
    assert _build.library_path() not in (before, edited)


def test_launch_counts_cover_every_kernel_wrapper():
    from torchebm_tpu_torch import ops

    assert set(ops.launch_counts()) == {
        "mixture_langevin_chain", "mixture_langevin_chain_trajectory",
        "doublewell_langevin_chain", "doublewell_langevin_chain_trajectory",
        "mixture_mala_chain", "mixture_mala_chain_trajectory",
        "mixture_hmc_chain", "mixture_hmc_chain_trajectory",
        "pt_langevin_chain", "pt_langevin_chain_trajectory", "mixture_ais_run",
        "fused_langevin_step", "mlp_langevin_chain", "sinkhorn_log_fused",
        "adaln_modulate", "adaln_modulate_backward", "gated_residual", "gated_residual_backward",
    }
    saved = ops.launch_counts()
    try:
        tfl.doublewell_langevin_chain.launches += 2
        assert ops.launch_counts()["doublewell_langevin_chain"] == saved[
            "doublewell_langevin_chain"] + 2
        ops.reset_launch_counts()
        assert set(ops.launch_counts().values()) == {0}
    finally:
        for fn in _build._COUNTED:
            fn.launches = saved[fn.__name__]


def _dw_halves(fn, x0, split, *args, noise=None, **kw):
    """``fn`` over rows ``[0, split)`` and ``[split, n)`` of the state, each at
    its first element (row times elements per row) as ``chain_offset`` with
    its rows of the injected normals, concatenated along the rows (a
    trajectory's dim 1)."""
    per_row = x0[0].numel()
    parts = []
    for a, b in ((0, split), (split, x0.shape[0])):
        inj = {} if noise is None else dict(noise=noise[:, a:b].contiguous())
        out = fn(x0[a:b].contiguous(), *args, chain_offset=a * per_row, **inj, **kw)
        parts.append(out if isinstance(out, tuple) else (out,))
    return [torch.cat(p, dim=1 if i == 0 and len(p[0].shape) > x0.ndim else 0)
            for i, p in enumerate(zip(*parts))]


@pytest.mark.parametrize("trajectory", [False, True], ids=["final", "trajectory"])
@pytest.mark.parametrize("shape", [(N_CHAINS, 3), (9, 4, 3)], ids=["2d", "3d"])
def test_doublewell_offset_halves_match_jax_interpret(trajectory, shape):
    """Two row shards of one state, each through the plain version at its
    first element's index with its rows of the injected normals, together
    equal the JAX kernel on the whole state."""
    rng = _rng(300 + len(shape))
    x0 = _normal(rng, *shape)
    noise = _normal(rng, 13, *shape)
    kw = dict(barrier_height=1.5, b=0.9, clamp=(-1.4, 1.4))
    jargs = (jnp.asarray(x0), 13, 0.01, 0.8)
    if trajectory:
        ref = jfl.doublewell_langevin_chain_trajectory(*jargs, thin=4, noise=jnp.asarray(noise),
                                                       interpret=True, **kw)
        fn, kw = tfl.doublewell_langevin_chain_trajectory_plain, dict(kw, thin=4)
    else:
        ref = (jfl.doublewell_langevin_chain(*jargs, noise=jnp.asarray(noise), interpret=True,
                                             **kw),)
        fn = tfl.doublewell_langevin_chain_plain
    out = _dw_halves(fn, torch.from_numpy(x0), 4, 13, 0.01, 0.8,
                     noise=torch.from_numpy(noise), **kw)
    for o, r in zip(out, ref):
        _close(o, r)


@pytest.mark.parametrize("trajectory", [False, True], ids=["final", "trajectory"])
def test_doublewell_philox_offset_halves_equal_the_whole_launch(trajectory):
    """On the quad stream (:func:`doublewell_normals`, the kernels' bit-exact
    twin) two row shards at their first elements' indices equal one launch
    over the whole state, bitwise, with an int seed and a 0-d seed tensor; a
    shard numbered from 0 draws other numbers."""
    x0 = torch.from_numpy(_normal(_rng(31), 10, 6))
    fn = (tfl.doublewell_langevin_chain_trajectory_plain if trajectory
          else tfl.doublewell_langevin_chain_plain)
    more = {"thin": 3} if trajectory else {}
    for seed in (2**40 + 7, torch.tensor(2**40 + 7)):
        whole = fn(x0, 10, 0.01, 1.0, seed=seed, **more)
        whole = whole if isinstance(whole, tuple) else (whole,)
        for split in (3, 7):
            for got, want in zip(_dw_halves(fn, x0, split, 10, 0.01, 1.0, seed=seed, **more),
                                 whole):
                assert torch.equal(got, want)
    alone = fn(x0[3:].contiguous(), 10, 0.01, 1.0, seed=5, **more)
    assert not torch.equal(alone[-1] if trajectory else alone,
                           fn(x0, 10, 0.01, 1.0, seed=5, **more)[-1][3:] if trajectory
                           else fn(x0, 10, 0.01, 1.0, seed=5)[3:])
    with pytest.raises(ValueError, match="chain_offset"):
        fn(x0, 10, 0.01, 1.0, chain_offset=-1, **more)
