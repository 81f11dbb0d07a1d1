"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; they skip without a CUDA device. This file imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -m gpu

The tolerance is atol 1e-4 (float32): the kernels contract multiply-adds and
take the mixture softmax online in one pass, the plain versions do neither;
the chains contract at these step sizes, so rounding does not grow.

The MALA, HMC, AIS and parallel-tempering chains take a Metropolis (or
exchange) decision per step: where the
uniform lies within rounding of the acceptance probability, kernel and plain
version may decide differently and that chain then differs by a whole
proposal. Those checks count the chains beyond the tolerance (state,
trajectory or acceptance) and allow at most 0.1% of the chains to flip; every
other chain must agree to atol 1e-4.
"""

import numpy as np
import pytest
import torch

from torchebm_tpu_torch.ops import fused_adaln as tadaln
from torchebm_tpu_torch.ops import fused_ais as tais
from torchebm_tpu_torch.ops import fused_hmc as thmc
from torchebm_tpu_torch.ops import fused_langevin as tfl
from torchebm_tpu_torch.ops import fused_mala as tmala
from torchebm_tpu_torch.ops import fused_mlp_langevin as tmlp
from torchebm_tpu_torch.ops import fused_pt as tpt
from torchebm_tpu_torch.ops import fused_sinkhorn as tsk

TOL = 1e-4


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


#: (n chains, d, K, precision, start at draws of the target): 4,096 chains from
#: N(0, I) on 8 components at d = 2 and on the d = 32 Gaussian; at 4,097
#: chains (a ragged last warp) K in {1, 3, 8, 12, 33} at d = 2 (one lane, an
#: idle lane, one component per lane, K > G, components past the registers)
#: and d in {1, 5, 16, 64} at K = 8 (the groups' buckets, then one lane),
#: started at draws of the target, where the chains contract
MIXTURE_CASES = [
    (4096, 2, 8, False, False), (4096, 32, 1, True, False),
    *[(4097, 2, k, False, True) for k in (1, 3, 8, 12, 33)],
    *[(4097, d, 8, False, True) for d in (1, 5, 16, 64)],
]


@pytest.mark.gpu
@pytest.mark.parametrize("inject", [True, False], ids=["noise", "philox"])
@pytest.mark.parametrize("n, d, k, precision, at_target", MIXTURE_CASES,
                         ids=[f"{n}x{d}-k{k}" + ("-gaussian" if p else "")
                              for n, d, k, p, _ in MIXTURE_CASES])
def test_mixture_kernels_match_plain_on_card(cuda, inject, n, d, k, precision, at_target):
    rng = _rng(0)
    n_steps = 20
    means = torch.from_numpy(_normal(rng, k, d, scale=2.0)).to(cuda)
    if at_target:
        comp = torch.from_numpy(rng.integers(0, k, n)).to(cuda)
        x0 = (means[comp] + torch.from_numpy(_normal(rng, n, d, scale=0.9)).to(cuda)).contiguous()
    else:
        x0 = torch.from_numpy(_normal(rng, n, d)).to(cuda)
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
@pytest.mark.parametrize("d, k, precision", [(2, 8, False), (5, 3, False), (3, 1, True)],
                         ids=["ring", "d5-k3", "gaussian"])
def test_mixture_kernels_with_a_chain_offset(cuda, d, k, precision):
    """A sharded batch's shards: the kernels over chains ``[a, b)`` at
    ``chain_offset=a`` equal rows ``[a, b)`` of the launch over every chain,
    and each equals its plain version at that offset."""
    rng = _rng(11)
    n, n_steps = 5001, 30
    means = torch.from_numpy(_normal(rng, k, d, scale=2.0)).to(cuda)
    x0 = torch.from_numpy(_normal(rng, n, d)).to(cuda)
    kw = dict(scale=0.9, seed=2**40 + 7)
    if precision:
        a = _normal(rng, d, d, scale=0.1)
        kw["precision"] = torch.from_numpy((a @ a.T + np.eye(d)).astype(np.float32)).to(cuda)
    whole = tfl.mixture_langevin_chain(x0, means, n_steps, 0.03, **kw)
    traj, final = tfl.mixture_langevin_chain_trajectory(x0, means, n_steps, 0.03, thin=5, **kw)
    for a, b in ((0, 2500), (2500, n)):
        part = tfl.mixture_langevin_chain(x0[a:b], means, n_steps, 0.03, chain_offset=a, **kw)
        torch.testing.assert_close(part, whole[a:b], rtol=0, atol=1e-4)
        plain = tfl.mixture_langevin_chain_plain(x0[a:b], means, n_steps, 0.03, chain_offset=a,
                                                 **kw)
        torch.testing.assert_close(part, plain, rtol=0, atol=1e-4)
        pt, pf = tfl.mixture_langevin_chain_trajectory(x0[a:b], means, n_steps, 0.03, thin=5,
                                                       chain_offset=a, **kw)
        torch.testing.assert_close(pt, traj[:, a:b], rtol=0, atol=1e-4)
        torch.testing.assert_close(pf, final[a:b], rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("inject", [True, False], ids=["noise", "philox"])
@pytest.mark.parametrize("group", [2, 4, 8])
@pytest.mark.parametrize("d, k", [(2, 8), (2, 12), (5, 8)])
def test_mixture_kernel_each_group_matches_plain_on_card(cuda, inject, group, d, k):
    """Every group the kernel is built for, whichever the plan picks: 1, 2 or
    4 components per lane in registers and the rest read from shared memory,
    one Philox block per step shared over G steps (d = 2) or blocks drawn by
    lanes (d = 5), at 1,001 chains (a ragged last warp), thin 3."""
    rng = _rng(8)
    n, n_steps = 1001, 20
    means = torch.from_numpy(_normal(rng, k, d, scale=2.0))
    x0 = (means[torch.from_numpy(rng.integers(0, k, n))]
          + torch.from_numpy(_normal(rng, n, d, scale=0.9))).contiguous()
    sched = torch.from_numpy(_schedule(rng, n_steps, 0.01, 0.05))
    noise = torch.from_numpy(_normal(rng, n_steps, n, d)) if inject else None
    args = (x0, means, n_steps, sched, 0.8, 3, 0.9, None, None, 31, (-4.0, 4.0), noise)
    traj, final, launched = tfl._mixture_run(
        "mixture_langevin_chain_trajectory",
        *[a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args], group=group)
    assert launched
    want_traj, want_final, _ = tfl._mixture_run("mixture_langevin_chain_trajectory", *args)
    torch.testing.assert_close(traj.cpu(), want_traj, rtol=0, atol=1e-4)
    torch.testing.assert_close(final.cpu(), want_final, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("d, k", [(2, 1), (2, 3), (2, 8), (2, 12), (5, 8), (16, 8), (64, 8)])
def test_mixture_kernel_draws_the_philox_twin(cuda, d, k):
    """Every lane of a group draws with the counters (chain, step, block) of
    ``philox_normals``: with all means at 0, unit scale, step 1 and noise
    scale 1/√2 the update is ``x − 1·x + 1·ε = ε``, so each kept state is the
    step's normals (to the ulps of the card's logf/sinf/cosf against the
    CPU's; a wrong counter is off by O(1))."""
    n, n_steps = 1001, 11
    x0 = torch.zeros((n, d), device=cuda)
    traj, _ = tfl.mixture_langevin_chain_trajectory(
        x0, torch.zeros((k, d), device=cuda), n_steps, 1.0, 2 ** -0.5, seed=(5 << 32) | 77)
    for t in range(n_steps):
        want = tfl.philox_normals(torch.arange(n), t, d, (5 << 32) | 77)
        torch.testing.assert_close(traj[t].cpu(), want, rtol=0, atol=1e-5)


#: (state shape, n_steps): 7,000 and 1,001 elements (not multiples of 32);
#: 20-23 steps end on a full quad and on partial quads of 1, 2 and 3 steps
DOUBLEWELL_SHAPES = [((1000, 7), 20), ((1000, 7), 21), ((1001,), 22), ((1000, 7), 23)]


@pytest.mark.gpu
@pytest.mark.parametrize("inject", [True, False], ids=["noise", "philox"])
@pytest.mark.parametrize("shape, n_steps", DOUBLEWELL_SHAPES,
                         ids=[f"{'x'.join(map(str, s))}-{t}steps" for s, t in DOUBLEWELL_SHAPES])
def test_doublewell_kernels_match_plain_on_card(cuda, inject, shape, n_steps):
    """Both double-well kernels against their plain versions: a constant
    schedule (two floats) and a per-step table, with and without the clamp,
    thin 1, 3 and 6 (kept slots inside and across the quads of the Philox
    stream)."""
    rng = _rng(1 + n_steps)
    x0 = torch.from_numpy(_normal(rng, *shape, scale=0.5)).to(cuda)
    sched = torch.from_numpy(_schedule(rng, n_steps, 0.005, 0.02)).to(cuda)
    noise = torch.from_numpy(_normal(rng, n_steps, *shape)).to(cuda) if inject else None
    for step_size, noise_scale in ((0.01, 0.8), (sched, 0.7)):
        for clamp in (None, (-1.2, 1.2)):
            kw = dict(seed=(7 << 32) | 5, clamp=clamp, noise=noise)
            got, want = _kernel_and_plain(tfl.doublewell_langevin_chain, cuda, x0, n_steps,
                                          step_size, noise_scale, **kw)
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
            for thin in (1, 3, 6):
                (gt, gf), (wt, wf) = _kernel_and_plain(
                    tfl.doublewell_langevin_chain_trajectory, cuda, x0, n_steps, step_size,
                    noise_scale, thin=thin, **kw)
                assert gt.shape == (n_steps // thin, *shape)
                torch.testing.assert_close(gt.cpu(), wt, rtol=0, atol=1e-4)
                torch.testing.assert_close(gf.cpu(), wf, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps", [20, 23])
def test_doublewell_kernels_take_a_device_seed(cuda, n_steps):
    """A 0-d int64 seed on the card keys the stream its int keys: both
    kernels give equal outputs bit for bit."""
    x0 = torch.from_numpy(_normal(_rng(2), 1000, 7, scale=0.5)).to(cuda)
    seed = (3 << 32) | 17
    dev_seed = torch.tensor(seed, device=cuda)
    a = tfl.doublewell_langevin_chain(x0, n_steps, 0.01, seed=seed)
    b = tfl.doublewell_langevin_chain(x0, n_steps, 0.01, seed=dev_seed)
    assert torch.equal(a, b)
    ta, fa = tfl.doublewell_langevin_chain_trajectory(x0, n_steps, 0.01, thin=3, seed=seed)
    tb, fb = tfl.doublewell_langevin_chain_trajectory(x0, n_steps, 0.01, thin=3, seed=dev_seed)
    assert torch.equal(ta, tb) and torch.equal(fa, fb)
    got, want = _kernel_and_plain(tfl.doublewell_langevin_chain, cuda, x0, n_steps, 0.01,
                                  seed=dev_seed)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


def _flipped_chains(got, want, n) -> int:
    """Chains whose state, trajectory or acceptance differ by more than TOL;
    every output is finite."""
    bad = torch.zeros(n, dtype=torch.bool)
    for g, w in zip(got, want):
        g = g.cpu()
        assert torch.isfinite(g).all()
        diff = (g - w).abs()
        if diff.ndim == 3:  # trajectory (n_kept, n, d)
            diff = diff.amax(dim=(0, 2))
        elif diff.ndim == 2:
            diff = diff.amax(dim=1)
        bad |= diff > TOL
    return int(bad.sum())


#: the correlated 2-D Gaussian of the ESS protocol (cov [[1, .8], [.8, 1]])
CORR_COV = np.array([[1.0, 0.8], [0.8, 1.0]])


def _metropolis_case(rng, target):
    """``(n, d, x0, means, kwargs)`` on the CPU for an 8-component mixture at
    d=2, a d=32 full-covariance Gaussian, or the correlated 2-D Gaussian."""
    n = 4096
    if target == "corr2":
        # the ESS protocol's target, started at exact draws of it
        x0 = _normal(rng, n, 2) @ np.linalg.cholesky(CORR_COV).T.astype(np.float32)
        kw = dict(seed=42, precision=torch.from_numpy(np.linalg.inv(CORR_COV).astype(np.float32)))
        return n, 2, torch.from_numpy(x0).contiguous(), torch.zeros(1, 2), kw
    k, d = (1, 32) if target == "gaussian" else (8, 2)
    means = torch.from_numpy(_normal(rng, k, d, scale=2.0))
    # start at draws of the target, where the chains contract
    x0 = means[torch.from_numpy(rng.integers(0, k, n))] + torch.from_numpy(
        _normal(rng, n, d, scale=1.0 if target == "gaussian" else 0.4))
    kw = dict(scale=0.4, seed=42)
    if target == "gaussian":
        a = _normal(rng, d, d, scale=0.1)
        kw = dict(seed=42, precision=torch.from_numpy((a @ a.T + np.eye(d)).astype(np.float32)))
    return n, d, x0.contiguous(), means, kw


#: (step, thin): small steps on the mixture and the d=32 Gaussian; on the
#: correlated Gaussian the ESS protocol's steps (MALA's pilot step, HMC's
#: adapted step with a material share of rejections) and its thin of 4
MALA_STEP = {"mixture": (0.02, 3), "gaussian": (0.02, 3), "corr2": (0.25, 4)}
HMC_STEP = {"mixture": (0.05, 3), "gaussian": (0.05, 3), "corr2": (0.6, 4)}


#: (target, lanes per chain): every group the MALA and HMC kernels are built
#: for (``mala_groups``, ``hmc_groups``: the same), on the mixture at 4,096
#: chains, at 1,001 (groups past the last chain in a partial last warp) and
#: at d = 16 (the groups' largest bucket, four Philox blocks per step drawn by
#: the lanes), on the correlated 2-D Gaussian (precision in registers), a
#: d = 16 Gaussian (precision in shared memory) and the d = 32 Gaussian (one
#: lane)
GROUP_TARGETS = {"mixture": (2, 8, False), "ragged": (2, 8, False), "d16": (16, 8, False),
               "gaussian": (32, 1, True), "corr2": (2, 1, True), "gauss16": (16, 1, True)}
GROUP_CASES = [(t, grp) for t, (d, k, gaussian) in GROUP_TARGETS.items()
             for grp in thmc.hmc_groups(d, k, gaussian)]
STEP_OF = {"ragged": "mixture", "d16": "mixture", "gauss16": "gaussian"}


def _group_case(rng, target):
    """``(n, d, x0, means, kwargs)`` on the CPU: the targets of
    :func:`_metropolis_case`, the mixture's first 1,001 chains, an
    8-component mixture at d = 16 started at draws of it, or a d = 16
    full-covariance Gaussian."""
    if target == "ragged":
        n, d, x0, means, kw = _metropolis_case(rng, "mixture")
        return 1001, d, x0[:1001].contiguous(), means, kw
    if target == "gauss16":
        n, d = 4096, 16
        a = _normal(rng, d, d, scale=0.1)
        prec = torch.from_numpy((a @ a.T + np.eye(d)).astype(np.float32))
        return n, d, torch.from_numpy(_normal(rng, n, d)), torch.zeros(1, d), dict(
            seed=42, precision=prec)
    if target == "d16":
        n, d, k = 4096, 16, 8
        means = torch.from_numpy(_normal(rng, k, d, scale=2.0))
        x0 = means[torch.from_numpy(rng.integers(0, k, n))] + torch.from_numpy(
            _normal(rng, n, d, scale=0.4))
        return n, d, x0.contiguous(), means, dict(scale=0.4, seed=42)
    return _metropolis_case(rng, target)


def _group_run(module, fn, x0, means, args, t, kw, group, planned, cuda):
    """``fn`` (a wrapper of ``module``, the MALA or HMC chain or trajectory)
    on the card at ``group`` lanes per chain, and its plain version on the
    CPU: through the public wrapper and its launch count where the launch
    plan picks ``group`` (``planned``), else through ``module._run``."""
    extra = {} if t is None else dict(thin=t)
    on_card = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    if planned:
        return _kernel_and_plain(fn, cuda, x0.to(cuda), means.to(cuda), *args, **extra,
                                 **on_card)
    traj, out, acc, launched = module._run(
        x0.to(cuda), means.to(cuda), *args, thin=t, scale=kw.get("scale", 1.0),
        log_weights=on_card.get("log_weights"), precision=on_card.get("precision"),
        seed=kw.get("seed", 0), noise=on_card.get("noise"), uniforms=on_card.get("uniforms"),
        group=group, **({"mass": on_card.get("mass")} if module is thmc else {}))
    assert launched
    got = (out, acc) if t is None else (traj, out, acc)
    return got, fn(x0, means, *args, **extra, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("inject", [True, False], ids=["noise", "philox"])
@pytest.mark.parametrize("target, group", GROUP_CASES, ids=[f"{t}-G{g}" for t, g in GROUP_CASES])
def test_mala_kernels_match_plain_on_card(cuda, inject, target, group):
    """Rows 6-7 at ``group`` lanes per chain against the plain versions under
    the flip rule; where the launch plan picks ``group`` itself, through the
    public wrappers and their launch counts."""
    rng = _rng(2)
    n, d, x0, means, kw = _group_case(rng, target)
    n_steps, (step, thin) = 20, MALA_STEP[STEP_OF.get(target, target)]
    if inject:
        kw["noise"] = torch.from_numpy(_normal(rng, n_steps, n, d))
        kw["uniforms"] = torch.from_numpy(rng.uniform(size=(n_steps, n)).astype(np.float32))
    planned = tmala.mala_launch_plan(n, d, means.shape[0], "precision" in kw)[0] == group
    for fn, t in ((tmala.mixture_mala_chain, None), (tmala.mixture_mala_chain_trajectory, thin)):
        got, want = _group_run(tmala, fn, x0, means, (n_steps, step), t, kw, group, planned, cuda)
        assert _flipped_chains(got, want, n) <= n // 1000


@pytest.mark.gpu
@pytest.mark.parametrize("inject", [True, False], ids=["noise", "philox"])
@pytest.mark.parametrize("target, group", GROUP_CASES, ids=[f"{t}-G{g}" for t, g in GROUP_CASES])
@pytest.mark.parametrize("mass", [False, True], ids=["unit", "diag-mass"])
def test_hmc_kernels_match_plain_on_card(cuda, inject, target, group, mass):
    """Rows 8-9 at ``group`` lanes per chain against the plain versions under
    the flip rule; where the launch plan picks ``group`` itself, through the
    public wrappers and their launch counts."""
    rng = _rng(3)
    n, d, x0, means, kw = _group_case(rng, target)
    n_draws, (step, thin) = 10, HMC_STEP[STEP_OF.get(target, target)]
    if mass:
        kw["mass"] = torch.from_numpy(rng.uniform(0.5, 2.0, d).astype(np.float32))
    if inject:
        kw["noise"] = torch.from_numpy(_normal(rng, n_draws, n, d))
        kw["uniforms"] = torch.from_numpy(rng.uniform(size=(n_draws, n)).astype(np.float32))
    planned = thmc.hmc_launch_plan(n, d, means.shape[0], "precision" in kw)[0] == group
    for fn, t in ((thmc.mixture_hmc_chain, None), (thmc.mixture_hmc_chain_trajectory, thin)):
        got, want = _group_run(thmc, fn, x0, means, (n_draws, step, 8), t, kw, group, planned, cuda)
        assert _flipped_chains(got, want, n) <= n // 1000


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4096, 32), (3, 5461), (1000, 7), (5, 7, 3), (1,)],
                         ids=["4096x32", "3x5461", "1000x7", "5x7x3", "1"])
@pytest.mark.parametrize("inject", [True, False], ids=["noise", "philox"])
def test_fused_langevin_step_matches_plain_on_card(cuda, shape, inject):
    rng = _rng(4)
    x, g = (torch.from_numpy(_normal(rng, *shape)).to(cuda) for _ in range(2))
    kw = dict(seed=17, clamp=(-1.0, 1.0))
    if inject:
        kw["noise"] = torch.from_numpy(_normal(rng, *shape)).to(cuda)
    got, want = _kernel_and_plain(tfl.fused_langevin_step, cuda, x, g, 0.01, 0.8, **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)
    # a state that is not 16-byte aligned takes the scalar path
    flat = torch.from_numpy(_normal(rng, 4 * 1000 + 2)).to(cuda)
    xs, gs = flat[1:-1], flat[2:]
    got, want = _kernel_and_plain(tfl.fused_langevin_step, cuda, xs, gs, 0.01, 0.0, seed=3)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)


#: the ladder's targets: (d, K, full covariance)
PT_TARGETS = {"mixture": (2, 6, False), "d16": (16, 8, False), "gaussian": (32, 1, True),
              "gauss4": (4, 1, True), "gauss16": (16, 1, True)}


def _pt_case(rng, target, n_rep, n):
    """``(replicas, means, kwargs)`` on the CPU: a ring-like mixture (6
    components at d = 2, or 8 at d = 16) started at its modes (noise 0.5
    keeps every replica there), or a full-covariance Gaussian at d = 4, 16
    or 32 (:data:`PT_TARGETS`)."""
    d, k, gaussian = PT_TARGETS[target]
    if gaussian:
        a = _normal(rng, d, d, scale=0.1)
        means = torch.from_numpy(_normal(rng, 1, d))
        reps = means + torch.from_numpy(_normal(rng, n_rep, n, d, scale=0.7))
        prec = torch.from_numpy((a @ a.T + np.eye(d)).astype(np.float32))
        return reps.contiguous(), means, dict(precision=prec)
    means = torch.from_numpy(_normal(rng, k, d, scale=3.0))
    comp = torch.from_numpy(rng.integers(0, k, (n_rep, n)))
    reps = means[comp] + torch.from_numpy(_normal(rng, n_rep, n, d, scale=0.4))
    return reps.contiguous(), means, dict(scale=0.4)


#: (R, n chains, n_steps, swap_every): R = 5 leaves three idle lanes in a
#: group of 8, 1001 chains end in a partial group and a partial block,
#: n_steps < swap_every runs no sweep
PT_CASES = [(2, 4096, 20, 5), (4, 1001, 23, 5), (5, 1001, 20, 3), (3, 600, 4, 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("inject", [True, False], ids=["noise", "philox"])
@pytest.mark.parametrize("target", ["mixture", "gaussian"])
@pytest.mark.parametrize("n_rep, n, n_steps, swap_every", PT_CASES)
def test_pt_kernels_match_plain_on_card(cuda, inject, target, n_rep, n, n_steps, swap_every):
    rng = _rng(5)
    reps, means, kw = _pt_case(rng, target, n_rep, n)
    betas = tuple(1.6 ** -r for r in range(n_rep))
    kw.update(seed=8, clamp=(-9.0, 9.0))
    if inject:
        d = reps.shape[-1]
        kw["noise"] = torch.from_numpy(_normal(rng, n_steps, n_rep, n, d))
        kw["swap_uniform"] = torch.from_numpy(
            rng.uniform(size=(n_steps // swap_every, n_rep - 1, n)).astype(np.float32))
    kw = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    args = (reps.to(cuda), means.to(cuda), n_steps, 0.02, 0.5, betas, swap_every)
    for fn, extra in ((tpt.pt_langevin_chain, {}),
                      (tpt.pt_langevin_chain_trajectory, dict(thin=2))):
        got, want = _kernel_and_plain(fn, cuda, *args, **extra, **kw)
        flipped = _flipped_chains(got[:-1], want[:-1], n)
        assert flipped <= n // 1000
        # the acceptance is a mean over chains: a flipped chain moves it by at most 1/n
        assert abs(float(got[-1]) - float(want[-1])) <= TOL + flipped / n
        if n_steps < swap_every:
            assert float(got[-1]) == 0.0


#: (target, R, n chains, n_steps, swap_every): every group of lanes per
#: replica the ladder kernel is built for (``pt_groups``) on the ring-like
#: mixture at R = 4 (up to 8 lanes per replica), R = 3 (a padded replica group
#: in every chain), R = 8 and R = 16 (the warp bounds the group at 4 and 2),
#: at 1,001 chains (a partial last warp) and swapping every step; a d = 16
#: mixture (four Philox blocks per step, drawn by the lanes); full-covariance
#: Gaussians at d = 4 (precision in registers) and d = 16 (in shared memory)
PT_GROUP_SHAPES = {"R4": ("mixture", 4, 4096, 23, 5), "R3": ("mixture", 3, 4096, 20, 3),
                   "R8": ("mixture", 8, 2048, 20, 5), "R16": ("mixture", 16, 1024, 20, 5),
                   "ragged": ("mixture", 4, 1001, 21, 1), "d16": ("d16", 4, 2048, 20, 5),
                   "gauss4": ("gauss4", 4, 2048, 20, 5), "gauss16": ("gauss16", 4, 2048, 20, 5)}
PT_GROUP_CASES = [(shape, grp) for shape, (t, n_rep, *_) in PT_GROUP_SHAPES.items()
                  for grp in tpt.pt_groups(n_rep, PT_TARGETS[t][0], PT_TARGETS[t][1],
                                           PT_TARGETS[t][2])]


@pytest.mark.gpu
@pytest.mark.parametrize("inject", [True, False], ids=["noise", "philox"])
@pytest.mark.parametrize("shape, group", PT_GROUP_CASES,
                         ids=[f"{s}-G{g}" for s, g in PT_GROUP_CASES])
def test_pt_kernels_each_group_match_plain_on_card(cuda, inject, shape, group):
    """Rows 10-11 at ``group`` lanes per replica, whichever the launch plan
    picks, against the plain versions under the flip rule: final ladder,
    trajectory (thin 2) and the last sweep's acceptance."""
    target, n_rep, n, n_steps, swap_every = PT_GROUP_SHAPES[shape]
    rng = _rng(7)
    reps, means, kw = _pt_case(rng, target, n_rep, n)
    d = reps.shape[-1]
    betas = tuple(1.6 ** -r for r in range(n_rep))
    kw = dict(scale=kw.get("scale", 1.0), log_weights=None, precision=kw.get("precision"),
              seed=11, clamp=(-9.0, 9.0), noise=None, swap_uniform=None)
    if inject:
        kw["noise"] = torch.from_numpy(_normal(rng, n_steps, n_rep, n, d))
        kw["swap_uniform"] = torch.from_numpy(
            rng.uniform(size=(n_steps // swap_every, n_rep - 1, n)).astype(np.float32))
    on_card = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    args = (n_steps, 0.02, 0.5, betas, swap_every)
    for thin in (None, 2):
        traj, out, acc = tpt._run(reps.to(cuda), means.to(cuda), *args, thin, **on_card,
                                  kernel=True, group=group)
        want = tpt._run(reps, means, *args, thin, **kw, kernel=False)
        got = (out, acc) if thin is None else (traj, out, acc)
        want = want[1:] if thin is None else want
        flipped = _flipped_chains(got, want, n)
        assert flipped <= n // 1000


#: the AIS kernel's targets: (d, K, full covariance, chains, transitions
#: per rung): a ring-like mixture at 4,096 chains with two transitions per
#: rung and at 1,001 (groups past the last chain in a partial last warp),
#: the full-covariance and the isotropic (one-component) Gaussian at d = 2,
#: an 8-component mixture and a full-covariance Gaussian at d = 16 (four
#: Philox blocks per transition, drawn by the lanes), the d = 32 Gaussian
#: (one lane)
AIS_TARGETS = {"mixture": (2, 6, False, 4096, 2), "ragged": (2, 6, False, 1001, 1),
               "gauss2": (2, 1, True, 4096, 1), "iso2": (2, 1, False, 4096, 1),
               "d16": (16, 8, False, 4096, 1), "gauss16": (16, 1, True, 4096, 1),
               "gaussian": (32, 1, True, 4096, 1)}
AIS_CASES = [(t, grp) for t, (d, k, gaussian, _, _) in AIS_TARGETS.items()
             for grp in tais.ais_groups(d, k, gaussian)]


def _ais_case(rng, target):
    """``(x0, base_mean, base_scale, means, step, kwargs)`` on the CPU for
    :data:`AIS_TARGETS`: mixtures started at their modes at step 0.005
    under the base N(0, 9 I); the Gaussians near their means at step 0.02,
    where the chains contract."""
    d, k, gaussian, n, n_tr = AIS_TARGETS[target]
    kw = dict(n_transitions=n_tr)
    if target == "iso2":
        means = torch.from_numpy(_normal(rng, 1, 2))
        x0 = torch.from_numpy(_normal(rng, n, 2, scale=1.5))
        return x0, torch.zeros(2), 1.5, means, 0.02, dict(kw, scale=0.8, log_norm_t=0.0)
    if gaussian:
        a = _normal(rng, d, d, scale=0.1)
        means = torch.from_numpy(_normal(rng, 1, d))
        x0 = means + torch.from_numpy(_normal(rng, n, d, scale=0.7))
        prec = torch.from_numpy((a @ a.T + np.eye(d)).astype(np.float32))
        return x0.contiguous(), means[0].clone(), 2.0, means, 0.02, dict(kw, precision=prec)
    reps, means, tkw = _pt_case(rng, "d16" if d == 16 else "mixture", 1, n)
    return reps[0], torch.zeros(d), 3.0, means, 0.005, dict(kw, **tkw)


@pytest.mark.gpu
@pytest.mark.parametrize("inject", [True, False], ids=["noise", "philox"])
@pytest.mark.parametrize("target, group", AIS_CASES, ids=[f"{t}-G{g}" for t, g in AIS_CASES])
def test_ais_kernel_matches_plain_on_card(cuda, inject, target, group):
    """Row 12 at ``group`` lanes per chain against the plain version under
    the flip rule, over 25 rungs; where the launch plan picks ``group``,
    through the public wrapper and its launch count, else through
    ``fused_ais._run``. The Philox cases key the kernel with a device seed
    tensor and the plain version with the int."""
    rng = _rng(6)
    n_rungs = 25
    x0, base_mean, base_scale, means, step, kw = _ais_case(rng, target)
    n, d = x0.shape
    n_tr = kw["n_transitions"]
    if inject:
        kw["noise"] = torch.from_numpy(_normal(rng, n_rungs * n_tr, n, d))
        kw["uniforms"] = torch.from_numpy(
            rng.uniform(size=(n_rungs * n_tr, n)).astype(np.float32))
    args = (x0, base_mean, base_scale, means, torch.linspace(0.0, 1.0, n_rungs + 1), step)
    on_card = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    card_args = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    seed = {} if inject else dict(seed=torch.tensor(9, device=cuda))
    planned = tais.ais_launch_plan(n, d, means.shape[0], "precision" in kw)[0] == group
    before = tais.mixture_ais_run.launches
    if planned:
        got = tais.mixture_ais_run(*card_args, **on_card, **seed)
        assert tais.mixture_ais_run.launches == before + 1
    else:
        *got, launched = tais._run(*card_args, **on_card, **seed, group=group)
        assert launched
    want = tais.mixture_ais_run(*args, **kw, **({} if inject else dict(seed=9)))
    assert _flipped_chains(got, want, n) <= n // 1000


def _mlp_layers(rng, widths):
    """``[(W, b), ..., (w_out, b_out)]`` on the CPU: LeCun-scaled weights,
    small biases."""
    dims = list(widths) + [1]
    return [(torch.from_numpy(_normal(rng, i, o, scale=i ** -0.5)),
             torch.from_numpy(_normal(rng, o, scale=0.1))) for i, o in zip(dims[:-1], dims[1:])]


#: (n chains, widths (d, H_1, ...), clamp): the CD path's 256 x 2 on MLP(128,
#: 128) and 4,096 chains, d = 32 with three hidden layers (a tensor-core
#: first layer), a ragged last tile, (512, 512), whose weights stream through
#: shared memory; and the larger tiles the plan picks once the grid fills the
#: card: 8,192 chains, 16,900 (a last tile of 4) and 8,190 on (512, 512) (a
#: last tile of 14); ragged widths and a narrow layer between wide ones
MLP_CASES = [
    (256, (2, 128, 128), None),
    (4096, (2, 128, 128), None),
    (1000, (32, 64, 64, 64), None),
    (37, (2, 128, 128), (-1.0, 1.0)),
    (512, (2, 512, 512), None),
    (8192, (2, 128, 128), None),
    (16_900, (2, 128, 128), None),
    (8190, (2, 512, 512), None),
    (100, (10, 40, 24), None),
    (40, (2, 4, 130, 2), None),
]
MLP_IDS = ["256x2", "4096x2", "1000x32-3layers", "37x2-clamp", "512x2-wide", "8192x2-tile16",
           "16900x2-tile32", "8190x2-wide-tile16", "100x10-ragged", "40x2-narrow"]
#: every launch setting (tile, warps, resident weights) the kernel is built for
MLP_SETTINGS = list(tmlp.SETTINGS)


@pytest.mark.gpu
def test_mlp_cases_cover_every_tile_and_route(cuda):
    plans = {tmlp.launch_plan(n, widths, cuda) for n, widths, _ in MLP_CASES}
    assert {p.tile for p in plans} == {8, 16, 32}
    assert {p.resident for p in plans} == {True, False}
    assert (16, 8, False) in plans


@pytest.mark.gpu
@pytest.mark.parametrize("inject", [True, False], ids=["noise", "philox"])
@pytest.mark.parametrize("n, widths, clamp", MLP_CASES, ids=MLP_IDS)
def test_mlp_kernel_matches_plain_on_card(cuda, inject, n, widths, clamp):
    """Through the public wrapper (the plan's pick), on weights of the JAX
    layout ``(in, out)``, which the wrapper copies."""
    rng = _rng(7)
    n_steps = 10
    x0 = torch.from_numpy(_normal(rng, n, widths[0])).to(cuda)
    layers = [(w.to(cuda), b.to(cuda)) for w, b in _mlp_layers(rng, widths)]
    kw = dict(seed=23, clamp=clamp)
    if inject:
        kw["noise"] = torch.from_numpy(_normal(rng, n_steps, n, widths[0])).to(cuda)
    before = tmlp.mlp_langevin_chain.launches
    got = tmlp.mlp_langevin_chain(x0, layers, n_steps, 0.01, 1.0, **kw)
    assert tmlp.mlp_langevin_chain.launches == before + 1
    want = tmlp.mlp_langevin_chain_plain(x0, layers, n_steps, 0.01, 1.0, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("n, widths", [(256, (2, 128, 128)), (1000, (2, 512, 512))],
                         ids=["256x2", "1000x2-wide"])
def test_mlp_kernel_with_a_chain_offset(cuda, n, widths):
    """Two offset launches (a shard's first chain in the middle of a tile)
    equal one launch over every chain and the plain version at that offset."""
    rng = _rng(12)
    x0 = torch.from_numpy(_normal(rng, n, widths[0])).to(cuda)
    layers = [(w.to(cuda), b.to(cuda)) for w, b in _mlp_layers(rng, widths)]
    kw = dict(seed=torch.tensor(41, device=cuda))
    whole = tmlp.mlp_langevin_chain(x0, layers, 10, 0.01, 1.0, **kw)
    half = n // 2 + 3
    for a, b in ((0, half), (half, n)):
        part = tmlp.mlp_langevin_chain(x0[a:b], layers, 10, 0.01, 1.0, chain_offset=a, **kw)
        torch.testing.assert_close(part, whole[a:b], rtol=0, atol=1e-4)
        plain = tmlp.mlp_langevin_chain_plain(x0[a:b], layers, 10, 0.01, 1.0, chain_offset=a,
                                              seed=41)
        torch.testing.assert_close(part, plain, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("setting", MLP_SETTINGS, ids=lambda s: "t{}-w{}-{}".format(
    s[0], s[1], "resident" if s[2] else "streamed"))
@pytest.mark.parametrize("n, widths", [(300, (2, 128, 128)), (77, (9, 64, 40))],
                         ids=["300x2", "77x9"])
def test_mlp_kernel_matches_plain_at_every_setting(cuda, setting, n, widths):
    """Each launch setting on ``extract_mlp_layers``' views of an MLPEnergy
    (the kernel reads ``nn.Linear``'s weights in place) with the sampler's
    device seed, against the plain version keyed by the same int."""
    from torchebm_tpu_torch.models import MLPEnergy

    torch.manual_seed(3)
    net = MLPEnergy(widths[0], widths[1:]).to(cuda)
    layers = tmlp.extract_mlp_layers(net)
    x0 = torch.from_numpy(_normal(_rng(8), n, widths[0])).to(cuda)
    plan = tmlp.MlpPlan(*setting)
    got = tmlp._launch(x0, layers, list(widths), 10, 0.01, 1.0, torch.tensor(31, device=cuda),
                       None, None, plan)
    want = tmlp.mlp_langevin_chain_plain(x0, layers, 10, 0.01, 1.0, seed=31)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


#: (shape, reg, iteration cap, tol, damping): the flow path's (256, 256) at
#: fixed work and gated, the damped update, ragged shapes, one row, one
#: column, a matrix wider than shared memory holds, and the largest it takes
SINKHORN_CASES = [
    ((256, 256), 0.05, 50, 0.0, 1.0), ((256, 256), 0.05, 50, 1e-3, 1.0),
    ((64, 192), 0.1, 80, 0.0, 0.5 / 0.6), ((8, 128), 0.05, 60, 0.0, 1.0),
    ((17, 33), 0.05, 60, 0.0, 1.0), ((5, 200), 0.05, 60, 1e-3, 1.0),
    ((200, 333), 0.05, 60, 0.0, 1.0), ((128, 128), 0.1, 500, 1e-4, 1.0),
    ((1, 1), 0.05, 5, 0.0, 1.0), ((3, 1), 0.05, 5, 0.0, 1.0), ((1, 70_000), 0.05, 5, 0.0, 1.0),
    ((70_000, 3), 0.05, 40, 1e-3, 1.0), ((1024, 1024), 0.05, 50, 0.0, 1.0),
    ((1024, 1024), 0.05, 100, 1e-3, 1.0),
]


#: each case through the public wrapper (the launch plan's cluster, blocks
#: None) and at every cluster size the kernel takes for its rows
SINKHORN_RUNS = [(*case, None) for case in SINKHORN_CASES] + [
    (*case, blocks) for case in SINKHORN_CASES for blocks in tsk.BLOCK_SIZES
    if blocks <= case[0][0]]


@pytest.mark.gpu
@pytest.mark.parametrize("shape, reg, cap, tol, damping, blocks", SINKHORN_RUNS,
                         ids=[f"{s[0]}x{s[1]}-tol{t:g}-phi{p:.2f}" + (f"-blocks{b}" if b else "")
                              for s, _, _, t, p, b in SINKHORN_RUNS])
def test_sinkhorn_kernel_matches_plain_on_card(cuda, shape, reg, cap, tol, damping, blocks):
    """The whole fixed point in one launch against the loop on the CPU: the
    same number of iterations, every entry of the log plan to 1e-4, and a
    gated balanced plan's marginals uniform to rtol 2e-3."""
    rng = _rng(14)
    n, m = shape
    x0, x1 = _normal(rng, n, 2), _normal(rng, m, 2) + 1.0
    cost = ((x0[:, None, :] - x1[None, :, :]) ** 2).sum(-1)
    cost = torch.from_numpy((cost / cost.max()).astype(np.float32)).to(cuda)
    if blocks is None:
        (got, k_iters), (want, p_iters) = _kernel_and_plain(
            tsk.sinkhorn_log_fused, cuda, cost, reg, cap, tol, damping, return_iters=True)
    else:
        before = tsk.sinkhorn_log_fused.launches
        got, k_iters = tsk._run(cost, reg, cap, tol, damping, blocks=blocks)
        assert tsk.sinkhorn_log_fused.launches == before + 1
        want, p_iters = tsk.sinkhorn_log_plain(cost.cpu(), reg, cap, tol, damping,
                                               return_iters=True)
    torch.cuda.synchronize()
    assert int(k_iters) == int(p_iters)
    assert torch.isfinite(got).all()
    assert float((got.cpu() - want).abs().max()) <= TOL
    if tol > 0 and damping == 1.0:
        assert int(k_iters) < cap
        plan = got.exp()
        assert float((plan.sum(1) * n - 1).abs().max()) <= 2e-3
        assert float((plan.sum(0) * m - 1).abs().max()) <= 2e-3


@pytest.mark.gpu
def test_sinkhorn_dispatch_on_card(cuda):
    """``"auto"`` launches the kernel for a float32 CUDA matrix that fits and
    takes the loop beyond the fit rule and for float64; ``"off"`` never
    launches; the coupling's train-step call launches once."""
    from torchebm_tpu_torch.couplings import SinkhornCoupling, sinkhorn_log

    g = torch.Generator(cuda).manual_seed(0)
    cost = torch.rand((64, 64), generator=g, device=cuda)
    fn = tsk.sinkhorn_log_fused
    for fused, matrix, launched in (("auto", cost, 1), ("force", cost, 1), ("off", cost, 0),
                                    ("auto", cost.double(), 0),
                                    ("auto", torch.rand((1025, 1024), device=cuda), 0)):
        before = fn.launches
        out = sinkhorn_log(matrix, 0.05, 20, tol=1e-3, fused=fused)
        assert fn.launches == before + launched and out.shape == matrix.shape
    before = fn.launches
    x0 = torch.randn((256, 2), generator=g, device=cuda)
    out = SinkhornCoupling(n_iters=50)(x0, x0 + 2.0, generator=g)
    assert fn.launches == before + 1 and out.x1.shape == (256, 2)


def _offset_rows(cuda):
    """``{row: (wrapper, whole batch, row dim, elements per row, args,
    keywords)}`` of the chain kernels that take a chain offset beside rows
    4-5 and 13, on the card: 5,001 chains (4,001 double-well rows of 8)
    started at draws of the 8-component ring, 30 steps."""
    rng = _rng(13)
    k = 8
    angles = np.arange(k) * 2 * np.pi / k
    means = torch.from_numpy(np.stack([4 * np.cos(angles), 4 * np.sin(angles)], 1).astype(
        np.float32)).to(cuda)
    n = 5001

    def at_target(m):
        comp = torch.from_numpy(rng.integers(0, k, m)).to(cuda)
        return (means[comp] + torch.from_numpy(_normal(rng, m, 2, scale=0.4)).to(cuda)).contiguous()

    x0 = at_target(n)
    ladder = torch.stack([at_target(n) for _ in range(4)])
    mix = dict(scale=0.4, seed=2**40 + 3)
    betas = (1.0, 0.625, 0.39, 0.244)
    ais_betas = torch.linspace(0.0, 1.0, 31, device=cuda)
    xdw = torch.from_numpy(_normal(rng, 4001, 8, scale=0.5)).to(cuda)
    return {
        "2": (tfl.doublewell_langevin_chain, xdw, 0, 8, (30, 0.01), dict(seed=5)),
        "3": (tfl.doublewell_langevin_chain_trajectory, xdw, 0, 8, (30, 0.01),
              dict(seed=5, thin=4)),
        "6": (tmala.mixture_mala_chain, x0, 0, 1, (means, 30, 0.05), mix),
        "7": (tmala.mixture_mala_chain_trajectory, x0, 0, 1, (means, 30, 0.05),
              dict(mix, thin=4)),
        "8": (thmc.mixture_hmc_chain, x0, 0, 1, (means, 30, 0.05, 4), mix),
        "9": (thmc.mixture_hmc_chain_trajectory, x0, 0, 1, (means, 30, 0.05, 4),
              dict(mix, thin=4)),
        "10": (tpt.pt_langevin_chain, ladder, 1, 1, (means, 30, 0.05, 1.0, betas, 3), mix),
        "11": (tpt.pt_langevin_chain_trajectory, ladder, 1, 1,
               (means, 30, 0.05, 1.0, betas, 3), dict(mix, thin=4)),
        # the AIS plan doubles the group while n G <= 32,768: the shards run at
        # the whole batch's group, whose summation order they then share
        "12": (lambda *a, **kw: tais._run(*a, group=tais.ais_launch_plan(n, 2, k, False)[0],
                                          **kw)[:3],
               3.0 * torch.from_numpy(_normal(rng, n, 2)).to(cuda), 0, 1,
               (torch.zeros(2, device=cuda), 3.0, means, ais_betas, 0.05), mix),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("row", ["2", "3", "6", "7", "8", "9", "10", "11", "12"])
def test_chain_kernels_with_a_chain_offset(cuda, row):
    """A sharded batch's shards: the kernel over chains ``[a, b)`` at
    ``chain_offset=a`` (the double well's at its first element, the ladder
    also at ``total_chains``) equals rows ``[a, b)`` of the launch over every
    chain, bitwise, and its plain version at that offset under the flip
    rule."""
    fn, x, dim, per_row, args, kw = _offset_rows(cuda)[row]
    n = x.shape[dim]
    if dim == 1:
        kw = dict(kw, total_chains=n)
    whole = fn(x, *args, **kw)
    whole = whole if isinstance(whole, tuple) else (whole,)
    parts = []
    for a, b in ((0, 2500), (2500, n)):
        xs = x.narrow(dim, a, b - a).contiguous()
        got = fn(xs, *args, chain_offset=a * per_row, **kw)
        got = got if isinstance(got, tuple) else (got,)
        cpu = fn(xs.cpu(), *[t.cpu() if isinstance(t, torch.Tensor) else t for t in args],
                 chain_offset=a * per_row, **kw)
        cpu = cpu if isinstance(cpu, tuple) else (cpu,)
        flipped = _flipped_chains([g for g in got if g.ndim], [c for c in cpu if c.ndim], b - a)
        assert flipped <= (b - a) // 1000
        parts.append(got)
    for w, a, b in zip(whole, *parts):
        if w.ndim:  # the ladder's 0-d acceptance is a mean over its chains
            assert torch.equal(torch.cat([a, b], dim=1 if w.ndim == 3 else 0), w)


#: (B, N, D) of the adaLN kernels' checks: DiT-B/2's stream at batch 256,
#: then ragged shapes: D = 72, 200, 768 and 1,152 (12 packs a lane in
#: float32), D = 100 (one value a pack in 16-bit types), N = 1 and 17, a
#: sample's tokens split over several blocks (small B) in the backward, and
#: SD3-medium's two streams at batch 32 (D = 1,536: 6 packs a lane in bf16,
#: 256 image and 154 text tokens)
ADALN_SHAPES = [(256, 256, 768), (3, 17, 72), (2, 1, 200), (5, 17, 768), (4, 33, 100),
                (2, 256, 1152), (32, 256, 1536), (32, 154, 1536)]
ADALN_KERNELS = ("adaln_modulate", "gated_residual", "adaln_modulate_backward",
                 "gated_residual_backward")


def _adaln_launches():
    return [getattr(tadaln, k).launches for k in ADALN_KERNELS]


def _rel_norm(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ADALN_SHAPES)
def test_adaln_kernels_against_their_plain_versions(cuda, dtype, shape):
    """Each adaLN kernel, forward and backward, against its plain version on
    the same inputs on the card (float32 arithmetic in both): float32 within
    1e-5 relative; bfloat16 outputs within 2^-6 relative (a few bf16 ulps:
    both round one float32 value, summed in another order) and gradients
    within 1e-2 of their norms. The parameters are strided chunks of one
    modulation output, as in the block. A second backward repeats bit for
    bit (no atomics)."""
    b, n, d = shape
    g = torch.Generator(device=cuda).manual_seed(b * n + d)

    def r(*size, scale=1.0, shift=0.0):
        return (scale * torch.randn(*size, generator=g, device=cuda) + shift).to(dtype)

    x = r(b, n, d, scale=2.0, shift=0.5)
    mod = r(b, 6 * d, scale=0.3)
    shift, scale, gate = mod[:, :d], mod[:, d:2 * d], mod[:, 2 * d:3 * d]
    y, dz, dres = r(b, n, d), r(b, n, d), r(b, n, d)
    before = _adaln_launches()
    z, mean, rstd = tadaln.adaln_modulate(x, shift, scale, 1e-6)
    out = tadaln.gated_residual(x, gate, y)
    back = tadaln.adaln_modulate_backward(dz, x, mean, rstd, scale, dres)
    gback = tadaln.gated_residual_backward(dz, gate, y)
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(_adaln_launches(), before)] == [1, 1, 1, 1]
    zp, mp, rp = tadaln.adaln_modulate_plain(x, shift, scale, 1e-6)
    outp = tadaln.gated_residual_plain(x, gate, y)
    backp = tadaln.adaln_modulate_backward_plain(dz, x, mp, rp, scale, dres)
    gbackp = tadaln.gated_residual_backward_plain(dz, gate, y)
    torch.testing.assert_close(mean, mp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rstd, rp, rtol=1e-5, atol=0.0)
    pairs = [(z, zp, "z"), (out, outp, "out")]
    grads = [*zip(back, backp, ("dx", "dshift", "dscale")), *zip(gback, gbackp, ("dy", "dgate"))]
    for got, want, name in pairs + grads:
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.isfinite(got).all(), name
    if dtype == torch.float32:
        for got, want, name in pairs + grads:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()),
                                       msg=name)
    else:
        for got, want, name in pairs:
            torch.testing.assert_close(got.float(), want.float(), rtol=2**-6,
                                       atol=2**-16 * float(want.abs().max().float()), msg=name)
        for got, want, name in grads:
            assert _rel_norm(got, want) <= 1e-2, (name, _rel_norm(got, want))
    again = tadaln.adaln_modulate_backward(dz, x, mean, rstd, scale, dres)
    for a, c in zip(again + tadaln.gated_residual_backward(dz, gate, y), back + gback):
        assert torch.equal(a, c)


@pytest.mark.gpu
def test_adaln_block_on_the_kernels_against_the_composite(cuda, monkeypatch):
    """A float32 DiT-B/2 block on the kernels against the same block on the
    plain operations, both on the card: output within 1e-5 and every
    gradient within 1e-4 of its largest entry."""
    from torchebm_tpu_torch.models.components import AdaLNZeroBlock
    from torchebm_tpu_torch.models.components import transformer as tr

    torch.manual_seed(0)
    with torch.device(cuda):
        block = AdaLNZeroBlock(768, 12)
        with torch.no_grad():
            block.modulation.weight.normal_(0.0, 0.02)
            block.modulation.bias.normal_(0.0, 0.2)
        x = torch.randn(4, 256, 768).requires_grad_()
        cond = torch.randn(4, 768)
    params = [x, *block.parameters()]
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(tr, "_plain_ops", lambda *ts: True)
        before = _adaln_launches()
        out = block(x, cond)
        grads = torch.autograd.grad(out.square().mean(), params)
        launched = [a - c for a, c in zip(_adaln_launches(), before)]
        assert launched == ([0, 0, 0, 0] if plain else [2, 2, 2, 2])
        runs.append((out.detach(), grads))
    (out, grads), (want, want_grads) = runs
    assert float((out - want).abs().max() / want.abs().max()) <= 1e-5
    for a, c in zip(grads, want_grads):
        assert float((a - c).abs().max() / c.abs().max()) <= 1e-4


@pytest.mark.gpu
def test_adaln_block_takes_the_gradient_of_a_sum(cuda, monkeypatch):
    """The gradient of a sum reaches a float32 block on the card as a
    broadcast view: the backward kernels run on it (launches 2 of each) and
    every gradient matches the composite's within 1e-4 of its largest
    entry."""
    from torchebm_tpu_torch.models.components import AdaLNZeroBlock
    from torchebm_tpu_torch.models.components import transformer as tr

    torch.manual_seed(1)
    with torch.device(cuda):
        block = AdaLNZeroBlock(768, 12)
        with torch.no_grad():
            block.modulation.weight.normal_(0.0, 0.02)
            block.modulation.bias.normal_(0.0, 0.2)
        x = torch.randn(2, 64, 768).requires_grad_()
        cond = torch.randn(2, 768)
    params = [x, *block.parameters()]
    before = _adaln_launches()
    grads = torch.autograd.grad(block(x, cond).sum(), params)
    assert [a - c for a, c in zip(_adaln_launches(), before)] == [2, 2, 2, 2]
    monkeypatch.setattr(tr, "_plain_ops", lambda *ts: True)
    for a, c in zip(grads, torch.autograd.grad(block(x, cond).sum(), params)):
        assert float((a - c).abs().max() / c.abs().max()) <= 1e-4


@pytest.mark.gpu
def test_dit_b2_launches_the_adaln_kernels(cuda):
    """DiT-B/2 in bf16 on the card: 25 modulations (12 blocks x 2 and the
    head) and 24 gated residuals a forward, their backward kernels as many
    times a backward; in float32, a torch.func transform, forward-mode AD
    and a create_graph backward launch no adaLN kernel of their own (a bf16
    LayerNorm's forward-mode derivative on the card is float32, which the
    bf16 model's next product refuses, with or without these kernels)."""
    import torch.autograd.forward_ad as fwAD

    from torchebm_tpu_torch.models import ConditionalTransformer2D

    def dit_b2(dtype):
        torch.manual_seed(0)
        with torch.device(cuda):
            return ConditionalTransformer2D(in_channels=4, out_channels=4, input_size=32,
                                            patch_size=2, embed_dim=768, depth=12, num_heads=12,
                                            cond_dim=768, dtype=dtype)

    net = dit_b2(torch.bfloat16)
    x = torch.randn(2, 4, 32, 32, device=cuda)
    cond = torch.randn(2, 768, device=cuda)

    def launched(fn):
        before = _adaln_launches()
        fn()
        torch.cuda.synchronize()
        return [a - c for a, c in zip(_adaln_launches(), before)]

    with torch.no_grad():
        assert launched(lambda: net(x, cond)) == [25, 24, 0, 0]
    holder = {}
    assert launched(lambda: holder.update(out=net(x, cond))) == [25, 24, 0, 0]
    assert launched(lambda: holder["out"].square().mean().backward()) == [0, 0, 25, 24]
    net = dit_b2(torch.float32)
    v = torch.ones_like(x)
    assert launched(lambda: torch.func.jvp(lambda x: net(x, cond), (x,), (v,))) == [0] * 4
    with fwAD.dual_level():
        assert launched(lambda: net(fwAD.make_dual(x, v), cond)) == [0] * 4
    x2 = x.clone().requires_grad_()
    out = net(x2, cond)
    assert launched(lambda: torch.autograd.grad(out.sum(), x2, create_graph=True)) == [0] * 4
