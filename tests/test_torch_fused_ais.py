"""Parity of the port's whole-run AIS kernel with the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the JAX Pallas kernel's injected-randomness path (``noise`` and
``uniforms``) in interpret mode on the same numpy inputs. Tolerances (float32,
those of tests/ops/test_ais_parity.py): atol 2e-5 on the samples, atol 5e-5
with rtol 1e-5 on the log-weights (a sum over rungs of log-density
differences), atol 1e-5 on the per-chain acceptance.

One divergence from the JAX package is pinned here: on an isotropic
:class:`GaussianEnergy` target the JAX sampler packs the target as a
one-component mixture and its kernel subtracts the mixture's normalisation
``log_norm_t = d·log σ + (d/2)·log 2π`` in every weight update, although the
energy has no such constant, so its log Z is off by ``−log_norm_t``. The
port's sampler passes ``log_norm_t=0`` there. The CUDA kernel is held against
the plain version in tests/test_torch_kernels_gpu.py.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torchebm_tpu.ops import fused_ais as jais
from torchebm_tpu_torch import core as tcore
from torchebm_tpu_torch import ops as tops
from torchebm_tpu_torch import samplers as ts
from torchebm_tpu_torch.ops import fused_ais as tais
from torchebm_tpu_torch.ops import fused_langevin as tfl

torch.set_num_threads(1)

MEANS = np.array([[2.0, 0.0], [-2.0, 0.0], [0.0, 2.0]], np.float32)
LOGW = np.log(np.array([0.5, 0.3, 0.2])).astype(np.float32)
MU0 = np.array([0.5, -0.5], np.float32)
S0 = 1.3


def _inputs(seed, n, n_rungs, n_transitions, d=2):
    rng = np.random.default_rng(seed)
    x0 = (MU0[:d] + S0 * rng.standard_normal((n, d))).astype(np.float32)
    betas = np.linspace(0.0, 1.0, n_rungs + 1).astype(np.float32)
    noise = rng.standard_normal((n_rungs * n_transitions, n, d)).astype(np.float32)
    unif = rng.uniform(size=(n_rungs * n_transitions, n)).astype(np.float32)
    return x0, betas, noise, unif


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _check(out, ref):
    samples, logw, acc = (np.asarray(r) for r in ref)
    np.testing.assert_allclose(out[0].numpy(), samples, rtol=0, atol=2e-5)
    np.testing.assert_allclose(out[1].numpy(), logw, rtol=1e-5, atol=5e-5)
    np.testing.assert_allclose(out[2].numpy(), acc, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_transitions", [1, 2])
@pytest.mark.parametrize("precision", [False, True], ids=["mixture", "precision"])
def test_ais_plain_matches_jax_interpret(n_transitions, precision):
    n, n_rungs = 37, 8
    x0, betas, noise, unif = _inputs(n_transitions, n, n_rungs, n_transitions)
    if precision:
        cov = np.array([[1.0, 0.4], [0.4, 0.8]])
        (jm, jp), (tm, tp) = _both(np.array([[0.5, -0.5]], np.float32),
                                   np.linalg.inv(cov).astype(np.float32))
        jkw, tkw = dict(precision=jp), dict(precision=tp)
    else:
        (jm, jlw), (tm, tlw) = _both(MEANS, LOGW)
        jkw, tkw = dict(scale=0.7, log_weights=jlw), dict(scale=0.7, log_weights=tlw)
    (jx, jmu, jb, jn, ju), (tx, tmu, tb, tn, tu) = _both(x0, MU0, betas, noise, unif)
    counts = tops.launch_counts()
    ref = jais.mixture_ais_run(jx, jmu, S0, jm, jb, 0.05, n_transitions=n_transitions,
                               noise=jn, uniforms=ju, interpret=True, **jkw)
    out = tais.mixture_ais_run(tx, tmu, S0, tm, tb, 0.05, n_transitions=n_transitions,
                               noise=tn, uniforms=tu, **tkw)
    assert [tuple(o.shape) for o in out] == [(n, 2), (n,), (n,)]
    _check(out, ref)
    # some proposals are taken and some refused, so both branches are compared
    assert 0.05 < float(out[2].mean()) < 0.999
    assert tops.launch_counts() == counts  # the CPU path launches no kernel


def test_isotropic_gaussian_target_carries_no_mixture_constant():
    """Fault of the JAX package, not copied: on an isotropic Gaussian energy
    the JAX kernel path subtracts ``log_norm_t`` in every weight update, so
    each log-weight (the betas' increments sum to 1) and log Z are off by
    exactly ``−log_norm_t``. The port's kernel with the sampler's
    ``log_norm_t=0`` gives the JAX weights plus ``log_norm_t``, and log Z
    within Monte-Carlo error of ``GaussianEnergy.log_z()`` and of the loop."""
    d, sigma = 2, 0.6
    target_mean = np.array([[0.3, -0.2]], np.float32)
    n, n_rungs = 48, 12
    x0, betas, noise, unif = _inputs(7, n, n_rungs, 1)
    (jx, jmu, jm, jb, jn, ju), (tx, tmu, tm, tb, tn, tu) = _both(x0, MU0, target_mean, betas,
                                                                 noise, unif)
    log_norm_t = d * math.log(sigma) + 0.5 * d * math.log(2 * math.pi)
    ref = jais.mixture_ais_run(jx, jmu, S0, jm, jb, 0.05, scale=sigma, noise=jn, uniforms=ju,
                               interpret=True)
    out = tais.mixture_ais_run(tx, tmu, S0, tm, tb, 0.05, scale=sigma, noise=tn, uniforms=tu,
                               log_norm_t=0.0)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=0, atol=2e-5)
    np.testing.assert_allclose(out[1].numpy() - np.asarray(ref[1]), log_norm_t, atol=1e-4)
    assert abs(log_norm_t - 0.8162) < 1e-3  # the JAX bias here is -log_norm_t ≈ -0.816

    # the sampler's kernel path (its plain version here) against the truth and the loop
    target = tcore.GaussianEnergy.create(torch.from_numpy(target_mean[0]),
                                         sigma**2 * torch.eye(d))
    base = tcore.GaussianEnergy.create(torch.from_numpy(MU0), S0**2 * torch.eye(d))
    kw = dict(base=base, n_samples=2000, n_rungs=60, step_size=0.05)
    fused = ts.annealed_importance_sampling(torch.Generator().manual_seed(0), target,
                                            fused="force", **kw)
    loop = ts.annealed_importance_sampling(torch.Generator().manual_seed(0), target, fused="off",
                                           **kw)
    truth = float(target.log_z())
    # each estimate within 0.05 of the truth: the JAX kernel's bias (-0.816)
    # is sixteen times that
    assert abs(float(fused.log_z) - truth) < 0.05
    assert abs(float(loop.log_z) - truth) < 0.05


def test_log_norm_t_defaults_follow_the_jax_rule():
    n, n_rungs = 16, 4
    x0, betas, noise, unif = _inputs(2, n, n_rungs, 1)
    _, (tx, tmu, tb, tn, tu) = _both(x0, MU0, betas, noise, unif)
    tm = torch.from_numpy(MEANS)
    base = tais.mixture_ais_run(tx, tmu, S0, tm, tb, 0.05, scale=0.7, noise=tn, uniforms=tu,
                                log_norm_t=0.0)
    mix = tais.mixture_ais_run(tx, tmu, S0, tm, tb, 0.05, scale=0.7, noise=tn, uniforms=tu)
    expect = 2 * math.log(0.7) + math.log(2 * math.pi)
    torch.testing.assert_close(base[1] - mix[1], torch.full((n,), expect), rtol=0, atol=1e-5)
    prec = tais.mixture_ais_run(tx, tmu, S0, tm[:1], tb, 0.05, precision=torch.eye(2),
                                noise=tn, uniforms=tu)
    prec0 = tais.mixture_ais_run(tx, tmu, S0, tm[:1], tb, 0.05, precision=torch.eye(2),
                                 noise=tn, uniforms=tu, log_norm_t=0.0)
    torch.testing.assert_close(prec, prec0, rtol=0, atol=0)


def test_philox_run_is_reproducible_seeded_and_estimates_log_z():
    """The Philox path has no JAX run to match number for number, so it is
    held to the truth: on a full-covariance Gaussian target (log_norm_t 0)
    the estimator recovers log Z within 0.1 (Monte-Carlo error of 2,000
    chains over 80 rungs), as tests/ops/test_ais_parity.py pins its kernel."""
    n, s0 = 2000, math.sqrt(2.0)
    cov = torch.tensor([[1.0, 0.4], [0.4, 0.8]])
    mean_t = torch.tensor([[0.5, -0.5]])
    g = torch.Generator().manual_seed(3)
    x0 = s0 * torch.randn(n, 2, generator=g)
    betas = torch.linspace(0.0, 1.0, 81)
    args = (x0, torch.zeros(2), s0, mean_t, betas, 0.1)
    prec = torch.linalg.inv(cov).contiguous()
    a = tais.mixture_ais_run(*args, precision=prec, seed=5)
    b = tais.mixture_ais_run(*args, precision=prec, seed=5)
    c = tais.mixture_ais_run(*args, precision=prec, seed=6)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a[1], c[1])
    log_z0 = math.log(2 * math.pi * s0**2)
    log_z = log_z0 + float(torch.logsumexp(a[1], 0) - math.log(n))
    want = math.log(2 * math.pi) + 0.5 * float(torch.linalg.slogdet(cov)[1])
    assert abs(log_z - want) < 0.1
    assert 0.5 < float(a[2].mean()) <= 1.0


def test_plain_function_equals_the_cpu_wrapper():
    x0, betas, noise, unif = _inputs(4, 20, 5, 2)
    _, (tx, tmu, tb, tn, tu) = _both(x0, MU0, betas, noise, unif)
    args = (tx, tmu, S0, torch.from_numpy(MEANS), tb, 0.05)
    for inj in ({}, dict(noise=tn, uniforms=tu)):
        kw = dict(n_transitions=2, scale=0.7, seed=3, **inj)
        for u, v in zip(tais.mixture_ais_run(*args, **kw), tais.mixture_ais_run_plain(*args, **kw)):
            torch.testing.assert_close(u, v, rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    x0, means, mu0 = torch.zeros(8, 2), torch.zeros(1, 2), torch.zeros(2)
    betas = torch.linspace(0, 1, 3)
    with pytest.raises(ValueError, match="betas"):
        tais.mixture_ais_run(x0, mu0, 1.0, means, torch.zeros(1), 0.1)
    with pytest.raises(ValueError, match="together"):
        tais.mixture_ais_run(x0, mu0, 1.0, means, betas, 0.1, noise=torch.zeros(2, 8, 2))
    with pytest.raises(ValueError, match="noise must have shape"):
        tais.mixture_ais_run(x0, mu0, 1.0, means, betas, 0.1, n_transitions=2,
                             noise=torch.zeros(2, 8, 2), uniforms=torch.zeros(4, 8))
    with pytest.raises(ValueError, match="base_mean must have shape"):
        tais.mixture_ais_run(x0, torch.zeros(3), 1.0, means, betas, 0.1)
    with pytest.raises(ValueError, match="n_transitions"):
        tais.mixture_ais_run(x0, mu0, 1.0, means, betas, 0.1, n_transitions=0)
    with pytest.raises(ValueError, match="step_size"):
        tais.mixture_ais_run(x0, mu0, 1.0, means, betas, 0.0)
    with pytest.raises(ValueError, match="supported sizes"):
        tais.mixture_ais_run(torch.zeros(4, 8), torch.zeros(8), 1.0, torch.zeros(129, 8), betas,
                             0.1)
    with pytest.raises(TypeError, match="float32"):
        tais.mixture_ais_run(x0.double(), mu0, 1.0, means, betas, 0.1)


@pytest.mark.parametrize("d, mu_scale, inv_var", [(1, 0.0, 1.0), (2, 1.0, 1.0 / 9.0),
                                                  (5, 3.0, 4.0), (16, 0.5, 0.3), (64, 2.0, 1.7)])
def test_closed_form_base_equals_the_one_component_mixture(d, mu_scale, inv_var):
    """The base in closed form, ``(x − μ)/σ²`` and ``−|x − μ|²/(2σ²)``,
    computes the one-component mixture evaluator's function (a one-term
    softmax weight is 1, a one-term logsumexp its term)."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy(3.0 * rng.standard_normal((257, d)).astype(np.float32))
    mu = torch.from_numpy(mu_scale * rng.standard_normal(d).astype(np.float32))
    grad, logp = tais._isotropic_grad_logp(x, mu, inv_var)
    want_grad, want_logp = tfl._mixture_grad_logp(x, mu[None], torch.zeros(1), inv_var)
    torch.testing.assert_close(grad, want_grad, rtol=0, atol=1e-6)
    torch.testing.assert_close(logp, want_logp, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("inject", [False, True], ids=["philox", "noise"])
def test_seed_as_an_int_or_a_tensor_gives_one_stream(inject):
    """A 0-d int64 seed tensor (what the sampler passes, read by the kernel
    on the card) keys the same Philox stream as the int; a seed tensor of
    another type or shape raises."""
    x0, betas, noise, unif = _inputs(9, 24, 6, 2)
    _, (tx, tmu, tb, tn, tu) = _both(x0, MU0, betas, noise, unif)
    args = (tx, tmu, S0, torch.from_numpy(MEANS), tb, 0.05)
    kw = dict(n_transitions=2, scale=0.7, **(dict(noise=tn, uniforms=tu) if inject else {}))
    seed = 2**40 + 12345
    by_int = tais.mixture_ais_run(*args, seed=seed, **kw)
    for fn in (tais.mixture_ais_run, tais.mixture_ais_run_plain):
        by_tensor = fn(*args, seed=torch.tensor(seed), **kw)
        for u, v in zip(by_int, by_tensor):
            torch.testing.assert_close(u, v, rtol=0, atol=0)
    if not inject:
        other = tais.mixture_ais_run(*args, seed=seed + 1, **kw)
        assert not torch.equal(other[1], by_int[1])
    for bad in (torch.tensor(3, dtype=torch.int32), torch.tensor([3]), torch.tensor(-1)):
        with pytest.raises(ValueError, match="seed"):
            tais.mixture_ais_run(*args, seed=bad, **kw)


#: (d, K, gaussian, chains, the plan's group): the main shapes (the ring at
#: 16,384 chains, the Gaussians at 65,536), few chains (more lanes), many
#: (halved to 2), more than 8 components at d = 2 (4 lanes), d > 2 (2),
#: one lane past d = 16
PLAN_CASES = [
    (2, 8, False, 16_384, 2), (2, 1, False, 65_536, 1), (2, 1, True, 65_536, 1),
    (2, 1, True, 16_384, 2), (2, 1, True, 32_768, 1), (2, 1, False, 4096, 8),
    (2, 8, False, 1001, 8), (2, 8, False, 2048, 8), (2, 8, False, 8192, 4),
    (2, 8, False, 100_000, 2), (2, 8, False, 300_000, 2), (2, 12, False, 16_384, 4),
    (2, 33, False, 16_384, 4), (2, 16, False, 100_000, 2), (3, 8, False, 16_384, 2),
    (16, 8, False, 16_384, 2), (16, 1, True, 16_384, 2), (17, 8, False, 16_384, 1),
    (32, 1, True, 16_384, 1), (64, 8, False, 16_384, 1),
]


@pytest.mark.parametrize("d, k, gaussian, n, group", PLAN_CASES,
                         ids=[f"d{d}-k{k}-n{n}" + ("-gauss" if g else "")
                              for d, k, g, n, _ in PLAN_CASES])
def test_ais_launch_plan(d, k, gaussian, n, group):
    """The group the card's timings pick, a grid that holds every chain's
    group and no block past the last chain, and the same plan when the
    group is passed back as the override."""
    got, threads, blocks = tais.ais_launch_plan(n, d, k, gaussian)
    assert got == group and got in tais.ais_groups(d, k, gaussian)
    assert threads == tais.AIS_THREADS and threads % 32 == 0
    assert blocks * threads >= n * group > (blocks - 1) * threads
    assert tais.ais_launch_plan(n, d, k, gaussian, group=group) == (group, threads, blocks)
    if group > 2:  # halving stops where the chains' lanes fit the card
        assert n * group <= tfl.MIXTURE_RESIDENT_THREADS


def test_ais_launch_plan_overrides_only_built_groups():
    """Every built group may be forced (timings compare them): 1, 2, 4, 8 up
    to d = 16, the one-component mixture (the isotropic Gaussian target)
    included; one lane above."""
    for d, k, gaussian, built in ((2, 8, False, (1, 2, 4, 8)), (16, 8, False, (1, 2, 4, 8)),
                                  (2, 1, True, (1, 2, 4, 8)), (2, 1, False, (1, 2, 4, 8)),
                                  (16, 1, False, (1, 2, 4, 8)), (17, 8, False, (1,)),
                                  (32, 1, True, (1,)), (64, 1, False, (1,))):
        assert tais.ais_groups(d, k, gaussian) == built
        for group in built:
            assert tais.ais_launch_plan(10_000, d, k, gaussian, group=group)[0] == group
    for d, k, gaussian, group in ((2, 8, False, 3), (2, 8, False, 16), (2, 1, False, 16),
                                  (32, 1, True, 2), (17, 8, False, 2)):
        with pytest.raises(ValueError, match="no AIS kernel"):
            tais.ais_launch_plan(100, d, k, gaussian, group=group)


@pytest.mark.parametrize("d, k, gaussian", [(2, 8, False), (2, 1, False), (2, 1, True),
                                            (16, 8, False), (17, 8, False), (32, 1, True)])
def test_group_rule_lives_in_one_place(d, k, gaussian):
    """The MALA, HMC, ladder and AIS kernels' built groups all derive from
    ``fused_langevin.dispatch_groups``; AIS alone splits a one-component
    mixture over lanes."""
    from torchebm_tpu_torch.ops import fused_hmc as thmc
    from torchebm_tpu_torch.ops import fused_mala as tmala
    from torchebm_tpu_torch.ops import fused_pt as tpt

    rule = tfl.dispatch_groups(d, k, gaussian)
    assert thmc.hmc_groups(d, k, gaussian) == tmala.mala_groups(d, k, gaussian) == rule
    assert tpt.pt_groups(4, d, k, gaussian) == rule
    assert tais.ais_groups(d, k, gaussian) == tfl.dispatch_groups(
        d, k, gaussian, split_one_component=True)
    assert thmc.HMC_GROUPS == tfl.DISPATCH_GROUPS == (1, 2, 4, 8)


def _ais_halves(x, split, *args, noise=None, uniforms=None, **kw):
    """The plain version over chains ``[0, split)`` and ``[split, n)``, each
    at its first chain as ``chain_offset`` with its rows of the injected
    draws, the outputs concatenated along the chains."""
    parts = []
    for a, b in ((0, split), (split, x.shape[0])):
        inj = {} if noise is None else dict(noise=noise[:, a:b].contiguous(),
                                             uniforms=uniforms[:, a:b].contiguous())
        parts.append(tais.mixture_ais_run_plain(x[a:b], *args, chain_offset=a, **inj, **kw))
    return [torch.cat(p) for p in zip(*parts)]


def test_offset_halves_match_jax_interpret_and_its_log_z():
    """Two blocks of one AIS batch, each at its chain offset with its rows of
    the injected draws, together equal the JAX kernel on the whole batch; the
    sampler's statistics of the two blocks' log-weights give the JAX
    kernel's log Z to 2e-5."""
    import jax

    n, n_rungs = 37, 8
    x0, betas, noise, unif = _inputs(21, n, n_rungs, 2)
    (jm, jlw), (tm, tlw) = _both(MEANS, LOGW)
    (jx, jmu, jb, jn, ju), (tx, tmu, tb, tn, tu) = _both(x0, MU0, betas, noise, unif)
    ref = jais.mixture_ais_run(jx, jmu, S0, jm, jb, 0.05, n_transitions=2, noise=jn, uniforms=ju,
                               interpret=True, scale=0.7, log_weights=jlw)
    out = _ais_halves(tx, 16, tmu, S0, tm, tb, 0.05, n_transitions=2, noise=tn, uniforms=tu,
                      scale=0.7, log_weights=tlw)
    _check(out, ref)
    base = tcore.GaussianEnergy.create(tmu, S0**2 * torch.eye(2))
    stats = ts.ais._ais_statistics(base, out[0], out[1], torch.mean(out[2]), n)
    want = float(base.log_z()) + float(jax.scipy.special.logsumexp(ref[1])) - math.log(n)
    assert abs(float(stats.log_z) - want) <= 2e-5


def test_philox_offset_halves_equal_the_whole_launch():
    """On the Philox stream two launches at chain offsets 0 and ``split``
    equal one over every chain, bitwise (an int seed and a 0-d seed tensor
    alike); a block at offset 0 draws other numbers."""
    n = 41
    x0, betas, _, _ = _inputs(22, n, 6, 1)
    tx, tmu, tb, tm, tlw = (torch.from_numpy(a) for a in (x0, MU0, betas, MEANS, LOGW))
    args = (tmu, S0, tm, tb, 0.05)
    for seed in (2**40 + 3, torch.tensor(2**40 + 3)):
        kw = dict(scale=0.7, log_weights=tlw, seed=seed)
        whole = tais.mixture_ais_run_plain(tx, *args, **kw)
        for split in (10, 33):
            for got, want in zip(_ais_halves(tx, split, *args, **kw), whole):
                assert torch.equal(got, want)
    alone = tais.mixture_ais_run_plain(tx[10:], *args, **kw)[0]
    assert not torch.equal(alone, whole[0][10:])
    with pytest.raises(ValueError, match="chain_offset"):
        tais.mixture_ais_run(tx, *args, chain_offset=-2, **kw)
