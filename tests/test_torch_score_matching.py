"""The port's score-matching losses against the JAX package's, on the JAX
draws injected.

Each JAX loss draws from its key once: DSM and the approximate Hessian probe
``jax.random.normal(key, x.shape)``, sliced SM ``jax.random.normal(key,
(n_projections · B, d))`` shaped into its projections. The tests recompute
that draw and hand it to the port (``noise=``, ``projections=``). Exact SM,
DSM and SSM agree to 1e-5, their parameter gradients to 1e-4, and three Adam
steps of DSM through ``BaseTrainer`` follow optax's to 1e-5. Approximate SM
takes a finite difference of two scores 1e-5 apart, which cancels in float32:
its quadratic term agrees to 1e-5 and the whole loss within the rounding
that cancellation amplifies (see ``_trace_tolerance``). Also here, the
behaviours of the JAX package's own score-matching tests.
"""

import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from torchebm_tpu.core import GaussianEnergy as JGaussian
from torchebm_tpu.core import WrappedEnergy as JWrapped
from torchebm_tpu.losses import DenoisingScoreMatching as JDSM
from torchebm_tpu.losses import ScoreMatching as JSM
from torchebm_tpu.losses import SlicedScoreMatching as JSSM
from torchebm_tpu.models import MLPEnergy as JMLP
from torchebm_tpu_torch.core import GaussianEnergy, WrappedEnergy, as_energy
from torchebm_tpu_torch.core.trainer import BaseTrainer
from torchebm_tpu_torch.losses import (
    BaseScoreMatching,
    DenoisingScoreMatching,
    ScoreMatching,
    SlicedScoreMatching,
)
from torchebm_tpu_torch.samplers import LangevinDynamics
from torchebm_tpu_torch.utils import mlp_energy_from_flax
from torchebm_tpu_torch.utils.convert import _flax_layers

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
BATCH = 32


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mlp(seed=0, hidden=(32, 32), d=2):
    net = JMLP(hidden_dims=hidden)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, d)))
    return net, params


def _x(seed, d=2, n=BATCH):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _gaussian_pair(d=3):
    rng = np.random.default_rng(7)
    a = rng.standard_normal((d, d)).astype(np.float32)
    cov = a @ a.T / d + np.eye(d, dtype=np.float32)
    mean = rng.standard_normal(d).astype(np.float32)
    return (JGaussian.create(jnp.asarray(mean), jnp.asarray(cov)),
            GaussianEnergy.create(torch.from_numpy(mean), torch.from_numpy(cov)))


def _models(kind):
    """``(jax_model, jax_params, port_energy, port_net)`` on one set of weights."""
    if kind == "gaussian":
        jg, tg = _gaussian_pair()
        return jg, None, tg, None
    net, params = _mlp()
    tnet = mlp_energy_from_flax(_np_tree(params), device="cpu")
    if kind == "mlp":
        return JWrapped(fn=net.apply, params=params), params, as_energy(tnet), tnet
    # a functional energy with its parameters inside the callable
    return (JWrapped(fn=lambda p, x: net.apply(p, x) + jnp.sum(x**4, -1), params=params),
            params, WrappedEnergy(fn=lambda x: tnet(x) + torch.sum(x**4, -1)), tnet)


def _grads_match(net, jgrads):
    for layer, (kernel, bias) in zip(net.layers, _flax_layers(_np_tree(jgrads), "Dense")):
        np.testing.assert_allclose(layer.weight.grad.numpy(), kernel.T, **GRAD_TOL)
        # a parameter the loss does not reach (the output bias, under a
        # gradient in x) has no gradient in PyTorch and a zero one in JAX
        grad = layer.bias.grad if layer.bias.grad is not None else torch.zeros_like(layer.bias)
        np.testing.assert_allclose(grad.numpy(), bias, **GRAD_TOL)


def _check(jloss, tloss, models, x, key, **inject):
    _, params, _, tnet = models
    run = jax.jit(jax.value_and_grad(lambda p: jloss(p, jnp.asarray(x), key)))
    want, jgrads = run(params) if params is not None else (jax.jit(
        lambda: jloss(None, jnp.asarray(x), key))(), None)
    got = tloss(None, torch.from_numpy(x), torch.Generator().manual_seed(0), **inject)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    if tnet is not None:
        got.backward()
        _grads_match(tnet, jgrads)


@pytest.mark.parametrize("kind", ["gaussian", "mlp", "wrapped"])
def test_exact_sm_matches_jax(kind):
    models = jm, _, tm, _ = _models(kind)
    x = _x(1, d=3 if kind == "gaussian" else 2)
    _check(JSM(model=jm), ScoreMatching(model=tm), models, x, jax.random.PRNGKey(0))


@pytest.mark.parametrize("kind", ["gaussian", "mlp"])
def test_dsm_matches_jax_with_its_sign(kind):
    models = jm, _, tm, _ = _models(kind)
    x = _x(2, d=3 if kind == "gaussian" else 2)
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    _check(JDSM(model=jm, noise_scale=0.3), DenoisingScoreMatching(model=tm, noise_scale=0.3),
           models, x, key, noise=torch.from_numpy(noise))
    if kind == "gaussian":
        # the JAX sign: the model score -∇E regressed onto -noise/σ², by hand
        xt = torch.from_numpy(x + 0.3 * noise)
        score = -tm.gradient(xt)
        want = 0.5 * torch.mean(torch.sum((score + torch.from_numpy(noise) / 0.3) ** 2, -1))
        got = DenoisingScoreMatching(model=tm, noise_scale=0.3)(None, torch.from_numpy(x), None,
                                                                noise=torch.from_numpy(noise))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("ptype", ["rademacher", "sphere", "gaussian"])
@pytest.mark.parametrize("kind", ["gaussian", "mlp"])
def test_ssm_matches_jax(ptype, kind):
    models = jm, _, tm, _ = _models(kind)
    x = _x(3, d=3 if kind == "gaussian" else 2)
    key = jax.random.PRNGKey(5)
    jloss = JSSM(model=jm, n_projections=4, projection_type=ptype)
    tloss = SlicedScoreMatching(model=tm, n_projections=4, projection_type=ptype)
    shape = (4 * x.shape[0], x.shape[1])
    v = tloss.project(torch.from_numpy(np.asarray(jax.random.normal(key, shape, jnp.float32))))
    np.testing.assert_allclose(v.numpy(), np.asarray(jloss._projections(key, shape, jnp.float32)),
                               rtol=1e-6, atol=1e-6)
    _check(jloss, tloss, models, x, key, projections=v)


def _trace_tolerance(score, x, noise, eps=1e-5):
    """Approximate SM's Hessian trace is Σ_j (s_j(x + εn) − s_j(x)) (εn_j) /
    (ε² d): two float32 scores 1e-5 apart are subtracted, so one unit
    roundoff u = 2^-24 of the largest score entry in each package becomes
    2·u·max|s|·Σ_j|εn_j| / (ε² d) in the loss (about 5e-3 here, where the
    packages differ by about 5e-4, as the port differs from its own float64
    evaluation)."""
    delta = (x + eps * noise) - x
    return (2 * 2.0**-24 * float(np.abs(score).max()) * float(np.abs(delta).sum(-1).mean())
            / (eps**2 * x.shape[1]))


@pytest.mark.parametrize("kind", ["gaussian", "mlp"])
def test_approx_sm_matches_jax(kind):
    jm, params, tm, _ = _models(kind)
    x = _x(6, d=3 if kind == "gaussian" else 2)
    key = jax.random.PRNGKey(6)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    jloss = JSM(model=jm, hessian_method="approx")
    tloss = ScoreMatching(model=tm, hessian_method="approx")
    jscore = np.asarray(jax.jit(lambda p: jloss.compute_score(jloss._model(p), jnp.asarray(x),
                                                              None))(params))
    tscore = tloss.compute_score(tm, torch.from_numpy(x), None)
    np.testing.assert_allclose(tscore.detach().numpy(), jscore, **TOL)
    # the quadratic term ½ E‖∇E‖²
    np.testing.assert_allclose(float(0.5 * torch.mean(torch.sum(tscore**2, -1))),
                               float(0.5 * np.mean(np.sum(jscore**2, -1))), **TOL)
    want = float(jax.jit(lambda p: jloss(p, jnp.asarray(x), key))(params))
    got = float(tloss(None, torch.from_numpy(x), None, noise=torch.from_numpy(noise)))
    assert abs(got - want) <= _trace_tolerance(jscore, x, noise), (got, want)


def test_three_adam_steps_of_dsm_through_the_trainer_match_optax():
    net, params = _mlp(1, (32, 32))
    tnet = mlp_energy_from_flax(_np_tree(params), device="cpu")
    jloss = JDSM(model=JWrapped(fn=net.apply, params=params), noise_scale=0.1)
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    x = _x(8)
    noises, jlosses = [], []
    for i in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(9), i)
        noises.append(torch.from_numpy(np.asarray(jax.random.normal(key, x.shape, jnp.float32))))
        value, grads = jax.jit(jax.value_and_grad(lambda p: jloss(p, jnp.asarray(x), key)))(params)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        jlosses.append(float(value))
    feeds = iter(noises)
    dsm = DenoisingScoreMatching(model=as_energy(tnet), noise_scale=0.1)
    trainer = BaseTrainer(lambda p, xx, g, model_kwargs=None: dsm(p, xx, g, noise=next(feeds),
                                                                  model_kwargs=model_kwargs),
                          functools.partial(torch.optim.Adam, lr=1e-3))
    state = trainer.init_state(tnet, torch.Generator().manual_seed(0))
    for i in range(3):
        state, metrics = trainer.train_step(state, torch.from_numpy(x))
        np.testing.assert_allclose(float(metrics["loss"]), jlosses[i], **TOL)
    for layer, (kernel, bias) in zip(tnet.layers, _flax_layers(_np_tree(params), "Dense")):
        np.testing.assert_allclose(layer.weight.detach().numpy(), kernel.T, **TOL)
        np.testing.assert_allclose(layer.bias.detach().numpy(), bias, **TOL)


def test_dsm_conditional_matches_jax():
    """DSM forwards model_kwargs (a label that moves the minimum)."""
    jm = JWrapped(fn=lambda x, y: jnp.sum((x - y.astype(x.dtype)[:, None]
                                           * jnp.array([[1.0, 0.0]])) ** 2, -1))
    tm = WrappedEnergy(fn=lambda x, y: torch.sum((x - y.to(x.dtype)[:, None]
                                                  * torch.tensor([[1.0, 0.0]])) ** 2, -1))
    x = _x(9, n=8)
    y = np.arange(8, dtype=np.int32)
    key = jax.random.PRNGKey(10)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    want = JDSM(model=jm, noise_scale=0.1)(None, jnp.asarray(x), key,
                                           model_kwargs={"y": jnp.asarray(y)})
    got = DenoisingScoreMatching(model=tm, noise_scale=0.1)(
        None, torch.from_numpy(x), None, noise=torch.from_numpy(noise),
        model_kwargs={"y": torch.from_numpy(y)})
    assert torch.isfinite(got)
    np.testing.assert_allclose(float(got), float(want), **TOL)


# ---------------------------------------------------------------- behaviours


def test_exact_sm_matched_model_analytic():
    r"""For x ~ N(0, I_d) and the matched Gaussian: loss = d/2 − d = −d/2."""
    g = torch.Generator().manual_seed(0)
    loss = ScoreMatching(model=GaussianEnergy.standard(3))(None, torch.randn(8192, 3, generator=g),
                                                           g)
    np.testing.assert_allclose(float(loss), -1.5, atol=0.1)


def test_exact_sm_minimised_at_true_scale():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4096, 2, generator=g)

    def loss_at(s):
        e = GaussianEnergy.create(torch.zeros(2), s**2 * torch.eye(2))
        return float(ScoreMatching(model=e)(None, x, g))

    assert loss_at(1.0) < loss_at(0.6) and loss_at(1.0) < loss_at(1.8)


def test_conditioning_and_argument_probes():
    g = torch.Generator().manual_seed(0)
    e = GaussianEnergy.standard(2)
    y = {"y": torch.zeros(4)}
    with pytest.raises(NotImplementedError):
        ScoreMatching(model=e)(None, torch.zeros(4, 2), g, model_kwargs=y)
    with pytest.raises(NotImplementedError):
        SlicedScoreMatching(model=e)(None, torch.zeros(4, 2), g, model_kwargs=y)
    with pytest.raises(ValueError):
        ScoreMatching(model=e, hessian_method="magic")
    with pytest.raises(ValueError):
        SlicedScoreMatching(model=e, projection_type="fourier")
    assert isinstance(DenoisingScoreMatching(model=e), BaseScoreMatching)
    approx = ScoreMatching(model=GaussianEnergy.create(torch.zeros(2), 2.0 * torch.eye(2)),
                           hessian_method="approx")
    assert np.isfinite(float(approx(None, torch.randn(2048, 2, generator=g), g)))


def test_dsm_optimum_is_the_smoothed_energy():
    r"""For N(0, I) data DSM's minimiser is E(x̃) = ‖x̃‖²/2(1+σ²); the
    inverted energy (the upstream sign) is worse."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(4096, 2, generator=g)
    sigma = 0.5
    noise = torch.randn(x.shape, generator=g)

    def loss_of(model):
        return float(DenoisingScoreMatching(model=model, noise_scale=sigma)(None, x, g,
                                                                            noise=noise))

    opt = GaussianEnergy.create(torch.zeros(2), (1 + sigma**2) * torch.eye(2))
    l_opt = loss_of(opt)
    for s_sq in (0.5, 1.0, 3.0):
        assert l_opt < loss_of(GaussianEnergy.create(torch.zeros(2), s_sq * torch.eye(2)))
    for c in (0.5, 2.0):
        near = as_energy(lambda xx, c=c: 0.5 * c * torch.sum(xx**2, -1) / (1 + sigma**2))
        assert l_opt <= loss_of(near) + 1e-4
    assert l_opt < loss_of(as_energy(lambda xx: -0.5 * torch.sum(xx**2, -1) / (1 + sigma**2)))


def test_dsm_optimum_is_sampler_compatible():
    sigma = 0.5
    opt = GaussianEnergy.create(torch.zeros(2), (1 + sigma**2) * torch.eye(2))
    out = LangevinDynamics(opt, step_size=0.05, fused="off").sample(
        torch.Generator().manual_seed(3), x=3.0 * torch.ones(512, 2), n_steps=300)
    assert float(out.mean(0).abs().max()) < 0.2
    np.testing.assert_allclose(out.var(0).numpy(), (1 + sigma**2) * np.ones(2), rtol=0.25)


def test_dsm_trains_an_mlp_energy():
    from torchebm_tpu_torch.models import MLPEnergy

    torch.manual_seed(0)
    net = MLPEnergy(2, (32, 32))
    trainer = BaseTrainer(DenoisingScoreMatching(model=as_energy(net), noise_scale=0.3),
                          functools.partial(torch.optim.Adam, lr=1e-2))
    g = torch.Generator().manual_seed(4)
    state = trainer.init_state(net, g)
    losses = []
    for _ in range(50):
        state, m = trainer.train_step(state, torch.randn(128, 2, generator=g) * 0.5 + 1.0)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10])


def test_ssm_approximates_exact_sm():
    g = torch.Generator().manual_seed(5)
    e = GaussianEnergy.standard(2)
    x = torch.randn(2048, 2, generator=g)
    exact = float(ScoreMatching(model=e)(None, x, g))
    for ptype in ("rademacher", "sphere", "gaussian"):
        sliced = float(SlicedScoreMatching(model=e, n_projections=64, projection_type=ptype)(
            None, x, g))
        assert np.isfinite(sliced) and abs(sliced - exact) < 0.5, (ptype, sliced, exact)


def test_regularisation():
    g = torch.Generator().manual_seed(6)
    e = GaussianEnergy.standard(2)
    x = 5.0 * torch.ones(16, 2)
    noise = torch.randn(x.shape, generator=g)
    plain = DenoisingScoreMatching(model=e, noise_scale=0.5)(None, x, g, noise=noise)
    reg = DenoisingScoreMatching(model=e, noise_scale=0.5, regularization_strength=1.0)(
        None, x, g, noise=noise)
    # mean ‖∇E(x)‖² = 50 at x = (5, 5)
    np.testing.assert_allclose(float(reg - plain), 50.0, rtol=1e-5)
    custom = DenoisingScoreMatching(model=e, noise_scale=0.5,
                                    custom_regularization=lambda loss, model, xx: loss + 42.0)
    np.testing.assert_allclose(float(custom(None, x, g, noise=noise) - plain), 42.0, rtol=1e-5)
