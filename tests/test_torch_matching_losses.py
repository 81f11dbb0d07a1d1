"""The port's Equilibrium Matching and Energy Matching losses against the JAX
package's: the same ``x0``, times and pairing on converted weights.

JAX draws ``x0``, the coupling's key and the times from ``jax.random.split``
of the call's key; the tests repeat that split, take JAX's own times and
pairing, and inject them into the port (a stub coupling, and the losses'
test hook ``t=``). Loss and gradient then agree to 1e-5, and three Adam steps
through ``BaseTrainer`` follow optax's to 1e-5.
"""

import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import torchebm_tpu.couplings as jc
from torchebm_tpu.core.energies import WrappedEnergy as JWrappedEnergy
from torchebm_tpu.losses import EnergyMatchingLoss as JEnergyMatching
from torchebm_tpu.losses import EquilibriumMatchingLoss as JEqM
from torchebm_tpu.models import MLPEnergy as JMLPEnergy
from torchebm_tpu.models import MLPVelocityField as JField
from torchebm_tpu_torch.core import GaussianMixtureEnergy, as_energy
from torchebm_tpu_torch.core.trainer import BaseTrainer
from torchebm_tpu_torch.couplings import BaseCoupling, CouplingResult
from torchebm_tpu_torch.losses import EnergyMatchingLoss, EquilibriumMatchingLoss
from torchebm_tpu_torch.models import EqMEnergy, MLPVelocityField
from torchebm_tpu_torch.utils import mlp_energy_from_flax, mlp_velocity_field_from_flax

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BATCH = 24


class _Paired(BaseCoupling):
    """A coupling that hands back a pairing made elsewhere."""

    def __init__(self, x1=None, weights=None):
        self.x1, self.weights = x1, weights

    def couple(self, x0, x1=None, *, generator=None, **kwargs):
        return CouplingResult(x0, self.x1, self.weights)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _field(seed=0, hidden=(16, 16)):
    net = JField(hidden_dims=hidden)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 2)), jnp.zeros((1,)))
    return net, params


def _data(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BATCH, 2)).astype(np.float32),
            (rng.standard_normal((BATCH, 2)) * 0.5 + 1.0).astype(np.float32))


def _jax_draws(loss, key, x0, x1, n_keys, eps=0.0):
    """JAX's own pairing and times for ``loss(params, x1, key, x0=x0)``."""
    keys = jax.random.split(key, n_keys)
    coupled = loss.coupling(jnp.asarray(x0), jnp.asarray(x1), key=keys[1])
    t = jax.random.uniform(keys[2], (x1.shape[0],), jnp.float32) * (1.0 - 2 * eps) + eps
    weights = None if coupled.weights is None else torch.from_numpy(np.array(coupled.weights))
    return _Paired(torch.from_numpy(np.array(coupled.x1)), weights), np.array(t)


def _grads_match(net, jgrads):
    from torchebm_tpu_torch.utils.convert import _flax_layers

    for layer, (kernel, bias) in zip(net.layers, _flax_layers(_np_tree(jgrads), "Dense")):
        np.testing.assert_allclose(layer.weight.grad.numpy(), kernel.T, **TOL)
        # a parameter the loss does not reach (EM's output bias) has no
        # gradient in PyTorch and a zero one in JAX
        grad = layer.bias.grad if layer.bias.grad is not None else torch.zeros_like(layer.bias)
        np.testing.assert_allclose(grad.numpy(), bias, **TOL)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(coupling="sinkhorn"),
    dict(coupling="unbalanced_sinkhorn"),
    dict(coupling="ot", time_invariant=False, train_eps=0.05),
    dict(energy_type="dot"),
    dict(energy_type="l2", coupling="greedy"),
    dict(energy_type="mean", ct_threshold=0.6, ct_multiplier=2.0),
    dict(prediction="score", loss_weight="velocity", train_eps=0.05, interpolant="cosine"),
    dict(prediction="noise", loss_weight="likelihood", train_eps=0.05, interpolant="vp"),
    dict(prediction="score", train_eps=0.05),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "defaults")
def test_eqm_loss_and_gradient_match_jax(kw):
    net, params = _field()
    x0, x1 = _data(1)
    key = jax.random.PRNGKey(7)
    jloss = JEqM(model=net.apply, **kw)
    want, jgrads = jax.value_and_grad(lambda p: jloss(p, jnp.asarray(x1), key,
                                                      x0=jnp.asarray(x0)))(params)
    stub, t = _jax_draws(jloss, key, x0, x1, 3, eps=kw.get("train_eps", 0.0))
    tnet = mlp_velocity_field_from_flax(_np_tree(params))
    tloss = EquilibriumMatchingLoss(model=tnet, **dict(kw, coupling=stub))
    got = tloss(None, torch.from_numpy(x1), torch.Generator().manual_seed(0),
                x0=torch.from_numpy(x0), t=torch.from_numpy(t))
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    got.backward()
    _grads_match(tnet, jgrads)
    terms = tloss.training_losses(None, torch.from_numpy(x1), torch.Generator().manual_seed(0),
                                  x0=torch.from_numpy(x0), t=torch.from_numpy(t))
    jterms = jloss.training_losses(params, jnp.asarray(x1), key, x0=jnp.asarray(x0))
    assert sorted(terms) == sorted(jterms)
    for k in ("loss", "pred", "energy"):
        if k in terms:
            np.testing.assert_allclose(terms[k].detach().numpy(), np.asarray(jterms[k]),
                                       rtol=1e-4, atol=1e-5)


def test_eqm_draws_come_from_the_generator_in_order():
    """Without injection the loss draws x0, the coupling's numbers and the
    times from the generator, and the Sinkhorn coupling takes the kernel's
    wrapper under ``fused="force"`` with the same result as the loop."""
    tnet = MLPVelocityField(2, (8,))
    x1 = torch.from_numpy(_data(2)[1])
    vals = []
    for fused in ("off", "force"):
        loss = EquilibriumMatchingLoss(model=tnet, coupling="sinkhorn")
        assert loss.coupling.fused == "auto"
        loss.coupling = type(loss.coupling)(fused=fused)
        vals.append(float(loss(None, x1, torch.Generator().manual_seed(3)).detach()))
    assert vals[0] == vals[1]
    g = torch.Generator().manual_seed(3)
    x0 = torch.randn(x1.shape, generator=g)
    coupled = loss.coupling(x0, x1, generator=g)
    t = torch.rand((BATCH,), generator=g)
    manual = EquilibriumMatchingLoss(model=tnet, coupling=_Paired(coupled.x1))(
        None, x1, torch.Generator(), x0=x0, t=t)
    assert float(manual.detach()) == pytest.approx(vals[0], rel=1e-6)
    with pytest.raises(ValueError, match="must match"):
        loss(None, x1, g, x0=torch.zeros(3, 2))
    for bad in (dict(prediction="x"), dict(energy_type="x"), dict(loss_weight="x")):
        with pytest.raises(ValueError, match="Unknown"):
            EquilibriumMatchingLoss(model=tnet, **bad)


def test_eqm_dispersion_term_matches_jax():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((2, 2)).astype(np.float32)

    def jmodel(p, x, t):
        h = jnp.tanh(x @ p)
        return h, [h * 2.0]

    class TModel(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))

        def forward(self, x, t):
            h = torch.tanh(x @ self.w)
            return h, [h * 2.0]

    x0, x1 = _data(5)
    key = jax.random.PRNGKey(8)
    jloss = JEqM(model=jmodel, apply_dispersion=True, dispersion_weight=0.3)
    want, jgrad = jax.value_and_grad(lambda p: jloss(p, jnp.asarray(x1), key,
                                                     x0=jnp.asarray(x0)))(jnp.asarray(w))
    stub, t = _jax_draws(jloss, key, x0, x1, 3)
    tm = TModel()
    got = EquilibriumMatchingLoss(model=tm, apply_dispersion=True, dispersion_weight=0.3,
                                  coupling=stub)(
        None, torch.from_numpy(x1), torch.Generator(), x0=torch.from_numpy(x0),
        t=torch.from_numpy(t))
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    got.backward()
    np.testing.assert_allclose(tm.w.grad.numpy(), np.asarray(jgrad), **TOL)


class _Fed:
    """The EqM loss with each call's ``x0``, times and pairing fed from a list."""

    def __init__(self, loss, feeds):
        self.loss, self.feeds, self.model = loss, iter(feeds), loss.model

    def __call__(self, params, x, generator, model_kwargs=None):
        x0, t, stub = next(self.feeds)
        self.loss.coupling = stub
        return self.loss(params, x, generator, x0=x0, t=t, model_kwargs=model_kwargs)


def test_three_adam_steps_through_the_trainer_match_optax():
    net, params = _field(1, (32, 32, 32))
    tnet = mlp_velocity_field_from_flax(_np_tree(params))
    jloss = JEqM(model=net.apply, coupling=jc.SinkhornCoupling(n_iters=50, reg=0.05))
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    _, x1 = _data(6)
    feeds, jlosses = [], []
    for i in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(9), i)
        x0 = np.array(jax.random.normal(jax.random.split(key, 3)[0], (BATCH, 2), jnp.float32))
        stub, t = _jax_draws(jloss, key, x0, x1, 3)
        feeds.append((torch.from_numpy(x0), torch.from_numpy(t), stub))
        l, g = jax.value_and_grad(lambda p: jloss(p, jnp.asarray(x1), key))(params)
        updates, opt_state = opt.update(g, opt_state)
        params = optax.apply_updates(params, updates)
        jlosses.append(float(l))
    trainer = BaseTrainer(_Fed(EquilibriumMatchingLoss(model=tnet), feeds),
                          functools.partial(torch.optim.Adam, lr=1e-3))
    state = trainer.init_state(tnet, torch.Generator().manual_seed(0))
    for i in range(3):
        state, metrics = trainer.train_step(state, torch.from_numpy(x1))
        np.testing.assert_allclose(float(metrics["loss"]), jlosses[i], **TOL)
    assert state.step == 3
    from torchebm_tpu_torch.utils.convert import _flax_layers

    for layer, (kernel, bias) in zip(tnet.layers, _flax_layers(_np_tree(params), "Dense")):
        np.testing.assert_allclose(layer.weight.detach().numpy(), kernel.T, **TOL)
        np.testing.assert_allclose(layer.bias.detach().numpy(), bias, **TOL)


@pytest.mark.parametrize("energy_type", ["implicit", "dot", "l2", "mean"])
def test_eqm_energy_adapter_matches_jax(energy_type):
    from torchebm_tpu.models import EqMEnergy as JEqMEnergy
    from torchebm_tpu.samplers.flow import WrappedField as JWrapped

    net, params = _field(2)
    tnet = mlp_velocity_field_from_flax(_np_tree(params))
    x = _data(7)[0]
    je = JEqMEnergy(field=JWrapped(fn=net.apply, params=params), energy_type=energy_type)
    te = EqMEnergy(tnet, energy_type=energy_type)
    np.testing.assert_allclose(te.energy(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(je.energy(jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(te.gradient(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(je.gradient(jnp.asarray(x))), rtol=1e-4, atol=1e-5)
    loss_type = "none" if energy_type == "implicit" else energy_type
    made = EqMEnergy.from_loss(EquilibriumMatchingLoss(model=tnet, energy_type=loss_type))
    assert made.energy_type == energy_type and made.field is tnet
    assert len(list(made.parameters())) == len(list(tnet.parameters()))
    with pytest.raises(ValueError, match="energy_type"):
        EqMEnergy(tnet, energy_type="none")


def _energy(seed=0, hidden=(16, 16)):
    net = JMLPEnergy(hidden_dims=hidden)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 2)))
    return net, params


@pytest.mark.parametrize("kw", [dict(coupling="ot"), dict(coupling="greedy", flow_weight_cutoff=0.5),
                                dict(coupling="unbalanced_sinkhorn"), dict(interpolant="cosine")],
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_em_flow_term_and_gradient_match_jax(kw):
    net, params = _energy()
    x0, x1 = _data(8)
    key = jax.random.PRNGKey(10)
    jloss = JEnergyMatching(model=JWrappedEnergy(fn=net.apply, params=params), sigma=0.0,
                            lambda_cd=0.0, **kw)
    want, jgrads = jax.value_and_grad(lambda p: jloss(p, jnp.asarray(x1), key,
                                                      x0=jnp.asarray(x0)))(params)
    stub, t = _jax_draws(jloss, key, x0, x1, 5)
    tnet = mlp_energy_from_flax(_np_tree(params))
    # deterministic couplings run as the port's own (the same permutation as
    # JAX's); the drawn one is injected
    coupling = stub if "sinkhorn" in kw.get("coupling", "") else kw.get("coupling", "ot")
    tloss = EnergyMatchingLoss(model=as_energy(tnet), sigma=0.0, lambda_cd=0.0,
                               **dict(kw, coupling=coupling))
    terms = tloss.training_losses(None, torch.from_numpy(x1), torch.Generator().manual_seed(0),
                                  x0=torch.from_numpy(x0), t=torch.from_numpy(t))
    assert sorted(terms) == ["cd_loss", "flow_loss", "loss"] and float(terms["cd_loss"]) == 0.0
    np.testing.assert_allclose(float(terms["loss"].detach()), float(want), **TOL)
    terms["loss"].backward()
    _grads_match(tnet, jgrads)


def test_em_contrastive_term_engages():
    """The joint phase, as the JAX e2e test reads it: finite loss and CD term,
    a CD term that is not zero, negatives of the batch's shape without a
    graph; a few Adam steps keep everything finite and lower the flow loss."""
    torch.manual_seed(0)
    from torchebm_tpu_torch.models import MLPEnergy
    from torchebm_tpu_torch.datasets import make_two_moons

    tnet = MLPEnergy(2, (32, 32))
    energy = as_energy(tnet)
    g = torch.Generator().manual_seed(1)
    warm = EnergyMatchingLoss(model=energy, lambda_cd=0.0, coupling="sinkhorn", sigma=0.05)
    joint = EnergyMatchingLoss(model=energy, lambda_cd=2.0, coupling="sinkhorn", sigma=0.05,
                               n_langevin_steps=12)
    trainer = BaseTrainer(warm, functools.partial(torch.optim.Adam, lr=2e-3))
    state = trainer.init_state(tnet, g)
    flow = []
    for _ in range(40):
        state, m = trainer.train_step(state, make_two_moons(g, 64))
        flow.append(float(m["loss"]))
    assert np.mean(flow[-10:]) < np.mean(flow[:10])
    trainer.loss_fn = joint
    for _ in range(3):
        state, m = trainer.train_step(state, make_two_moons(g, 64))
        assert np.isfinite(float(m["loss"]))
    terms = joint.training_losses(None, make_two_moons(g, 64), g)
    assert np.isfinite(float(terms["loss"])) and np.isfinite(float(terms["cd_loss"]))
    assert float(terms["cd_loss"]) != 0.0 and float(terms["cd_loss"]) >= -joint.cd_clamp
    assert terms["negatives"].shape == (64, 2) and not terms["negatives"].requires_grad
    assert torch.isfinite(terms["negatives"]).all()
    assert float(terms["loss"]) == pytest.approx(float(terms["flow_loss"] + terms["cd_loss"]))


def test_em_negatives_on_an_analytic_energy_and_validation():
    """On an analytic mixture the negatives' Langevin chains take the port's
    whole-chain row (its plain version here); conditioning is sliced per
    population; the constructor validates as the JAX package's."""
    mix = GaussianMixtureEnergy.eight_gaussians()
    em = EnergyMatchingLoss(model=mix, n_langevin_steps=8, noise_fraction=0.25)
    assert em.sampler.model is mix and em.sampler.step_size == em.langevin_dt
    g = torch.Generator().manual_seed(2)
    x1 = mix.sample(g, 16)
    negs, mk = em._sample_negatives(None, x1, None, g, {})
    assert negs.shape == (16, 2) and mk == {} and torch.isfinite(negs).all()
    # conditioning: the first population keeps the first rows, the second a
    # permutation's; unbatched values pass through
    cond = as_energy(lambda x, y=None, scale=1.0: scale * ((x - y[:, None]) ** 2).sum(-1))
    em_c = EnergyMatchingLoss(model=cond, n_langevin_steps=3, noise_fraction=0.25)
    negs, mk = em_c._sample_negatives(None, x1, None, g, {"y": torch.arange(16.0), "scale": 2.0})
    assert negs.shape == (16, 2) and mk["y"].shape == (16,) and mk["scale"] == 2.0
    assert mk["y"][:4].tolist() == [0, 1, 2, 3]
    assert len(set(mk["y"][4:].tolist())) == 12
    assert float(em._noise_sweep.value(0)) == 0.0
    assert float(em._noise_const.value(5)) == pytest.approx(0.15 ** 0.5)
    for bad, match in [(dict(noise_fraction=1.5), "noise_fraction"),
                       (dict(cd_trim_fraction=1.0), "cd_trim_fraction"),
                       (dict(cd_clamp=-1.0), "cd_clamp"), (dict(langevin_dt=0.0), "langevin_dt")]:
        with pytest.raises(ValueError, match=match):
            EnergyMatchingLoss(model=mix, **bad)
        with pytest.raises(ValueError, match=match):
            JEnergyMatching(model=None, sampler=object(), **bad)
