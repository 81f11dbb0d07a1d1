"""The port's CD / PCD / PT-CD losses against the JAX package.

- A deterministic CD step: at ``noise_scale=0`` the negatives are a
  noise-free chain started at the data, so both packages compute the same
  numbers from the same flax weights. The loss and its parameter gradients
  agree to rtol 1e-5 (the gradients atol 1e-6 beside entries of order 0.1:
  the output bias's is a near-cancelling difference; float32 sums in another
  order), and the
  ``ContrastiveDivergenceTrainer`` parameters after three Adam steps to atol
  1e-6 (Adam's steps are 1e-3 each; the rounding of the chain and the
  gradients moves them by far less). The port's metrics are the loss's own
  mean energies, at the parameters before each update; they are held to the
  JAX model's energies at those parameters.
- A PCD train step of BASELINE config 4's recipe (step 10, clamp (-1, 1))
  on a narrow ``ConvEnergy2D`` (channels (4, 8, 8), 28 x 28): at
  ``noise_scale=0``, ``new_sample_ratio=0`` and a buffer the size of the
  batch, the buffer's rows are the chains' starts in both packages, so three
  steps (the ring fed back) agree: negatives, buffer, loss, energies and
  parameters. Tolerances: negatives and buffer atol 5e-5 (the ring fed
  back makes three steps one chain of 120 steps at step size 10, which
  carries the convolutions' rounding, of order 1e-7 per step: 3e-7 after the
  first step, 1.4e-5 after the third on this CPU), the rest as the MLP
  trainer's. In bf16 (the reference's end-to-end bf16 recipe) the chain
  state and the buffer stay bf16 through the step.
- ``ReplayBuffer.push`` wraps around exactly as JAX's.
- The PCD and PT-CD contracts mirror tests/losses/test_contrastive_divergence.py.
- ``init_buffer`` lets a failing warm-up sampler raise, where the JAX
  package keeps the chunk's noise (a repair: on the card the catch would hide
  a kernel that fails to build or launch).
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchebm_tpu.core import as_energy as jax_as_energy
from torchebm_tpu.core.trainer import ContrastiveDivergenceTrainer as JaxCDTrainer
from torchebm_tpu.losses import ContrastiveDivergence as JaxCD
from torchebm_tpu.losses import ReplayBuffer as JaxReplayBuffer
from torchebm_tpu.models import ConvEnergy2D as JaxConv
from torchebm_tpu.models import MLPEnergy as JaxMLP
from torchebm_tpu.samplers import LangevinDynamics as JaxLangevin
from torchebm_tpu_torch import core as tcore
from torchebm_tpu_torch import ops as tops
from torchebm_tpu_torch.core.trainer import ContrastiveDivergenceTrainer
from torchebm_tpu_torch.losses import (
    ContrastiveDivergence,
    ParallelTemperingCD,
    PersistentContrastiveDivergence,
    ReplayBuffer,
)
from torchebm_tpu_torch.models import ConvEnergy2D, MLPEnergy
from torchebm_tpu_torch.samplers import LangevinDynamics, ParallelTemperingLangevin
from torchebm_tpu_torch.utils import conv_energy_from_flax, mlp_energy_from_flax

torch.set_num_threads(1)


def _g(seed=0):
    return torch.Generator().manual_seed(seed)


def _energy(hidden=(16,), seed=0):
    torch.manual_seed(seed)
    net = MLPEnergy(2, hidden)
    return tcore.as_energy(net), net


def _cd(energy, **kw):
    return ContrastiveDivergence(model=energy, sampler=LangevinDynamics(energy, step_size=0.01),
                                 **kw)


# --------------------------------------------------------------------------
# number for number against JAX
# --------------------------------------------------------------------------


def _deterministic_pair(k_steps=5):
    """The same MLP(16, 16) CD loss at noise 0 in both packages."""
    net = JaxMLP(hidden_dims=(16, 16))
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 2)))
    je = jax_as_energy(net, params)
    jcd = JaxCD(model=je, sampler=JaxLangevin(je, step_size=0.05, noise_scale=0.0),
                k_steps=k_steps)
    port = mlp_energy_from_flax(params)
    te = tcore.as_energy(port)
    tcd = ContrastiveDivergence(model=te, sampler=LangevinDynamics(te, step_size=0.05,
                                                                    noise_scale=0.0),
                                k_steps=k_steps)
    data = np.random.default_rng(0).standard_normal((3, 64, 2)).astype(np.float32)
    return params, jcd, port, tcd, data


def test_deterministic_cd_loss_and_gradients_match_jax():
    params, jcd, port, tcd, data = _deterministic_pair()
    (loss, (neg, _)), grads = jax.value_and_grad(
        lambda p: jcd(p, jnp.asarray(data[0]), jax.random.PRNGKey(1)), has_aux=True)(params)
    tloss, (tneg, buf) = tcd(None, torch.tensor(data[0]), _g(1))
    tloss.backward()
    assert buf is None and not tneg.requires_grad
    np.testing.assert_allclose(tneg.numpy(), np.asarray(neg), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-5)
    jgrad = mlp_energy_from_flax(jax.device_get(grads))
    for (name, g), (_, want) in zip(port.named_parameters(), jgrad.named_parameters()):
        torch.testing.assert_close(g.grad, want.detach(), rtol=1e-5, atol=1e-6, msg=name)


def test_deterministic_cd_trainer_matches_jax_after_three_adam_steps():
    params, jcd, port, tcd, data = _deterministic_pair()
    jt = JaxCDTrainer(jcd, learning_rate=1e-3)
    jstate = jt.init_state(params, jax.random.PRNGKey(2))
    trainer = ContrastiveDivergenceTrainer(tcd, learning_rate=1e-3)
    state = trainer.init_state(port, _g(2))
    for batch in data:
        jx = jnp.asarray(batch)
        _, (jneg, _) = jcd(jstate.params, jx, jax.random.PRNGKey(0))
        jmodel = jcd._model(jstate.params)
        want = {"pos_energy": jnp.mean(jmodel.energy(jx)),
                "neg_energy": jnp.mean(jmodel.energy(jneg))}
        jstate, jm = jt.train_step(jstate, jx)
        want["loss"] = jm["loss"]
        state, m = trainer.train_step(state, torch.tensor(batch))
        for k in ("loss", "pos_energy", "neg_energy"):
            np.testing.assert_allclose(float(m[k]), float(want[k]), rtol=1e-5, atol=1e-6)
    assert state.step == 3
    want = mlp_energy_from_flax(jax.device_get(jstate.params))
    for (name, p), (_, w) in zip(port.named_parameters(), want.named_parameters()):
        torch.testing.assert_close(p.detach(), w.detach(), rtol=0, atol=1e-6, msg=name)


#: BASELINE config 4's chain (benchmarks/headline.py:502-518) at a narrow width
CONV_CHANNELS, CONV_BATCH, CONV_K, CONV_STEP, CONV_CLAMP = (4, 8, 8), 8, 40, 10.0, (-1.0, 1.0)


def _conv_pcd_pair():
    """Config 4's PCD loss in both packages on one flax ``ConvEnergy2D``, at
    noise 0 with a buffer of the batch's size and no fresh rows: every
    draw of the step is then determined by the buffer. Returns the JAX
    params, loss and buffer, the port's net, loss and buffer, and three data
    batches."""
    net = JaxConv(channels=CONV_CHANNELS, dense_dim=16)
    params = jax.jit(net.init)(jax.random.PRNGKey(3), jnp.zeros((1, 1, 28, 28)))
    kw = dict(k_steps=CONV_K, buffer_size=CONV_BATCH, new_sample_ratio=0.0, init_steps=0)
    je = jax_as_energy(net, params)
    jcd = JaxCD(model=je, sampler=JaxLangevin(je, step_size=CONV_STEP, noise_scale=0.0,
                                              clamp=CONV_CLAMP), persistent=True, **kw)
    port = conv_energy_from_flax(params)
    te = tcore.as_energy(port)
    tcd = PersistentContrastiveDivergence(
        model=te, sampler=LangevinDynamics(te, step_size=CONV_STEP, noise_scale=0.0,
                                           clamp=CONV_CLAMP), **kw)
    rng = np.random.default_rng(3)
    buf = rng.uniform(-1.0, 1.0, (CONV_BATCH, 1, 28, 28)).astype(np.float32)
    data = rng.standard_normal((3, CONV_BATCH, 1, 28, 28)).astype(np.float32)
    jbuf = JaxReplayBuffer(samples=jnp.asarray(buf), ptr=jnp.int32(0))
    return params, jcd, jbuf, port, tcd, ReplayBuffer(samples=torch.tensor(buf)), data


def test_pcd_conv_train_steps_match_jax():
    params, jcd, jbuf, port, tcd, buf, data = _conv_pcd_pair()
    jt = JaxCDTrainer(jcd, learning_rate=1e-3)
    jstate = jt.init_state(params, jax.random.PRNGKey(4), loss_state=jbuf)
    trainer = ContrastiveDivergenceTrainer(tcd, learning_rate=1e-3)
    state = trainer.init_state(port, _g(4), loss_state=buf)
    mean_energy = jax.jit(lambda p, x: jnp.mean(jcd._model(p).energy(x)))
    for batch in data:
        jx = jnp.asarray(batch)
        # the step donates the parameters' buffers: the energies read a copy
        before = jax.tree_util.tree_map(jnp.copy, jstate.params)
        jstate, jm = jt.train_step(jstate, jx)
        # the ring is the batch's size: after the step it holds the negatives
        jneg = jstate.loss_state.samples
        want = {"loss": jm["loss"], "pos_energy": mean_energy(before, jx),
                "neg_energy": mean_energy(before, jneg)}
        state, m = trainer.train_step(state, torch.tensor(batch))
        for k in ("loss", "pos_energy", "neg_energy"):
            np.testing.assert_allclose(float(m[k]), float(want[k]), rtol=1e-5, atol=1e-6)
        got = state.loss_state.samples.numpy()
        assert got.min() >= CONV_CLAMP[0] and got.max() <= CONV_CLAMP[1]
        np.testing.assert_allclose(got, np.asarray(jneg), rtol=0, atol=5e-5)
        assert state.loss_state.ptr == int(jstate.loss_state.ptr) == 0
    assert state.step == 3
    want = conv_energy_from_flax(jax.device_get(jstate.params))
    for (name, p), (_, w) in zip(port.named_parameters(), want.named_parameters()):
        torch.testing.assert_close(p.detach(), w.detach(), rtol=0, atol=1e-6, msg=name)


def test_pcd_conv_keeps_a_bf16_chain_state_and_buffer():
    """Config 4 in bf16 end to end (``headline.py:422-428``): a bf16 net, a
    bf16 buffer and bf16 data; the train step's chains run in bf16 and the
    ring keeps its dtype, the parameters and the loss stay float32."""
    torch.manual_seed(0)
    net = ConvEnergy2D(channels=CONV_CHANNELS, dense_dim=16, dtype=torch.bfloat16)
    e = tcore.as_energy(net)
    cd = PersistentContrastiveDivergence(
        model=e, sampler=LangevinDynamics(e, step_size=CONV_STEP, clamp=CONV_CLAMP),
        k_steps=5, buffer_size=4 * CONV_BATCH, init_steps=0)
    g = _g(5)
    buf = cd.init_buffer(g, (1, 28, 28))
    buf = ReplayBuffer(samples=buf.samples.to(torch.bfloat16), ptr=buf.ptr)
    trainer = ContrastiveDivergenceTrainer(cd, learning_rate=1e-4)
    state = trainer.init_state(net, g, loss_state=buf)
    x = torch.randn((CONV_BATCH, 1, 28, 28), generator=g).to(torch.bfloat16)
    _, (neg, _) = cd(None, x, _g(6), ReplayBuffer(samples=buf.samples.clone(), ptr=0))
    assert neg.dtype == torch.bfloat16
    assert float(neg.min()) >= CONV_CLAMP[0] and float(neg.max()) <= CONV_CLAMP[1]
    for _ in range(2):
        state, m = trainer.train_step(state, x)
    assert state.loss_state.samples.dtype == torch.bfloat16 and state.loss_state.ptr == 16
    assert torch.isfinite(state.loss_state.samples.float()).all()
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(np.isfinite(float(v)) for v in m.values())


@pytest.mark.parametrize("ptr, n", [(90, 64), (0, 100), (99, 1), (30, 30)])
def test_replay_buffer_push_wraps_as_jax(ptr, n):
    rng = np.random.default_rng(ptr)
    samples = rng.standard_normal((100, 2)).astype(np.float32)
    batch = rng.standard_normal((n, 2)).astype(np.float32)
    want = JaxReplayBuffer(samples=jnp.asarray(samples), ptr=jnp.int32(ptr)).push(
        jnp.asarray(batch))
    got = ReplayBuffer(samples=torch.tensor(samples), ptr=ptr).push(torch.tensor(batch))
    np.testing.assert_array_equal(got.samples.numpy(), np.asarray(want.samples))
    assert got.ptr == int(want.ptr)


def test_init_buffer_lets_a_sampler_error_propagate():
    """Divergence from the JAX package: its ``init_buffer`` catches every
    exception of the warm-up sampler and keeps the chunk's noise; the port
    raises it."""
    def broken(x):
        raise FloatingPointError("the warm-up sampler failed")

    je = jax_as_energy(lambda x: jnp.sum(x**2, -1))
    jcd = JaxCD(model=je, sampler=JaxLangevin(je, step_size=0.01), persistent=True,
                buffer_size=32, init_steps=3)
    jcd = jcd.replace(sampler=jcd.sampler.replace(model=jax_as_energy(broken)))
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        buf = jcd.init_buffer(jax.random.PRNGKey(0), (2,))
    assert buf.samples.shape == (32, 2)  # JAX: noise kept, no error

    te = tcore.as_energy(broken)
    pcd = ContrastiveDivergence(model=te, sampler=LangevinDynamics(te, step_size=0.01),
                                persistent=True, buffer_size=32, init_steps=3)
    with pytest.raises(FloatingPointError, match="warm-up sampler failed"):
        pcd.init_buffer(_g(), (2,))


def test_init_buffer_keeps_noise_on_a_shape_mismatch():
    class Squeezing(LangevinDynamics):
        def sample(self, generator, x=None, **kw):
            return x[:, :1]

    energy, _ = _energy()
    pcd = ContrastiveDivergence(model=energy, sampler=Squeezing(energy), persistent=True,
                                buffer_size=16, init_steps=2)
    with pytest.warns(RuntimeWarning, match="shape mismatch"):
        buf = pcd.init_buffer(_g(), (2,))
    assert buf.samples.shape == (16, 2) and float(buf.samples.abs().max()) < 0.1


# --------------------------------------------------------------------------
# contracts (mirroring tests/losses/test_contrastive_divergence.py)
# --------------------------------------------------------------------------


def test_cd_returns_loss_and_negatives():
    energy, _ = _energy()
    x = torch.randn(32, 2, generator=_g(1))
    loss, (neg, buf) = _cd(energy, k_steps=5)(None, x, _g(2))
    assert loss.shape == () and neg.shape == x.shape and buf is None
    # the same call with the loss's mean energies, detached
    again, (neg2, _), energies = _cd(energy, k_steps=5).loss_and_energies(None, x, _g(2))
    assert torch.equal(again, loss) and torch.equal(neg2, neg)
    assert not any(e.requires_grad for e in energies.values())
    with torch.no_grad():
        torch.testing.assert_close(energies["pos_energy"], energy(x).mean())
        torch.testing.assert_close(energies["neg_energy"], energy(neg).mean())


def test_cd_training_lowers_the_energy_of_the_data():
    energy, net = _energy((32,))
    cd = _cd(energy, k_steps=15)
    opt = torch.optim.Adam(net.parameters(), lr=2e-3)
    g = _g(3)
    mean, chol = torch.tensor([1.0, -1.0]), torch.linalg.cholesky(
        torch.tensor([[0.5, 0.2], [0.2, 0.4]]))

    def data(n=128):
        return mean + torch.randn(n, 2, generator=g) @ chol.T

    for _ in range(60):
        opt.zero_grad()
        loss, _ = cd(None, data(), g)
        loss.backward()
        opt.step()
    with torch.no_grad():
        assert float(energy(data()).mean()) < float(energy(8.0 * torch.ones(16, 2)).mean())


def test_pcd_buffer_lifecycle_and_wraparound():
    energy, _ = _energy()
    pcd = _cd(energy, k_steps=3, persistent=True, buffer_size=256, init_steps=5)
    buf = pcd.init_buffer(_g(), (2,))
    assert isinstance(buf, ReplayBuffer) and buf.samples.shape == (256, 2) and buf.ptr == 0
    x = torch.randn(64, 2, generator=_g(1))
    _, (neg, buf2) = pcd(None, x, _g(2), buf)
    assert buf2.ptr == 64
    torch.testing.assert_close(buf2.samples[:64], neg, rtol=0, atol=0)
    _, (_, buf3) = pcd(None, x, _g(3), buf2)
    assert buf3.ptr == 128
    ring = _cd(energy, k_steps=1, persistent=True, buffer_size=100, init_steps=0)
    buf = ReplayBuffer(ring.init_buffer(_g(), (2,)).samples, ptr=90)
    _, (neg, buf2) = ring(None, x, _g(4), buf)
    assert buf2.ptr == (90 + 64) % 100
    assert torch.equal(buf2.samples[90:], neg[:10]) and torch.equal(buf2.samples[:54], neg[10:])


def test_pcd_requires_a_buffer():
    energy, _ = _energy()
    trainer = ContrastiveDivergenceTrainer(_cd(energy, persistent=True))
    with pytest.raises(ValueError, match="ReplayBuffer"):
        _cd(energy, persistent=True)(None, torch.zeros(8, 2), _g())
    with pytest.raises(ValueError, match="ReplayBuffer"):
        trainer.init_state(energy.fn, _g())
    with pytest.raises(ValueError, match="persistent"):
        _cd(energy).init_buffer(_g(), (2,))


def test_gradient_flows_only_through_the_energies():
    energy, net = _energy()
    cd = _cd(energy, k_steps=3, energy_reg_weight=0.0)
    x = torch.randn(16, 2, generator=_g(1))
    loss, (neg, _) = cd(None, x, _g(2))
    loss.backward()
    assert not neg.requires_grad and neg.grad_fn is None
    assert sum(float(p.grad.norm()) for p in net.parameters()) > 0
    # the negatives equal a chain run outside autograd entirely
    with torch.no_grad():
        again = LangevinDynamics(energy, step_size=0.01).sample(_g(2), x=x, n_steps=3)
    torch.testing.assert_close(neg, again, rtol=0, atol=0)


def test_nan_guard_reads_point_one():
    e = tcore.as_energy(lambda x: torch.full((x.shape[0],), float("nan")))
    cd = ContrastiveDivergence(model=e, sampler=LangevinDynamics(e, step_size=0.01), k_steps=1,
                               energy_reg_weight=0.0)
    loss, _ = cd(None, torch.randn(8, 2), _g())
    assert float(loss) == pytest.approx(0.1)


def test_energy_regularisation_and_real_noise():
    energy, _ = _energy()
    x = torch.randn(32, 2, generator=_g(1)) + 10.0
    l0, _ = _cd(energy, k_steps=1, energy_reg_weight=0.0)(None, x, _g(2))
    l1, _ = _cd(energy, k_steps=1, energy_reg_weight=1.0)(None, x, _g(2))
    assert float(l1) > float(l0)
    ln, _ = _cd(energy, k_steps=1, add_noise_to_real=True, noise_scale=0.5)(None, x, _g(2))
    lp, _ = _cd(energy, k_steps=1)(None, x, _g(2))
    assert abs(float(ln) - float(lp)) > 1e-6


def test_params_inject_into_a_functional_energy():
    """``params`` replaces a functional ``WrappedEnergy``'s parameters for
    the call (energy and chain alike); ``None`` keeps the module's own, and a
    module without a ``params`` field refuses a value."""
    e = tcore.WrappedEnergy(fn=lambda p, x: torch.sum((x - p) ** 2, dim=-1), params=torch.zeros(2))
    cd = ContrastiveDivergence(model=e, sampler=LangevinDynamics(e, step_size=0.1), k_steps=3,
                               energy_reg_weight=0.0)
    x = torch.randn(16, 2, generator=_g(1))
    shift = torch.tensor([3.0, -3.0], requires_grad=True)
    loss, (neg, _) = cd(shift, x, _g(2))
    (grad,) = torch.autograd.grad(loss, shift)
    assert float(grad.abs().sum()) > 0 and e.params.abs().sum() == 0
    # the negatives drift toward the injected centre, not the stored one
    assert float((neg - x).mean(0) @ shift.detach()) > 0
    energy, _ = _energy()
    with pytest.raises(TypeError, match="params"):
        _cd(energy)(torch.zeros(2), x, _g())


def test_pcd_factory_and_negative_samples():
    energy, _ = _energy()
    pcd = PersistentContrastiveDivergence(model=energy, sampler=LangevinDynamics(energy),
                                          buffer_size=64, init_steps=0)
    assert pcd.persistent
    buf = pcd.init_buffer(_g(), (2,))
    neg = pcd.get_negative_samples(_g(1), 40, (2,), buf)
    assert neg.shape == (40, 2)
    assert _cd(energy).get_negative_samples(_g(1), 7, (2,)).shape == (7, 2)


def test_cd_runs_the_neural_kernel_once_per_step():
    """With ``fused_neural="force"`` every CD call's chain is one call of the
    neural chain wrapper (its plain version here) and PCD's warm-up one per
    chunk; ``"off"`` keeps it on the loop."""
    energy, _ = _energy((16, 16))
    calls = []
    real = tops.fused_mlp_langevin.mlp_langevin_chain

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    tops.fused_mlp_langevin.mlp_langevin_chain = spy
    try:
        for mode, expected in (("force", 1), ("off", 0)):
            calls.clear()
            cd = ContrastiveDivergence(
                model=energy, sampler=LangevinDynamics(energy, step_size=0.01,
                                                       fused_neural=mode), k_steps=10)
            cd(None, torch.randn(64, 2), _g())
            assert len(calls) == expected
        calls.clear()
        pcd = ContrastiveDivergence(
            model=energy, sampler=LangevinDynamics(energy, step_size=0.01, fused_neural="force"),
            persistent=True, buffer_size=300, init_steps=5)
        pcd.init_buffer(_g(), (2,), chunk_size=128)
        assert calls == [(128, 2), (128, 2), (44, 2)]
    finally:
        tops.fused_mlp_langevin.mlp_langevin_chain = real


# --------------------------------------------------------------------------
# ParallelTemperingCD
# --------------------------------------------------------------------------


def _ptcd(energy, **kw):
    sampler = ParallelTemperingLangevin(energy, temperatures=(1.0, 2.0, 4.0), step_size=0.01,
                                        swap_every=2)
    return ParallelTemperingCD(model=energy, sampler=sampler, **kw)


def test_ptcd_rejects_a_plain_sampler():
    energy, _ = _energy()
    with pytest.raises(TypeError, match="ParallelTemperingLangevin"):
        ParallelTemperingCD(model=energy, sampler=LangevinDynamics(energy))


def test_ptcd_returns_cold_negatives_and_trains():
    energy, net = _energy()
    ptcd = _ptcd(energy, k_steps=5)
    x = torch.randn(32, 2, generator=_g(1))
    loss, (neg, buf) = ptcd(None, x, _g(2))
    assert loss.shape == () and neg.shape == x.shape and buf is None
    assert torch.isfinite(loss)
    loss.backward()
    assert all(p.grad is not None for p in net.parameters())


def test_ptcd_persistent_ladder_buffer():
    energy, _ = _energy()
    ptcd = _ptcd(energy, k_steps=3, persistent=True, buffer_size=64, init_steps=4)
    buf = ptcd.init_buffer(_g(), (2,))
    assert buf.samples.shape == (64, 3, 2)
    before = buf.samples[:16].clone()
    x = torch.randn(16, 2, generator=_g(1))
    _, (neg, buf2) = ptcd(None, x, _g(2), buf)
    assert neg.shape == (16, 2) and buf2.samples.shape == (64, 3, 2) and buf2.ptr == 16
    assert not torch.equal(buf2.samples[:16], before)
    torch.testing.assert_close(buf2.samples[:16, 0], neg, rtol=0, atol=0)
    with pytest.raises(ValueError, match="ReplayBuffer"):
        ptcd(None, x, _g(), None)
