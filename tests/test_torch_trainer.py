"""The port's trainer and training utilities, mirroring tests/core/test_trainer.py
and tests/utils/ (EMA, accumulation, the scanned epoch, callbacks, a bitwise
checkpoint round trip, resume parity, precision policies, batch stacking).

The JAX trainer tests train a denoising-score-matching loss, which the port
does not have yet; a small stateless loss of the same form stands in here
(``_DSM``), and the stateful tests use PCD. ``EMA`` is also held against the
JAX ``update_ema`` number for number.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torchebm_tpu.utils import training as jtraining
from torchebm_tpu_torch import core as tcore
from torchebm_tpu_torch.core.trainer import (
    BaseTrainer,
    ContrastiveDivergenceTrainer,
    TrainState,
    _split_batch,
)
from torchebm_tpu_torch.losses import ContrastiveDivergence, ReplayBuffer
from torchebm_tpu_torch.models import MLPEnergy
from torchebm_tpu_torch.samplers import LangevinDynamics
from torchebm_tpu_torch.utils import (
    Policy,
    bf16_policy,
    benchmark_fn,
    cast_floating,
    f32_policy,
    freeze_mask,
    latest_checkpoint_step,
    load_checkpoint,
    prefetch_to_device,
    profile_context,
    stack_batches,
    update_ema,
)

torch.set_num_threads(1)


def _g(seed=0):
    return torch.Generator().manual_seed(seed)


def _adam(lr):
    return functools.partial(torch.optim.Adam, lr=lr)


class _Tanh(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a, self.b = torch.nn.Linear(2, 32), torch.nn.Linear(32, 1)

    def forward(self, x):
        return self.b(torch.tanh(self.a(x))).squeeze(-1)


class _DSM:
    """Denoising score matching on ``model``: ``E|σ∇E(x+σε) - ε|²``."""

    def __init__(self, model, noise_scale=0.3):
        self.model, self.noise_scale = model, noise_scale

    def __call__(self, params, x, generator, model_kwargs=None):
        eps = torch.randn(x.shape, generator=generator)
        xn = (x + self.noise_scale * eps).requires_grad_(True)
        (grad,) = torch.autograd.grad(self.model(xn).sum(), xn, create_graph=True)
        return torch.mean(torch.sum((self.noise_scale * grad - eps) ** 2, dim=-1))


@pytest.fixture
def net():
    torch.manual_seed(0)
    return _Tanh()


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def test_split_batch_forms():
    x = torch.ones(4, 2)
    assert _split_batch(x)[1] == {}
    assert "y" in _split_batch((x, {"y": torch.zeros(4)}))[1]
    assert "y" in _split_batch({"data": x, "y": torch.zeros(4)})[1]
    with pytest.raises(ValueError):
        _split_batch({"images": x})
    with pytest.raises(ValueError):
        _split_batch((x, x, x))


def test_base_trainer_reduces_loss(net):
    trainer = BaseTrainer(_DSM(net), _adam(1e-2))
    state = trainer.init_state(net, _g())
    g = _g(1)
    data = torch.randn(512, 2, generator=g) + torch.tensor([1.0, -1.0])
    losses = []
    for _ in range(30):
        state, m = trainer.train_step(state, data[torch.randint(0, 512, (64,), generator=g)])
        losses.append(float(m["loss"]))
    assert state.step == 30 and isinstance(state, TrainState)
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_ema_tracking(net):
    p0 = _params(net)
    trainer = BaseTrainer(_DSM(net), _adam(1e-2), ema_decay=0.5)
    state = trainer.init_state(net, _g())
    for i in range(5):
        state, _ = trainer.train_step(state, torch.randn(32, 2, generator=_g(10 + i)))

    def dist(a, b):
        return sum(float((a[k] - b[k]).norm() ** 2) for k in a) ** 0.5

    assert 0 < dist(state.ema_params, p0) < dist(_params(net), p0)


def test_update_ema_matches_jax():
    rng = np.random.default_rng(0)
    ema = {"w": rng.standard_normal((3, 4)).astype(np.float32)}
    new = {"w": rng.standard_normal((3, 4)).astype(np.float32)}
    want = jtraining.update_ema({k: jnp.asarray(v) for k, v in ema.items()},
                                {k: jnp.asarray(v) for k, v in new.items()}, 0.9)
    got = update_ema({k: torch.tensor(v) for k, v in ema.items()},
                     {k: torch.tensor(v) for k, v in new.items()}, 0.9)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), rtol=1e-6)


def test_grad_accumulation_applies_the_mean_every_k_steps(net):
    """k micro-batches: the parameters stay until the k-th, then one SGD step
    with the mean gradient (``optax.MultiSteps``)."""
    trainer = BaseTrainer(_DSM(net), functools.partial(torch.optim.SGD, lr=0.1),
                          grad_accum_steps=4)
    state = trainer.init_state(net, _g())
    p0 = _params(net)
    batches = [torch.randn(8, 2, generator=_g(20 + i)) for i in range(4)]
    for b in batches[:3]:
        state, _ = trainer.train_step(state, b)
        assert all(torch.equal(p, p0[n]) for n, p in net.named_parameters())
    state, _ = trainer.train_step(state, batches[3])
    assert not all(torch.equal(p, p0[n]) for n, p in net.named_parameters())

    # the same update from the mean gradient, computed by hand
    torch.manual_seed(0)
    ref = _Tanh()
    ref.load_state_dict(p0)
    loss = _DSM(ref)
    g = _g()
    # the output bias does not enter the score: no gradient, no step
    grads = [torch.autograd.grad(loss(None, b, g), list(ref.parameters()), allow_unused=True)
             for b in batches]
    with torch.no_grad():
        for p, *gs in zip(ref.parameters(), *grads):
            if gs[0] is not None:
                p -= 0.1 * torch.stack(gs).mean(0)
    for (n, p), q in zip(net.named_parameters(), ref.parameters()):
        torch.testing.assert_close(p.detach(), q, rtol=1e-6, atol=1e-7, msg=n)


def test_validation():
    with pytest.raises(ValueError):
        BaseTrainer(lambda *a, **k: 0.0, _adam(0.1), grad_accum_steps=0)


def test_epoch_loop_and_callbacks(net):
    events = []

    class Recorder:
        def on_train_start(self, trainer, state):
            events.append("train_start")

        def on_epoch_start(self, trainer, state):
            events.append("epoch_start")

        def on_batch_end(self, trainer, state, metrics):
            events.append("batch_end")

        def on_epoch_end(self, trainer, state, metrics):
            events.append(("epoch_end", metrics["loss"]))

        def on_train_end(self, trainer, state, history):
            events.append("train_end")

    trainer = BaseTrainer(_DSM(net), _adam(1e-3), callbacks=[Recorder()])
    state = trainer.init_state(net, _g())
    data = torch.randn(64, 2, generator=_g(1))
    state, history = trainer.train(state, epochs=2, batch_iter_fn=lambda e: [data[:32], data[32:]])
    assert events[0] == "train_start" and events[-1] == "train_end"
    assert events.count("epoch_start") == 2 and events.count("batch_end") == 4
    assert len(history) == 2 and isinstance(history[0]["loss"], float)


def test_scanned_epoch_matches_loop_exactly(net):
    """``train_epoch_scanned`` on a stacked epoch = ``train_epoch`` on the
    same batches: same draws, same parameters, same mean metrics."""
    data = torch.randn(8, 16, 2, generator=_g(2))
    p0 = _params(net)
    t1 = BaseTrainer(_DSM(net), _adam(1e-2), ema_decay=0.99, stateful_loss=False)
    s1, m1 = t1.train_epoch(t1.init_state(net, _g(3)), list(data))
    p1, ema1 = _params(net), s1.ema_params

    net.load_state_dict(p0)
    t2 = BaseTrainer(_DSM(net), _adam(1e-2), ema_decay=0.99, stateful_loss=False)
    s2, m2 = t2.train_epoch_scanned(t2.init_state(net, _g(3)), data)
    assert s1.step == s2.step == 8
    for n, p in net.named_parameters():
        assert torch.equal(p.detach(), p1[n]) and torch.equal(s2.ema_params[n], ema1[n])
    assert torch.equal(s1.generator.get_state(), s2.generator.get_state())
    assert m1 == m2 and np.isfinite(m2["loss"])


def test_scanned_epoch_threads_pcd_buffer_and_conditioning():
    """A stateful loss (the PCD buffer) and dict batches with conditioning
    go through the stacked epoch: the buffer advances, the loss is finite."""

    class CondE(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a, self.emb, self.b = (torch.nn.Linear(2, 16), torch.nn.Embedding(4, 16),
                                        torch.nn.Linear(16, 1))

        def forward(self, x, y):
            return self.b(torch.tanh(self.a(x) + self.emb(y))).squeeze(-1)

    torch.manual_seed(0)
    m = CondE()
    energy = tcore.as_energy(m)
    cd = ContrastiveDivergence(model=energy, sampler=LangevinDynamics(energy, step_size=0.05),
                               k_steps=3, persistent=True, buffer_size=64, init_steps=0)
    trainer = ContrastiveDivergenceTrainer(cd, learning_rate=1e-3)
    state = trainer.init_state(m, _g(), loss_state=cd.init_buffer(_g(), (2,)))
    before = state.loss_state.samples.clone()
    batches = stack_batches([{"data": torch.randn(16, 2, generator=_g(30 + i)),
                              "y": torch.zeros(16, dtype=torch.long)} for i in range(5)])
    assert batches["data"].shape == (5, 16, 2)
    state, metrics = trainer.train_epoch_scanned(state, batches)
    assert state.step == 5 and np.isfinite(metrics["loss"])
    assert state.loss_state.ptr == (5 * 16) % 64
    assert float((state.loss_state.samples - before).abs().max()) > 0


def test_cd_trainer_with_pcd():
    torch.manual_seed(0)
    net = MLPEnergy(2, (32,))
    energy = tcore.as_energy(net)
    cd = ContrastiveDivergence(model=energy, sampler=LangevinDynamics(energy, step_size=0.01),
                               k_steps=5, persistent=True, buffer_size=128, init_steps=0)
    trainer = ContrastiveDivergenceTrainer(cd, learning_rate=1e-3)
    state = trainer.init_state(net, _g(), loss_state=cd.init_buffer(_g(), (2,)))
    state, metrics = trainer.train_step(state, torch.randn(32, 2, generator=_g(1)))
    assert set(metrics) == {"loss", "pos_energy", "neg_energy"}
    assert state.loss_state.ptr == 32


def _pcd_trainer(seed=0):
    torch.manual_seed(seed)
    net = _Tanh()
    energy = tcore.as_energy(net)
    cd = ContrastiveDivergence(model=energy, sampler=LangevinDynamics(energy, step_size=0.01),
                               k_steps=3, persistent=True, buffer_size=64, init_steps=0)
    trainer = ContrastiveDivergenceTrainer(cd, learning_rate=1e-3, ema_decay=0.9)
    state = trainer.init_state(net, _g(5), loss_state=cd.init_buffer(_g(6), (2,)))
    return trainer, state, net


def _snapshot(state):
    return dict(params=_params(state.model), opt=state.optimizer.state_dict(),
                ema={k: v.clone() for k, v in state.ema_params.items()},
                gen=state.generator.get_state(), buf=state.loss_state.samples.clone(),
                ptr=state.loss_state.ptr, step=state.step)


def _equal_opt(a, b):
    for k, sa in a["state"].items():
        for name, t in sa.items():
            assert torch.equal(torch.as_tensor(t), torch.as_tensor(b["state"][k][name]))
    assert a["param_groups"] == b["param_groups"]


def test_checkpoint_roundtrip_bitwise(tmp_path):
    """Train 5 steps, save, restore into a fresh state: parameters, optimizer,
    EMA, step, generator and PCD buffer come back bitwise, and it steps on."""
    trainer, state, _ = _pcd_trainer()
    batches = [torch.randn(16, 2, generator=_g(100 + i)) for i in range(5)]
    for b in batches:
        state, _ = trainer.train_step(state, b)
    snap = _snapshot(state)
    path = trainer.save(state, str(tmp_path))
    assert path.endswith("step_00000005")

    trainer2, template, _ = _pcd_trainer(seed=1)
    restored = trainer2.restore(str(tmp_path), template)
    got = _snapshot(restored)
    assert got["step"] == 5 and got["ptr"] == snap["ptr"]
    assert isinstance(restored.loss_state, ReplayBuffer)
    for k in ("params", "ema"):
        assert all(torch.equal(got[k][n], snap[k][n]) for n in snap[k])
    assert torch.equal(got["gen"], snap["gen"]) and torch.equal(got["buf"], snap["buf"])
    _equal_opt(got["opt"], snap["opt"])
    restored, m = trainer2.train_step(restored, batches[0])
    assert restored.step == 6 and np.isfinite(float(m["loss"]))


def test_resume_training_parity(tmp_path):
    """5 steps, checkpoint, 3 more = 8 uninterrupted steps, bitwise: the
    generator's state rides in the checkpoint."""
    batches = [torch.randn(16, 2, generator=_g(200 + i)) for i in range(8)]
    trainer_a, state_a, _ = _pcd_trainer()
    for b in batches:
        state_a, _ = trainer_a.train_step(state_a, b)
    want = _snapshot(state_a)

    trainer_b, state_b, _ = _pcd_trainer()
    for b in batches[:5]:
        state_b, _ = trainer_b.train_step(state_b, b)
    trainer_b.save(state_b, str(tmp_path))
    trainer_c, template, _ = _pcd_trainer(seed=3)
    resumed = trainer_c.restore(str(tmp_path), template)
    for b in batches[5:]:
        resumed, _ = trainer_c.train_step(resumed, b)
    got = _snapshot(resumed)
    assert got["step"] == 8
    assert all(torch.equal(got["params"][n], want["params"][n]) for n in want["params"])
    assert all(torch.equal(got["ema"][n], want["ema"][n]) for n in want["ema"])
    assert torch.equal(got["buf"], want["buf"])


def test_restore_or_init_and_train_writes_checkpoints(tmp_path, net):
    trainer, _, model = _pcd_trainer()
    buf = trainer.loss_fn.init_buffer(_g(), (2,))
    fresh = trainer.restore_or_init(str(tmp_path), model, _g(), loss_state=buf)
    assert fresh.step == 0
    for _ in range(2):
        fresh, _ = trainer.train_step(fresh, torch.ones(8, 2))
    trainer.save(fresh, str(tmp_path))
    resumed = trainer.restore_or_init(str(tmp_path), model, _g(),
                                      loss_state=trainer.loss_fn.init_buffer(_g(), (2,)))
    assert resumed.step == 2

    ckpt = tmp_path / "dsm"
    dsm_trainer = BaseTrainer(_DSM(net), _adam(1e-3))
    state = dsm_trainer.init_state(net, _g())
    data = torch.randn(64, 2, generator=_g(1))
    dsm_trainer.train(state, epochs=2, batch_iter_fn=lambda e: [data[:32], data[32:]],
                      ckpt_dir=str(ckpt))
    assert latest_checkpoint_step(str(ckpt)) == 4
    assert load_checkpoint(str(ckpt))["step"] == 4
    assert latest_checkpoint_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"))


# --------------------------------------------------------------------------
# utilities
# --------------------------------------------------------------------------


def test_freeze_mask_sets_requires_grad(net):
    mask = freeze_mask(net, lambda name, p: not name.startswith("a."))
    assert mask == {"a.weight": False, "a.bias": False, "b.weight": True, "b.bias": True}
    trainer = BaseTrainer(_DSM(net), _adam(1e-2))
    state = trainer.init_state(net, _g())
    frozen = net.a.weight.detach().clone()
    trainer.train_step(state, torch.randn(16, 2, generator=_g(1)))
    assert torch.equal(net.a.weight, frozen)


def test_precision_policy_casts_floats_only():
    tree = {"x": torch.ones(2), "y": torch.ones(2, dtype=torch.long), "n": 3,
            "pair": (torch.zeros(1), [torch.ones(1, dtype=torch.float64)])}
    out = cast_floating(tree, torch.bfloat16)
    assert out["x"].dtype == torch.bfloat16 and out["y"].dtype == torch.long
    assert out["n"] == 3 and out["pair"][1][0].dtype == torch.bfloat16
    pol = bf16_policy()
    assert (pol.param_dtype, pol.compute_dtype, pol.output_dtype) == (
        torch.float32, torch.bfloat16, torch.float32)
    assert f32_policy() == Policy()
    wrapped = pol.wrap(lambda x, labels: (x.dtype, labels.dtype, x.sum()))
    xd, ld, s = wrapped(torch.ones(3), torch.zeros(3, dtype=torch.long))
    assert xd == torch.bfloat16 and ld == torch.long and s.dtype == torch.float32


def test_stack_batches_and_prefetch():
    batches = [(torch.full((4, 2), float(i)), {"y": torch.full((4,), i)}) for i in range(3)]
    stacked = stack_batches(batches)
    assert stacked[0].shape == (3, 4, 2) and stacked[1]["y"].shape == (3, 4)
    with pytest.raises(ValueError):
        stack_batches([])
    with pytest.raises(ValueError):
        stack_batches([torch.zeros(2), {"data": torch.zeros(2)}])
    got = list(prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(got) == 3 and torch.equal(got[2][0], batches[2][0])
    with pytest.raises(ValueError):
        list(prefetch_to_device(batches, size=0))


def test_profiling_helpers(tmp_path):
    with profile_context(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").exists()
    stats = benchmark_fn(lambda: torch.ones(16).sum(), warmup=1, iters=3)
    assert stats["iters"] == 3.0 and stats["min_s"] <= stats["median_s"]
