"""SD3's MMDiT (``JointTransformer2D``) on the card: against the plain
operations on the CPU at the small size of ``tests/test_torch_mmdit.py``,
its adaLN kernel launches a forward and a backward, and ``BaseTrainer``'s
CUDA-graph replay of its EqM steps against the eager steps, under the
profiler and after a parameter's storage is replaced.
Skipped without a CUDA device; this file imports no JAX."""

import functools

import pytest
import torch

from torchebm_tpu_torch.core import BaseTrainer
from torchebm_tpu_torch.losses import EquilibriumMatchingLoss
from torchebm_tpu_torch.models import JointTransformer2D
from torchebm_tpu_torch.ops import fused_adaln as tadaln
from torchebm_tpu_torch.utils import profiling

ADALN_KERNELS = ("adaln_modulate", "gated_residual", "adaln_modulate_backward",
                 "gated_residual_backward")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the adaLN kernels have no CPU mode)")
    return torch.device("cuda")


def _launches():
    return [getattr(tadaln, k).launches for k in ADALN_KERNELS]


def _small(dtype=torch.float32, seed=0):
    """d 64, 2 heads, depth 3 (two joint blocks and the context_pre_only
    one), every parameter drawn non-zero."""
    torch.manual_seed(seed)
    net = JointTransformer2D(in_channels=16, out_channels=16, sample_size=16, patch_size=2,
                             embed_dim=64, depth=3, num_heads=2, context_dim=32, pooled_dim=16,
                             pos_embed_max_size=12, dtype=dtype)
    with torch.no_grad():
        for p in net.parameters():
            p.normal_(0.0, 0.02 if p.ndim == 1 else p.shape[-1] ** -0.5)
    return net


def _inputs(device, b=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, 16, 8, 8, generator=g)
    t = torch.rand(b, generator=g)
    context = torch.randn(b, 6, 32, generator=g)
    pooled = torch.randn(b, 16, generator=g)
    return [a.to(device) for a in (x, t, context, pooled)]


@pytest.mark.gpu
def test_mmdit_on_the_card_matches_the_cpu_plain_path(cuda):
    """float32 on the card (the adaLN kernels, SDPA's fused attention, TF32
    off) against the CPU's plain operations: the output within 1e-5 and every
    gradient within 1e-4 of its largest entry, as the DiT block's check."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = []
        for device in ("cpu", cuda):
            net = _small().to(device)
            x, t, context, pooled = _inputs(device)
            out = net(x, t, context=context, pooled=pooled)
            out.square().mean().backward()
            runs.append((out.detach().cpu(), [p.grad.cpu() for p in net.parameters()]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    (want, want_grads), (got, grads) = runs
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    for a, c in zip(grads, want_grads):
        assert float((a - c).abs().max() / c.abs().max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [3, 24])
def test_mmdit_adaln_launches(cuda, depth):
    """In bf16 a forward launches, per joint block, two modulations and two
    gated residuals a stream, per ``context_pre_only`` block three
    modulations and two gated residuals, and one modulation for the head
    (12 and 10 at depth 3, 96 and 94 at SD3-medium's 24); a backward as many
    of each backward kernel."""
    torch.manual_seed(0)
    with torch.device(cuda):
        net = JointTransformer2D(in_channels=16, out_channels=16, sample_size=16, patch_size=2,
                                 embed_dim=64, depth=depth, num_heads=2, context_dim=32,
                                 pooled_dim=16, pos_embed_max_size=12, dtype=torch.bfloat16)
    x, t, context, pooled = _inputs(cuda)
    mods, gates = 4 * (depth - 1) + 3 + 1, 4 * (depth - 1) + 2
    before = _launches()
    out = net(x, t, context=context, pooled=pooled)
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(_launches(), before)] == [mods, gates, 0, 0]
    before = _launches()
    out.square().mean().backward()
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(_launches(), before)] == [0, 0, mods, gates]
    with torch.no_grad():
        before = _launches()
        net(x, t, context=context, pooled=pooled)
        assert [a - c for a, c in zip(_launches(), before)] == [mods, gates, 0, 0]


def _eqm_trainer(net, accum=1, cuda_graph=False):
    loss = EquilibriumMatchingLoss(net, prediction="velocity", energy_type="none",
                                   interpolant="linear", coupling="independent",
                                   ct_threshold=0.8, ct_multiplier=4.0, time_invariant=True)
    return BaseTrainer(loss, functools.partial(torch.optim.AdamW, lr=1e-3),
                       ema_decay=0.9, grad_accum_steps=accum, cuda_graph=cuda_graph)


def _step(trainer, state, device, i):
    x, _, context, pooled = _inputs(device, b=4, seed=10 + i)
    return trainer.train_step(state, (x, {"context": context, "pooled": pooled}))


def _train(dtype, graphed, steps, accum=1, between=None):
    """``steps`` EqM steps from the same weights and draws; ``between(net)``
    runs after the first. The losses, and the parameters' and the EMA's
    changes."""
    net = _small(dtype).to("cuda")
    start = {n: p.detach().clone() for n, p in net.named_parameters()}
    trainer = _eqm_trainer(net, accum, cuda_graph=graphed)
    state = trainer.init_state(net, torch.Generator("cuda").manual_seed(7))
    losses = []
    for i in range(steps):
        state, metrics = _step(trainer, state, "cuda", i)
        losses.append(float(metrics["loss"]))
        if i == 0 and between is not None:
            between(net)
    assert (trainer._graphed is not None and trainer._graphed.graphs is not None) == graphed
    return (torch.tensor(losses), {n: p.detach() - start[n] for n, p in net.named_parameters()},
            {n: e - start[n] for n, e in state.ema_params.items()})


def _assert_close(got, want, tol):
    (got_l, got_u, got_e), (want_l, want_u, want_e) = got, want
    torch.testing.assert_close(got_l, want_l, rtol=tol, atol=0)
    for name in want_u:
        assert float((got_u[name] - want_u[name]).norm() / want_u[name].norm()) <= tol, name
        assert float((got_e[name] - want_e[name]).norm() / want_e[name].norm()) <= tol, name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,accum,tol", [(torch.float32, 1, 1e-4), (torch.bfloat16, 1, 2e-2),
                                             (torch.bfloat16, 2, 2e-2)])
def test_mmdit_cuda_graph_trains_as_the_eager_model(cuda, dtype, accum, tol):
    """Four EqM steps (AdamW, EMA) replayed from the trainer's graphs against
    the eager steps from the same weights and draws: the losses, the
    parameters' and the EMA's changes within ``tol`` of their norms (the
    same kernels replayed; SDPA's backward may sum in another order). With
    two micro-batches a step the first one's gradients are copied out of
    the graphs' memory and the second's added to them."""
    _assert_close(_train(dtype, True, 4 * accum, accum), _train(dtype, False, 4 * accum, accum),
                  tol)


@pytest.mark.gpu
def test_cuda_graph_recaptures_when_a_parameter_is_replaced(cuda):
    """A parameter moved to new storage after the capture (as ``module.to``
    or an assigning restore would) makes the next step capture anew, so it
    reads the new values: three steps with every parameter replaced by half
    of itself after the first match the eager steps."""
    def replace(net):
        with torch.no_grad():
            for p in net.parameters():
                p.data = p.data * 0.5

    _assert_close(_train(torch.float32, True, 3, between=replace),
                  _train(torch.float32, False, 3, between=replace), 1e-4)


@pytest.mark.gpu
def test_mmdit_cuda_graph_replays_under_the_profiler(cuda):
    """A profiler session sees the replayed step: the trainer's phases are
    timed on the card, the graphs' kernels (the adaLN ones among them) are
    in the trace, and no ``models.joint_attention`` span is recorded, since
    a replay runs no Python; the graphs are kept."""
    net = _small(torch.bfloat16).to(cuda)
    trainer = _eqm_trainer(net, cuda_graph=True)
    state = trainer.init_state(net, torch.Generator(cuda).manual_seed(7))
    state, _ = _step(trainer, state, cuda, 0)
    graphs = trainer._graphed.graphs
    assert graphs is not None
    profiling.clear_spans()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        state, _ = _step(trainer, state, cuda, 1)
        torch.cuda.synchronize()
    assert trainer._graphed.graphs is graphs
    root = [r for r in profiling.spans() if r.parent is None][-1]
    phases = {c.name: c for c in root.children}
    assert all(phases[k].device_ms > 0 for k in ("trainer.forward", "trainer.backward"))
    assert not any(s.name == "models.joint_attention" for s in profiling.spans())
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("adaln_modulate_backward" in n for n in names), sorted(set(names))[:20]


@pytest.mark.gpu
def test_cuda_graph_captures_under_the_profiler(cuda):
    """A first step inside a profiler session captures the graphs with the
    model's spans off during the capture (a span there would time the
    capture, not the work) and trains as the eager step does: the loss and
    each parameter's change within 1e-4 of its norm."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    runs = []
    for graphed in (False, True):
        net = _small(torch.float32).to(cuda)
        start = {n: p.detach().clone() for n, p in net.named_parameters()}
        trainer = _eqm_trainer(net, cuda_graph=graphed)
        state = trainer.init_state(net, torch.Generator(cuda).manual_seed(7))
        profiling.clear_spans()
        with torch.profiler.profile(activities=acts):
            state, metrics = _step(trainer, state, cuda, 0)
            torch.cuda.synchronize()
        # the capture's warm-up passes are eager forwards, each recorded;
        # the capture itself records none
        joint = [s for s in profiling.spans() if s.name == "models.joint_attention"]
        assert len(joint) == 3 * (trainer._graphed.WARMUP if graphed else 1)
        runs.append((float(metrics["loss"]),
                     {n: p.detach() - start[n] for n, p in net.named_parameters()}))
    (want_loss, want), (got_loss, got) = runs
    assert got_loss == pytest.approx(want_loss, rel=1e-4)
    for name in want:
        assert float((got[name] - want[name]).norm() / want[name].norm()) <= 1e-4, name
