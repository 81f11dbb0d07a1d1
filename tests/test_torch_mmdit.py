"""SD3's MMDiT in the port (``JointTransformer2D``) against the plain
reference ``tests/torch_reference/mmdit.py`` at a small size: d 64, 2 heads,
depth 3 (two joint blocks and the ``context_pre_only`` one), an 8 × 8 × 16
latent, 6 text tokens of 32 and a pooled vector of 16, on seeded weights
drawn at the benchmark's scales (the zero-start layers non-zero, so every
parameter gets a gradient).

Forward values are held to rtol 1e-5 / atol 1e-5 and gradients to rtol 1e-4
/ atol 1e-5 (float32 both: the same products summed in another order, the
fused QKV against the reference's, SDPA against the explicit softmax); two
training steps' changes are held to 5e-4 of their norms. Also here: the
cropped positional table and today's table unchanged, bf16 compute over
float32 parameters, the joint attention's derivatives under ``torch.func``
and a ``create_graph`` backward, the reference's two copies, and the
``models.joint_attention`` span.
"""

import functools
import importlib.util
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from torch_reference import mmdit as ref
from torchebm_tpu_torch.core import BaseTrainer
from torchebm_tpu_torch.losses import EquilibriumMatchingLoss
from torchebm_tpu_torch.models import (
    JointAdaLNZeroBlock,
    JointSelfAttention,
    JointTransformer2D,
    build_2d_sincos_pos_embed,
    crop_2d_pos_embed,
)
from torchebm_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
CFG = dict(in_channels=16, out_channels=16, sample_size=16, patch_size=2, num_layers=3,
           num_attention_heads=2, attention_head_dim=32, joint_attention_dim=32,
           pooled_projection_dim=16, pos_embed_max_size=12, mlp_ratio=4.0,
           frequency_embedding_size=256)
EQM = dict(prediction="velocity", energy_type="none", interpolant="linear",
           coupling="independent", ct_threshold=0.8, ct_multiplier=4.0, time_invariant=True)
OPT = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, ema_decay=0.9)


def _weights(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {name: (torch.randn(shape, generator=g) * std).to(dtype)
            for name, shape, std in ref.param_layout(CFG)}


def _model(weights, dtype=torch.float32):
    c = CFG
    net = JointTransformer2D(
        in_channels=c["in_channels"], out_channels=c["out_channels"],
        sample_size=c["sample_size"], patch_size=c["patch_size"],
        embed_dim=c["num_attention_heads"] * c["attention_head_dim"], depth=c["num_layers"],
        num_heads=c["num_attention_heads"], context_dim=c["joint_attention_dim"],
        pooled_dim=c["pooled_projection_dim"], pos_embed_max_size=c["pos_embed_max_size"],
        mlp_ratio=c["mlp_ratio"], frequency_embedding_size=c["frequency_embedding_size"],
        dtype=dtype)
    params = dict(net.named_parameters())
    assert sorted(params) == sorted(weights)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name].to(p.dtype))
    return net


def _inputs(b=2, seed=1, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, CFG["in_channels"], 8, 8, generator=g, dtype=dtype)
    t = torch.rand(b, generator=g, dtype=dtype)
    context = torch.randn(b, 6, CFG["joint_attention_dim"], generator=g, dtype=dtype)
    pooled = torch.randn(b, CFG["pooled_projection_dim"], generator=g, dtype=dtype)
    return x, t, context, pooled


def test_forward_and_every_gradient_match_the_reference():
    w = _weights()
    net = _model(w)
    x, t, context, pooled = _inputs()
    probe = torch.randn(2, 16, 8, 8, generator=torch.Generator().manual_seed(5))
    out = net(x, t, context=context, pooled=pooled)
    (out * probe).sum().backward()
    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    want = ref.forward(leaves, CFG, x, t, context, pooled)
    (want * probe).sum().backward()
    assert out.shape == (2, 16, 8, 8) and float(want.detach().abs().max()) > 0.1
    torch.testing.assert_close(out, want, **TOL)
    for name, p in net.named_parameters():
        assert float(leaves[name].grad.abs().max()) > 0, name
        torch.testing.assert_close(p.grad, leaves[name].grad, **GRAD_TOL, msg=name)


def test_an_eqm_trainer_step_matches_the_reference_train():
    """Two BaseTrainer steps with EquilibriumMatchingLoss, AdamW and the EMA
    against the reference's ``train`` on the same batches and draws: the
    losses to 1e-5, the first step's gradients, and the parameters' and
    EMA's changes to 5e-4 of their norm, leaf by leaf (Adam divides each
    entry by its gradient's root mean square, so an entry whose gradient is
    mostly round-off moves by a share of the learning rate either way: the
    largest such entry reads 1.7e-3 of the largest change, the worst leaf's
    norm 7e-5 of its change)."""
    w = _weights(2)
    net = _model(w)
    loss = EquilibriumMatchingLoss(net, **EQM)
    trainer = BaseTrainer(loss, functools.partial(
        torch.optim.AdamW, lr=OPT["lr"], betas=OPT["betas"], eps=OPT["eps"],
        weight_decay=OPT["weight_decay"]), ema_decay=OPT["ema_decay"])
    state = trainer.init_state(net, torch.Generator().manual_seed(7))
    batches = [_inputs(4, seed=10 + i) for i in range(2)]
    losses, first = [], None
    for i, (x, _, context, pooled) in enumerate(batches):
        state, metrics = trainer.train_step(state, (x, {"context": context, "pooled": pooled}))
        losses.append(float(metrics["loss"]))
        if i == 0:
            first = {n: state.optimizer.state[p]["exp_avg"] / (1 - OPT["betas"][0])
                     for n, p in net.named_parameters()}
    want = ref.train({k: v.clone() for k, v in w.items()}, CFG, OPT, EQM,
                     [(x, c, p) for x, _, c, p in batches], torch.Generator().manual_seed(7),
                     2, 3)
    torch.testing.assert_close(torch.tensor(losses), torch.tensor(want["losses"]),
                               rtol=1e-5, atol=0)
    def gap(got, want):
        return float((got - want).norm() / want.norm())

    for name, p in net.named_parameters():
        torch.testing.assert_close(first[name], want["grad_t"][name], **GRAD_TOL, msg=name)
        assert gap(p.detach() - w[name], want["update"][name]) <= 5e-4, name
        assert gap(state.ema_params[name] - w[name], want["ema"][name]) <= 5e-4, name


def test_the_cropped_table_matches_the_reference():
    """SD3's table (coordinates over ``base_size``, centre crop) against the
    reference's float64 one; at SD3-medium's grid too (192, base 64, a 32 × 32
    latent grid)."""
    for dim, m, base, gh, gw in ((64, 12, 8, 4, 4), (64, 12, 8, 5, 3), (1536, 192, 64, 32, 32)):
        got = crop_2d_pos_embed(build_2d_sincos_pos_embed(dim, m, base_size=base), gh, gw)
        want = ref.pos_embed(dim, m, base, gh, gw, "cpu")
        assert got.shape == (gh * gw, dim)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    with pytest.raises(ValueError):
        crop_2d_pos_embed(build_2d_sincos_pos_embed(8, 4), 5, 4)


@pytest.mark.parametrize("grid", [1, 4, 16])
def test_todays_table_is_unchanged_bit_for_bit(grid):
    """Without ``base_size`` the table is the one the DiT has always had:
    the integer grid, MAE's layout, the float32 arithmetic as it was."""
    dim = 32

    def sincos(d, pos):
        omega = torch.arange(d // 2, dtype=torch.float32)
        omega = 1.0 / (10000.0 ** (omega / (d / 2)))
        out = pos[:, None].to(torch.float32) * omega[None, :]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    g = torch.arange(grid, dtype=torch.float32)
    ww, hh = torch.meshgrid(g, g, indexing="xy")
    cells = torch.stack([ww, hh], dim=0).reshape(2, -1)
    want = torch.cat([sincos(dim // 2, cells[0]), sincos(dim // 2, cells[1])], dim=1)
    assert torch.equal(build_2d_sincos_pos_embed(dim, grid), want)


def test_bf16_compute_keeps_float32_parameters():
    w = _weights(3)
    net32, net16 = _model(w), _model(w, torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in net16.parameters())
    x, t, context, pooled = _inputs()
    out = net16(x, t, context=context, pooled=pooled)
    want = net32(x, t, context=context, pooled=pooled)
    assert out.dtype == torch.float32
    rel = float((out - want).detach().norm() / want.detach().norm())
    assert 1e-5 < rel < 5e-2, rel
    out.square().mean().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in net16.parameters())


def _joint_block(seed=4, pre_only=False):
    torch.manual_seed(seed)
    block = JointAdaLNZeroBlock(16, 2, context_pre_only=pre_only, dtype=torch.float64).double()
    with torch.no_grad():
        for p in block.parameters():
            p.add_(0.1 * torch.randn_like(p))
    return block


@pytest.mark.parametrize("pre_only", [False, True])
def test_joint_attention_under_torch_func_and_create_graph(pre_only):
    """The joint block's derivatives where the einsum form runs: a
    ``torch.func.jvp`` against central differences in float64, and a
    ``create_graph`` backward's Hessian-vector product against
    ``torch.func``'s forward-over-reverse one, to 1e-5 of its norm (the
    einsum form's softmax runs in float32, as the JAX package's does, so
    float64 inputs agree to float32's rounding there)."""
    block = _joint_block(pre_only=pre_only)
    g = torch.Generator().manual_seed(6)
    x, c = torch.randn(2, 5, 16, generator=g, dtype=torch.float64), torch.randn(
        2, 3, 16, generator=g, dtype=torch.float64)
    cond = torch.randn(2, 16, generator=g, dtype=torch.float64)
    v = torch.randn(x.shape, generator=g, dtype=torch.float64)

    def f(x):
        return block(x, c, cond)[0]

    _, tangent = torch.func.jvp(f, (x,), (v,))
    eps = 1e-6
    fd = (f(x + eps * v) - f(x - eps * v)) / (2 * eps)
    torch.testing.assert_close(tangent, fd, rtol=1e-6, atol=1e-7)

    def energy(x):
        return f(x).square().sum()

    xg = x.clone().requires_grad_()
    (grad,) = torch.autograd.grad(energy(xg), xg, create_graph=True)
    (hvp,) = torch.autograd.grad((grad * v).sum(), xg)
    _, want = torch.func.jvp(torch.func.grad(energy), (x,), (v,))
    assert float((hvp - want).norm() / want.norm()) <= 1e-5


def test_joint_attention_pre_only_drops_the_text_queries():
    """With ``context_pre_only`` the image rows equal those of the full joint
    attention, and no text output comes back."""
    full = JointSelfAttention(16, 2)
    pre = JointSelfAttention(16, 2, context_pre_only=True)
    pre.load_state_dict({k: v for k, v in full.state_dict().items() if "c_out_proj" not in k})
    x, c = torch.randn(2, 5, 16), torch.randn(2, 3, 16)
    out_x, out_c = pre(x, c)
    want_x, _ = full(x, c)
    assert out_c is None and pre.c_out_proj is None
    torch.testing.assert_close(out_x, want_x, **TOL)


def test_the_reference_copies_agree():
    path = ROOT / "perfbench" / "reference" / "mmdit.py"
    spec = importlib.util.spec_from_file_location("perfbench_reference_mmdit", path)
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    assert copy.param_layout(CFG) == ref.param_layout(CFG)
    w = _weights(8)
    x, t, context, pooled = _inputs(seed=9)
    assert torch.equal(copy.forward(w, CFG, x, t, context, pooled),
                       ref.forward(w, CFG, x, t, context, pooled))
    x0 = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    assert torch.equal(copy.eqm_sample_losses(w, CFG, EQM, x, context, pooled, x0, t),
                       ref.eqm_sample_losses(w, CFG, EQM, x, context, pooled, x0, t))


def _step(trainer, state):
    x, _, context, pooled = _inputs(2, seed=12)
    return trainer.train_step(state, (x, {"context": context, "pooled": pooled}))


def test_joint_attention_span_three_times_a_forward_inside_trainer_forward():
    net = _model(_weights(1))
    trainer = BaseTrainer(EquilibriumMatchingLoss(net, **EQM),
                          functools.partial(torch.optim.AdamW, lr=1e-4))
    state = trainer.init_state(net, torch.Generator().manual_seed(0))
    profiling.clear_spans()
    state, _ = _step(trainer, state)
    assert profiling.spans() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        state, _ = _step(trainer, state)
    roots = [s for s in profiling.spans() if s.parent is None]
    assert [r.name for r in roots] == ["trainer.train_step"]
    phases = {c.name: c for c in roots[0].children}
    joint = [c.name for c in phases["trainer.forward"].children]
    assert joint == ["models.joint_attention"] * CFG["num_layers"]
    assert not phases["trainer.backward"].children and not phases["trainer.optimizer"].children
    assert all(s.device_ms is None for s in phases["trainer.forward"].children)
    profiling.clear_spans()


def test_the_model_refuses_what_it_cannot_build():
    with pytest.raises(ValueError):
        JointTransformer2D(embed_dim=64, depth=0, num_heads=2)
    with pytest.raises(ValueError):
        JointSelfAttention(30, 4)
    net = _model(_weights())
    x, t, context, pooled = _inputs()
    with pytest.raises(ValueError):
        net(F.pad(x, (0, 20, 0, 20)), t, context=context, pooled=pooled)


def test_cuda_graph_off_the_card_is_the_eager_model():
    """``BaseTrainer(cuda_graph=True)`` on the CPU runs the eager step: two
    EqM steps give the same losses, parameters and EMA bit for bit, and no
    graph is captured."""
    w = _weights(3)
    batches = [_inputs(4, seed=20 + i) for i in range(2)]
    runs = []
    for graphed in (False, True):
        net = _model(w)
        trainer = BaseTrainer(EquilibriumMatchingLoss(net, **EQM),
                              functools.partial(torch.optim.AdamW, lr=OPT["lr"]),
                              ema_decay=OPT["ema_decay"], cuda_graph=graphed)
        state = trainer.init_state(net, torch.Generator().manual_seed(7))
        losses = []
        for x, _, context, pooled in batches:
            state, metrics = trainer.train_step(state, (x, {"context": context, "pooled": pooled}))
            losses.append(metrics["loss"])
        runs.append((torch.stack(losses), {n: p.detach() for n, p in net.named_parameters()},
                     state.ema_params))
    assert trainer.cuda_graph and trainer._graphed.graphs is None
    (want_l, want_p, want_e), (got_l, got_p, got_e) = runs
    assert torch.equal(got_l, want_l)
    assert all(torch.equal(got_p[n], want_p[n]) and torch.equal(got_e[n], want_e[n])
               for n in want_p)
