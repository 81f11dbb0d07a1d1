"""The adaLN-Zero kernels' plain versions and the DiT block's dispatch to them,
on the CPU (``torchebm_tpu_torch.ops.fused_adaln``,
``models/components/transformer.py``).

The plain versions hold the formulas the kernels implement (``dx``,
``dshift``, ``dscale``, ``dgate``, ``dy``); they are checked in float64
against autograd of the plain composite the block ran before the kernels. On
the CPU the block runs that composite bit for bit. The autograd functions
that carry the kernels on the card are driven here through the plain
versions (the wrappers' CPU path), with the device gate opened for the CPU:
first-order gradients by the backward wrappers, and a ``create_graph=True``
backward, a ``torch.func`` transform and forward-mode AD by the composite.
"""

import pytest
import torch
import torch.autograd.forward_ad as fwAD

from torchebm_tpu_torch import ops
from torchebm_tpu_torch.models.components import AdaLNZeroBlock, AdaLNZeroPatchHead
from torchebm_tpu_torch.models.components import transformer as tr
from torchebm_tpu_torch.ops import fused_adaln as fa

EPS = 1e-6
SHAPES = [(d, n) for d in (72, 200, 768) for n in (1, 17, 256)]


def _inputs(n, d, dtype=torch.float64, b=2, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, dtype=torch.float64)).to(dtype)

    # x off zero mean and unit scale, as a residual stream is
    return dict(x=r(b, n, d, scale=2.0) + 0.5, shift=r(b, d, scale=0.3), scale=r(b, d, scale=0.3),
                gate=r(b, d, scale=0.3), y=r(b, n, d), dz=r(b, n, d), dres=r(b, n, d))


def _composite_modulate(x, shift, scale):
    return tr.modulate(tr._layer_norm(x, EPS), shift, scale)


@pytest.mark.parametrize("d,n", SHAPES)
def test_modulate_plain_matches_the_composite_and_its_autograd(d, n):
    t = _inputs(n, d)
    x, shift, scale = (t[k].requires_grad_() for k in ("x", "shift", "scale"))
    want = _composite_modulate(x, shift, scale)
    z, mean, rstd = fa.adaln_modulate_plain(x.detach(), shift.detach(), scale.detach(), EPS)
    torch.testing.assert_close(z, want.detach(), rtol=1e-12, atol=1e-12)
    gx, gshift, gscale = torch.autograd.grad(want, (x, shift, scale), t["dz"])
    dx, dshift, dscale = fa.adaln_modulate_backward_plain(t["dz"], x.detach(), mean, rstd,
                                                          scale.detach(), t["dres"])
    torch.testing.assert_close(dx, gx + t["dres"], rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(dshift, gshift, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(dscale, gscale, rtol=1e-10, atol=1e-10)
    # without the residual's gradient, dx is the LayerNorm path's alone
    dx0, _, _ = fa.adaln_modulate_backward_plain(t["dz"], x.detach(), mean, rstd, scale.detach())
    torch.testing.assert_close(dx0, gx, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("d,n", SHAPES)
def test_gated_residual_plain_matches_the_composite_and_its_autograd(d, n):
    t = _inputs(n, d)
    x, gate, y = (t[k].requires_grad_() for k in ("x", "gate", "y"))
    want = x + gate[:, None, :] * y
    torch.testing.assert_close(fa.gated_residual_plain(x.detach(), gate.detach(), y.detach()),
                               want.detach(), rtol=1e-12, atol=1e-12)
    gx, ggate, gy = torch.autograd.grad(want, (x, gate, y), t["dz"])
    dy, dgate = fa.gated_residual_backward_plain(t["dz"], gate.detach(), y.detach())
    torch.testing.assert_close(gx, t["dz"])  # the stream's gradient is dout itself
    torch.testing.assert_close(dy, gy, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dgate, ggate, rtol=1e-10, atol=1e-10)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    t = _inputs(17, 72, dtype=torch.bfloat16)
    counts = ops.launch_counts()
    z, mean, rstd = ops.adaln_modulate(t["x"], t["shift"], t["scale"], EPS)
    want = fa.adaln_modulate_plain(t["x"], t["shift"], t["scale"], EPS)
    for got, w in zip((z, mean, rstd), want):
        assert torch.equal(got, w)
    assert z.dtype == torch.bfloat16 and mean.dtype == rstd.dtype == torch.float32
    assert ops.adaln_modulate(t["x"], t["shift"], t["scale"], EPS, stats=False)[1:] == (None, None)
    back = ops.adaln_modulate_backward(t["dz"], t["x"], mean, rstd, t["scale"], dres=t["dres"])
    assert [g.dtype for g in back] == [torch.bfloat16] * 3
    assert torch.equal(ops.gated_residual(t["x"], t["gate"], t["y"]),
                       fa.gated_residual_plain(t["x"], t["gate"], t["y"]))
    dy, dgate = ops.gated_residual_backward(t["dz"], t["gate"], t["y"])
    assert dy.shape == t["y"].shape and dgate.shape == t["gate"].shape
    assert ops.launch_counts() == counts  # the CPU path launches no kernel


def test_wrappers_refuse_what_the_kernels_do_not_take():
    t = _inputs(4, 16, dtype=torch.float32)
    with pytest.raises(ValueError, match=r"\(B, N, D\)"):
        ops.adaln_modulate(t["x"][0], t["shift"], t["scale"])
    with pytest.raises(ValueError, match="shift must have shape"):
        ops.adaln_modulate(t["x"], t["shift"][:, :8], t["scale"])
    with pytest.raises(ValueError, match="y must have shape"):
        ops.gated_residual(t["x"], t["gate"], t["y"][:, :2])
    with pytest.raises(ValueError, match="mean must be"):
        ops.adaln_modulate_backward(t["dz"], t["x"], torch.zeros(2, 3), torch.ones(2, 4),
                                    t["scale"])
    with pytest.raises(ValueError, match="only CPU"):
        ops.gated_residual(t["x"].to("meta"), t["gate"].to("meta"), t["y"].to("meta"))


@pytest.mark.parametrize("case,want", [
    # (B, N, D, itemsize, backward) -> (vec, items, rows, chunks)
    ((256, 256, 768, 2, False), (True, 3, 64, 4)),
    ((256, 256, 768, 2, True), (True, 3, 256, 1)),
    ((256, 256, 768, 4, False), (True, 6, 64, 4)),
    ((8, 256, 768, 2, True), (True, 3, 16, 16)),
    ((2, 17, 72, 2, True), (True, 1, 6, 3)),
    ((3, 1, 200, 4, False), (True, 2, 1, 1)),
    ((2, 1, 200, 2, True), (True, 1, 1, 1)),
    ((4, 30, 100, 2, False), (False, 4, 30, 1)),
    ((4, 30, 1152, 4, True), (True, 12, 8, 4)),
    ((4, 30, 4096, 2, False), (True, 16, 30, 1)),
    # SD3-medium's image and text streams at batch 32: 4 chunks, 128 blocks
    # for 132 multiprocessors (5 chunks would start a second wave of 28)
    ((32, 256, 1536, 2, True), (True, 6, 64, 4)),
    ((32, 154, 1536, 2, True), (True, 6, 39, 4)),
    ((100, 64, 768, 2, True), (True, 3, 64, 1)),
])
def test_launch_plan(case, want):
    b, n, d, itemsize, backward = case
    assert tuple(fa.launch_plan(b, n, d, itemsize, backward=backward)) == want


def test_launch_plan_refuses_what_no_build_takes():
    assert fa.launch_plan(1, 1, 512, 2, aligned=False).items == 16
    for args in ((1, 1, 513, 2), (1, 1, 4104, 2), (1, 1, 2056, 4), (70_000, 1, 8, 2),
                 (1, 0, 8, 2)):
        with pytest.raises(ValueError):
            fa.launch_plan(*args)
    with pytest.raises(ValueError, match="exceeds"):
        fa.launch_plan(1, 1, 600, 2, aligned=False)


def _block(dtype=torch.float32, seed=0, d=72, heads=4):
    torch.manual_seed(seed)
    block = AdaLNZeroBlock(d, heads, cond_dim=24, dtype=dtype)
    with torch.no_grad():  # a block some way into training: the gates open
        block.modulation.weight.normal_(0.0, 0.2)
        block.modulation.bias.normal_(0.0, 0.2)
    return block


def _today(block, x, cond):
    """The block's forward as the plain composite (before the kernels)."""
    mod = tr._linear(block.modulation, torch.nn.functional.silu(cond).to(block.dtype))
    shift1, scale1, gate1, shift2, scale2, gate2 = mod.chunk(6, dim=1)
    x = x + gate1[:, None, :] * block.attn(tr.modulate(tr._layer_norm(x, block.eps), shift1,
                                                       scale1))
    return x + gate2[:, None, :] * block.mlp(tr.modulate(tr._layer_norm(x, block.eps), shift2,
                                                         scale2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_dispatch_is_the_composite_bit_for_bit(dtype):
    block = _block(dtype=dtype)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 17, 72, generator=g).to(dtype).requires_grad_()
    cond = torch.randn(3, 24, generator=g)
    got, want = block(x, cond), _today(block, x, cond)
    assert torch.equal(got, want)
    dz = torch.randn(got.shape, generator=g).to(dtype)
    params = list(block.parameters())
    for a, b in zip(torch.autograd.grad(got, [x, *params], dz),
                    torch.autograd.grad(want, [x, *params], dz)):
        assert torch.equal(a, b)
    head = AdaLNZeroPatchHead(72, 2, 2, cond_dim=24, dtype=dtype)
    with torch.no_grad():
        head.modulation.weight.normal_(0.0, 0.2)
        head.proj.weight.normal_(0.0, 0.2)
    shift, scale = tr._linear(head.modulation, torch.nn.functional.silu(cond).to(dtype)).chunk(2, 1)
    tokens = tr.modulate(tr._layer_norm(x[:, :16], 1e-6), shift, scale)
    from torchebm_tpu_torch.models.components.patch import unpatchify2d
    want = unpatchify2d(tr._linear(head.proj, tokens.to(dtype)), 2, out_channels=2)
    assert torch.equal(head(x[:, :16], cond), want)


@pytest.fixture
def kernel_gate(monkeypatch):
    """Opens the block's kernel path for CPU tensors: the autograd functions
    then run the wrappers' CPU path (the plain versions); transforms and
    tangents still take the composite."""
    monkeypatch.setattr(tr, "_plain_ops", tr._transformed)


def _functions_ran(monkeypatch):
    """Counts of the autograd functions' forwards and backwards."""
    seen = {"mod": 0, "mod_back": 0, "gate": 0, "gate_back": 0}
    for cls, key in ((tr._AdaLNModulate, "mod"), (tr._GatedResidual, "gate")):
        fwd, bwd = cls.forward, cls.backward

        def forward(ctx, *a, _f=fwd, _k=key):
            seen[_k] += 1
            return _f(ctx, *a)

        def backward(ctx, *a, _f=bwd, _k=key):
            seen[_k + "_back"] += 1
            return _f(ctx, *a)

        monkeypatch.setattr(cls, "forward", staticmethod(forward))
        monkeypatch.setattr(cls, "backward", staticmethod(backward))
    return seen


def test_kernel_path_matches_the_composite_first_order(kernel_gate, monkeypatch):
    seen = _functions_ran(monkeypatch)
    block = _block(torch.float64)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 17, 72, generator=g, dtype=torch.float64).requires_grad_()
    cond = torch.randn(2, 24, generator=g, dtype=torch.float64)
    got, want = block(x, cond), _today(block, x, cond)
    assert seen["mod"] == 2 and seen["gate"] == 2
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    dz = torch.randn(got.shape, generator=g, dtype=torch.float64)
    params = list(block.parameters())
    for a, b in zip(torch.autograd.grad(got, [x, *params], dz),
                    torch.autograd.grad(want, [x, *params], dz)):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
    assert seen["mod_back"] == 2 and seen["gate_back"] == 2


def test_kernel_path_under_no_grad_keeps_no_statistics(kernel_gate, monkeypatch):
    kept = []
    real = fa.adaln_modulate_plain

    def plain(*a, stats=True, **k):
        kept.append(stats)
        return real(*a, stats=stats, **k)

    monkeypatch.setattr(fa, "adaln_modulate_plain", plain)
    block = _block()
    x = torch.randn(2, 5, 72)
    with torch.no_grad():
        block(x, torch.randn(2, 24))
    block(x, torch.randn(2, 24))
    assert kept == [False, False, True, True]


def test_backward_kernels_take_contiguous_gradients(kernel_gate, monkeypatch):
    """The gradient of a sum reaches the block as a broadcast view (stride
    0); the backward kernels take contiguous streams only, so the autograd
    functions hand them contiguous gradients, and the gradients match the
    composite's."""
    streams = []
    for name, at in (("_modulate_backward", (0, 5)), ("_gated_backward", (0,))):
        real = getattr(fa, name)

        def spy(*a, _real=real, _at=at):
            streams.extend(a[i] is None or a[i].is_contiguous() for i in _at)
            return _real(*a)

        monkeypatch.setattr(fa, name, spy)
    block = _block(torch.float64)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 9, 72, generator=g, dtype=torch.float64).requires_grad_()
    cond = torch.randn(2, 24, generator=g, dtype=torch.float64)
    params = [x, *block.parameters()]
    got = torch.autograd.grad(block(x, cond).sum(), params)
    assert len(streams) == 6 and all(streams)
    for a, b in zip(got, torch.autograd.grad(_today(block, x, cond).sum(), params)):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def test_create_graph_backward_differentiates_the_composite(kernel_gate, monkeypatch):
    """A second-order loss (the mean square of an input gradient taken with
    create_graph=True) through the kernel path's functions: their backward
    takes the composite, whose own gradients match the composite's."""
    block = _block(torch.float64)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 9, 72, generator=g, dtype=torch.float64)
    cond = torch.randn(2, 24, generator=g, dtype=torch.float64)

    def second(fn):
        x2 = x.clone().requires_grad_()
        (gx,) = torch.autograd.grad((fn(x2, cond) * x2).sum(), x2, create_graph=True)
        return torch.autograd.grad(gx.square().mean(), list(block.parameters()))

    seen = _functions_ran(monkeypatch)
    got = second(block)
    # two of each in the create_graph backward (the composite), two more as
    # the second-order loss's backward passes the forward's nodes (first order)
    assert seen["mod_back"] == 4 and seen["gate_back"] == 4
    for a, b in zip(got, second(lambda x, c: _today(block, x, c))):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)


def test_transforms_and_tangents_take_the_composite(kernel_gate, monkeypatch):
    seen = _functions_ran(monkeypatch)
    block = _block(torch.float64)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 9, 72, generator=g, dtype=torch.float64)
    cond = torch.randn(2, 24, generator=g, dtype=torch.float64)
    v = torch.randn(x.shape, generator=g, dtype=torch.float64)
    out, jvp = torch.func.jvp(lambda x: block(x, cond), (x,), (v,))
    want_out, want_jvp = torch.func.jvp(lambda x: _today(block, x, cond), (x,), (v,))
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(jvp, want_jvp, rtol=0, atol=0)
    with fwAD.dual_level():
        tangent = fwAD.unpack_dual(block(fwAD.make_dual(x, v), cond)).tangent
    torch.testing.assert_close(tangent, want_jvp, rtol=1e-12, atol=1e-12)
    assert seen == {"mod": 0, "mod_back": 0, "gate": 0, "gate_back": 0}
