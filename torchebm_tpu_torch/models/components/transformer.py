r"""Transformer building blocks with adaLN-Zero conditioning (counterpart of
:mod:`torchebm_tpu.models.components.transformer`).

Every ``Linear`` runs in the block's compute ``dtype`` over float32
parameters. QKV is one ``Linear`` whose output columns are ordered (3, H,
hd). Attention, at scale hd^-0.5, runs on ``F.scaled_dot_product_attention``'s
fused backends, which accumulate the softmax in float32 for bf16 inputs as
the JAX package's f32 softmax does, wherever a first-order gradient at most
is taken; those backends have no forward-mode and no second-order
derivative, so under a ``torch.func`` transform or forward-mode AD, and in
a backward asked to be differentiable (``create_graph=True``), it runs the
JAX package's einsum form instead (``_attention``). Callers need not know:
losses that differentiate a model twice use it as it is. The adaLN
modulation is zero-initialised, so every block starts as the identity.

The adaLN-Zero conditioning around each branch (LayerNorm, scale and shift
before it; gate and residual after it) runs on the card as two hand-written
kernels with kernel backwards (:mod:`~torchebm_tpu_torch.ops.fused_adaln`),
one pass over the token stream a side of each branch, with the same rule as
attention: the plain operations on the CPU, under a ``torch.func`` transform
or forward-mode AD, and in a ``create_graph=True`` backward.

The joint (MMDiT) block of SD3 (:class:`JointAdaLNZeroBlock`) keeps two
token streams, image and text, each with its own adaLN-Zero, QKV, output
projection and MLP, that meet in one softmax attention over the joined
sequence (:class:`JointSelfAttention`); it is built from the same pieces.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F
from torch import nn

from ..nets import _lecun_init, _linear

Tensor = torch.Tensor

__all__ = ["modulate", "MultiheadSelfAttention", "FeedForward", "AdaLNZeroBlock",
           "JointSelfAttention", "JointAdaLNZeroBlock"]


def modulate(x: Tensor, shift: Tensor, scale: Tensor) -> Tensor:
    """adaLN modulation: ``x·(1+scale) + shift`` with per-sample (B, D) params."""
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _zero_linear(in_features: int, out_features: int) -> nn.Linear:
    layer = nn.Linear(in_features, out_features)
    nn.init.zeros_(layer.weight)
    nn.init.zeros_(layer.bias)
    return layer


def _transformed(*ts: Tensor) -> bool:
    """Whether a ``torch.func`` transform is active or a tensor of ``ts``
    carries a forward-mode tangent: the fused kernels have no such
    derivatives. Tangents are looked for only inside a dual level: each
    look is an operator call."""
    return torch._C._are_functorch_transforms_active() or (
        fwAD._current_level >= 0 and any(fwAD.unpack_dual(t).tangent is not None for t in ts))


def _einsum_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """The JAX package's attention on (B, H, N, hd): the logits by einsum at
    scale hd^-0.5, the softmax in float32, cast back, einsum with ``v``.
    Plain operations, so every derivative exists."""
    logits = torch.einsum("bhnd,bhmd->bhnm", q, k) * q.shape[-1] ** -0.5
    weights = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bhmd->bhnd", weights, v)


class _FusedAttention(torch.autograd.Function):
    """SDPA's fused kernels forward and, for a first-order gradient, backward
    (through the graph the forward keeps, freed once used); a backward that
    must itself be differentiable (``create_graph=True``), or that runs a
    second time, differentiates :func:`_einsum_attention` instead."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
        ctx.save_for_backward(q, k, v)
        with torch.enable_grad():
            leaves = tuple(t.detach().requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(*leaves)
        ctx.fused = (out, leaves)
        return out.detach()

    @staticmethod
    def backward(ctx, grad_out: Tensor):
        fused, ctx.fused = ctx.fused, None
        create_graph = torch.is_grad_enabled()
        if fused is not None and not create_graph:
            return torch.autograd.grad(*fused, grad_out)
        with torch.enable_grad():
            # fresh nodes: one input may lie on another's path (q = x, k = f(x))
            qkv = tuple(t.view_as(t) if create_graph and t.requires_grad
                        else t.detach().requires_grad_()
                        for t in ctx.saved_tensors)
            return torch.autograd.grad(_einsum_attention(*qkv), qkv, grad_out,
                                       create_graph=create_graph)


def _attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Softmax attention on (B, H, N, hd) at scale hd^-0.5. Under a
    ``torch.func`` transform or forward-mode AD the einsum form; with no
    gradient to take SDPA's fused kernels alone; else :class:`_FusedAttention`.
    On an H100 80GB HBM3 at 700 W the fused kernels take a DiT-768x12 train
    step at batch 256 from 45.4 ms to 41.9 in bf16 and from 210.2 ms to
    205.5 in f32, against the einsum form (``scripts/time_dit_attention.py``)."""
    if _transformed(q, k, v):
        return _einsum_attention(q, k, v)
    if not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return F.scaled_dot_product_attention(q, k, v)
    return _FusedAttention.apply(q, k, v)


def _layer_norm(x: Tensor, eps: float) -> Tensor:
    """LayerNorm over the last axis with no scale and no bias."""
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def _plain_ops(*ts: Tensor) -> bool:
    """Whether the adaLN conditioning runs as plain operations: off the card,
    or :func:`_transformed`."""
    return not ts[0].is_cuda or _transformed(*ts)


def _differentiable_grads(fn, inputs, grads):
    """The gradients of ``fn(*inputs)`` at ``grads``, themselves
    differentiable (a ``create_graph=True`` backward), through fresh nodes:
    one input may lie on another's path."""
    with torch.enable_grad():
        leaves = tuple(t.view_as(t) if t.requires_grad else t.detach().requires_grad_()
                       for t in inputs)
        return torch.autograd.grad(fn(*leaves), leaves, grads, create_graph=True,
                                   allow_unused=True)


class _AdaLNModulate(torch.autograd.Function):
    """``modulate(LayerNorm(x))`` by :func:`~torchebm_tpu_torch.ops.
    fused_adaln.adaln_modulate`, returning ``(z, x)``: the stream passes
    through, so that the residual's gradient reaches this node and its
    backward kernel adds it to ``dx`` in the same pass. A ``create_graph``
    backward differentiates the plain operations instead."""

    @staticmethod
    def forward(ctx, x: Tensor, shift: Tensor, scale: Tensor, eps: float):
        from ...ops import fused_adaln

        z, mean, rstd = fused_adaln.adaln_modulate(x, shift, scale, eps)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, shift, scale, mean, rstd)
        return z, x

    @staticmethod
    def backward(ctx, dz: Optional[Tensor], dres: Optional[Tensor]):
        x, shift, scale, mean, rstd = ctx.saved_tensors
        if dz is None:
            return dres, None, None, None
        if torch.is_grad_enabled():
            dx, dshift, dscale = _differentiable_grads(
                lambda x, shift, scale: modulate(_layer_norm(x, ctx.eps), shift, scale),
                (x, shift, scale), dz)
            return dx if dres is None else dx + dres, dshift, dscale, None
        from ...ops import fused_adaln

        # the forward checked x, shift and scale, and autograd gives the
        # gradients their outputs' shapes and types; a gradient may be a
        # broadcast view (the gradient of a sum)
        dx, dshift, dscale = fused_adaln._modulate_backward(
            dz.contiguous(), x, mean, rstd, scale, None if dres is None else dres.contiguous())
        return dx, dshift, dscale, None


class _GatedResidual(torch.autograd.Function):
    """``x + gate[:, None, :]·y`` by :func:`~torchebm_tpu_torch.ops.
    fused_adaln.gated_residual`; the backward kernel gives ``y``'s and
    ``gate``'s gradients and ``x``'s is the incoming one. A ``create_graph``
    backward differentiates the plain operations instead."""

    @staticmethod
    def forward(ctx, x: Tensor, gate: Tensor, y: Tensor):
        from ...ops import fused_adaln

        ctx.save_for_backward(gate, y)
        return fused_adaln.gated_residual(x, gate, y)

    @staticmethod
    def backward(ctx, dout: Tensor):
        gate, y = ctx.saved_tensors
        if torch.is_grad_enabled():
            _, dgate, dy = _differentiable_grads(lambda x, gate, y: x + gate[:, None, :] * y,
                                                 (dout, gate, y), dout)
            return dout, dgate, dy
        from ...ops import fused_adaln

        dy, dgate = fused_adaln._gated_backward(dout.contiguous(), gate, y)
        return dout, dgate, dy


def _needs_grad(a: Tensor, b: Tensor, c: Tensor) -> bool:
    return torch.is_grad_enabled() and (a.requires_grad or b.requires_grad or c.requires_grad)


def _adaln(x: Tensor, shift: Tensor, scale: Tensor, eps: float) -> Tuple[Tensor, Tensor]:
    """``(modulate(LayerNorm(x), shift, scale), x)``: on the card by the
    kernel, through :class:`_AdaLNModulate` (whose ``x`` carries the
    residual's gradient back into its kernel) where a gradient is taken and
    directly where none is (an autograd function's call costs the host as
    much as the kernel's own); else by the plain operations."""
    if _plain_ops(x, shift, scale):
        return modulate(_layer_norm(x, eps), shift, scale), x
    if _needs_grad(x, shift, scale):
        return _AdaLNModulate.apply(x, shift, scale, eps)
    from ...ops import fused_adaln

    return fused_adaln.adaln_modulate(x, shift, scale, eps, stats=False)[0], x


def _gated_residual(x: Tensor, gate: Tensor, y: Tensor) -> Tensor:
    """``x + gate[:, None, :]·y``: on the card by the kernel, through
    :class:`_GatedResidual` where a gradient is taken; else by the plain
    operations."""
    if _plain_ops(x, gate, y):
        return x + gate[:, None, :] * y
    if _needs_grad(x, gate, y):
        return _GatedResidual.apply(x, gate, y)
    from ...ops import fused_adaln

    return fused_adaln.gated_residual(x, gate, y)


class MultiheadSelfAttention(nn.Module):
    """Self-attention ``(B, N, D) -> (B, N, D)`` with a fused QKV projection."""

    def __init__(self, embed_dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(
                f"embed_dim ({embed_dim}) must be divisible by num_heads ({num_heads})"
            )
        self.embed_dim = int(embed_dim)
        self.num_heads = int(num_heads)
        self.dtype = dtype
        self.qkv = _lecun_init(nn.Linear(self.embed_dim, 3 * self.embed_dim))
        self.out_proj = _lecun_init(nn.Linear(self.embed_dim, self.embed_dim))

    def forward(self, x: Tensor) -> Tensor:
        b, n, d = x.shape
        qkv = _linear(self.qkv, x.to(self.dtype))
        qkv = qkv.reshape(b, n, 3, self.num_heads, d // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (B, H, N, hd)
        y = _attention(q, k, v)
        return _linear(self.out_proj, y.transpose(1, 2).reshape(b, n, d))


class FeedForward(nn.Module):
    """``Linear``, tanh-approximated GELU, ``Linear``; ``layers`` holds the
    two (flax's ``Dense_0`` and ``Dense_1``)."""

    def __init__(self, embed_dim: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(embed_dim * mlp_ratio)
        self.dtype = dtype
        self.layers = nn.ModuleList([
            _lecun_init(nn.Linear(embed_dim, hidden)),
            _lecun_init(nn.Linear(hidden, embed_dim)),
        ])

    def forward(self, x: Tensor) -> Tensor:
        h = F.gelu(_linear(self.layers[0], x.to(self.dtype)), approximate="tanh")
        return _linear(self.layers[1], h)


class AdaLNZeroBlock(nn.Module):
    """Transformer block with adaLN-Zero conditioning: ``modulation``
    (zero-initialised, on ``silu(cond)``) gives shift, scale and gate of the
    attention branch, then of the MLP branch; each branch reads a LayerNorm
    without scale or bias. ``cond`` is ``(B, cond_dim or embed_dim)``."""

    def __init__(self, embed_dim: int, num_heads: int, cond_dim: Optional[int] = None,
                 mlp_ratio: float = 4.0, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = float(eps)
        self.dtype = dtype
        self.modulation = _zero_linear(cond_dim or embed_dim, 6 * embed_dim)
        self.attn = MultiheadSelfAttention(embed_dim, num_heads, dtype=dtype)
        self.mlp = FeedForward(embed_dim, mlp_ratio, dtype=dtype)

    def forward(self, x: Tensor, cond: Tensor) -> Tensor:
        mod = _linear(self.modulation, F.silu(cond).to(self.dtype))
        shift1, scale1, gate1, shift2, scale2, gate2 = mod.chunk(6, dim=1)
        h, x = _adaln(x, shift1, scale1, self.eps)
        x = _gated_residual(x, gate1, self.attn(h))
        h, x = _adaln(x, shift2, scale2, self.eps)
        return _gated_residual(x, gate2, self.mlp(h))


class JointSelfAttention(nn.Module):
    """SD3's joint attention: each stream's fused QKV projection (``x_qkv``
    for the image tokens, ``c_qkv`` for the text tokens, columns ordered (3,
    H, hd)), one softmax attention over the joined sequence (image tokens
    first) by :func:`_attention`, split back, and each stream's output
    projection. ``forward(x, c) -> (x_out, c_out)``, ``(B, Nx, D)`` and
    ``(B, Nc, D)``. With ``context_pre_only`` the text tokens give keys and
    values alone: only the image tokens query, and ``c_out`` is None (the
    text stream's output is discarded after the last block).

    The joining, attending and splitting run inside the span
    ``models.joint_attention`` (:func:`~torchebm_tpu_torch.utils.profiling.
    span`), timed on the card while a profiler runs."""

    def __init__(self, embed_dim: int, num_heads: int, context_pre_only: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(
                f"embed_dim ({embed_dim}) must be divisible by num_heads ({num_heads})"
            )
        self.embed_dim = int(embed_dim)
        self.num_heads = int(num_heads)
        self.context_pre_only = bool(context_pre_only)
        self.dtype = dtype
        self.x_qkv = _lecun_init(nn.Linear(self.embed_dim, 3 * self.embed_dim))
        self.x_out_proj = _lecun_init(nn.Linear(self.embed_dim, self.embed_dim))
        self.c_qkv = _lecun_init(nn.Linear(self.embed_dim, 3 * self.embed_dim))
        self.c_out_proj = (None if self.context_pre_only
                           else _lecun_init(nn.Linear(self.embed_dim, self.embed_dim)))

    def _heads(self, layer: nn.Linear, h: Tensor) -> Tensor:
        b, n, d = h.shape
        return _linear(layer, h.to(self.dtype)).reshape(b, n, 3, self.num_heads,
                                                        d // self.num_heads)

    def forward(self, x: Tensor, c: Tensor) -> Tuple[Tensor, Optional[Tensor]]:
        from ...utils.profiling import span

        b, nx, d = x.shape
        qkv_x, qkv_c = self._heads(self.x_qkv, x), self._heads(self.c_qkv, c)
        with span("models.joint_attention", x.device):
            qkv = torch.cat([qkv_x, qkv_c], dim=1).permute(2, 0, 3, 1, 4)  # (3, B, H, N, hd)
            q, k, v = qkv.unbind(0)
            if self.context_pre_only:
                q = q[:, :, :nx]
            y = _attention(q, k, v).transpose(1, 2)
            y = y.reshape(b, y.shape[1], d)
            y_x, y_c = y[:, :nx], y[:, nx:]
        out_x = _linear(self.x_out_proj, y_x)
        return out_x, (None if self.context_pre_only else _linear(self.c_out_proj, y_c))


class JointAdaLNZeroBlock(nn.Module):
    """SD3's MMDiT block: two token streams, image ``x`` and text ``c``,
    each with its own adaLN-Zero (``x_modulation``, ``c_modulation``:
    shift, scale and gate of the attention branch, then of the MLP branch,
    on ``silu(cond)``) and MLP (``x_mlp``, ``c_mlp``), meeting in
    :class:`JointSelfAttention` (``attn``). ``forward(x, c, cond) -> (x,
    c)``.

    With ``context_pre_only`` (the last block) the text stream only feeds
    the attention its keys and values, through a continuous adaLN:
    ``c_modulation`` gives scale and shift (in that order, diffusers'
    ``AdaLayerNormContinuous``) and no gate; it has no output projection and
    no MLP, and ``c`` comes back as None."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 context_pre_only: bool = False, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = float(eps)
        self.dtype = dtype
        self.context_pre_only = bool(context_pre_only)
        self.x_modulation = _zero_linear(embed_dim, 6 * embed_dim)
        self.c_modulation = _zero_linear(embed_dim, (2 if context_pre_only else 6) * embed_dim)
        self.attn = JointSelfAttention(embed_dim, num_heads, context_pre_only, dtype=dtype)
        self.x_mlp = FeedForward(embed_dim, mlp_ratio, dtype=dtype)
        self.c_mlp = None if context_pre_only else FeedForward(embed_dim, mlp_ratio, dtype=dtype)

    def forward(self, x: Tensor, c: Tensor, cond: Tensor) -> Tuple[Tensor, Optional[Tensor]]:
        sc = F.silu(cond).to(self.dtype)
        shift1, scale1, gate1, shift2, scale2, gate2 = _linear(self.x_modulation,
                                                               sc).chunk(6, dim=1)
        mod_c = _linear(self.c_modulation, sc)
        hx, x = _adaln(x, shift1, scale1, self.eps)
        if self.context_pre_only:
            c_scale, c_shift = mod_c.chunk(2, dim=1)
            hc, _ = _adaln(c, c_shift, c_scale, self.eps)
        else:
            c_shift1, c_scale1, c_gate1, c_shift2, c_scale2, c_gate2 = mod_c.chunk(6, dim=1)
            hc, c = _adaln(c, c_shift1, c_scale1, self.eps)
        ax, ac = self.attn(hx, hc)
        x = _gated_residual(x, gate1, ax)
        hx, x = _adaln(x, shift2, scale2, self.eps)
        x = _gated_residual(x, gate2, self.x_mlp(hx))
        if self.context_pre_only:
            return x, None
        c = _gated_residual(c, c_gate1, ac)
        hc, c = _adaln(c, c_shift2, c_scale2, self.eps)
        return x, _gated_residual(c, c_gate2, self.c_mlp(hc))
