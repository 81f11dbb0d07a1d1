"""Plain MMDiT (Stable Diffusion 3's joint transformer) with its timestep and
pooled-text embedders, the EqM loss, AdamW and the EMA.

The network is SD3's (Esser et al., arXiv:2403.03206; diffusers'
``SD3Transformer2DModel``): a patch embedding plus a fixed 2-D sin-cos
table over a ``pos_embed_max_size``² grid, coordinates ``arange(M) / (M /
base)`` with ``base = sample_size / patch_size``, centre-cropped to the
latent's patch grid; the text features through ``Linear(joint_attention_dim,
d)``; the conditioning ``c`` the sinusoidal timestep embedding (cosines,
then sines, max period 10,000) through ``Linear``-SiLU-``Linear`` plus the
pooled vector through ``Linear``-SiLU-``Linear``. Each block keeps an image
and a text stream, each with its own adaLN-Zero (LayerNorm without affine
parameters at eps 1e-6; shift, scale and gate of attention and MLP from
``Linear(SiLU(c))``), QKV, output projection and tanh-GELU MLP; the streams
meet in one softmax attention over the joined sequence (image tokens
first) at scale ``hd^-0.5``. The last block is ``context_pre_only``: its
text stream is a continuous adaLN (scale, then shift, from
``Linear(SiLU(c))``) feeding only the joint attention's QKV, whose text
outputs are discarded. The head: shift and scale from ``Linear(SiLU(c))``,
LayerNorm-modulate, ``Linear(d, p·p·C_out)``, unpatchify.

Departures, each a layout of the program's that computes the same function:
one fused QKV ``Linear`` a stream (columns ordered (3, H, hd)) where
diffusers has three; the patch features ordered (ph, pw, C) rather than the
convolution's (C, ph, pw); the head's modulation chunked (shift, scale)
where diffusers' ``norm_out`` has (scale, shift). The EqM loss is Wang &
Du's (arXiv:2510.02300), as ``dit.py`` has it.

Parameters are a ``{name: tensor}`` dict with the names of
:func:`param_layout`. Every matrix product goes through ``q`` (a control's
rounding) when one is given. Kept equal to ``perfbench/reference/mmdit.py``
(a test runs both on the same weights).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def dims(cfg: dict) -> dict:
    """Hidden width ``d``, heads, MLP width and depth of the configuration."""
    heads = cfg["num_attention_heads"]
    d = heads * cfg["attention_head_dim"]
    return {"d": d, "heads": heads, "hidden": int(d * cfg["mlp_ratio"]),
            "depth": cfg["num_layers"]}


def param_layout(cfg: dict) -> List[tuple]:
    """``[(name, shape, std)]`` of every parameter, with the standard
    deviation the benchmark draws it at: LeCun's for the matrices of the
    embedders, attention and MLP, and 0.02 for the biases and for the layers
    adaLN-Zero starts at zero (the modulations, the head's projection). That
    stands for a model some way into training, whose every parameter already
    gets a gradient."""
    g = dims(cfg)
    d, hidden, p = g["d"], g["hidden"], cfg["patch_size"]
    lay = []

    def linear(name, n_in, n_out, std=None):
        lay.append((f"{name}.weight", (n_out, n_in), n_in ** -0.5 if std is None else std))
        lay.append((f"{name}.bias", (n_out,), 0.02))

    linear("t_embed.layers.0", cfg["frequency_embedding_size"], d)
    linear("t_embed.layers.1", d, d)
    linear("pooled_embed.layers.0", cfg["pooled_projection_dim"], d)
    linear("pooled_embed.layers.1", d, d)
    linear("context_embed", cfg["joint_attention_dim"], d)
    linear("patch_embed.proj", cfg["in_channels"] * p * p, d)
    for i in range(g["depth"]):
        b = f"blocks.{i}"
        last = i == g["depth"] - 1
        linear(f"{b}.x_modulation", d, 6 * d, 0.02)
        linear(f"{b}.c_modulation", d, (2 if last else 6) * d, 0.02)
        linear(f"{b}.attn.x_qkv", d, 3 * d)
        linear(f"{b}.attn.x_out_proj", d, d)
        linear(f"{b}.attn.c_qkv", d, 3 * d)
        if not last:
            linear(f"{b}.attn.c_out_proj", d, d)
        linear(f"{b}.x_mlp.layers.0", d, hidden)
        linear(f"{b}.x_mlp.layers.1", hidden, d)
        if not last:
            linear(f"{b}.c_mlp.layers.0", d, hidden)
            linear(f"{b}.c_mlp.layers.1", hidden, d)
    linear("head.modulation", d, 2 * d, 0.02)
    linear("head.proj", d, p * p * cfg["out_channels"], 0.02)
    return lay


def _sincos(dim: int, pos: Tensor) -> Tensor:
    omega = torch.arange(dim // 2, dtype=torch.float64, device=pos.device) / (dim / 2.0)
    out = pos.to(torch.float64)[:, None] / 10000.0 ** omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def pos_embed(dim: int, max_size: int, base_size: float, gh: int, gw: int, device) -> Tensor:
    """diffusers' ``get_2d_sincos_pos_embed(dim, max_size, base_size)``
    (MAE's layout: the first half embeds the column coordinate, the second
    the row), centre-cropped to ``gh × gw``: ``(gh·gw, dim)``."""
    g = torch.arange(max_size, dtype=torch.float64, device=device) / (max_size / base_size)
    cols = g.repeat(max_size)
    rows = g.repeat_interleave(max_size)
    table = torch.cat([_sincos(dim // 2, cols), _sincos(dim // 2, rows)], dim=1).float()
    top, left = (max_size - gh) // 2, (max_size - gw) // 2
    return table.reshape(max_size, max_size, dim)[top:top + gh, left:left + gw].reshape(gh * gw,
                                                                                       dim)


def timestep_embedding(t: Tensor, dim: int, max_period: float = 10000.0) -> Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def forward(W: Dict[str, Tensor], cfg: dict, x: Tensor, t: Tensor, context: Tensor,
            pooled: Tensor, q: Optional[Callable] = None) -> Tensor:
    """The field ``(B, C_out, H, W)`` at ``x`` ``(B, C, H, W)``, times ``t``
    ``(B,)``, text features ``context`` ``(B, Nc, joint_attention_dim)`` and
    pooled text vectors ``pooled`` ``(B, pooled_projection_dim)``."""
    rnd = q or (lambda a: a)

    def lin(h, name):
        return rnd(h) @ rnd(W[f"{name}.weight"]).T + W[f"{name}.bias"]

    def mlp(h, name):
        return lin(F.silu(lin(h, f"{name}.0")), f"{name}.1")

    def ln(h):
        return F.layer_norm(h, (h.shape[-1],), eps=1e-6)

    g = dims(cfg)
    d, heads, hd = g["d"], g["heads"], g["d"] // g["heads"]
    b, c_in, hh, ww = x.shape
    p = cfg["patch_size"]
    gh, gw = hh // p, ww // p
    nx, nc = gh * gw, context.shape[1]
    cond = (mlp(timestep_embedding(t, cfg["frequency_embedding_size"]), "t_embed.layers")
            + mlp(pooled, "pooled_embed.layers"))
    sc = F.silu(cond)
    patches = x.reshape(b, c_in, gh, p, gw, p).permute(0, 2, 4, 3, 5, 1).reshape(b, nx, -1)
    hx = lin(patches, "patch_embed.proj") + pos_embed(
        d, cfg["pos_embed_max_size"], cfg["sample_size"] / p, gh, gw, x.device)[None]
    hc = lin(context, "context_embed")

    def heads_of(a, name):
        n = a.shape[1]
        return lin(a, name).reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)

    for i in range(g["depth"]):
        blk = f"blocks.{i}"
        last = i == g["depth"] - 1
        shift1, scale1, gate1, shift2, scale2, gate2 = lin(sc, f"{blk}.x_modulation").chunk(6, 1)
        ax = ln(hx) * (1 + scale1[:, None]) + shift1[:, None]
        if last:
            c_scale, c_shift = lin(sc, f"{blk}.c_modulation").chunk(2, 1)
            ac = ln(hc) * (1 + c_scale[:, None]) + c_shift[:, None]
        else:
            c_shift1, c_scale1, c_gate1, c_shift2, c_scale2, c_gate2 = lin(
                sc, f"{blk}.c_modulation").chunk(6, 1)
            ac = ln(hc) * (1 + c_scale1[:, None]) + c_shift1[:, None]
        qkv = torch.cat([heads_of(ax, f"{blk}.attn.x_qkv"), heads_of(ac, f"{blk}.attn.c_qkv")],
                        dim=3)
        qh, kh, vh = qkv[0], qkv[1], qkv[2]
        weights = torch.softmax(rnd(qh) @ rnd(kh).transpose(-1, -2) * hd ** -0.5, dim=-1)
        att = (rnd(weights) @ rnd(vh)).transpose(1, 2).reshape(b, nx + nc, d)
        hx = hx + gate1[:, None] * lin(att[:, :nx], f"{blk}.attn.x_out_proj")
        a = ln(hx) * (1 + scale2[:, None]) + shift2[:, None]
        hx = hx + gate2[:, None] * lin(F.gelu(lin(a, f"{blk}.x_mlp.layers.0"), approximate="tanh"),
                                       f"{blk}.x_mlp.layers.1")
        if not last:
            hc = hc + c_gate1[:, None] * lin(att[:, nx:], f"{blk}.attn.c_out_proj")
            a = ln(hc) * (1 + c_scale2[:, None]) + c_shift2[:, None]
            hc = hc + c_gate2[:, None] * lin(
                F.gelu(lin(a, f"{blk}.c_mlp.layers.0"), approximate="tanh"),
                f"{blk}.c_mlp.layers.1")
    shift, scale = lin(sc, "head.modulation").chunk(2, dim=1)
    out = lin(ln(hx) * (1 + scale[:, None]) + shift[:, None], "head.proj")
    c_out = cfg["out_channels"]
    return out.reshape(b, gh, gw, p, p, c_out).permute(0, 5, 1, 3, 2, 4).reshape(b, c_out, hh, ww)


def eqm_sample_losses(W, cfg, eqm: dict, x1, context, pooled, x0, t, q=None) -> Tensor:
    """Per-sample EqM losses ``(B,)`` at data ``x1``, noise ``x0``, times
    ``t``: with ``x_t = t x1 + (1 - t) x0``, the target ``-(x1 - x0) c(t)``,
    ``c(t) = lambda min(1, (1 - t) / (1 - a))``, a time-invariant field (it
    sees t = 0), the mean square per sample."""
    te = t[:, None, None, None]
    xt = te * x1 + (1 - te) * x0
    ct = eqm["ct_multiplier"] * torch.clamp((1 - t) / (1 - eqm["ct_threshold"]), max=1.0)
    target = -(x1 - x0) * ct[:, None, None, None]
    pred = forward(W, cfg, xt, torch.zeros_like(t), context, pooled, q)
    return torch.mean(torch.square(pred - target).reshape(x1.shape[0], -1), dim=1)


def _norms(tensors: Dict[str, Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def train(W0: Dict[str, Tensor], cfg: dict, opt: dict, eqm: dict, batches: list,
          draws, n_steps: int, block_rows: int, q=None,
          sample_losses: Optional[Callable] = None) -> dict:
    """``n_steps`` EqM steps with AdamW and the EMA from ``W0`` on
    ``batches`` (``(x1, context, pooled)``). ``draws`` is a generator, or a
    list of generators that each draw for an equal share of a batch's rows
    in turn, as the ranks of a sharded batch draw their own: each draws its
    rows' noise, then their times. Gradients are summed over blocks of
    ``block_rows`` rows. ``sample_losses`` (by default
    :func:`eqm_sample_losses`) takes ``(W, cfg, eqm, *batch_rows, x0, t,
    q)``: another model's per-sample EqM losses train it alike. Returns the
    losses, the first step's gradients (``grad_t``) and their per-leaf norms
    (``grad``), and the change of the parameters (``update``) and of the EMA
    (``ema``) after the last step, each taken against ``W0`` leaf by leaf as
    the state is dropped."""
    gens = list(draws) if isinstance(draws, (list, tuple)) else [draws]
    sample_losses = sample_losses or eqm_sample_losses
    params = {k: v.detach().clone().requires_grad_(True) for k, v in W0.items()}
    ema = {k: v.detach().clone() for k, v in W0.items()}
    m = {k: torch.zeros_like(v) for k, v in W0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in W0.items()}
    b1, b2 = opt["betas"]
    losses, first = [], None
    for step in range(1, n_steps + 1):
        batch = batches[step - 1]
        x1 = batch[0]
        n = x1.shape[0]
        share = n // len(gens)
        x0, t = [], []
        for g in gens:
            x0.append(torch.randn((share, *x1.shape[1:]), generator=g, device=x1.device))
            t.append(torch.rand((share,), generator=g, device=x1.device))
        x0, t = torch.cat(x0), torch.cat(t)
        total = 0.0
        for a in range(0, n, block_rows):
            s = slice(a, a + block_rows)
            blk = sample_losses(params, cfg, eqm, *(b[s] for b in batch), x0[s], t[s], q)
            part = torch.sum(blk) / n
            part.backward()
            total += float(part.detach())
        losses.append(total)
        with torch.no_grad():
            if step == 1:
                first = {k: p.grad.clone() for k, p in params.items()}
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for k, p in params.items():
                g = p.grad
                p.mul_(1 - opt["lr"] * opt["weight_decay"])
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = v2[k].sqrt() / math.sqrt(bc2) + opt["eps"]
                p.addcdiv_(m[k], denom, value=-opt["lr"] / bc1)
                p.grad = None
                ema[k].mul_(opt["ema_decay"]).add_(p, alpha=1 - opt["ema_decay"])
    del m, v2
    update, ema_change = {}, {}
    for k in list(params):
        w0 = W0[k]
        update[k] = params.pop(k).detach().sub_(w0)
        ema_change[k] = ema.pop(k).sub_(w0)
    return {"losses": losses, "grad": _norms(first), "grad_t": first, "update": update,
            "ema": ema_change}
