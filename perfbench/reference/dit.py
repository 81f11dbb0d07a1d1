"""Plain DiT with timestep and label embedders, the EqM loss, AdamW, the EMA,
and classifier-free guided Euler generation.

The network is DiT (Peebles & Xie, arXiv:2212.09748): a patch embedding, the
fixed 2-D sin-cos table of MAE's code, adaLN-Zero blocks (LayerNorm without
affine parameters at eps 1e-6; shift, scale and gate of attention and MLP from
``Linear(SiLU(c))``; tanh GELU), and the adaLN final layer. ``c`` is the
sinusoidal timestep embedding through ``Linear``-SiLU-``Linear`` plus a row of
the label table, whose last row is the null label. Departures, each the
layout the program and its JAX original use: the patch features are ordered
(ph, pw, C) rather than the convolution's (C, ph, pw), and the output has no
learned sigma. The EqM loss is Wang & Du's (arXiv:2510.02300): with the
linear path ``x_t = t x1 + (1 - t) x0``, the target ``-(x1 - x0) c(t)``,
``c(t) = lambda min(1, (1 - t) / (1 - a))``, a time-invariant field (it sees
t = 0), the mean square per sample, averaged over the batch.

Parameters are a ``{name: tensor}`` dict with the names of
:func:`param_layout`. Every matrix product goes through ``q`` (a control's
rounding, :func:`perfbench.reference.lowered`) when one is given.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def param_layout(cfg: dict) -> List[tuple]:
    """``[(name, shape, std)]`` of every parameter, with the standard
    deviation the benchmark draws it at: LeCun's for the matrices of the
    embedders, attention and MLP, and 0.02 for the biases and for the layers
    DiT starts at zero (adaLN modulations, the output projection); the label
    table at ``embed_dim ** -0.5``. That stands for a model some way into
    training, whose every parameter already gets a gradient."""
    d, p = cfg["embed_dim"], cfg["patch_size"]
    fe = cfg["frequency_embedding_size"]
    hidden = int(d * cfg["mlp_ratio"])
    cond = cfg["cond_dim"]
    lay = []

    def linear(name, n_in, n_out, std=None):
        lay.append((f"{name}.weight", (n_out, n_in), n_in ** -0.5 if std is None else std))
        lay.append((f"{name}.bias", (n_out,), 0.02))

    linear("t_embed.layers.0", fe, d)
    linear("t_embed.layers.1", d, d)
    n_labels = cfg["num_classes"] + (1 if cfg["label_dropout"] > 0 else 0)
    lay.append(("y_embed.embed.weight", (n_labels, d), d ** -0.5))
    linear("dit.patch_embed.proj", cfg["in_channels"] * p * p, d)
    for i in range(cfg["depth"]):
        b = f"dit.blocks.{i}"
        linear(f"{b}.modulation", cond, 6 * d, 0.02)
        linear(f"{b}.attn.qkv", d, 3 * d)
        linear(f"{b}.attn.out_proj", d, d)
        linear(f"{b}.mlp.layers.0", d, hidden)
        linear(f"{b}.mlp.layers.1", hidden, d)
    linear("dit.head.modulation", cond, 2 * d, 0.02)
    linear("dit.head.proj", d, p * p * cfg["out_channels"], 0.02)
    return lay


def _sincos(dim: int, pos: Tensor) -> Tensor:
    omega = torch.arange(dim // 2, dtype=torch.float64, device=pos.device) / (dim / 2.0)
    out = pos.to(torch.float64)[:, None] / 10000.0 ** omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def pos_embed(dim: int, grid: int, device) -> Tensor:
    """MAE's ``get_2d_sincos_pos_embed``: its first half embeds the grid's
    column coordinate (``meshgrid(w, h)``'s first plane), the second the row."""
    g = torch.arange(grid, dtype=torch.float64, device=device)
    cols = g.repeat(grid)
    rows = g.repeat_interleave(grid)
    return torch.cat([_sincos(dim // 2, cols), _sincos(dim // 2, rows)], dim=1).float()


def timestep_embedding(t: Tensor, dim: int, max_period: float = 10000.0) -> Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def forward(W: Dict[str, Tensor], cfg: dict, x: Tensor, t: Tensor, y: Tensor,
            drop: Optional[Tensor] = None, q: Optional[Callable] = None) -> Tensor:
    """The field ``(B, C_out, H, W)`` at ``x`` ``(B, C, H, W)``, times ``t``
    ``(B,)`` and labels ``y`` ``(B,)``; ``drop`` (bool ``(B,)``) replaces a
    label by the null label."""
    rnd = q or (lambda a: a)

    def lin(h, name):
        return rnd(h) @ rnd(W[f"{name}.weight"]).T + W[f"{name}.bias"]

    b, c_in, hh, ww = x.shape
    p, d, heads = cfg["patch_size"], cfg["embed_dim"], cfg["num_heads"]
    eps = 1e-6
    gh, gw = hh // p, ww // p
    cond = lin(F.silu(lin(timestep_embedding(t, cfg["frequency_embedding_size"]),
                          "t_embed.layers.0")), "t_embed.layers.1")
    if drop is not None:
        y = torch.where(drop, torch.full_like(y, cfg["num_classes"]), y)
    cond = cond + W["y_embed.embed.weight"][y]
    patches = x.reshape(b, c_in, gh, p, gw, p).permute(0, 2, 4, 3, 5, 1).reshape(b, gh * gw, -1)
    h = lin(patches, "dit.patch_embed.proj") + pos_embed(d, gh, x.device)[None]
    sc = F.silu(cond)
    n = gh * gw
    for i in range(cfg["depth"]):
        blk = f"dit.blocks.{i}"
        shift1, scale1, gate1, shift2, scale2, gate2 = lin(sc, f"{blk}.modulation").chunk(6, dim=1)
        a = F.layer_norm(h, (d,), eps=eps) * (1 + scale1[:, None]) + shift1[:, None]
        qkv = lin(a, f"{blk}.attn.qkv").reshape(b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        qh, kh, vh = qkv[0], qkv[1], qkv[2]
        weights = torch.softmax(rnd(qh) @ rnd(kh).transpose(-1, -2) * (d // heads) ** -0.5, dim=-1)
        att = (rnd(weights) @ rnd(vh)).transpose(1, 2).reshape(b, n, d)
        h = h + gate1[:, None] * lin(att, f"{blk}.attn.out_proj")
        a = F.layer_norm(h, (d,), eps=eps) * (1 + scale2[:, None]) + shift2[:, None]
        mlp = lin(F.gelu(lin(a, f"{blk}.mlp.layers.0"), approximate="tanh"), f"{blk}.mlp.layers.1")
        h = h + gate2[:, None] * mlp
    shift, scale = lin(sc, "dit.head.modulation").chunk(2, dim=1)
    a = F.layer_norm(h, (d,), eps=eps) * (1 + scale[:, None]) + shift[:, None]
    out = lin(a, "dit.head.proj")
    c_out = cfg["out_channels"]
    return out.reshape(b, gh, gw, p, p, c_out).permute(0, 5, 1, 3, 2, 4).reshape(b, c_out, hh, ww)


def eqm_sample_losses(W, cfg, eqm: dict, x1, y, drop, x0, t, q=None) -> Tensor:
    """Per-sample EqM losses ``(B,)`` at data ``x1``, noise ``x0``, times ``t``."""
    te = t[:, None, None, None]
    xt = te * x1 + (1 - te) * x0
    ct = eqm["ct_multiplier"] * torch.clamp((1 - t) / (1 - eqm["ct_threshold"]), max=1.0)
    target = -(x1 - x0) * ct[:, None, None, None]
    pred = forward(W, cfg, xt, torch.zeros_like(t), y, drop, q)
    return torch.mean(torch.square(pred - target).reshape(x1.shape[0], -1), dim=1)


def _norms(tensors: Dict[str, Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def train(W0: Dict[str, Tensor], cfg: dict, opt: dict, eqm: dict, batches: list,
          draws: torch.Generator, n_steps: int, block_rows: int, q=None) -> dict:
    """``n_steps`` EqM steps with AdamW and the EMA from ``W0`` on
    ``batches`` (``(x1, y, drop)``), noise and times drawn from ``draws`` as a
    whole batch per step (noise, then times). Gradients are summed over
    blocks of ``block_rows`` rows. Returns the losses, the first step's
    gradients (``grad_t``) and their per-leaf norms (``grad``), and the change
    of the parameters (``update``) and of the EMA (``ema``) after the last
    step."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in W0.items()}
    ema = {k: v.detach().clone() for k, v in W0.items()}
    m = {k: torch.zeros_like(v) for k, v in W0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in W0.items()}
    b1, b2 = opt["betas"]
    losses, first = [], None
    for step in range(1, n_steps + 1):
        x1, y, drop = batches[step - 1]
        n = x1.shape[0]
        x0 = torch.randn(x1.shape, generator=draws, device=x1.device)
        t = torch.rand((n,), generator=draws, device=x1.device)
        total = 0.0
        for a in range(0, n, block_rows):
            s = slice(a, a + block_rows)
            blk = eqm_sample_losses(params, cfg, eqm, x1[s], y[s], drop[s], x0[s], t[s], q)
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
    return {"losses": losses, "grad": _norms(first), "grad_t": first,
            "update": {k: p.detach() - W0[k] for k, p in params.items()},
            "ema": {k: e - W0[k] for k, e in ema.items()}}


@torch.no_grad()
def cfg_euler(W, cfg, x0: Tensor, y: Tensor, n_steps: int, cfg_scale: float,
              guide_channels: int, q=None) -> Tensor:
    """Euler on the probability-flow ODE from ``x0`` at t = 0 to t = 1 over
    ``n_steps`` even steps of the guided field: on the first
    ``guide_channels`` channels ``uncond + cfg_scale (cond - uncond)``, the
    others unconditional."""
    grid = torch.linspace(0.0, 1.0, n_steps + 1, device=x0.device)
    null = torch.full_like(y, cfg["num_classes"])
    x = x0
    for k in range(n_steps):
        t = grid[k].expand(x.shape[0])
        cond = forward(W, cfg, x, t, y, None, q)
        uncond = forward(W, cfg, x, t, null, None, q)
        c = min(guide_channels, cond.shape[1])
        v = uncond.clone()
        v[:, :c] = uncond[:, :c] + cfg_scale * (cond[:, :c] - uncond[:, :c])
        x = x + (grid[k + 1] - grid[k]) * v
    return x
