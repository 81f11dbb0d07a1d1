"""Plain Langevin and HMC chains on an isotropic Gaussian mixture, with the
counter-based random numbers the program's whole-chain kernels draw.

The mixture is ``p(x) ∝ Σ_k w_k N(x; μ_k, σ² I)``; the ring has K modes at
radius ``r``, ``μ_k = r (cos 2πk/K, sin 2πk/K)``, equal weights.

Randomness: normals and Metropolis uniforms come from Philox4x32-10 (Salmon et
al., SC'11) with key ``(seed lo, seed hi)`` and counter ``(chain lo, step,
block, chain hi)``: block ``j`` gives coordinates ``4j..4j+3`` by two
Box–Muller transforms of its words' top 24 bits, block ``0xFFFFFFFF`` the
uniform (the first word's top 24 bits times 2^-24). The ``seed`` of a call is
what ``torch.randint(0, 2**63 - 1, (), generator=g)`` draws from the call's
generator. The arithmetic here is int64 masked to 32 bits.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

Tensor = torch.Tensor
_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_TWO_PI_F32 = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))
UNIFORM_BLOCK = _MASK


def kernel_seed(state: Tensor, device) -> int:
    """The seed a call draws from a generator in ``state``."""
    g = torch.Generator(device)
    g.set_state(state)
    return int(torch.randint(0, 2**63 - 1, (), generator=g, device=device))


def _mulhilo(a: int, b: Tensor) -> Tuple[Tensor, Tensor]:
    lo16, hi16 = b * (a & 0xFFFF), b * (a >> 16)
    mid = lo16 + ((hi16 & 0xFFFF) << 16)
    return (hi16 >> 16) + (mid >> 32), mid & _MASK


def philox(c0, c1, c2, c3, seed: int):
    k0, k1 = seed & _MASK, (seed >> 32) & _MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _counters(n_chains: int, n_steps: int, device):
    chain = torch.arange(n_chains, dtype=torch.int64, device=device)[None, :]
    step = torch.arange(n_steps, dtype=torch.int64, device=device)[:, None]
    zero = torch.zeros((n_steps, n_chains), dtype=torch.int64, device=device)
    return (chain & _MASK) + zero, step + zero, zero, (chain >> 32) + zero


def normals(seed: int, n_chains: int, n_steps: int, d: int, device) -> Tensor:
    """``(n_steps, n_chains, d)`` standard normals."""
    c0, c1, zero, c3 = _counters(n_chains, n_steps, device)
    zs = []
    for j in range((d + 3) // 4):
        o = philox(c0, c1, zero + j, c3, seed)
        for a, b in ((o[0], o[1]), (o[2], o[3])):
            u1 = (a >> 8).to(torch.float32) * 2.0**-24 + 2.0**-25
            u2 = (b >> 8).to(torch.float32) * 2.0**-24
            r = torch.sqrt(-2.0 * torch.log(u1))
            zs += [r * torch.cos(_TWO_PI_F32 * u2), r * torch.sin(_TWO_PI_F32 * u2)]
    return torch.stack(zs[:d], dim=-1)


def uniforms(seed: int, n_chains: int, n_steps: int, device) -> Tensor:
    """``(n_steps, n_chains)`` uniforms in [0, 1)."""
    c0, c1, zero, c3 = _counters(n_chains, n_steps, device)
    return (philox(c0, c1, zero + UNIFORM_BLOCK, c3, seed)[0] >> 8).to(torch.float32) * 2.0**-24


def ring_means(cfg: dict, device) -> Tensor:
    k = cfg["n_components"]
    ang = torch.arange(k, dtype=torch.float64, device=device) * (2 * math.pi / k)
    return (cfg["radius"] * torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)).float()


def grad_logp(x: Tensor, means: Tensor, sigma: float) -> Tuple[Tensor, Tensor]:
    """``(∇E(x), log p(x) + const)`` of the equal-weight mixture."""
    diff = x[:, None, :] - means[None]
    logits = -0.5 * torch.sum(diff * diff, dim=-1) / sigma**2
    resp = torch.softmax(logits, dim=-1)
    return (x - resp @ means) / sigma**2, torch.logsumexp(logits, dim=-1)


@torch.no_grad()
def langevin(x0: Tensor, means: Tensor, sigma: float, step: float, n_steps: int, seed: int,
             dtype: torch.dtype = torch.float32) -> Tensor:
    """``x ← x − η ∇E(x) + √(2η) ε`` for ``n_steps`` steps; ``dtype`` is a
    control's lower precision (the state and every operation in it)."""
    eps = normals(seed, x0.shape[0], n_steps, x0.shape[1], x0.device).to(dtype)
    x, mu = x0.to(dtype), means.to(dtype)
    coef = math.sqrt(2.0 * step)
    for t in range(n_steps):
        x = x - step * grad_logp(x, mu, sigma)[0] + coef * eps[t]
    return x.float()


@torch.no_grad()
def hmc(x0: Tensor, means: Tensor, sigma: float, step: float, n_leapfrog: int, n_draws: int,
        seed: int, dtype: torch.dtype = torch.float32) -> Tensor:
    """HMC with unit mass: per draw a fresh momentum, ``n_leapfrog``
    leapfrog steps of size ``step`` and a Metropolis test; ``dtype`` as for
    :func:`langevin`."""
    n, d = x0.shape
    eps = normals(seed, n, n_draws, d, x0.device).to(dtype)
    us = uniforms(seed, n, n_draws, x0.device)
    x, mu = x0.to(dtype), means.to(dtype)
    for t in range(n_draws):
        p = eps[t]
        g, lp0 = grad_logp(x, mu, sigma)
        h0 = -lp0 + 0.5 * torch.sum(p * p, dim=-1)
        q = x
        for _ in range(n_leapfrog):
            p = p - 0.5 * step * g
            q = q + step * p
            g, lp1 = grad_logp(q, mu, sigma)
            p = p - 0.5 * step * g
        h1 = -lp1 + 0.5 * torch.sum(p * p, dim=-1)
        alpha = torch.clamp(torch.exp(torch.clamp((h0 - h1).float(), -50.0, 50.0)), max=1.0)
        x = torch.where((us[t] < alpha)[:, None], q, x)
    return x.float()
