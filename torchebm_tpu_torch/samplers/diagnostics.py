r"""Cross-chain MCMC convergence diagnostics: split-R̂ and effective sample size.

Counterpart of :mod:`torchebm_tpu.samplers.diagnostics`: classic split-R̂ and
ESS (Gelman et al., *Bayesian Data Analysis* 3rd ed. §11.4-11.5) and the
rank-normalised variants of Vehtari, Gelman, Simpson, Carpenter & Bürkner
(2021): ``rank_normalized=True`` on both estimators, folded R̂, and
:func:`tail_effective_sample_size`. Everything is tensor code on the
trajectory's device.

Convention: trajectories are ``(n_chains, n_draws, dim)``, the layout of
``sample(..., return_trajectory=True)``.

A trajectory sharded over its chains (a DTensor split on dim 0, as a sharded
``sample`` returns it) gives the unsharded values on every process:
split-R̂, ESS and the means pool per-chain sums over the processes
(:class:`_Chains`); the rank-normalised variants and tail-ESS, which rank or
sort the pooled draws, gather the trajectory first.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import is_dtensor, row_shard, sum_over_rows

Tensor = torch.Tensor

__all__ = [
    "potential_scale_reduction",
    "effective_sample_size",
    "tail_effective_sample_size",
    "summarize_chains",
]


def _quantile(flat: Tensor, q: float) -> Tensor:
    """Per-column quantile of ``(S, D)`` draws by linear interpolation between
    order statistics, with the position and weights in float32 as
    ``jnp.quantile`` takes them (so ``q = 0.5`` averages the two middle values
    of an even count, where ``torch.median`` returns the lower one). Sorts
    instead of calling ``torch.quantile``, which refuses a column of more
    than 2^24 draws."""
    s = flat.shape[0]
    srt = torch.sort(flat, dim=0).values
    pos = torch.tensor(q, dtype=torch.float32) * float(s - 1)
    lo = torch.floor(pos)
    high_weight = pos - lo
    low_weight = 1.0 - high_weight
    lo_i = min(int(lo), s - 1)
    hi_i = min(int(torch.ceil(pos)), s - 1)
    return srt[lo_i] * float(low_weight) + srt[hi_i] * float(high_weight)


def _split_chains(traj: Tensor) -> Tensor:
    """Split each chain in half: (C, N, D) -> (2C, N//2, D) (drops an odd draw)."""
    half = traj.shape[1] // 2
    return torch.cat([traj[:, :half], traj[:, half:2 * half]], dim=0)


def _rank_normalize(traj: Tensor) -> Tensor:
    r"""Rank-normalise pooled draws to standard-normal z-scores,
    :math:`z = \Phi^{-1}\big((r - 3/8)/(S + 1/4)\big)` over the pooled
    ``S = M·N`` draws (Vehtari et al. 2021, eq. 14; ordinal ranks, stable for
    ties). traj: (M, N, D) -> (M, N, D)."""
    m, n, d = traj.shape
    flat = traj.reshape(m * n, d)
    order = torch.argsort(flat, dim=0, stable=True)
    ranks = torch.argsort(order, dim=0, stable=True) + 1  # 1..S
    u = (ranks.to(torch.float32) - 0.375) / (m * n + 0.25)
    return torch.special.ndtri(u).reshape(m, n, d)


def _fold(traj: Tensor) -> Tensor:
    """Fold around the pooled median (Vehtari et al. §3.2): |x - median|."""
    return torch.abs(traj - _quantile(traj.reshape(-1, traj.shape[-1]), 0.5))


class _Chains:
    """Means and variances over the chain axis (dim 0) of per-chain values:
    over this process's chains, or with ``like`` (the sharded trajectory) over
    every process's, ``m`` chains in all."""

    def __init__(self, m: int, like=None):
        self.m, self.like = m, like

    def mean(self, t: Tensor) -> Tensor:
        if self.like is None:
            return torch.mean(t, dim=0)
        return sum_over_rows(torch.sum(t, dim=0), self.like) / self.m

    def var(self, t: Tensor) -> Tensor:
        """The unbiased variance (``correction=1``), two passes when pooled."""
        if self.like is None:
            return torch.var(t, dim=0, correction=1)
        centred = torch.sum(torch.square(t - self.mean(t)), dim=0)
        return sum_over_rows(centred, self.like) / (self.m - 1)


def _prepare(traj: Tensor, split: bool, gather: bool = False):
    """``(local (M, N, D) draws, their _Chains)``: split in halves where
    ``split``; a sharded trajectory pooled, or gathered whole where
    ``gather``."""
    like = None
    if is_dtensor(traj):
        if gather:
            traj = traj.full_tensor()
        else:
            like, traj = traj, row_shard(traj)[0]
    if traj.ndim == 2:
        traj = traj[..., None]
    m = traj.shape[0] if like is None else like.shape[0]
    if split:
        traj, m = _split_chains(traj), 2 * m
    return traj, _Chains(m, like)


def potential_scale_reduction(traj: Tensor, split: bool = True,
                              rank_normalized: bool = False) -> Tensor:
    r"""Split-:math:`\hat R` per dimension,
    :math:`\hat R = \sqrt{(\frac{N-1}{N} W + \frac1N B) / W}` with
    between-chain variance ``B`` and within-chain variance ``W``. Values near
    1 indicate convergence; > 1.01 is suspect.

    ``rank_normalized=True`` gives the Vehtari et al. 2021 statistic,
    ``max(R̂(z), R̂(z_folded))`` over rank-normalised draws and folded draws.
    Returns a ``(dim,)`` tensor.
    """
    traj, chains = _prepare(traj, split, gather=rank_normalized)
    if rank_normalized:
        bulk = _rhat_raw(_rank_normalize(traj))
        folded = _rhat_raw(_rank_normalize(_fold(traj)))
        return torch.maximum(bulk, folded)
    return _rhat_raw(traj, chains)


def _rhat_raw(traj: Tensor, chains: Optional[_Chains] = None) -> Tensor:
    chains = _Chains(traj.shape[0]) if chains is None else chains
    n = traj.shape[1]
    chain_means = torch.mean(traj, dim=1)  # (M, D)
    chain_vars = torch.var(traj, dim=1, correction=1)  # (M, D)
    w = chains.mean(chain_vars)
    b = n * chains.var(chain_means)
    var_plus = (n - 1) / n * w + b / n
    return torch.sqrt(var_plus / torch.clamp(w, min=1e-30))


def _autocov_fft(x: Tensor) -> Tensor:
    """Autocovariance of each chain at lags 0..N-1 along dim 1, through an FFT
    zero-padded to 2N (the circular correlation then equals the linear one)."""
    n = x.shape[1]
    xc = x - torch.mean(x, dim=1, keepdim=True)
    f = torch.fft.rfft(xc, n=2 * n, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=2 * n, dim=1)[:, :n]
    return acov / n


def _ess_raw(traj: Tensor, chains: Optional[_Chains] = None) -> Tensor:
    """Geyer initial-monotone ESS per dimension of ``(M, N, D)`` draws."""
    chains = _Chains(traj.shape[0]) if chains is None else chains
    m, n = chains.m, traj.shape[1]
    acov = _autocov_fft(traj)  # (M, N, D)
    chain_var = acov[:, 0] * n / max(n - 1, 1)  # (M, D)
    w = chains.mean(chain_var)  # (D,)
    mean_acov = chains.mean(acov)  # (N, D)
    if m > 1:
        b_over_n = chains.var(torch.mean(traj, dim=1))
    else:
        b_over_n = torch.zeros_like(w)
    var_plus = (n - 1) / n * w + b_over_n
    rho = 1.0 - (w - mean_acov) / torch.clamp(var_plus, min=1e-30)  # (N, D)

    # Geyer pairs P_k = rho_2k + rho_2k+1, truncated at the first negative,
    # then forced monotone non-increasing
    n_pairs = n // 2
    pairs = rho[:2 * n_pairs].reshape(n_pairs, 2, -1).sum(dim=1)  # (n_pairs, D)
    pairs = pairs * torch.cumprod((pairs > 0).to(pairs.dtype), dim=0)
    pairs = torch.clamp(torch.cummin(pairs, dim=0).values, min=0.0)
    # tau = -1 + 2 sum P_k (rho_0 = 1 is in the first pair)
    tau = -1.0 + 2.0 * torch.sum(pairs, dim=0)
    return m * n / torch.clamp(tau, min=1.0 / (m * n))


def effective_sample_size(traj: Tensor, split: bool = True,
                          rank_normalized: bool = False) -> Tensor:
    r"""Effective sample size per dimension (Geyer initial-monotone
    estimator), :math:`\text{ESS} = MN / (1 + 2\sum_t \hat\rho_t)`.

    ``rank_normalized=True`` gives bulk-ESS (Vehtari et al. 2021), the same
    estimator on rank-normalised draws. Returns a ``(dim,)`` tensor.
    """
    traj, chains = _prepare(traj, split, gather=rank_normalized)
    if rank_normalized:
        return _ess_raw(_rank_normalize(traj))
    return _ess_raw(traj, chains)


def tail_effective_sample_size(traj: Tensor, split: bool = True) -> Tensor:
    r"""Tail-ESS per dimension (Vehtari et al. 2021 §4.3): the smaller ESS
    of the 5% and 95% quantile indicators :math:`I(x \le \hat q_\alpha)`.
    Returns a ``(dim,)`` tensor."""
    traj, _ = _prepare(traj, split, gather=True)
    flat = traj.reshape(-1, traj.shape[-1])
    ess05 = _ess_raw((traj <= _quantile(flat, 0.05)).to(torch.float32))
    ess95 = _ess_raw((traj <= _quantile(flat, 0.95)).to(torch.float32))
    return torch.minimum(ess05, ess95)


def summarize_chains(traj: Tensor, rank_normalized: bool = False) -> dict:
    """Mean, std, split-R̂ and ESS per dimension, with ``n_chains`` and
    ``n_draws``; ``rank_normalized=True`` adds ``r_hat_rank`` (max of bulk
    and folded rank-R̂), ``ess_bulk`` and ``ess_tail``."""
    like = traj if is_dtensor(traj) else None
    local = traj if like is None else row_shard(traj)[0]
    if local.ndim == 2:
        local = local[..., None]
    flat = local.reshape(-1, local.shape[-1])
    if like is None:
        mean, std = torch.mean(flat, dim=0), torch.std(flat, dim=0, correction=0)
    else:
        total = like.shape[0] * local.shape[1]
        mean = sum_over_rows(torch.sum(flat, dim=0), like) / total
        std = torch.sqrt(sum_over_rows(torch.sum(torch.square(flat - mean), dim=0), like) / total)
    out = {
        "mean": mean,
        "std": std,
        "r_hat": potential_scale_reduction(traj),
        "ess": effective_sample_size(traj),
        "n_chains": traj.shape[0],
        "n_draws": local.shape[1],
    }
    if rank_normalized:
        out["r_hat_rank"] = potential_scale_reduction(traj, rank_normalized=True)
        out["ess_bulk"] = effective_sample_size(traj, rank_normalized=True)
        out["ess_tail"] = tail_effective_sample_size(traj)
    return out
