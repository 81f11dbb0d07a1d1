r"""Minibatch optimal-transport couplings (counterpart of :mod:`torchebm_tpu.couplings.ot`).

- The log-domain Sinkhorn fixed point runs as one CUDA kernel launch
  (:func:`torchebm_tpu_torch.ops.sinkhorn_log_fused`) for a float32 cost
  matrix on a CUDA device that fits it, and as the loop
  (:func:`torchebm_tpu_torch.ops.fused_sinkhorn.sinkhorn_log_plain`)
  otherwise; see :func:`sinkhorn_log`.
- The row-conditional draw is a Gumbel-max draw from the log plan with the
  caller's ``torch.Generator`` (the JAX package's
  ``jax.random.categorical``; the streams differ, the distribution does not).
- The Bertsekas auction and the greedy assignment are the JAX package's
  vectorised rounds. Their loop conditions are read on the host: one device
  sync per bidding round, and per greedy round, where the JAX package runs a
  ``while_loop`` on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from ..ops import fused_sinkhorn as _fs
from ..parallel.mesh import is_dtensor
from ..utils.profiling import count
from .base import BaseCostCoupling, BaseCoupling, BaseModelCoupling, CouplingResult

Tensor = torch.Tensor

__all__ = [
    "ExactOTCoupling",
    "SinkhornCoupling",
    "UnbalancedSinkhornCoupling",
    "GreedyCoupling",
    "IndependentCoupling",
    "ReflowCoupling",
    "sinkhorn_log",
    "unbalanced_sinkhorn_log",
    "auction_assignment",
    "greedy_assignment",
]


# ---------------------------------------------------------------- solvers


def _use_fused_sinkhorn(C: Tensor, fused: str) -> bool:
    """Dispatch gate of the whole-loop kernel, decided before any launch.

    ``"off"``: never. ``"auto"``: a float32 cost matrix on a CUDA device
    that :func:`~torchebm_tpu_torch.ops.fits_fused_sinkhorn`. ``"force"``
    drops the device and dtype gates: a CPU matrix then runs the kernel's
    plain version, another float type is computed in float32. A matrix that
    does not fit takes the loop either way.
    """
    if fused not in ("auto", "off", "force"):
        raise ValueError(f"fused must be 'auto', 'off' or 'force', got {fused!r}")
    if fused == "off":
        return False
    if fused != "force" and (C.device.type != "cuda" or C.dtype != torch.float32):
        return False
    return C.ndim == 2 and _fs.fits_fused_sinkhorn(*C.shape)


def _sinkhorn(C: Tensor, reg, n_iters, tol, damping, fused: str) -> Tensor:
    if _use_fused_sinkhorn(C, fused):
        out = _fs.sinkhorn_log_fused(C.to(torch.float32).contiguous(), reg, n_iters, tol=tol,
                                     damping=damping)
        return out.to(C.dtype)
    return _fs.sinkhorn_log_plain(C, reg, n_iters, tol=tol, damping=damping)


def sinkhorn_log(C: Tensor, reg: float, n_iters: int, tol: float = 0.0,
                 fused: str = "auto") -> Tensor:
    """Log-domain Sinkhorn; returns the **log** transport plan ``(n, m)``.

    ``n_iters`` is the iteration cap; with ``tol > 0`` the fixed point exits
    once ``max|Δf| <= tol``. ``fused="auto"`` takes the one-launch kernel for
    a CUDA float32 matrix that fits it, ``"off"`` the loop of ``2·n_iters``
    ``logsumexp`` calls (with ``tol > 0`` one host sync every
    ``ops.fused_sinkhorn.CHECK_EVERY`` iterations),
    ``"force"`` the kernel's wrapper on any device. A CUDA matrix sent to the
    kernel launches it or raises.
    """
    return _sinkhorn(C, reg, n_iters, tol, 1.0, fused)


def unbalanced_sinkhorn_log(C: Tensor, reg: float, reg_marginal: float, n_iters: int,
                            tol: float = 0.0, fused: str = "auto") -> Tensor:
    r"""KL-relaxed log-domain Sinkhorn with damping
    :math:`\phi=\rho/(\rho+\varepsilon)` (Chizat et al. 2018); returns the log
    plan. Same ``tol`` and ``fused`` semantics as :func:`sinkhorn_log`: the
    damped update runs in the same kernel."""
    return _sinkhorn(C, reg, n_iters, tol, reg_marginal / (reg_marginal + reg), fused)


def _scatter_drop(base: Tensor, index: Tensor, src: Tensor, reduce: Optional[str] = None) -> Tensor:
    """``base`` with ``src`` written (or reduced by ``"amax"``/``"amin"``) at
    ``index``; an index equal to ``len(base)`` is dropped."""
    ext = torch.cat([base, base.new_zeros(1)])
    if reduce is None:
        ext = ext.scatter(0, index, src)
    else:
        ext = ext.scatter_reduce(0, index, src, reduce, include_self=True)
    return ext[:-1]


def _rank_pair_leftovers(assign: Tensor, col_free: Tensor) -> Tensor:
    """Safety valve: pair the rows still unassigned (``assign < 0``) with the
    free columns by rank."""
    n = assign.shape[0]
    iota = torch.arange(n, device=assign.device)
    row_free = assign < 0
    row_rank = torch.cumsum(row_free.to(torch.int64), 0) - 1
    col_order = torch.argsort(torch.where(col_free, iota, n + iota))
    fallback = col_order[torch.clamp(row_rank, 0, n - 1)]
    return torch.where(row_free, fallback, assign)


@torch.no_grad()
def auction_assignment(cost: Tensor, tol: float = 1e-4, scale_factor: float = 8.0,
                       max_rounds: int = 0) -> Tensor:
    r"""Vectorised Bertsekas forward auction with ε-scaling.

    Each bidding round: every unassigned row bids on its best column (the
    margin over its second best); contested columns resolve by highest bid,
    then lowest row index; evicted owners re-enter the pool. Prices persist
    across ε-scaling phases. Returns a permutation ``perm`` (int64) with row
    ``i`` assigned to column ``perm[i]``, within ``tol`` of the optimal
    assignment. The ε schedule is float32 arithmetic on the host; the host
    reads the cost spread once and "any row unassigned" once per round.
    """
    n = cost.shape[0]
    dev = cost.device
    if n == 1:
        return torch.zeros(1, dtype=torch.int64, device=dev)
    benefit = -cost.to(torch.float32)
    eps_final = torch.tensor(tol / n, dtype=torch.float32)
    count("host_reads")
    spread = torch.maximum((torch.max(benefit) - torch.min(benefit)).cpu(), eps_final)
    eps = torch.maximum(spread / 4.0, eps_final)
    if max_rounds <= 0:
        max_rounds = max(200, 100 * n)

    rows_iota = torch.arange(n, device=dev)
    full_n = torch.full((n,), n, dtype=torch.int64, device=dev)
    neg_inf = torch.full((n,), -torch.inf, dtype=torch.float32, device=dev)
    prices = torch.zeros(n, dtype=torch.float32, device=dev)
    rounds, done = 0, False
    while not done:
        a_row = torch.full((n,), -1, dtype=torch.int64, device=dev)
        a_col = torch.full((n,), -1, dtype=torch.int64, device=dev)
        e = float(eps)
        while rounds <= max_rounds:
            count("host_reads")
            if not bool(torch.any(a_row < 0)):
                break
            unassigned = a_row < 0
            top2_vals, top2_idx = torch.topk(benefit - prices[None, :], 2, dim=1)
            best_col = top2_idx[:, 0]
            margin = top2_vals[:, 0] - top2_vals[:, 1]
            bids = torch.where(unassigned, prices[best_col] + margin + e, neg_inf)
            # highest bid per contested column; the lowest row index wins ties
            bid_max = neg_inf.scatter_reduce(0, best_col, bids, "amax", include_self=True)
            is_winner = unassigned & (bids >= bid_max[best_col])
            winner_row = _scatter_drop(full_n, torch.where(is_winner, best_col, full_n),
                                       torch.where(is_winner, rows_iota, full_n), "amin")
            col_won = winner_row < n
            # evict the previous owners of the won columns, then assign the winners
            prev_owner = torch.where(col_won, a_col, -1)
            a_row = _scatter_drop(a_row, torch.where(prev_owner >= 0, prev_owner, full_n),
                                  torch.full_like(a_row, -1))
            a_row = _scatter_drop(a_row, torch.where(col_won, winner_row, full_n), rows_iota)
            a_col = torch.where(col_won, winner_row, a_col)
            prices = torch.where(col_won, bid_max, prices)
            rounds += 1
        done = rounds > max_rounds or bool(eps <= eps_final)
        eps = torch.maximum(eps / scale_factor, eps_final)
    return _rank_pair_leftovers(a_row, a_col < 0)


@torch.no_grad()
def greedy_assignment(cost: Tensor) -> Tensor:
    """Nearest-free-pair greedy assignment.

    Each round assigns every *locally dominant* free pair (cheapest in both
    its row and its column): the cheapest remaining pair is always locally
    dominant, and a locally dominant pair is untouched by any earlier greedy
    pick, so assigning them together reproduces the sequential
    nearest-free-pair result exactly for distinct costs (ties may resolve
    differently). Expected O(log n) rounds on random costs, n at worst; the
    host reads "any row unassigned" once per round.
    """
    n = cost.shape[0]
    dev = cost.device
    if n == 1:
        return torch.zeros(1, dtype=torch.int64, device=dev)
    iota = torch.arange(n, device=dev)
    full_n = torch.full((n,), n, dtype=torch.int64, device=dev)
    c = cost.to(torch.float32).clone()
    perm = torch.full((n,), -1, dtype=torch.int64, device=dev)
    rounds = 0
    while rounds < n:
        count("host_reads")
        if not bool(torch.any(perm < 0)):
            break
        rmin = torch.argmin(c, dim=1)  # cheapest free column per row
        cmin = torch.argmin(c, dim=0)  # cheapest free row per column
        dominant = (perm < 0) & (cmin[rmin] == iota) & torch.isfinite(c[iota, rmin])
        perm = torch.where(dominant, rmin, perm)
        col_taken = _scatter_drop(torch.zeros(n, dtype=torch.bool, device=dev),
                                  torch.where(dominant, rmin, full_n),
                                  torch.ones(n, dtype=torch.bool, device=dev))
        c = torch.where(dominant[:, None] | col_taken[None, :], torch.inf, c)
        rounds += 1
    # safety valve (non-finite costs): rank-pair the leftovers
    taken = _scatter_drop(torch.zeros(n, dtype=torch.bool, device=dev),
                          torch.where(perm < 0, full_n, perm),
                          torch.ones(n, dtype=torch.bool, device=dev))
    return _rank_pair_leftovers(perm, ~taken)


def _row_conditional_draw(log_plan: Tensor, generator: torch.Generator) -> Tensor:
    """One column index per row, drawn from the row's softmax by Gumbel-max
    (``argmax(log p - log E)`` with ``E`` standard exponential)."""
    e = torch.empty_like(log_plan).exponential_(generator=generator)
    return torch.argmax(log_plan - torch.log(e), dim=1)


# ---------------------------------------------------------------- couplings


def _check_sinkhorn_fields(c) -> None:
    if c.reg <= 0:
        raise ValueError(f"reg must be positive, got {c.reg}")
    if c.n_iters <= 0:
        raise ValueError(f"n_iters must be positive, got {c.n_iters}")
    if c.tol < 0:
        raise ValueError(f"tol must be non-negative, got {c.tol}")
    if c.fused not in ("auto", "off", "force"):
        raise ValueError(f"fused must be 'auto', 'off' or 'force', got {c.fused!r}")


@dataclass(frozen=True)
class IndependentCoupling(BaseCoupling):
    """Identity pairing."""

    def couple(self, x0, x1=None, *, generator=None, **kwargs) -> CouplingResult:
        x1 = self._require_x1(x1)
        self._check_batch(x0, x1)
        return CouplingResult(x0.detach(), x1.detach())


@dataclass(frozen=True)
class ExactOTCoupling(BaseCostCoupling):
    """Exact minibatch OT via the auction algorithm: a deterministic
    permutation of the target batch. Prefer :class:`SinkhornCoupling` inside
    training loops: the auction syncs with the host once per bidding round."""

    tol: float = 1e-4

    def _solve(self, cost, generator=None):
        return auction_assignment(cost, tol=self.tol)


@dataclass(frozen=True)
class SinkhornCoupling(BaseCostCoupling):
    """Entropic OT: the log-Sinkhorn plan, then a row-conditional draw.

    ``n_iters`` caps the fixed point; ``tol`` (sup-norm of the potential
    update, default 1e-3) exits early once converged; ``tol=0.0`` always runs
    exactly ``n_iters`` iterations. ``fused`` as in :func:`sinkhorn_log`.
    """

    reg: float = 0.05
    n_iters: int = 100
    tol: float = 1e-3
    fused: str = "auto"

    def __post_init__(self):
        _check_sinkhorn_fields(self)

    def _solve(self, cost, generator=None):
        if generator is None:
            raise ValueError(
                "SinkhornCoupling draws row-conditionally; a torch.Generator is required."
            )
        log_plan = sinkhorn_log(cost, reg=self.reg, n_iters=self.n_iters, tol=self.tol,
                                fused=self.fused)
        return _row_conditional_draw(log_plan, generator)


@dataclass(frozen=True)
class UnbalancedSinkhornCoupling(BaseCostCoupling):
    """KL-relaxed Sinkhorn with per-pair importance weights: each pair's
    weight is its row's transported mass over the mean mass."""

    reg: float = 0.05
    reg_marginal: float = 1.0
    n_iters: int = 100
    tol: float = 1e-3
    fused: str = "auto"

    def __post_init__(self):
        _check_sinkhorn_fields(self)
        if self.reg_marginal <= 0:
            raise ValueError(f"reg_marginal must be positive, got {self.reg_marginal}")

    @torch.no_grad()
    def couple(self, x0, x1=None, *, generator=None, **kwargs) -> CouplingResult:
        x1 = self._require_x1(x1)
        if is_dtensor(x0) or is_dtensor(x1):
            return self._couple_sharded(x0, x1, generator, kwargs)
        self._check_batch(x0, x1)
        if x0.shape[0] == 1:
            return CouplingResult(x0.detach(), x1.detach())
        if generator is None:
            raise ValueError("UnbalancedSinkhornCoupling requires a torch.Generator.")
        cost = self.compute_cost(x0, x1, **kwargs)
        log_plan = unbalanced_sinkhorn_log(cost, reg=self.reg, reg_marginal=self.reg_marginal,
                                           n_iters=self.n_iters, tol=self.tol, fused=self.fused)
        mass = torch.exp(torch.logsumexp(log_plan, dim=1))
        weights = mass / torch.clamp(torch.mean(mass), min=1e-12)
        idx = _row_conditional_draw(log_plan, generator)
        return CouplingResult(x0.detach(), x1.detach()[idx], weights=weights)

    def _solve(self, cost, generator=None):  # pragma: no cover
        raise NotImplementedError("UnbalancedSinkhornCoupling overrides couple() to attach weights")


@dataclass(frozen=True)
class GreedyCoupling(BaseCostCoupling):
    """Greedy nearest-free-pair coupling."""

    def _solve(self, cost, generator=None):
        return greedy_assignment(cost)


@dataclass(frozen=True)
class ReflowCoupling(BaseModelCoupling):
    r"""Model-induced coupling :math:`x_1 = \Phi(x_0)` for rectified-flow reflow.

    ``model`` may be a sampler-like object with ``.sample(generator, x=x0,
    ...)`` (a :class:`~torchebm_tpu_torch.samplers.FlowSampler`) or a bare
    callable ``phi(x0)`` / ``phi(generator, x0)``. Instance-only: not
    registered by name.
    """

    model: object = None
    sample_kwargs: dict = field(default_factory=dict)

    def _generate(self, x0, generator=None, **kwargs):
        m = self.model
        if hasattr(m, "sample"):
            return m.sample(generator, x=x0, **dict(self.sample_kwargs, **kwargs))
        try:
            return m(generator, x0, **kwargs)
        except TypeError:
            return m(x0, **kwargs)
