r"""No-U-Turn Sampler (NUTS): iterative multinomial trees, all chains in lockstep.

Counterpart of :mod:`torchebm_tpu.samplers.nuts` (Hoffman & Gelman 2014, with
multinomial sampling along the trajectory, the generalised U-turn criterion
on the summed momentum and biased progressive sampling at each doubling).

The JAX package writes one chain's transition as two ``while_loop``\ s and
vmaps it, which XLA runs as masked lockstep. Here the batched transition is
written directly. Every chain still building its tree is at the same
doubling and the same leaf ``i``; a chain whose tree has turned or diverged
is masked out of every quantity the transition returns. In lockstep the
subtree's checkpoint stack is a function of ``i`` alone: leaf ``i`` pushes
its (momentum, summed momentum) pair for each subtree it begins (one per
trailing zero of ``i``, ``depth`` of them at ``i = 0``) and checks and pops one
per trailing one of ``i``. So the stack is a Python list of references to
those ``(n, d)`` tensors, with no scatter or gather, and the subtree's
leaves run with no host read. The host reads one flag per doubling after
the first, whether any chain is still building (at most
``max_tree_depth - 1`` reads per transition), to end the tree early.

A transition draws from the generator, in order: the momentum's normals
``(n, d)``, then per doubling ``j`` one ``(n, 2 + 2^j)`` block of uniforms: the
direction (right where the first is below 0.5), the merge uniform, and one
uniform per leaf. The private ``_transition`` takes them injected instead.

``model_kwargs`` go whole to the batched energy: a leaf whose leading
dimension is the chain count is already aligned with the chains, and a
batch-shared leaf is seen whole by every chain. ``shared_kwargs`` keeps the
JAX signature and must name keys of ``model_kwargs``.

A sharded batch (:mod:`.base`) draws each of these for the whole batch and
keeps its rows, reads the flag over every shard (one all-reduce per doubling
after the first), and pools the diagnostics and the warmup's acceptance.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..core.energies import Energy
from ..core.schedulers import BaseScheduler, sched_value
from .base import BaseSampler, _any_chain, _rand, _randn
from .hmc import _dual_averaging_warmup

Tensor = torch.Tensor

__all__ = ["NoUTurnSampler"]


def _trailing_ones(n):
    """Number of trailing 1-bits of ``n`` (an int, or an int tensor read as
    32-bit two's complement): the trailing zeros of ``m = n + 1``, which are
    the 1-bits of ``(m & -m) - 1``."""
    m = n + 1
    low = (m & -m) - 1
    if isinstance(low, int):
        return low.bit_count()
    bits = torch.arange(32, dtype=low.dtype, device=low.device)
    return ((low[..., None] >> bits) & 1).sum(-1).to(low.dtype)


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


@dataclass(eq=False)
class NoUTurnSampler(BaseSampler):
    r"""NUTS sampler with multinomial sampling and dual-averaging warmup.

    ``max_tree_depth`` bounds trajectories at :math:`2^{\text{depth}}-1`
    leapfrog steps. ``mass`` is a scalar or a per-dimension diagonal. The
    state is ``(n_chains, dim)``. Diagnostics add ``acceptance_rate`` (the
    mean over chains of the mean MH statistic over each trajectory's states,
    the dual-averaging signal), ``tree_depth`` (mean doublings per
    transition) and ``divergence_rate``.
    """

    model: Energy = None
    step_size: Union[float, BaseScheduler] = 0.1
    max_tree_depth: int = 10
    mass: Optional[Union[float, Tensor]] = None
    target_accept: float = 0.8
    divergence_threshold: float = 1000.0
    shared_kwargs: Tuple[str, ...] = ()

    def __post_init__(self):
        if not 1 <= self.max_tree_depth <= 12:
            raise ValueError("max_tree_depth must be in [1, 12]")
        self.shared_kwargs = tuple(self.shared_kwargs)

    # ------------------------------------------------------------ energetics

    def _u(self, x: Tensor, model_kwargs) -> Tensor:
        return torch.clamp(self.energy_of(x, model_kwargs), -1e10, 1e10)

    def _mass_like(self, x: Tensor) -> Optional[Tensor]:
        """The mass as a tensor that broadcasts against ``x``; a scalar stays
        a 0-d tensor where it is (on the host it enters device ops as a
        number), None for the unit mass."""
        if self.mass is None:
            return None
        m = torch.as_tensor(self.mass, dtype=x.dtype)
        return m if m.ndim == 0 else m.to(x.device)

    @staticmethod
    def _kinetic(r: Tensor, m: Optional[Tensor]) -> Tensor:
        return 0.5 * torch.sum(r * r if m is None else r * r / m, dim=-1)

    # ---------------------------------------------------------- one NUTS move

    def _subtree(self, x, r, g, e, depth: int, log_u, active, h0, m, model_kwargs):
        """The ``2^depth`` leaves of a new subtree from ``(x, r, g)`` at the
        per-chain signed step ``e`` (``(n, 1)``), with ``log_u`` the leaves'
        log uniforms; chains outside ``active``, and each chain after the
        leaf where it turns or diverges, are masked out of every output but
        the trajectory's end, which then goes unused."""
        n = x.shape[0]
        he = 0.5 * e
        cum = torch.zeros_like(x)
        x_prop = x
        logw = torch.full((n,), -math.inf, dtype=x.dtype, device=x.device)
        acc = torch.zeros((n,), dtype=x.dtype, device=x.device)
        leaves = torch.zeros((n,), dtype=x.dtype, device=x.device)
        turning = torch.zeros((n,), dtype=torch.bool, device=x.device)
        diverging = turning
        live = active
        stack = []  # (r / m, summed momentum) at each open subtree's first leaf
        for i in range(2 ** depth):
            r_half = r - he * g
            x = x + e * r_half if m is None else x + e * r_half / m
            g = self.gradient_of(x, model_kwargs)
            r = r_half - he * g
            neg_h = -(self._u(x, model_kwargs) + self._kinetic(r, m))
            gain = neg_h + h0  # -(h - h0), exactly
            # progressive multinomial sampling within the subtree
            logw_new = torch.logaddexp(logw, neg_h)
            take = log_u[:, i] < (neg_h - logw_new)
            x_prop = torch.where(take[:, None], x, x_prop)
            logw = logw_new
            # min(1, e^-(h - h0)), the leaf's Metropolis statistic
            acc = acc + torch.where(live, torch.exp(torch.clamp(gain, max=0.0)), 0.0)
            leaves = leaves + live
            r_m = r if m is None else r / m
            if i % 2 == 0:
                # an even leaf begins one subtree per trailing zero of i
                begins = depth if i == 0 else min(_trailing_ones(~i), depth)
                stack.extend([(r_m, cum)] * begins)
            cum = cum + r
            stop = gain < -self.divergence_threshold  # h - h0 > threshold
            diverging = diverging | (live & stop)
            # an odd leaf ends one subtree per trailing one of i: U-turn checks
            for _ in range(_trailing_ones(i) if i % 2 else 0):
                r_first, cum_first = stack.pop()
                p_sub = cum - cum_first
                turn = (_dot(p_sub, r_first) < 0.0) | (_dot(p_sub, r_m) < 0.0)
                turning = turning | (live & turn)
                stop = stop | turn
            live = live & ~stop
        return {"x": x, "r": r, "g": g, "cum": cum, "x_prop": x_prop, "logw": logw,
                "acc": acc, "leaves": leaves, "turning": turning, "diverging": diverging,
                "live": live}

    def _transition(self, x: Tensor, generator: Optional[torch.Generator], eps, model_kwargs,
                    draws: Optional[Dict[str, Tensor]] = None):
        """One NUTS transition of every chain of ``x`` (``(n, d)``).

        Returns per chain ``(x_new, accept_stat, depth, diverged)``. The
        randomness comes from ``generator`` (see the module docstring) or from
        ``draws``: ``momentum`` ``(n, d)`` standard normals, ``direction``
        ``(n, D)`` booleans (True: right), ``leaf`` ``(n, D, 2^(D-1))`` and
        ``merge`` ``(n, D)`` uniforms, with ``D = max_tree_depth``.
        """
        n, d = x.shape
        dev, dt = x.device, x.dtype
        m = self._mass_like(x)
        if draws is None:
            z = _randn(generator, (n, d), device=dev, dtype=dt)
        else:
            z = draws["momentum"]
        r0 = z if m is None else z * torch.sqrt(m)
        g0 = self.gradient_of(x, model_kwargs)
        h0 = self._u(x, model_kwargs) + self._kinetic(r0, m)

        x_l = x_r = x_prop = x
        r_l = r_r = p_sum = r0
        g_l = g_r = g0
        logw = -h0
        depth = torch.zeros((n,), dtype=dt, device=dev)
        acc_sum = torch.zeros((n,), dtype=dt, device=dev)
        n_leaves = torch.zeros((n,), dtype=dt, device=dev)
        diverging = torch.zeros((n,), dtype=torch.bool, device=dev)
        active = torch.ones((n,), dtype=torch.bool, device=dev)
        for j in range(self.max_tree_depth):
            # the transition's only host read: is any tree still growing? (on
            # a sharded batch, in any shard: every shard takes the same doublings)
            if j and not _any_chain(active, generator):
                break
            if draws is None:
                u = _rand(generator, (n, 2 + 2 ** j), device=dev, dtype=dt)
                go_right, merge_u, leaf_u = u[:, 0] < 0.5, u[:, 1], u[:, 2:]
            else:
                go_right = draws["direction"][:, j]
                merge_u, leaf_u = draws["merge"][:, j], draws["leaf"][:, j, : 2 ** j]
            right = go_right[:, None]
            e = torch.where(right, 1.0, -1.0).to(dt) * eps
            sub = self._subtree(
                torch.where(right, x_r, x_l), torch.where(right, r_r, r_l),
                torch.where(right, g_r, g_l), e, j, torch.log(leaf_u), active, h0, m,
                model_kwargs,
            )
            ok = sub["live"]
            # biased progressive sampling at the doubling level
            take = ok & (torch.log(merge_u) < torch.clamp(sub["logw"] - logw, max=0.0))
            x_prop = torch.where(take[:, None], sub["x_prop"], x_prop)
            logw = torch.logaddexp(logw, torch.where(ok, sub["logw"], -math.inf))
            x_l, r_l, g_l = (torch.where(right, v, sub[k]) for v, k in
                             ((x_l, "x"), (r_l, "r"), (g_l, "g")))
            x_r, r_r, g_r = (torch.where(right, sub[k], v) for v, k in
                             ((x_r, "x"), (r_r, "r"), (g_r, "g")))
            p_sum = p_sum + sub["cum"]
            v_l, v_r = (r_l, r_r) if m is None else (r_l / m, r_r / m)
            turn = (_dot(p_sum, v_l) < 0.0) | (_dot(p_sum, v_r) < 0.0)
            depth = depth + active
            acc_sum = acc_sum + sub["acc"]
            n_leaves = n_leaves + sub["leaves"]
            diverging = diverging | sub["diverging"]
            active = ok & ~turn
        accept_stat = acc_sum / torch.clamp(n_leaves, min=1.0)
        return x_prop, accept_stat, depth, diverging

    def _check_shared_kwargs(self, model_kwargs) -> None:
        unknown = set(self.shared_kwargs).difference(model_kwargs)
        if unknown:
            raise ValueError(
                f"shared_kwargs names {sorted(unknown)} not present in "
                f"model_kwargs {sorted(model_kwargs)}"
            )

    def _transition_batch(self, x: Tensor, generator, eps, model_kwargs, draws=None):
        """One transition; ``(x_new, mean accept statistic, mean depth,
        divergence rate)``, the means over chains."""
        self._check_shared_kwargs(model_kwargs)
        x_new, acc, depth, div = self._transition(x, generator, eps, model_kwargs, draws)
        return x_new, torch.mean(acc), torch.mean(depth), torch.mean(div.to(acc.dtype))

    # ---------------------------------------------------------------- hooks

    def init_carry(self, x0, generator, model_kwargs) -> Dict[str, Any]:
        zero = torch.zeros((), device=x0.device)
        return {"x": x0, "accept_rate": zero, "tree_depth": zero, "divergence_rate": zero}

    def step(self, carry, i, generator, model_kwargs):
        x_new, acc, depth, div = self._transition_batch(
            carry["x"], generator, sched_value(self.step_size, i), model_kwargs)
        return {"x": x_new, "accept_rate": acc, "tree_depth": depth, "divergence_rate": div}

    def extra_diagnostics(self, carry, model_kwargs):
        return {
            "acceptance_rate": carry["accept_rate"],
            "tree_depth": carry["tree_depth"],
            "divergence_rate": carry["divergence_rate"],
        }

    # ---------------------------------------------------------------- warmup

    @torch.no_grad()
    def warmup(
        self,
        generator: torch.Generator,
        x: Optional[Tensor] = None,
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        n_warmup: int = 500,
        n_samples: int = 1,
        *,
        adapt_mass: bool = False,
        model_kwargs: Optional[Dict[str, Any]] = None,
    ):
        """Dual-averaging step-size warmup, the contract of
        :meth:`HamiltonianMonteCarlo.warmup`: returns ``(warmed x, adapted
        step_size)``, the step size a Python float; with ``adapt_mass=True``
        also a diagonal mass, the inverse of the per-dimension variance pooled
        over all chains and the second half of warmup::

            x, eps, mass = nuts.warmup(g, dim=2, n_samples=64, adapt_mass=True)
            tuned = nuts.replace(step_size=eps, mass=mass)
        """
        self._check_shared_kwargs(model_kwargs or {})
        return _dual_averaging_warmup(
            self, lambda x_, g_, eps, mk: self._transition(x_, g_, eps, mk)[:2],
            generator, x, dim, n_warmup, n_samples, adapt_mass, model_kwargs)
