"""Instructions by class and bytes of the whole-chain kernels' calls, and the
least time they allow on a card.

Frozen copy of ``torchebm_tpu_torch/ops/_counts.py`` at commit 1f6b563 (its
``mixture_langevin*`` and ``mixture_hmc*`` branches, kernel rows 4 and 8),
counted by hand from the CUDA sources: per chain-step (per chain-draw for
HMC) one gradient and log-density evaluation of the mixture per evaluation
point, ``ceil(d/4)`` Philox4x32-10 blocks of normals, for HMC one block for
the Metropolis uniform, and the updates. Classes: ``fp32`` adds, multiplies,
FMAs, min/max and compares; ``int32`` Philox's multiplies, xors and key adds;
``sfu`` exponentials, logarithms, square roots, reciprocals, sines, cosines
and int-to-float conversions. Overhead a design adds (lanes repeating work,
shuffles) is not counted. Bytes: the start, the means, the log-weights and
the output (and HMC's acceptance) read or written once.
"""

from __future__ import annotations

from typing import Dict

_NORMALS4 = {"int32": 84, "fp32": 60, "sfu": 12}
_UNIFORM = {"int32": 84, "fp32": 2, "sfu": 1}


def _add(*parts, times=1) -> Dict[str, float]:
    total = {"fp32": 0.0, "int32": 0.0, "sfu": 0.0}
    for p in parts:
        for k, v in p.items():
            total[k] += v * times
    return total


def _eval(d: int, k: int) -> dict:
    """One gradient and log-density evaluation of a ``k``-component
    isotropic mixture in ``d`` dimensions."""
    return {"fp32": k * (3 * d + 8) + 2 * d + 6, "sfu": k + 2}


def _normals(d: int) -> dict:
    return _add(_NORMALS4, times=-(-d // 4))


def langevin(n: int, d: int, k: int, n_steps: int) -> dict:
    """``{"ops": {class: instructions}, "bytes": n}`` of one mixture Langevin
    chain call (row 4): ``n`` chains, ``n_steps`` steps."""
    per = _add(_eval(d, k), _normals(d), {"fp32": 4 * d})
    return {"ops": _add(per, times=n * n_steps), "bytes": 4 * (2 * n * d + k * d + k)}


def hmc(n: int, d: int, k: int, n_draws: int, n_leapfrog: int) -> dict:
    """The same for one mixture HMC chain call (row 8): per draw
    ``n_leapfrog`` evaluations with their kicks and drifts, the normals, the
    uniform and the Metropolis test; one more evaluation per chain starts the
    run."""
    ev = _eval(d, k)
    per = _add(_add(ev, {"fp32": 4 * d}, times=n_leapfrog), _normals(d), _UNIFORM,
               {"fp32": 6 * d + 12, "sfu": 2})
    return {"ops": _add(_add(per, times=n * n_draws), _add(ev, times=n)),
            "bytes": 4 * (2 * n * d + n + k * d + k)}


def bound_s(work: dict, peaks: dict) -> float:
    """The least time of ``work`` on the card of ``peaks``: the larger of its
    bytes over the memory rate and, per class, its instructions over the
    class's rate per SM and clock times the SMs and the largest SM clock."""
    clock = peaks["sms"] * peaks["max_sm_clock_mhz"] * 1e6
    op_s = max(v / (peaks["rate_per_sm_clock"][c] * clock) for c, v in work["ops"].items())
    return max(op_s, work["bytes"] / peaks["hbm_bytes_per_s"])
