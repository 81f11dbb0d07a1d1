r"""Whole-loop log-domain Sinkhorn kernel: wrapper, plain version, fit rule, launch count.

PyTorch counterpart of :mod:`torchebm_tpu.ops.fused_sinkhorn`. On an
``(n, m)`` cost matrix ``C`` with uniform marginals the fixed point

.. math::
    M = -C/\varepsilon,\qquad
    f \leftarrow \phi\,(\log\mu - \mathrm{LSE}_j(M + g)),\qquad
    g \leftarrow \phi\,(\log\nu - \mathrm{LSE}_i(M + f))

runs from :math:`f = g = 0` for at most ``n_iters`` iterations and, with
``tol > 0``, stops before an iteration once the sup-norm of the last update of
``f`` is no larger than ``tol`` (the first iteration always runs). It returns
the log transport plan :math:`M + f + g`. :math:`\phi = 1` is balanced
Sinkhorn; :math:`\phi = \rho/(\rho+\varepsilon) < 1` the KL-relaxed
(unbalanced) update of Chizat et al. (2018).

:func:`sinkhorn_log_fused` runs the whole loop in one launch of a
hand-written CUDA kernel (``csrc/fused_sinkhorn.cu``) when ``C`` lies on a
CUDA device, and :func:`sinkhorn_log_plain`, the same function as a loop of
PyTorch operations, when ``C`` lies on the CPU; any other device raises. The
plain version is also the ``fused="off"`` path of
:func:`torchebm_tpu_torch.couplings.sinkhorn_log`. With ``tol > 0`` the plain
version reads the error on the host before every iteration (one device sync
each); the kernel takes the decision on the device.

``reg``, ``tol``, ``damping`` and ``n_iters`` are run-time arguments of the
kernel. There is no padding: ragged shapes are handled by bounds.
:func:`fits_fused_sinkhorn` is this card's fit rule (the matrix and the plan
stay in the 50 MB L2 cache), :func:`launch_plan` the cluster size and what
lives in shared memory. The wrapper's ``launches`` attribute counts its kernel
launches.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple, Union

import torch

from . import _build

Tensor = torch.Tensor

__all__ = ["fits_fused_sinkhorn", "launch_plan", "sinkhorn_log_fused", "sinkhorn_log_plain"]

#: the largest matrix the kernel takes, the TPU kernel's cap without its
#: padding: C and the plan (4 MB each) stay in the 50 MB L2 cache
MAX_ELEMS = 1024 * 1024
#: dynamic shared memory a block may plan for (of the 232,448 bytes a block
#: can opt in to; the kernel's static arrays take about 4 KB)
SMEM_BUDGET = 216 * 1024
#: f or g lives in shared memory up to this many entries (32 KB each)
VEC_SMEM = 8192
#: a block is worth starting for this many matrix elements
ELEMS_PER_BLOCK = 4096
MAX_BLOCKS = 8

#: ``tebm_sinkhorn_log_fused``'s argument types before the stream: cost, out,
#: scratch, iters, n, m, blocks, resident, g_smem, f_smem, smem_bytes,
#: -1/reg, n_iters, tol, damping, log_mu, log_nu
_SIGNATURE = ((_build.PTR,) * 4 + (_build.INT,) * 7 + (_build.FLOAT,) + (_build.INT,)
              + (_build.FLOAT,) * 4)


class LaunchPlan(NamedTuple):
    """How one call runs: the cluster's ``blocks`` (1, 2, 4 or 8), each on a
    band of ``ceil(n / blocks)`` rows; whether a band of ``M`` is ``resident``
    in shared memory (else it stays in the output buffer, in L2); whether
    ``g`` and a band's ``f`` live in shared memory; the dynamic shared memory
    per block; and the floats of device scratch."""

    blocks: int
    resident: bool
    g_smem: bool
    f_smem: bool
    smem_bytes: int
    scratch_floats: int


def fits_fused_sinkhorn(n: int, m: int) -> bool:
    """Whether the kernel takes an ``(n, m)`` cost matrix: non-empty and at
    most 1,048,576 elements (the TPU kernel's cap counts its padded shape)."""
    return n >= 1 and m >= 1 and n * m <= MAX_ELEMS


def launch_plan(n: int, m: int) -> LaunchPlan:
    """The :class:`LaunchPlan` of an ``(n, m)`` matrix that fits."""
    if not fits_fused_sinkhorn(n, m):
        raise ValueError(
            f"cost matrix ({n}, {m}) exceeds the fused Sinkhorn kernel's {MAX_ELEMS} elements; "
            "use the loop (fused='off')"
        )
    blocks = 1
    while blocks < MAX_BLOCKS and 2 * blocks <= n and 2 * blocks * ELEMS_PER_BLOCK <= n * m:
        blocks *= 2
    band = -(-n // blocks)
    g_smem, f_smem = m <= VEC_SMEM, band <= VEC_SMEM
    vec_bytes = 4 * (m * g_smem + band * f_smem)
    resident = 4 * band * m + vec_bytes <= SMEM_BUDGET
    smem_bytes = vec_bytes + 4 * band * m * resident
    scratch = 4 * blocks * m + 2 * MAX_BLOCKS + blocks * m + n
    return LaunchPlan(blocks, resident, g_smem, f_smem, smem_bytes, scratch)


def _check(C: Tensor, reg, n_iters, tol, damping,
           kernel: bool = True) -> Tuple[float, int, float, float]:
    """Validate a call; with ``kernel`` also what the kernel asks of the
    matrix (float32, contiguous)."""
    if not isinstance(C, Tensor) or C.ndim != 2:
        raise ValueError("the cost matrix must be a 2D tensor")
    n, m = C.shape
    if n < 1 or m < 1:
        raise ValueError(f"cost matrix must be non-empty, got {tuple(C.shape)}")
    if kernel and C.dtype != torch.float32:
        raise TypeError(f"the cost matrix must be float32, got {C.dtype}")
    if kernel and not C.is_contiguous():
        raise ValueError("the cost matrix must be contiguous")
    reg, tol, damping = float(reg), float(tol), float(damping)
    if not reg > 0.0:
        raise ValueError(f"reg must be positive, got {reg}")
    if int(n_iters) < 0:
        raise ValueError(f"n_iters must be non-negative, got {n_iters}")
    if tol < 0.0:
        raise ValueError(f"tol must be non-negative, got {tol}")
    if not 0.0 < damping <= 1.0:
        raise ValueError(f"damping must be in (0, 1], got {damping}")
    return reg, int(n_iters), tol, damping


def _run_plain(C: Tensor, reg: float, n_iters: int, tol: float, damping: float):
    """The loop; ``(log plan, iterations run as a 0-d int32 tensor)``."""
    n, m = C.shape
    M = C * (-1.0 / reg)
    log_mu, log_nu = -math.log(n), -math.log(m)
    f = torch.zeros(n, dtype=C.dtype, device=C.device)
    g = torch.zeros(m, dtype=C.dtype, device=C.device)
    if C.dtype == torch.float32:  # the kernel compares in float32
        tol = float(torch.tensor(tol, dtype=torch.float32))
    it, err = 0, math.inf
    while it < n_iters and (tol <= 0.0 or err > tol):
        f_new = damping * (log_mu - torch.logsumexp(M + g[None, :], dim=1))
        g = damping * (log_nu - torch.logsumexp(M + f_new[:, None], dim=0))
        if tol > 0.0:
            err = float(torch.max(torch.abs(f_new - f)))
        f = f_new
        it += 1
    iters = torch.tensor(it, dtype=torch.int32, device=C.device)
    return M + f[:, None] + g[None, :], iters


def sinkhorn_log_plain(C: Tensor, reg: float, n_iters: int, tol: float = 0.0,
                       damping: float = 1.0,
                       return_iters: bool = False) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Plain PyTorch version of :func:`sinkhorn_log_fused`, on ``C``'s device;
    it takes a matrix of any float type and size."""
    out, iters = _run_plain(C, *_check(C, reg, n_iters, tol, damping, kernel=False))
    return (out, iters) if return_iters else out


@_build.counted
def sinkhorn_log_fused(C: Tensor, reg: float, n_iters: int, tol: float = 0.0,
                       damping: float = 1.0,
                       return_iters: bool = False) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """The whole Sinkhorn fixed point in one kernel; returns the log plan
    ``(n, m)`` (with ``return_iters`` also the iterations it ran, a 0-d int32
    tensor on ``C``'s device).

    ``C``: ``(n, m)`` float32, contiguous, within :func:`fits_fused_sinkhorn`.
    ``tol == 0`` runs exactly ``n_iters`` iterations; ``damping`` is
    :math:`\\phi` (1 for balanced Sinkhorn).
    """
    reg, n_iters, tol, damping = _check(C, reg, n_iters, tol, damping)
    n, m = C.shape
    plan = launch_plan(n, m)
    if C.device.type == "cpu":
        out, iters = _run_plain(C, reg, n_iters, tol, damping)
        return (out, iters) if return_iters else out
    if C.device.type != "cuda":
        raise ValueError(f"sinkhorn_log_fused takes a CPU or CUDA tensor, got {C.device}")
    out = torch.empty_like(C)
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32, device=C.device)
    iters = torch.empty((), dtype=torch.int32, device=C.device)
    p = _build.ptr
    _build.launch(
        "sinkhorn_log_fused", _SIGNATURE, C.device,
        p(C), p(out), p(scratch), p(iters), n, m, plan.blocks, int(plan.resident),
        int(plan.g_smem), int(plan.f_smem), plan.smem_bytes, -1.0 / reg, n_iters, tol, damping,
        -math.log(n), -math.log(m),
    )
    sinkhorn_log_fused.launches += 1
    return (out, iters) if return_iters else out
