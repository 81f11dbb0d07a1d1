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
version reads its errors on the host once every :data:`CHECK_EVERY`
iterations (one device sync each) and keeps the potentials of the iteration
that met ``tol``; the kernel takes the decision on the device.

``reg``, ``tol``, ``damping`` and ``n_iters`` are run-time arguments of the
kernel. There is no padding: ragged shapes are handled by bounds.
:func:`fits_fused_sinkhorn` is this card's fit rule (the matrix and the plan
stay in the 50 MB L2 cache), :func:`launch_plan` the cluster size and what
lives in shared memory, :func:`max_active_clusters` whether the card can hold
such a cluster. The wrapper's ``launches`` attribute counts its kernel
launches.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..utils.profiling import count
from . import _build

Tensor = torch.Tensor

__all__ = ["fits_fused_sinkhorn", "launch_plan", "max_active_clusters", "sinkhorn_log_fused",
           "sinkhorn_log_plain"]

#: the largest matrix the kernel takes, the TPU kernel's cap without its
#: padding: C and the plan (4 MB each) stay in the 50 MB L2 cache
MAX_ELEMS = 1024 * 1024
#: dynamic shared memory a block may plan for (of the 232,448 bytes a block
#: can opt in to; the kernel's static arrays take under 100 bytes)
SMEM_BUDGET = 216 * 1024
#: a band's f lives in shared memory up to this many entries (32 KB)
VEC_SMEM = 8192
#: the cluster sizes the kernel takes (16 is Hopper's non-portable size)
BLOCK_SIZES = (1, 2, 4, 8, 16)
MAX_BLOCKS = BLOCK_SIZES[-1]
#: threads per block (``kThreads`` of the kernel)
THREADS = 512
#: the loop (:func:`sinkhorn_log_plain`) with ``tol > 0`` reads its errors
#: on the host once every this many iterations
CHECK_EVERY = 4

#: ``tebm_sinkhorn_log_fused``'s argument types before the stream: cost, out,
#: scratch, iters, n, m, blocks, slices, stride, resident, f_smem, pairs_smem,
#: smem_bytes, -1/reg, n_iters, tol, damping, log_mu, log_nu
_SIGNATURE = ((_build.PTR,) * 4 + (_build.INT,) * 9 + (_build.FLOAT,) + (_build.INT,)
              + (_build.FLOAT,) * 4)


class LaunchPlan(NamedTuple):
    """How one call runs: one cluster of ``blocks`` (1, 2, 4, 8 or 16), each
    on a band of ``ceil(n / blocks)`` rows and merging ``ceil(m / blocks)``
    columns over the bands; ``slices``, the lanes of a warp that split a
    column in the column pass (each group of ``32 / slices`` lanes spans as
    many columns); ``stride``, the row stride of the band of ``M`` in floats;
    whether that band is ``resident`` in shared memory (else it stays in the
    output buffer, in L2, at stride ``m``); whether a band's ``f`` lives in
    shared memory; whether the bands' (max, sum) pairs, their errors and ``g``
    live in and are exchanged through shared memory (``pairs_smem``; else
    through device scratch); the dynamic shared memory per block; and the
    floats of device scratch."""

    blocks: int
    slices: int
    stride: int
    resident: bool
    f_smem: bool
    pairs_smem: bool
    smem_bytes: int
    scratch_floats: int


def fits_fused_sinkhorn(n: int, m: int) -> bool:
    """Whether the kernel takes an ``(n, m)`` cost matrix: non-empty and at
    most 1,048,576 elements (the TPU kernel's cap counts its padded shape)."""
    return n >= 1 and m >= 1 and n * m <= MAX_ELEMS


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def launch_plan(n: int, m: int, blocks: Optional[int] = None) -> LaunchPlan:
    """The :class:`LaunchPlan` of an ``(n, m)`` matrix that fits.

    ``blocks=None`` takes as many blocks as there are rows, up to 16 (on an
    H100 this pick was the fastest size at 12 of 14 shapes from (5, 200) to
    (70,000, 3), and within 3% of it at the other two); ``blocks`` forces a
    size of :data:`BLOCK_SIZES` (at most ``n``).
    In shared memory, in this order while ``SMEM_BUDGET`` holds them: ``f``
    up to ``VEC_SMEM`` entries; the exchange (the pairs of the columns the
    block merges, ``blocks * (ceil(m / blocks) + 1)`` float2, and ``g``); then the
    band of ``M`` at a row stride padded to ``32 / slices`` modulo 32 banks,
    so the column pass's lanes read distinct banks (unpadded where only that
    fits)."""
    if not fits_fused_sinkhorn(n, m):
        raise ValueError(
            f"cost matrix ({n}, {m}) exceeds the fused Sinkhorn kernel's {MAX_ELEMS} elements; "
            "use the loop (fused='off')"
        )
    if blocks is None:
        blocks = min(MAX_BLOCKS, _pow2_floor(n))
    elif blocks not in BLOCK_SIZES:
        raise ValueError(f"blocks must be one of {BLOCK_SIZES}, got {blocks}")
    elif blocks > n:
        raise ValueError(f"{blocks} blocks for {n} rows: a cluster has at most one block per row")
    band, own = -(-n // blocks), -(-m // blocks)
    slices = min(32, _pow2_floor(THREADS // m), _pow2_floor(band))
    f_smem = band <= VEC_SMEM
    used = 4 * band * f_smem
    exchange = 8 * blocks * (own + 1) + 4 * m  # received pairs, g
    pairs_smem = used + exchange <= SMEM_BUDGET
    used += exchange * pairs_smem
    # the padded stride where it fits, else the band unpadded, else L2
    stride = m + (32 // slices - m) % 32 if slices > 1 else m
    if used + 4 * band * stride > SMEM_BUDGET:
        stride = m
    resident = used + 4 * band * stride <= SMEM_BUDGET
    used += 4 * band * stride * resident
    scratch = (4 * blocks * m + 2 * MAX_BLOCKS + m) * (not pairs_smem) + n * (not f_smem)
    return LaunchPlan(blocks, slices, stride, resident, f_smem, pairs_smem, used, max(1, scratch))


def max_active_clusters(plan: LaunchPlan, device=None) -> int:
    """How many clusters of ``plan`` the card can hold at once
    (``cudaOccupancyMaxActiveClusters``); 0 means it cannot launch one."""
    device = torch.device("cuda") if device is None else torch.device(device)
    with torch.cuda.device(device):
        count = _build._entry("sinkhorn_max_active_clusters",
                              (_build.INT, _build.INT))(plan.blocks, plan.smem_bytes, None)
    if count < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with error {-count}")
    return count


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
    """The loop; ``(log plan, iterations run as a 0-d int32 tensor)``.

    With ``tol > 0`` each iteration's error stays on ``C``'s device; the
    host reads the last :data:`CHECK_EVERY` of them at once (one sync) and
    stops at the first that is no larger than ``tol``, with the potentials
    of that iteration. The plan and the count are those of a loop that reads
    every error, up to ``CHECK_EVERY - 1`` iterations of work later."""
    n, m = C.shape
    M = C * (-1.0 / reg)
    log_mu, log_nu = -math.log(n), -math.log(m)
    f = torch.zeros(n, dtype=C.dtype, device=C.device)
    g = torch.zeros(m, dtype=C.dtype, device=C.device)
    if C.dtype == torch.float32:  # the kernel compares in float32
        tol = float(torch.tensor(tol, dtype=torch.float32))
    it, recent = 0, []  # (f, g, error) of the iterations since the last read
    while it < n_iters:
        f_new = damping * (log_mu - torch.logsumexp(M + g[None, :], dim=1))
        g = damping * (log_nu - torch.logsumexp(M + f_new[:, None], dim=0))
        if tol > 0.0:
            recent.append((f_new, g, torch.max(torch.abs(f_new - f))))
        f = f_new
        it += 1
        if recent and (len(recent) == CHECK_EVERY or it == n_iters):
            count("host_reads")
            errs = torch.stack([e for _, _, e in recent]).tolist()
            met = next((k for k, e in enumerate(errs) if not e > tol), None)
            if met is not None:
                f, g, _ = recent[met]
                it += met + 1 - len(recent)
                break
            recent = []
    iters = torch.tensor(it, dtype=torch.int32, device=C.device)
    return M + f[:, None] + g[None, :], iters


def sinkhorn_log_plain(C: Tensor, reg: float, n_iters: int, tol: float = 0.0,
                       damping: float = 1.0,
                       return_iters: bool = False) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Plain PyTorch version of :func:`sinkhorn_log_fused`, on ``C``'s device;
    it takes a matrix of any float type and size."""
    out, iters = _run_plain(C, *_check(C, reg, n_iters, tol, damping, kernel=False))
    return (out, iters) if return_iters else out


def _run(C: Tensor, reg: float, n_iters: int, tol: float = 0.0, damping: float = 1.0, *,
         blocks: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """One launch of the kernel on a CUDA matrix at
    ``launch_plan(n, m, blocks)``; ``(log plan, iterations)``. A refused
    launch raises."""
    reg, n_iters, tol, damping = _check(C, reg, n_iters, tol, damping)
    if C.device.type != "cuda":
        raise ValueError(f"the Sinkhorn kernel runs on a CUDA tensor, got {C.device}")
    n, m = C.shape
    plan = launch_plan(n, m, blocks)
    out = torch.empty_like(C)
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32, device=C.device)
    iters = torch.empty((), dtype=torch.int32, device=C.device)
    p = _build.ptr
    _build.launch(
        "sinkhorn_log_fused", _SIGNATURE, C.device,
        p(C), p(out), p(scratch), p(iters), n, m, plan.blocks, plan.slices, plan.stride,
        int(plan.resident), int(plan.f_smem), int(plan.pairs_smem), plan.smem_bytes, -1.0 / reg,
        n_iters, tol, damping, -math.log(n), -math.log(m),
    )
    sinkhorn_log_fused.launches += 1
    return out, iters


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
    if isinstance(C, Tensor) and C.device.type == "cuda":
        out, iters = _run(C, reg, n_iters, tol, damping)
    else:
        reg, n_iters, tol, damping = _check(C, reg, n_iters, tol, damping)
        launch_plan(*C.shape)  # the kernel's fit rule holds on the CPU too
        if C.device.type != "cpu":
            raise ValueError(f"sinkhorn_log_fused takes a CPU or CUDA tensor, got {C.device}")
        out, iters = _run_plain(C, reg, n_iters, tol, damping)
    return (out, iters) if return_iters else out
