r"""adaLN-Zero kernels of the DiT block: wrappers, plain versions, launch plan, launch counts.

A DiT block (:class:`~torchebm_tpu_torch.models.components.AdaLNZeroBlock`)
conditions each branch on per-sample vectors ``shift``, ``scale`` and
``gate`` of ``(B, D)`` that meet the ``(B, N, D)`` token stream ``x``:

.. math::
    z = \mathrm{LN}(x)\,(1 + \mathrm{scale}) + \mathrm{shift},\qquad
    x \leftarrow x + \mathrm{gate}\cdot\mathrm{branch}(z)

with :math:`\mathrm{LN}` a LayerNorm without scale or bias. The JAX package
leaves this to XLA, which fuses it into the jitted step; eager PyTorch runs a
LayerNorm and five broadcast elementwise operations, each a pass over the
stream, and autograd more in the backward. Two kernels, each with a kernel
for its backward, do it in one pass a side of each branch:

- :func:`adaln_modulate` (``csrc/fused_adaln.cu``): ``z`` from ``x``, with
  the statistics and the modulation in float32 and ``z`` rounded to ``x``'s
  type once; it keeps the per-token mean and ``rstd`` (float32) for
  :func:`adaln_modulate_backward`, which gives ``dx``, ``dshift`` and
  ``dscale`` in one pass, adding the residual stream's incoming gradient
  ``dres`` to ``dx`` as it goes;
- :func:`gated_residual` (``csrc/fused_gated_residual.cu``): ``x + gate·y``;
  :func:`gated_residual_backward` gives ``dy = gate·dout`` and ``dgate`` (the
  stream's own gradient is ``dout``, which needs no kernel).

The per-sample sums over the tokens (``dshift``, ``dscale``, ``dgate``) are
taken without atomics, in a fixed order, so a run repeats bit for bit.
Storage is float32, float16 or bfloat16 (each kernel built for the three);
``D`` is any width up to 16 packs a lane (:func:`launch_plan`: 4,096 in 16-bit
types and 2,048 in float32 where ``D`` fills 16-byte packs, else 512), ``N``
any length. Each wrapper runs its kernel on CUDA tensors and its plain
PyTorch version (``*_plain``, the same formulas, in float32 or wider) on CPU
tensors; any other device raises. A wrapper's ``launches`` attribute counts
its calls that launched its kernel. A backward call whose samples' tokens
span several blocks (:class:`LaunchPlan` ``chunks`` above 1: at half as many
samples as the card has multiprocessors or fewer) launches a second, small kernel
that adds the blocks' partial sums; it is counted with the call, not apart.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

Tensor = torch.Tensor

__all__ = [
    "adaln_modulate", "adaln_modulate_backward", "adaln_modulate_backward_plain",
    "adaln_modulate_plain", "gated_residual", "gated_residual_backward",
    "gated_residual_backward_plain", "gated_residual_plain", "launch_plan",
]

#: pack items a lane holds, as built (``with_items``, csrc/tebm_adaln.cuh)
ITEMS = (1, 2, 3, 4, 6, 8, 12, 16)
#: warps a block (``kWarps``)
WARPS = 8
#: token rows a block of the forward kernels walks (8 a warp)
FORWARD_ROWS = 64
#: the backward kernels split a sample's tokens over as many blocks as fit
#: one wave of this many blocks a streaming multiprocessor (their registers
#: hold one block of 8 warps a multiprocessor from DiT-B/2's width in bf16)
BLOCKS_PER_SM = 1
#: a launch's samples are its grid's second dimension
MAX_SAMPLES = 65_535
#: storage type -> the kernels' type code (``DType``, csrc/tebm_adaln.cuh)
_TYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_P, _I, _F, _LL = _build.PTR, _build.INT, _build.FLOAT, _build.I64
#: C entry point (``tebm_<name>``) -> its argument types before the stream
_SIGNATURES = {
    "adaln_modulate": (_I, _I, _I, _P, _P, _LL, _P, _LL, _P, _P, _P, _I, _I, _I, _I, _F),
    "adaln_modulate_backward":
        (_I, _I, _I, _P, _P, _P, _P, _P, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _I),
    "gated_residual": (_I, _I, _P, _P, _LL, _P, _P, _I, _I, _I, _I),
    "gated_residual_backward": (_I, _I, _I, _P, _P, _LL, _P, _P, _P, _P, _I, _I, _I, _I),
    "adaln_column_sums": (_I, _P, _I, _I, _I, _I, _P, _P),
}


class LaunchPlan(NamedTuple):
    """How a kernel walks a ``(B, N, D)`` stream: 16-byte packs of ``D``
    (``vec``, else one value a pack); the pack ``items`` each lane holds of a
    row (the smallest of :data:`ITEMS` that covers it); the token ``rows``
    of one sample that a block walks; and the ``chunks`` of blocks that
    split a sample's tokens (in the backward, each writes a partial row of
    column sums that a second pass adds in chunk order)."""

    vec: bool
    items: int
    rows: int
    chunks: int


@functools.lru_cache(maxsize=1024)
def launch_plan(n_samples: int, n_tokens: int, d: int, itemsize: int, *, backward: bool = False,
                aligned: bool = True, sms: int = 132) -> LaunchPlan:
    """The :class:`LaunchPlan` of a ``(n_samples, n_tokens, d)`` stream of
    ``itemsize``-byte values on a card of ``sms`` streaming multiprocessors.

    Packs are 16 bytes where ``d`` is a multiple of their values and every
    stream's address is 16-byte ``aligned``. The forward kernels give a
    block :data:`FORWARD_ROWS` rows; the backward kernels split a sample's
    tokens into the most chunks whose blocks run as one wave of
    :data:`BLOCKS_PER_SM` a multiprocessor (one chunk where the samples
    alone fill it), no chunk under a row a warp: a second, part-filled wave
    would take as long as the first."""
    if n_samples < 1 or n_tokens < 1 or d < 1:
        raise ValueError(f"an empty stream ({n_samples}, {n_tokens}, {d}) has no launch plan")
    if n_samples > MAX_SAMPLES:
        raise ValueError(f"{n_samples} samples: the adaLN kernels take at most {MAX_SAMPLES}")
    per_pack = 16 // itemsize
    vec = aligned and d % per_pack == 0
    width = 32 * (per_pack if vec else 1)
    need = -(-d // width)
    if need > ITEMS[-1]:
        raise ValueError(f"d={d} exceeds the adaLN kernels' {ITEMS[-1] * width} "
                         f"({'16-byte packs' if vec else 'one value a pack'}, "
                         f"{ITEMS[-1]} a lane)")
    items = next(i for i in ITEMS if i >= need)
    if backward:
        chunks = min(max(1, BLOCKS_PER_SM * sms // n_samples), -(-n_tokens // WARPS))
        rows = -(-n_tokens // max(chunks, 1))
    else:
        rows = min(FORWARD_ROWS, n_tokens)
    return LaunchPlan(vec, items, rows, -(-n_tokens // rows))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan(x: Tensor, *others: Optional[Tensor], backward: bool = False) -> LaunchPlan:
    aligned = all(t is None or t.data_ptr() % 16 == 0 for t in (x, *others))
    b, n, d = x.shape
    return launch_plan(b, n, d, x.element_size(), backward=backward, aligned=aligned,
                       sms=_sms(x.get_device()))


def _launch(name: str, device, *args) -> None:
    _build.launch(name, _SIGNATURES[name], device, *args)


def _acc(t: Tensor) -> torch.dtype:
    """The plain versions' arithmetic type: float32, or float64 for float64."""
    return torch.promote_types(t.dtype, torch.float32)


def _check(x: Tensor, rows: Tuple[Tuple[str, Tensor], ...],
           streams: Tuple[Tuple[str, Optional[Tensor]], ...]) -> bool:
    """``x`` is ``(B, N, D)``; each of ``rows`` ``(B, D)``; each of
    ``streams`` (None allowed) of ``x``'s shape; all on ``x``'s device.
    Returns whether that is a CUDA device, where the kernels also ask for
    ``x``'s type (float32, float16 or bfloat16) throughout, ``x`` and the
    streams contiguous and the rows at unit stride along ``D``."""
    if not isinstance(x, Tensor) or x.dim() != 3:
        raise ValueError(f"the token stream must be a (B, N, D) tensor, got "
                         f"{tuple(x.shape) if isinstance(x, Tensor) else type(x).__name__}")
    kernel = x.is_cuda
    if not kernel and x.device.type != "cpu":
        raise ValueError(f"the stream is on {x.device}: only CPU (plain) and CUDA (kernel) run")
    b, _, d = x.shape
    where, dtype = x.get_device(), x.dtype
    if kernel and (dtype not in _TYPES or not x.is_contiguous()):
        raise TypeError(f"the adaLN kernels take a contiguous float32, float16 or bfloat16 "
                        f"stream, got {dtype}")
    for is_row, (name, t) in [*((True, r) for r in rows), *((False, s) for s in streams)]:
        if t is None:
            continue
        want = (b, d) if is_row else x.shape
        if t.shape != want:
            raise ValueError(f"{name} must have shape {tuple(want)}, got {tuple(t.shape)}")
        if t.get_device() != where:
            raise ValueError(f"{name} is on {t.device}, the stream on {x.device}")
        if kernel and t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, the stream {dtype}")
        if kernel and not (t.stride(1) == 1 if is_row else t.is_contiguous()):
            raise ValueError(f"{name} must be "
                             f"{'at unit stride along D' if is_row else 'contiguous'}")
    return kernel


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def adaln_modulate_plain(x: Tensor, shift: Tensor, scale: Tensor, eps: float = 1e-6, *,
                         stats: bool = True):
    """Plain PyTorch version of :func:`adaln_modulate`, on ``x``'s device."""
    acc = _acc(x)
    mean = x.to(acc).mean(-1, keepdim=True)
    xc = x.to(acc) - mean
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    z = (xc * rstd * (1 + scale.to(acc)[:, None, :]) + shift.to(acc)[:, None, :]).to(x.dtype)
    return (z, mean[..., 0], rstd[..., 0]) if stats else (z, None, None)


def adaln_modulate_backward_plain(dz: Tensor, x: Tensor, mean: Tensor, rstd: Tensor,
                                  scale: Tensor, dres: Optional[Tensor] = None):
    """Plain PyTorch version of :func:`adaln_modulate_backward`:
    ``(dx, dshift, dscale)``."""
    acc = _acc(x)
    rstd = rstd.to(acc)[..., None]
    xh = (x.to(acc) - mean.to(acc)[..., None]) * rstd
    g = dz.to(acc)
    dscale, dshift = (g * xh).sum(1), g.sum(1)
    g = g * (1 + scale.to(acc)[:, None, :])
    dx = rstd * (g - g.mean(-1, keepdim=True) - xh * (g * xh).mean(-1, keepdim=True))
    if dres is not None:
        dx = dx + dres.to(acc)
    return dx.to(x.dtype), dshift.to(scale.dtype), dscale.to(scale.dtype)


def gated_residual_plain(x: Tensor, gate: Tensor, y: Tensor) -> Tensor:
    """Plain PyTorch version of :func:`gated_residual`."""
    acc = _acc(x)
    return (x.to(acc) + gate.to(acc)[:, None, :] * y.to(acc)).to(x.dtype)


def gated_residual_backward_plain(dout: Tensor, gate: Tensor, y: Tensor):
    """Plain PyTorch version of :func:`gated_residual_backward`: ``(dy, dgate)``."""
    acc = _acc(dout)
    dy = (gate.to(acc)[:, None, :] * dout.to(acc)).to(y.dtype)
    return dy, (dout.to(acc) * y.to(acc)).sum(1).to(gate.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _column_sums(partial: Tensor, outs: Tuple[Tensor, ...]) -> None:
    """Adds the backward kernels' partial rows ``(B, chunks, len(outs), D)``
    into ``outs`` in chunk order (the second pass)."""
    b, chunks, n_sums, d = partial.shape
    _launch("adaln_column_sums", partial.device, _TYPES[outs[0].dtype], _build.ptr(partial), b,
            chunks, n_sums, d, _build.ptr(outs[0]), _build.ptr(outs[1] if n_sums == 2 else None))


@_build.counted
def adaln_modulate(x: Tensor, shift: Tensor, scale: Tensor, eps: float = 1e-6, *,
                   stats: bool = True):
    """``(z, mean, rstd)``: ``z = LN(x)·(1 + scale) + shift`` of ``x``'s
    shape and type, and the per-token mean and ``rstd`` ``(B, N)`` float32
    that :func:`adaln_modulate_backward` reads (None without ``stats``).

    ``x``: ``(B, N, D)``, contiguous; ``shift``, ``scale``: ``(B, D)``, unit
    stride along ``D`` (a chunk of the modulation's output is)."""
    if not _check(x, (("shift", shift), ("scale", scale)), ()):
        return adaln_modulate_plain(x, shift, scale, eps, stats=stats)
    b, n, d = x.shape
    out = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean, rstd = torch.empty((2, b, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out, mean, rstd
    plan = _plan(x)
    p = _build.ptr
    _launch("adaln_modulate", x.device, _TYPES[x.dtype], int(plan.vec), plan.items, p(x),
            p(shift), shift.stride(0), p(scale), scale.stride(0), p(out), p(mean), p(rstd), b, n, d,
            plan.rows, float(eps))
    adaln_modulate.launches += 1
    return out, mean, rstd


def _sums_out(x: Tensor, plan: LaunchPlan, n_sums: int, dtype: torch.dtype):
    """``(partial or None, outs)``: the backward kernels' per-sample sums
    ``(B, D)`` of ``dtype``, and the float32 partial rows ``(B, chunks,
    n_sums, D)`` they are added from where a sample's tokens span chunks."""
    b, _, d = x.shape
    outs = tuple(torch.empty((n_sums, b, d), dtype=dtype, device=x.device))
    partial = (torch.empty((b, plan.chunks, n_sums, d), dtype=torch.float32, device=x.device)
               if plan.chunks > 1 else None)
    return partial, outs


@_build.counted
def adaln_modulate_backward(dz: Tensor, x: Tensor, mean: Tensor, rstd: Tensor, scale: Tensor,
                            dres: Optional[Tensor] = None):
    """The backward of :func:`adaln_modulate` at ``dz``: ``(dx, dshift,
    dscale)``, ``dx`` of ``x``'s shape and type plus ``dres`` (the residual
    stream's incoming gradient, if given), the sums over the tokens ``(B,
    D)`` of ``scale``'s type. ``mean`` and ``rstd`` are the forward's.
    ``launches`` counts the call once, its second pass included."""
    kernel = _check(x, (("scale", scale),), (("dz", dz), ("dres", dres)))
    b, n, d = x.shape
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.shape != (b, n) or t.get_device() != x.get_device():
            raise ValueError(f"{name} must be ({b}, {n}) on {x.device}, got {tuple(t.shape)} "
                             f"on {t.device}")
        if kernel and not (t.dtype == torch.float32 and t.is_contiguous()):
            raise TypeError(f"{name} must be contiguous float32, as adaln_modulate gives it")
    return _modulate_backward(dz, x, mean, rstd, scale, dres)


def _modulate_backward(dz: Tensor, x: Tensor, mean: Tensor, rstd: Tensor, scale: Tensor,
                       dres: Optional[Tensor]):
    """:func:`adaln_modulate_backward` without its checks, for a caller
    whose tensors passed them (``dz`` and ``dres`` contiguous, of ``x``'s
    shape and type; ``mean`` and ``rstd`` as :func:`adaln_modulate` gave
    them): the kernels on CUDA tensors, the plain version on CPU ones."""
    if not x.is_cuda:
        return adaln_modulate_backward_plain(dz, x, mean, rstd, scale, dres)
    b, n, d = x.shape
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        zeros = torch.zeros((b, d), dtype=scale.dtype, device=x.device)
        return dx, zeros, zeros.clone()
    plan = _plan(x, dz, dres, backward=True)
    partial, (dscale, dshift) = _sums_out(x, plan, 2, scale.dtype)
    p = _build.ptr
    _launch("adaln_modulate_backward", x.device, _TYPES[x.dtype], int(plan.vec), plan.items, p(dz),
            p(x), p(mean), p(rstd), p(scale), scale.stride(0), p(dres), p(dx), p(partial),
            p(dscale), p(dshift), b, n, d, plan.rows)
    if partial is not None:
        _column_sums(partial, (dscale, dshift))
    adaln_modulate_backward.launches += 1
    return dx, dshift, dscale


@_build.counted
def gated_residual(x: Tensor, gate: Tensor, y: Tensor) -> Tensor:
    """``x + gate·y`` of ``x``'s shape and type: ``x`` and ``y`` ``(B, N,
    D)``, contiguous; ``gate`` ``(B, D)``, unit stride along ``D``."""
    if not _check(x, (("gate", gate),), (("y", y),)):
        return gated_residual_plain(x, gate, y)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    b, n, d = x.shape
    plan = _plan(x, y)
    p = _build.ptr
    _launch("gated_residual", x.device, _TYPES[x.dtype], int(plan.vec), p(x), p(gate),
            gate.stride(0), p(y), p(out), b, n, d, plan.rows)
    gated_residual.launches += 1
    return out


@_build.counted
def gated_residual_backward(dout: Tensor, gate: Tensor, y: Tensor):
    """The backward of :func:`gated_residual` at ``dout`` for ``y`` and
    ``gate``: ``(dy, dgate)`` (the stream's own gradient is ``dout``).
    ``launches`` counts the call once, its second pass included."""
    _check(dout, (("gate", gate),), (("y", y),))
    return _gated_backward(dout, gate, y)


def _gated_backward(dout: Tensor, gate: Tensor, y: Tensor):
    """:func:`gated_residual_backward` without its checks, for a caller
    whose tensors passed them: the kernels on CUDA tensors, the plain
    version on CPU ones."""
    if not dout.is_cuda:
        return gated_residual_backward_plain(dout, gate, y)
    b, n, d = dout.shape
    dy = torch.empty_like(y)
    if dy.numel() == 0:
        return dy, torch.zeros((b, d), dtype=gate.dtype, device=dout.device)
    plan = _plan(dout, y, backward=True)
    partial, (dgate,) = _sums_out(dout, plan, 1, gate.dtype)
    p = _build.ptr
    _launch("gated_residual_backward", dout.device, _TYPES[dout.dtype], int(plan.vec),
            plan.items, p(dout), p(gate), gate.stride(0), p(y), p(dy), p(partial), p(dgate), b, n,
            d, plan.rows)
    if partial is not None:
        _column_sums(partial, (dgate,))
    gated_residual_backward.launches += 1
    return dy, dgate
