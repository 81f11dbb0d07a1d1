r"""Whole-chain Langevin on a SiLU-MLP energy: wrapper, plain version, launch count.

PyTorch counterpart of :mod:`torchebm_tpu.ops.fused_mlp_langevin`. The
energy is :class:`~torchebm_tpu_torch.models.MLPEnergy`'s stack,
:math:`E(x) = w_{out}\cdot\mathrm{silu}(W_L(\cdots\mathrm{silu}(W_1 x + b_1)\cdots) + b_L) + b_{out}`,
and :func:`mlp_langevin_chain` runs ``n_steps`` steps

.. math::
    x \leftarrow \mathrm{clip}\big(x - \eta\,\nabla_x E(x)
    + \text{noise\_scale}\sqrt{2\eta}\,\varepsilon\big)

with the exact gradient

.. math::
    \nabla_x E = W_1^\top(\sigma'(a_1)\odot(\cdots W_L^\top(\sigma'(a_L)\odot
    w_{out})\cdots)), \qquad \mathrm{silu}'(a) = \sigma(a)(1 + a(1-\sigma(a)))

in one launch of a hand-written CUDA kernel (``csrc/fused_mlp_langevin.cu``)
when ``x0`` lies on a CUDA device, and in its plain PyTorch version when it
lies on the CPU. ``step_size`` and ``noise_scale`` are constants (the CD
negative-sampling contract). The output is a sample with no gradient: the
wrapper reads the weights detached, and the CD loss differentiates the plain
energy, as in the JAX package.

``layers`` is :func:`extract_mlp_layers`'s list ``[(W_1, b_1), …, (W_L, b_L),
(w_out, b_out)]`` with ``W_i`` of shape ``(in, out)`` (the flax ``Dense``
layout, so the JAX package's arrays pass as they are) and ``w_out`` of shape
``(H_L, 1)``. :func:`extract_mlp_layers` gives views of the module's own
``nn.Linear`` weights, and the kernel reads those where they lie, in
``nn.Linear``'s ``(out, in)`` layout: the main path copies no weight. An
``(in, out)`` array of the JAX layout is copied once per call. ``noise``
(``(n_steps, n_chains, d)``) injects the normals; without it they come from
the Philox4x32-10 stream keyed by ``seed``
(:func:`~torchebm_tpu_torch.ops.fused_langevin.philox_normals`), a Python int
or a 0-d int64 tensor on the state's device, which the kernel reads on the
device (the sampler's draw, with no host sync).

Caps: at most :data:`MAX_HIDDEN` hidden layers, every width at most
:data:`MAX_WIDTH` (the JAX package's cap), and a tile of 8 chains whose
buffers fit in the card's shared memory (:func:`supports`); the sampler's
gate sends other nets to the generic loop before any launch. The wrapper
plans the launch (:func:`launch_plan`: tile, warps per block and route) and
the kernel's shared memory (:func:`_smem_layout`, the one statement of its
layout) from the card's own limits and passes both to the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ._build import ptr as _ptr
from .fused_langevin import (
    _chain_offset,
    _check_common,
    _clamp_args,
    _run_plain,
    _schedule_table,
    _seed_arg,
    _seed_words,
)

Tensor = torch.Tensor
Layers = List[Tuple[Tensor, Tensor]]

__all__ = [
    "MAX_HIDDEN",
    "MAX_WIDTH",
    "SETTINGS",
    "extract_mlp_layers",
    "fits",
    "launch_plan",
    "mlp_langevin_chain",
    "mlp_langevin_chain_plain",
    "supports",
]

#: the JAX package's width cap; and the depth the kernel's shape struct holds
MAX_WIDTH = 512
MAX_HIDDEN = 8

_P, _I, _F, _U = _build.PTR, _build.INT, _build.FLOAT, _build.U32
_SIGNATURE = (_P,) * 8 + (_I,) * 6 + (_F, _F, _I, _F, _F, _U, _U, _build.I64)

#: candidate tiles (chains per block), largest first, and SETTINGS, every
#: (tile, warps, resident) the kernel is built for, in the plan's order of
#: preference at a tile: 8 warps; 4 only where a streamed chunk for 8 does
#: not fit
_TILES = (32, 16, 8)
SETTINGS = tuple((t, w, r) for t in _TILES for w, r in ((8, True), (8, False), (4, False)))
#: the kernel's constants: a layer with fewer inputs runs on FP32 FMAs; the
#: streamed chunk's K
_MMA_MIN_K = 8
_CHUNK_K = 32
#: an H100's opt-in shared memory per block and SM count: the limits of a
#: plan made for a CPU state, where no card is there to ask
_H100_LIMITS = (232_448, 132)
#: Hopper's shared memory per SM, and what the runtime reserves per block
_SM_SMEM_BYTES = 233_472
_BLOCK_RESERVED_BYTES = 1024


def extract_mlp_layers(module) -> Optional[Layers]:
    """``[(W_1, b_1), ..., (w_out, b_out)]`` of a SiLU-MLP module, detached,
    with ``W_i`` as ``(in, out)``: views of the module's own parameters
    (``lin.weight.T``), so the kernel reads them where they lie.

    ``module`` must carry a ``layers`` :class:`~torch.nn.ModuleList` of
    biased :class:`~torch.nn.Linear` layers ending in one output
    (:class:`~torchebm_tpu_torch.models.MLPEnergy`'s structure); anything
    else gives None, so the dispatch falls back to the loop. The activation
    cannot be read from the structure: the sampler also requires the
    ``arch="silu_mlp"`` tag.
    """
    stack = getattr(module, "layers", None)
    if not isinstance(stack, torch.nn.ModuleList) or len(stack) == 0:
        return None
    layers = []
    for lin in stack:
        if type(lin) is not torch.nn.Linear or lin.bias is None:
            return None
        layers.append((lin.weight.detach().T, lin.bias.detach()))
    if layers[-1][0].shape[1] != 1:
        return None
    for (w, _), (w_next, _) in zip(layers[:-1], layers[1:]):
        if w.shape[1] != w_next.shape[0]:
            return None
    return layers


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


class SmemLayout(NamedTuple):
    """The kernel's dynamic shared memory, in floats (``_smem_layout``)."""

    #: each hidden layer's staged weight (-1: streamed through ``stage``)
    w: Tuple[int, ...]
    #: each hidden layer's bias, zero-padded to a multiple of 16 units
    b: Tuple[int, ...]
    #: w_out, padded like the last bias
    out: int
    #: the tile's state and gradient (row pitch ``xp``), and the state split
    #: into TF32 hi and lo for a tensor-core first layer (-1: none)
    x: int
    g: int
    xo: int
    #: every hidden layer's silu' but the last's, and the two operand buffers
    #: (activations forward, deltas backward; each hi, then lo), row pitch ``ap``
    act: int
    op: int
    #: the Philox normals of ``z_steps`` steps (4 per chain and block of
    #: four coordinates), drawn at once, one block a thread
    z: int
    #: the streamed route's two chunks of W
    stage: int
    end: int
    xp: int
    ap: int
    z_steps: int

    def as_ints(self) -> Tuple[int, ...]:
        """The kernel's ``layout`` array."""
        return (self.out, self.x, self.g, self.xo, self.act, self.op, self.z, self.stage,
                self.end, self.xp, self.ap, self.z_steps, *self.w, *self.b)


@functools.lru_cache(maxsize=1024)
def _smem_layout(widths: Tuple[int, ...], tile: int, warps: int, resident: bool) -> SmemLayout:
    """The kernel's shared memory for ``widths`` ``(d, H_1, ..., H_L)`` at
    ``tile`` chains and ``warps`` warps per block, every region 16-byte
    aligned, in order: each layer's staged weight (a layer of fewer than
    :data:`_MMA_MIN_K` inputs as ``(H_p, in)`` rows, FP32 FMAs read it; a
    tensor-core layer, resident route only, as its TF32 hi and lo parts,
    each ``(H_p, in rounded up to 32)`` with swizzled columns), the biases
    and w_out, the state and gradient, the split state (when ``d`` is at
    least :data:`_MMA_MIN_K`), every hidden layer's silu' but the last's,
    the operand buffers (two, one at L = 1, each hi and lo), the Philox
    normals of as many steps as give every thread of the block one block of
    four to draw (at least one step) and, streamed, two chunks of ``warps *
    16`` by ``_CHUNK_K`` floats. ``H_p`` is a width rounded up to 16 (the
    M-tiles); the row pitches ``xp`` and ``ap`` are 4 past a multiple of 16,
    so the B-fragment loads are conflict-free. The kernel reads these
    offsets as they are."""
    d, hidden = widths[0], list(widths[1:])
    n_hidden = len(hidden)
    hp = [_round_up(h, 16) for h in hidden]
    off, w = 0, []
    for din, p in zip(widths[:-1], hp):
        if din < _MMA_MIN_K:
            size = p * din
        elif resident:
            size = 2 * p * _round_up(din, 32)
        else:
            w.append(-1)
            continue
        w.append(off)
        off += _round_up(size, 4)
    b = []
    for p in hp:
        b.append(off)
        off += p
    out = off
    off += hp[-1]
    xp, ap = _round_up(d, 16) + 4, max(hp) + 4
    x = off
    g = x + tile * xp
    xo = g + tile * xp
    act = xo + (2 * tile * xp if d >= _MMA_MIN_K else 0)
    op = act + tile * ap * (n_hidden - 1)
    z = op + 2 * tile * ap * min(n_hidden, 2)
    quads = -(-d // 4)
    z_steps = max(1, 32 * warps // (tile * quads))
    stage = z + 4 * z_steps * tile * quads
    end = stage + (0 if resident else 2 * warps * 16 * _CHUNK_K)
    return SmemLayout(tuple(w), tuple(b), out, x, g, xo if d >= _MMA_MIN_K else -1, act, op, z,
                      stage, end, xp, ap, z_steps)


def _card_limits(device) -> Tuple[int, int]:
    """``(opt-in shared memory bytes per block, SM count)`` of ``device``'s
    card, or an H100's for a CPU state."""
    if device is None or torch.device(device).type != "cuda":
        return _H100_LIMITS
    index = torch.device(device).index
    return _cuda_limits(torch.cuda.current_device() if index is None else index)


@functools.cache
def _cuda_limits(index: int) -> Tuple[int, int]:
    query = _build.load_library().tebm_mlp_max_smem_bytes
    query.argtypes, query.restype = [ctypes.c_int], ctypes.c_int
    smem_bytes = query(index)
    if smem_bytes <= 0:
        raise RuntimeError(f"cannot read the shared memory limit of cuda:{index} ({-smem_bytes})")
    return smem_bytes, torch.cuda.get_device_properties(index).multi_processor_count


class MlpPlan(NamedTuple):
    """One launch: ``tile`` chains and ``warps`` warps per block, and whether
    every weight stays in shared memory (``resident``) or streams."""

    tile: int
    warps: int
    resident: bool


def fits(widths: Sequence[int], plan, device=None) -> bool:
    """Whether ``plan``'s shared memory fits in a block of ``device``'s card
    (an H100 for None or the CPU)."""
    return 4 * _smem_layout(tuple(widths), *plan).end <= _card_limits(device)[0]


def launch_plan(n_chains: int, widths: Sequence[int], device=None) -> Optional[MlpPlan]:
    """The launch for ``n_chains`` chains of an MLP with widths ``(d, H_1,
    ..., H_L)`` on ``device``'s card (an H100 for None or the CPU), or None
    when no tile fits in its shared memory.

    The rule follows the card's timings of the kernel (``chip_smoke.py``'s
    plan sweep): a block's step takes longer at a larger tile but less than
    in proportion, so the tile is the smallest whose grid the card holds at
    once (every block resident, by shared memory), else the largest that
    fits; resident weights win over streamed ones at any tile, and 8 warps
    over 4 (:data:`SETTINGS`)."""
    return _plan(int(n_chains), tuple(int(w) for w in widths), *_card_limits(device))


@functools.lru_cache(maxsize=1024)
def _plan(n_chains: int, widths: Tuple[int, ...], smem_bytes: int,
          n_sms: int) -> Optional[MlpPlan]:
    def first_fit(tiles):
        for resident in (True, False):
            for t in tiles:
                for st, w, r in SETTINGS:
                    if (st, r) == (t, resident) and 4 * _smem_layout(widths, t, w, r).end <= \
                            smem_bytes:
                        return MlpPlan(t, w, r)
        return None

    for t in reversed(_TILES):  # the smallest tile whose grid the card holds at once
        plan = first_fit([t])
        if plan is not None:
            per_sm = _SM_SMEM_BYTES // (4 * _smem_layout(widths, *plan).end
                                        + _BLOCK_RESERVED_BYTES)
            if -(-n_chains // t) <= n_sms * per_sm:
                return plan
    return first_fit(_TILES)


def supports(widths: Sequence[int], device=None) -> bool:
    """Whether the kernel takes an MLP with widths ``(d, H_1, ..., H_L)`` on
    ``device``'s card: 1 to :data:`MAX_HIDDEN` hidden layers, widths 1 to
    :data:`MAX_WIDTH`, and a plan at the smallest tile."""
    widths = [int(w) for w in widths]
    if not 1 <= len(widths) - 1 <= MAX_HIDDEN:
        return False
    if not all(1 <= w <= MAX_WIDTH for w in widths):
        return False
    return launch_plan(1, widths, device) is not None


def _mlp_args(x0: Tensor, layers: Layers, n_steps: int, noise: Optional[Tensor]) -> List[int]:
    """Validate a call; return the widths ``(d, H_1, ..., H_L)``."""
    _check_common(x0, n_steps, noise)
    if x0.ndim != 2:
        raise ValueError(f"x0 must have shape (n_chains, d), got {tuple(x0.shape)}")
    if len(layers) < 2:
        raise ValueError("layers must hold at least one hidden layer and the output layer")
    widths = [x0.shape[1]]
    for i, (w, b) in enumerate(layers):
        for name, t in (("weight", w), ("bias", b)):
            if not isinstance(t, Tensor) or t.dtype != torch.float32 or t.device != x0.device:
                raise ValueError(f"layer {i} {name} must be a float32 tensor on {x0.device}")
        out = 1 if i == len(layers) - 1 else w.shape[-1]
        if w.shape != (widths[-1], out) or b.shape != (out,):
            raise ValueError(
                f"layer {i} shape mismatch: weight {tuple(w.shape)}, bias {tuple(b.shape)}; "
                f"expected ({widths[-1]}, {out}) and ({out},)"
            )
        if i < len(layers) - 1:
            widths.append(out)
    if not supports(widths, x0.device):
        raise ValueError(
            f"the MLP chain kernel takes 1 to {MAX_HIDDEN} hidden layers of width at most "
            f"{MAX_WIDTH} whose buffers fit in shared memory; got widths {widths}"
        )
    return widths


def _mlp_grad(x: Tensor, layers: Layers) -> Tensor:
    """``∇_x E`` of the SiLU stack by the hand-written backward pass."""
    acts, h = [], x
    for w, b in layers[:-1]:
        a = h @ w + b
        acts.append(a)
        h = F.silu(a)
    g = layers[-1][0][:, 0].expand_as(h)
    for (w, _), a in zip(reversed(layers[:-1]), reversed(acts)):
        s = torch.sigmoid(a)
        g = (s * (1.0 + a * (1.0 - s)) * g) @ w.T
    return g


def _plain(x0, layers, n_steps, step_size, noise_scale, seed, clamp, noise,
           chain_offset=0) -> Tensor:
    layers = [(w.detach(), b.detach()) for w, b in layers]
    seed = int(seed)
    _seed_words(seed)
    sched = _schedule_table(float(step_size), float(noise_scale), int(n_steps), x0.device)
    return _run_plain(x0, lambda x: _mlp_grad(x, layers), sched, x0.shape[1], clamp, seed,
                      noise, None, chain_offset=chain_offset)[1]


def mlp_langevin_chain_plain(x0: Tensor, layers: Layers, n_steps: int, step_size: float,
                             noise_scale: float = 1.0, *, seed=0, clamp=None,
                             noise: Optional[Tensor] = None, chain_offset: int = 0) -> Tensor:
    """Plain PyTorch version of :func:`mlp_langevin_chain`, on ``x0``'s
    device: the same update, gradient and Philox stream."""
    _mlp_args(x0, layers, n_steps, noise)
    _seed_arg(seed, x0.device)
    return _plain(x0, layers, n_steps, step_size, noise_scale, seed, clamp, noise,
                  _chain_offset(chain_offset, x0.shape[0]))


def _launch(x0: Tensor, layers: Layers, widths: Sequence[int], n_steps: int, step_size: float,
            noise_scale: float, seed, clamp, noise: Optional[Tensor], plan: MlpPlan,
            chain_offset: int = 0) -> Tensor:
    """One launch of the kernel on the checked arguments at ``plan``. The
    weights go as ``w.T.contiguous()``: for :func:`extract_mlp_layers`' views
    that is the module's own ``nn.Linear.weight``, no copy; an ``(in, out)``
    array of the JAX layout is copied."""
    seed_t, seed_lo, seed_hi = _seed_arg(seed, x0.device)
    layout = _smem_layout(tuple(widths), plan.tile, plan.warps, plan.resident).as_ints()
    weights = [w.detach().T.contiguous() for w, _ in layers]
    out = torch.empty_like(x0)
    use_clamp, lo, hi = _clamp_args(clamp)
    c_weights = (ctypes.c_void_p * len(weights))(*[_ptr(w) for w in weights])
    c_biases = (ctypes.c_void_p * (len(layers) - 1))(*[_ptr(b) for _, b in layers[:-1]])
    c_widths = (ctypes.c_int * len(widths))(*widths)
    c_layout = (ctypes.c_int * len(layout))(*layout)
    eta = float(step_size)
    coef = float(noise_scale) * math.sqrt(2.0 * eta)
    _build.launch(
        "mlp_langevin_chain", _SIGNATURE, x0.device,
        _ptr(x0), _ptr(out), ctypes.addressof(c_weights), ctypes.addressof(c_biases),
        _ptr(noise), _ptr(seed_t), ctypes.addressof(c_widths), ctypes.addressof(c_layout),
        len(widths) - 1, int(plan.resident), x0.shape[0], plan.tile, plan.warps, int(n_steps),
        eta, coef, use_clamp, lo, hi, seed_lo, seed_hi,
        _chain_offset(chain_offset, x0.shape[0]),
    )
    return out


@_build.counted
def mlp_langevin_chain(
    x0: Tensor,
    layers: Layers,
    n_steps: int,
    step_size: float,
    noise_scale: float = 1.0,
    *,
    seed=0,
    clamp: Optional[Tuple[float, float]] = None,
    noise: Optional[Tensor] = None,
    chain_offset: int = 0,
) -> Tensor:
    """Full n-step Langevin chain on a SiLU-MLP energy in one kernel launch.

    ``x0``: ``(n_chains, d)`` float32; ``layers``: :func:`extract_mlp_layers`'s
    list, or ``(in, out)`` arrays of the JAX layout. ``seed``: a Python int
    or a 0-d int64 tensor on ``x0``'s device, read by the kernel where it
    lies. ``chain_offset``: the first chain's Philox index, so that a shard
    of rows ``[a, b)`` launched at ``a`` draws what those rows draw in the
    launch over the whole batch (a Python int: no host sync). Returns the
    final state, with no gradient.
    """
    widths = _mlp_args(x0, layers, n_steps, noise)
    _seed_arg(seed, x0.device)
    chain_offset = _chain_offset(chain_offset, x0.shape[0])
    if x0.device.type == "cpu":
        return _plain(x0, layers, n_steps, step_size, noise_scale, seed, clamp, noise,
                      chain_offset)
    out = _launch(x0, layers, widths, n_steps, step_size, noise_scale, seed, clamp, noise,
                  launch_plan(x0.shape[0], widths, x0.device), chain_offset)
    mlp_langevin_chain.launches += 1
    return out
