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
``(H_L, 1)``. ``noise`` (``(n_steps, n_chains, d)``) injects the normals;
without it they come from the Philox4x32-10 stream keyed by ``seed``
(:func:`~torchebm_tpu_torch.ops.fused_langevin.philox_normals`).

Caps: at most :data:`MAX_HIDDEN` hidden layers, every width at most
:data:`MAX_WIDTH` (the JAX package's cap), and a tile of 8 chains whose
buffers fit in the card's shared memory (:func:`supports`); the sampler's
gate sends other nets to the generic loop before any launch. The wrapper
plans the kernel's shared memory (:func:`_smem_layout`, the one statement of
its layout) from the card's own limits and passes the plan to the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ._build import ptr as _ptr
from .fused_langevin import _check_common, _clamp_args, _run_plain, _schedule_table, _seed_words

Tensor = torch.Tensor
Layers = List[Tuple[Tensor, Tensor]]

__all__ = [
    "MAX_HIDDEN",
    "MAX_WIDTH",
    "extract_mlp_layers",
    "launch_plan",
    "mlp_langevin_chain",
    "mlp_langevin_chain_plain",
    "supports",
]

#: the JAX package's width cap; and the depth the kernel's shape struct holds
MAX_WIDTH = 512
MAX_HIDDEN = 8

_P, _I, _F, _U = _build.PTR, _build.INT, _build.FLOAT, _build.U32
_SIGNATURE = (_P,) * 6 + (_I,) * 4 + (_F, _F, _I, _F, _F, _U, _U)

#: the streamed chunk's weight rows and the candidate tiles (chains per block)
_CHUNK_ROWS = 32
_TILES = (32, 16, 8)
#: an H100's opt-in shared memory per block and SM count: the limits of a
#: plan made for a CPU state, where no card is there to ask
_H100_LIMITS = (232_448, 132)


def extract_mlp_layers(module) -> Optional[Layers]:
    """``[(W_1, b_1), ..., (w_out, b_out)]`` of a SiLU-MLP module, detached,
    with ``W_i`` as ``(in, out)``.

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


def _packed_size(widths: Sequence[int]) -> int:
    return sum(i * (o + 1) + o for i, o in zip(widths[:-1], widths[1:])) + widths[-1]


def _smem_layout(widths: Sequence[int], tile: int, resident: bool) -> Tuple[int, ...]:
    """The kernel's dynamic shared memory, in floats: ``(chunk rows (0 for
    resident weights), state, gradient, pre-activations, activations, end)``.
    The weights (or one streamed chunk of rows) come first, then the tile's
    state, gradient, every layer's pre-activations and the current
    activations. The kernel reads these offsets as they are."""
    d, hidden = widths[0], widths[1:]
    x = _packed_size(widths) if resident else _CHUNK_ROWS * (max(hidden) + 1)
    g = x + tile * d
    act = g + tile * d
    h = act + tile * sum(hidden)
    return (0 if resident else _CHUNK_ROWS, x, g, act, h, h + tile * max(hidden))


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


def launch_plan(n_chains: int, widths: Sequence[int],
                device=None) -> Optional[Tuple[int, bool]]:
    """``(tile, resident)`` for ``n_chains`` chains of an MLP with widths
    ``(d, H_1, ..., H_L)`` on ``device``'s card (an H100 for None or the
    CPU), or None when no tile fits in its shared memory.

    The preferred tile is the largest that still gives two blocks per SM;
    resident weights win over streamed ones at any tile."""
    smem_bytes, n_sms = _card_limits(device)
    preferred = next((t for t in _TILES[:-1] if -(-n_chains // t) >= 2 * n_sms), _TILES[-1])
    tiles = [t for t in _TILES if t <= preferred]
    for resident in (True, False):
        for tile in tiles:
            if 4 * _smem_layout(widths, tile, resident)[-1] <= smem_bytes:
                return tile, resident
    return None


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


def _plain(x0, layers, n_steps, step_size, noise_scale, seed, clamp, noise) -> Tensor:
    layers = [(w.detach(), b.detach()) for w, b in layers]
    sched = _schedule_table(float(step_size), float(noise_scale), int(n_steps), x0.device)
    return _run_plain(x0, lambda x: _mlp_grad(x, layers), sched, x0.shape[1], clamp, seed,
                      noise, None)[1]


def mlp_langevin_chain_plain(x0: Tensor, layers: Layers, n_steps: int, step_size: float,
                             noise_scale: float = 1.0, *, seed: int = 0, clamp=None,
                             noise: Optional[Tensor] = None) -> Tensor:
    """Plain PyTorch version of :func:`mlp_langevin_chain`, on ``x0``'s
    device: the same update, gradient and Philox stream."""
    _mlp_args(x0, layers, n_steps, noise)
    _seed_words(seed)
    return _plain(x0, layers, n_steps, step_size, noise_scale, seed, clamp, noise)


def _pack(layers: Layers) -> Tensor:
    """The kernel's weight buffer: per hidden layer ``W_i`` with rows padded
    by one zero, then ``b_i``; then ``w_out``."""
    parts = []
    for w, b in layers[:-1]:
        parts += [F.pad(w.detach(), (0, 1)).reshape(-1), b.detach()]
    parts.append(layers[-1][0].detach().reshape(-1))
    return torch.cat(parts)


@_build.counted
def mlp_langevin_chain(
    x0: Tensor,
    layers: Layers,
    n_steps: int,
    step_size: float,
    noise_scale: float = 1.0,
    *,
    seed: int = 0,
    clamp: Optional[Tuple[float, float]] = None,
    noise: Optional[Tensor] = None,
) -> Tensor:
    """Full n-step Langevin chain on a SiLU-MLP energy in one kernel launch.

    ``x0``: ``(n_chains, d)`` float32; ``layers``: :func:`extract_mlp_layers`'s
    list. Returns the final state, with no gradient.
    """
    widths = _mlp_args(x0, layers, n_steps, noise)
    seed_lo, seed_hi = _seed_words(seed)
    if x0.device.type == "cpu":
        return _plain(x0, layers, n_steps, step_size, noise_scale, seed, clamp, noise)
    n = x0.shape[0]
    tile, resident = launch_plan(n, widths, x0.device)
    layout = _smem_layout(widths, tile, resident)
    packed = _pack(layers)
    out = torch.empty_like(x0)
    use_clamp, lo, hi = _clamp_args(clamp)
    c_widths = (ctypes.c_int * len(widths))(*widths)
    c_layout = (ctypes.c_int * len(layout))(*layout)
    eta = float(step_size)
    coef = float(noise_scale) * math.sqrt(2.0 * eta)
    _build.launch(
        "mlp_langevin_chain", _SIGNATURE, x0.device,
        _ptr(x0), _ptr(out), _ptr(packed), _ptr(noise), ctypes.addressof(c_widths),
        ctypes.addressof(c_layout), len(widths) - 1, n, tile, int(n_steps), eta, coef,
        use_clamp, lo, hi, seed_lo, seed_hi,
    )
    mlp_langevin_chain.launches += 1
    return out
