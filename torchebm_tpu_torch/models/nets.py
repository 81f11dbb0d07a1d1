r"""Ready-made networks: the SiLU-MLP energy, the time-conditioned MLP vector
field and a conv energy for image EBMs.

PyTorch counterpart of :mod:`torchebm_tpu.models.nets`. The energies are
``nn.Module``\ s mapping a batch to ``(B,)`` float32 energies; wrap them with
:func:`~torchebm_tpu_torch.core.as_energy`. PyTorch needs the input sizes
when a module is built (flax infers them at ``init``), so ``MLPEnergy`` and
``MLPVelocityField`` take ``input_dim`` and ``ConvEnergy2D`` ``in_channels``
and ``image_size``.

The weights start as flax's ``Dense``/``Conv`` defaults: LeCun-normal
kernels (a normal of variance 1/fan-in truncated at two standard deviations)
and zero biases. :mod:`~torchebm_tpu_torch.utils.convert` carries the JAX
package's trained weights across.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

__all__ = ["MLPEnergy", "MLPVelocityField", "ConvEnergy2D"]

#: the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _lecun_init(layer: nn.Module) -> nn.Module:
    """flax's default init: truncated LeCun-normal weights, zero bias."""
    fan_in = layer.weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(layer.weight, std=std, a=-2.0 * std, b=2.0 * std)
    nn.init.zeros_(layer.bias)
    return layer


def _linear(layer: nn.Linear, h: Tensor) -> Tensor:
    """``layer`` applied in ``h``'s dtype; the parameters keep their own (as
    flax's ``dtype=`` computes in bf16 over float32 parameters)."""
    return F.linear(h, layer.weight.to(h.dtype), layer.bias.to(h.dtype))


class MLPEnergy(nn.Module):
    """Scalar energy MLP ``(B, input_dim) -> (B,)`` with SiLU activations.

    ``layers`` holds the hidden ``Linear`` layers and the output layer; this
    exact class carries the ``silu_mlp`` tag through
    :func:`~torchebm_tpu_torch.core.as_energy`, which the neural Langevin
    chain kernel dispatches on.
    """

    def __init__(self, input_dim: int, hidden_dims: Sequence[int] = (128, 128),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_dim = int(input_dim)
        self.hidden_dims = tuple(int(h) for h in hidden_dims)
        self.dtype = dtype
        widths = (self.input_dim, *self.hidden_dims, 1)
        self.layers = nn.ModuleList(
            _lecun_init(nn.Linear(i, o)) for i, o in zip(widths[:-1], widths[1:])
        )

    def forward(self, x: Tensor) -> Tensor:
        h = x.reshape(x.shape[0], -1).to(self.dtype)
        for layer in self.layers[:-1]:
            h = F.silu(_linear(layer, h))
        return _linear(self.layers[-1], h).squeeze(-1).to(torch.float32)


class MLPVelocityField(nn.Module):
    """Time-conditioned vector field ``(x, t) -> dx`` for flow and EqM
    training, ``(B, input_dim), (B,) -> (B, input_dim)`` float32.

    Time enters through a sinusoidal embedding of ``time_embed_dim`` entries
    concatenated after ``x``, then a SiLU MLP.
    """

    def __init__(self, input_dim: int, hidden_dims: Sequence[int] = (128, 128, 128),
                 time_embed_dim: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_dim = int(input_dim)
        self.hidden_dims = tuple(int(h) for h in hidden_dims)
        self.time_embed_dim = int(time_embed_dim)
        self.dtype = dtype
        widths = (self.input_dim + self.time_embed_dim, *self.hidden_dims, self.input_dim)
        self.layers = nn.ModuleList(
            _lecun_init(nn.Linear(i, o)) for i, o in zip(widths[:-1], widths[1:])
        )

    def forward(self, x: Tensor, t: Tensor) -> Tensor:
        from .components.embeddings import MLPTimestepEmbedder

        te = MLPTimestepEmbedder.sinusoidal_embedding(t, self.time_embed_dim)
        h = torch.cat([x, te.to(x.dtype)], dim=-1).to(self.dtype)
        for layer in self.layers[:-1]:
            h = F.silu(_linear(layer, h))
        return _linear(self.layers[-1], h).to(torch.float32)


def _same_pads(size: int, kernel: int = 3, stride: int = 2) -> Tuple[int, int]:
    """``(before, after)`` padding of XLA's ``SAME``: output ``ceil(size /
    stride)``, the odd pixel after (28 → 14 pads (0, 1); 7 → 4 pads (1, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvEnergy2D(nn.Module):
    """Convolutional scalar energy for image EBMs: ``(B, C, H, W) -> (B,)``.

    Strided 3×3 SiLU convolutions with XLA's ``SAME`` padding, then a SiLU
    dense layer and a scalar head (the swish convnet of Du & Mordatch 2019).
    The features are flattened in H·W·C order, as the JAX package flattens
    its NHWC maps, so flax weights carry across unpermuted.
    ``data_format="NHWC"`` takes channels-last input.
    """

    def __init__(self, in_channels: int = 1, image_size: Tuple[int, int] = (28, 28),
                 channels: Sequence[int] = (32, 64, 64), dense_dim: int = 128,
                 dtype: torch.dtype = torch.float32, data_format: str = "NCHW"):
        super().__init__()
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"data_format must be 'NCHW' or 'NHWC', got {data_format!r}")
        self.channels = tuple(int(c) for c in channels)
        self.dtype = dtype
        self.data_format = data_format
        self.pads = []
        convs = []
        h, w = image_size
        c_in = in_channels
        for c_out in self.channels:
            self.pads.append((*_same_pads(w), *_same_pads(h)))  # F.pad order: W, then H
            convs.append(_lecun_init(nn.Conv2d(c_in, c_out, 3, stride=2)))
            h, w, c_in = -(-h // 2), -(-w // 2), c_out
        self.convs = nn.ModuleList(convs)
        self.dense = _lecun_init(nn.Linear(h * w * c_in, dense_dim))
        self.head = _lecun_init(nn.Linear(dense_dim, 1))

    def forward(self, x: Tensor) -> Tensor:
        h = x.permute(0, 3, 1, 2) if self.data_format == "NHWC" else x
        h = h.to(self.dtype)
        for pad, conv in zip(self.pads, self.convs):
            w, b = conv.weight.to(h.dtype), conv.bias.to(h.dtype)
            h = F.silu(F.conv2d(F.pad(h, pad), w, b, stride=2))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # H·W·C, the NHWC flatten
        h = F.silu(_linear(self.dense, h))
        return _linear(self.head, h).squeeze(-1).to(torch.float32)
