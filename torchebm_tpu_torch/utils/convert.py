"""Carry parameters across from the JAX package.

The JAX package's energies keep their parameters as arrays and its
schedulers as static fields. Given those as numpy arrays (or Python numbers),
these functions build the port's objects with the same values, so both
packages can be run on one set of parameters:

    energy_from_arrays("GaussianMixtureEnergy",
                       {"means": m, "scale": s, "log_weights": lw}, device)
    sampler_from_fields("HamiltonianMonteCarlo",
                        {"step_size": 0.3, "n_leapfrog_steps": 8, "mass": mass}, energy)

Networks come across from their flax parameter trees (numpy arrays under
``Dense_i``/``Conv_i``): a flax ``Dense`` kernel is ``(in, out)`` where a
``Linear`` weight is ``(out, in)``, and a flax ``Conv`` kernel is HWIO where
``Conv2d`` takes OIHW:

    mlp_energy_from_flax(params)                       # MLPEnergy
    conv_energy_from_flax(params, image_size=(28, 28)) # ConvEnergy2D
    mlp_velocity_field_from_flax(params)               # MLPVelocityField
    conditional_transformer_2d_from_flax(params, num_heads=12, input_size=32,
                                         patch_size=4)  # ConditionalTransformer2D
    label_embedder_from_flax(params, dropout_prob=0.1)  # LabelEmbedder

A model that nests these (a label-conditioned DiT) converts each subtree:
``conditional_transformer_2d_from_flax(tree["ConditionalTransformer2D_0"],
...)``, ``label_embedder_from_flax(tree["LabelEmbedder_0"], 0.1)``.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from .. import samplers
from ..core import energies, schedulers
from ..core.module import default_device
from ..models.components import LabelEmbedder
from ..models.conditional_transformer_2d import ConditionalTransformer2D
from ..models.nets import ConvEnergy2D, MLPEnergy, MLPVelocityField

__all__ = [
    "conditional_transformer_2d_from_flax",
    "conv_energy_from_flax",
    "energy_from_arrays",
    "label_embedder_from_flax",
    "mlp_energy_from_flax",
    "mlp_velocity_field_from_flax",
    "sampler_from_fields",
    "scheduler_from_fields",
]

#: energy name -> the names of its tensor buffers; every other field is a float
_BUFFERS = {
    "GaussianMixtureEnergy": ("means", "scale", "log_weights"),
    "GaussianEnergy": ("mean", "cov", "cov_inv"),
}
_SCALAR_ENERGIES = (
    "DoubleWellEnergy", "HarmonicEnergy", "RosenbrockEnergy", "AckleyEnergy", "RastriginEnergy",
)


def energy_from_arrays(name: str, arrays: Mapping[str, Any],
                       device: Optional[torch.device] = None) -> energies.Energy:
    """The port's energy ``name`` with the JAX package's field values.

    Buffer fields (means, covariances, log-weights) become float32 tensors on
    ``device`` (by default the current CUDA device when there is one, else
    the CPU); scalar fields (barrier height, ...) become Python floats.
    """
    device = default_device() if device is None else device
    if name in _BUFFERS:
        fields = _BUFFERS[name]
        missing = set(fields) - set(arrays)
        if missing:
            raise ValueError(f"{name} needs arrays {sorted(missing)}")
        tensors = {
            f: torch.tensor(np.asarray(arrays[f], dtype=np.float32), device=device)
            for f in fields
        }
        return getattr(energies, name)(**tensors)
    if name in _SCALAR_ENERGIES:
        return getattr(energies, name)(**{f: float(v) for f, v in arrays.items()})
    raise ValueError(
        f"Unknown energy '{name}'. Available: {sorted([*_BUFFERS, *_SCALAR_ENERGIES])}"
    )


def scheduler_from_fields(name: str, fields: Mapping[str, Any]) -> schedulers.BaseScheduler:
    """The port's scheduler ``name`` built from the JAX scheduler's static
    fields. A nested scheduler (``WarmupScheduler.main_scheduler``) is given
    as a ``(name, fields)`` pair."""
    cls = getattr(schedulers, name, None)
    base = schedulers.BaseScheduler
    if not (isinstance(cls, type) and issubclass(cls, base)) or cls is base:
        raise ValueError(f"Unknown scheduler '{name}'")
    kwargs = {
        f: scheduler_from_fields(*v) if isinstance(v, tuple) and len(v) == 2
        and isinstance(v[0], str) else v
        for f, v in fields.items()
    }
    return cls(**kwargs)


#: the samplers :func:`sampler_from_fields` builds
_SAMPLERS = (
    "LangevinDynamics", "MetropolisAdjustedLangevin", "HamiltonianMonteCarlo",
    "GradientDescentSampler", "ParallelTemperingLangevin", "FlowSampler",
)


def sampler_from_fields(name: str, fields: Mapping[str, Any],
                        energy: Any) -> samplers.BaseSampler:
    """The port's sampler ``name`` on ``energy`` (for ``"FlowSampler"`` the
    field ``model(x, t)``), built from the JAX sampler's field values;
    interpolants and integrators are given by their registry names.

    Numbers and strings pass as they are; a numpy array (an HMC ``mass``)
    becomes a float32 tensor on the device of ``energy``'s buffers (the CPU
    when it has none); a scheduler is given as a ``(name, fields)`` pair, as
    in :func:`scheduler_from_fields`.
    """
    if name not in _SAMPLERS:
        raise ValueError(f"Unknown sampler '{name}'. Available: {sorted(_SAMPLERS)}")
    buffers = energy.buffers() if isinstance(energy, torch.nn.Module) else ()
    device = next(iter(buffers), torch.empty(0)).device

    def convert(v):
        if isinstance(v, np.ndarray):
            return torch.tensor(v.astype(np.float32), device=device)
        if isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], str):
            return scheduler_from_fields(*v)
        return v

    return getattr(samplers, name)(model=energy, **{f: convert(v) for f, v in fields.items()})


def _tree(params: Mapping[str, Any]) -> Mapping[str, Any]:
    """A flax tree with its ``params`` collection unwrapped."""
    return params["params"] if "params" in params else params


def _flax_layers(params: Mapping[str, Any], prefix: str) -> list:
    """``[(kernel, bias), ...]`` of ``<prefix>_0, <prefix>_1, ...`` as float32
    numpy arrays, in index order."""
    tree = _tree(params)
    names = sorted((n for n in tree if n.startswith(f"{prefix}_")),
                   key=lambda n: int(n.split("_")[1]))
    return [(np.array(tree[n]["kernel"], np.float32), np.array(tree[n]["bias"], np.float32))
            for n in names]


@torch.no_grad()
def _load_linear(layer: torch.nn.Linear, kernel: np.ndarray, bias: np.ndarray) -> None:
    if kernel.shape != (layer.in_features, layer.out_features):
        raise ValueError(f"Dense kernel {kernel.shape} does not fit {layer}")
    layer.weight.copy_(torch.from_numpy(kernel.T.copy()))
    layer.bias.copy_(torch.from_numpy(bias))


def mlp_energy_from_flax(params: Mapping[str, Any],
                         device: Optional[torch.device] = None) -> MLPEnergy:
    """The port's :class:`MLPEnergy` with the weights of the JAX package's
    ``MLPEnergy`` parameter tree (``Dense_0 ... Dense_L``), on ``device``
    (by default the current CUDA device when there is one, else the CPU)."""
    dense = _flax_layers(params, "Dense")
    if len(dense) < 1 or dense[-1][0].shape[1] != 1:
        raise ValueError("an MLPEnergy tree is a Dense_0..Dense_L stack ending in one output")
    net = MLPEnergy(dense[0][0].shape[0], [k.shape[1] for k, _ in dense[:-1]])
    for layer, (kernel, bias) in zip(net.layers, dense):
        _load_linear(layer, kernel, bias)
    return net.to(default_device() if device is None else device)


def mlp_velocity_field_from_flax(params: Mapping[str, Any], time_embed_dim: int = 32,
                                 device: Optional[torch.device] = None) -> MLPVelocityField:
    """The port's :class:`MLPVelocityField` with the weights of the JAX
    package's ``MLPVelocityField`` parameter tree (``Dense_0 ... Dense_L``; the
    first kernel's rows are ``x`` then the ``time_embed_dim`` embedding
    entries, the order both packages concatenate them in). On ``device``, as
    :func:`mlp_energy_from_flax`."""
    dense = _flax_layers(params, "Dense")
    d = dense[-1][0].shape[1] if dense else 0
    if len(dense) < 1 or dense[0][0].shape[0] != d + time_embed_dim:
        raise ValueError("an MLPVelocityField tree is a Dense_0..Dense_L stack from "
                         "d + time_embed_dim inputs to d outputs")
    net = MLPVelocityField(d, [k.shape[1] for k, _ in dense[:-1]], time_embed_dim)
    for layer, (kernel, bias) in zip(net.layers, dense):
        _load_linear(layer, kernel, bias)
    return net.to(default_device() if device is None else device)


def conv_energy_from_flax(params: Mapping[str, Any], image_size=(28, 28),
                          data_format: str = "NCHW",
                          device: Optional[torch.device] = None) -> ConvEnergy2D:
    """The port's :class:`ConvEnergy2D` with the weights of the JAX package's
    ``ConvEnergy2D`` parameter tree (``Conv_0 ...``, ``Dense_0``, ``Dense_1``).
    Both flatten the feature maps in H·W·C order, so the dense rows carry
    across as they are. On ``device``, as :func:`mlp_energy_from_flax`."""
    conv = _flax_layers(params, "Conv")
    dense = _flax_layers(params, "Dense")
    if not conv or len(dense) != 2:
        raise ValueError("a ConvEnergy2D tree holds Conv_0..Conv_n, Dense_0 and Dense_1")
    net = ConvEnergy2D(in_channels=conv[0][0].shape[2], image_size=tuple(image_size),
                       channels=[k.shape[3] for k, _ in conv], dense_dim=dense[0][0].shape[1],
                       data_format=data_format)
    with torch.no_grad():
        for layer, (kernel, bias) in zip(net.convs, conv):
            w = torch.from_numpy(kernel).permute(3, 2, 0, 1)  # HWIO -> OIHW
            if w.shape != layer.weight.shape:
                raise ValueError(f"Conv kernel {kernel.shape} does not fit {layer}")
            layer.weight.copy_(w)
            layer.bias.copy_(torch.from_numpy(bias))
    _load_linear(net.dense, *dense[0])
    _load_linear(net.head, *dense[1])
    return net.to(default_device() if device is None else device)


def _load_dense(layer: torch.nn.Linear, node: Mapping[str, Any]) -> None:
    _load_linear(layer, np.array(node["kernel"], np.float32), np.array(node["bias"], np.float32))


def conditional_transformer_2d_from_flax(params: Mapping[str, Any], *, num_heads: int,
                                         input_size: int, patch_size: int,
                                         mlp_ratio: float = 4.0,
                                         use_sincos_pos_embed: bool = True,
                                         dtype: torch.dtype = torch.float32,
                                         device: Optional[torch.device] = None
                                         ) -> ConditionalTransformer2D:
    """The port's :class:`ConditionalTransformer2D` with the weights of the
    JAX package's parameter tree (``ConvPatchEmbed2d_0/proj``, ``block_i/
    {MultiheadSelfAttention_0/{qkv, out_proj}, FeedForward_0/{Dense_0,
    Dense_1}, modulation}``, ``head/{modulation, proj}``). Widths, depth and
    channels are read from the kernels; what they do not fix is passed. On
    ``device``, as :func:`mlp_energy_from_flax`."""
    tree = _tree(params)
    p2 = patch_size * patch_size
    patch = tree["ConvPatchEmbed2d_0"]["proj"]
    head = tree["head"]
    depth = sum(1 for n in tree if n.startswith("block_"))
    c_p2, embed_dim = np.shape(patch["kernel"])
    cond_dim = np.shape(head["modulation"]["kernel"])[0]
    net = ConditionalTransformer2D(
        in_channels=int(c_p2) // p2,
        out_channels=int(np.shape(head["proj"]["kernel"])[1]) // p2,
        input_size=input_size, patch_size=patch_size, embed_dim=int(embed_dim), depth=depth,
        num_heads=num_heads, cond_dim=int(cond_dim),
        mlp_ratio=mlp_ratio, use_sincos_pos_embed=use_sincos_pos_embed, dtype=dtype)
    _load_dense(net.patch_embed.proj, patch)
    for i, block in enumerate(net.blocks):
        _load_block(block, tree[f"block_{i}"])
    _load_head(net.head, head)
    return net.to(default_device() if device is None else device)


def _load_attention(attn: torch.nn.Module, node: Mapping[str, Any]) -> None:
    """A ``MultiheadSelfAttention`` from its flax subtree ``{qkv, out_proj}``."""
    _load_dense(attn.qkv, node["qkv"])
    _load_dense(attn.out_proj, node["out_proj"])


def _load_feedforward(mlp: torch.nn.Module, node: Mapping[str, Any]) -> None:
    """A ``FeedForward`` from its flax subtree ``{Dense_0, Dense_1}``."""
    for j, layer in enumerate(mlp.layers):
        _load_dense(layer, node[f"Dense_{j}"])


def _load_block(block: torch.nn.Module, node: Mapping[str, Any]) -> None:
    """An ``AdaLNZeroBlock`` from its flax subtree."""
    _load_dense(block.modulation, node["modulation"])
    _load_attention(block.attn, node["MultiheadSelfAttention_0"])
    _load_feedforward(block.mlp, node["FeedForward_0"])


def _load_head(head: torch.nn.Module, node: Mapping[str, Any]) -> None:
    """An ``AdaLNZeroPatchHead`` from its flax subtree ``{modulation, proj}``."""
    _load_dense(head.modulation, node["modulation"])
    _load_dense(head.proj, node["proj"])


def label_embedder_from_flax(params: Mapping[str, Any], dropout_prob: float,
                             device: Optional[torch.device] = None) -> LabelEmbedder:
    """The port's :class:`LabelEmbedder` with the table of the JAX package's
    ``LabelEmbedder`` tree (``Embed_0/embedding``, one row more than classes
    when ``dropout_prob > 0``). On ``device``, as :func:`mlp_energy_from_flax`."""
    table = np.array(_tree(params)["Embed_0"]["embedding"], np.float32)
    rows = table.shape[0] - (1 if dropout_prob > 0 else 0)
    emb = LabelEmbedder(rows, table.shape[1], dropout_prob=dropout_prob)
    with torch.no_grad():
        emb.embed.weight.copy_(torch.from_numpy(table))
    return emb.to(default_device() if device is None else device)
