"""SD3's MMDiT as the port builds it: ``JointTransformer2D`` at the
configuration's widths and depth, computing in its ``dtype``, holding the
weights the benchmark drew (every parameter, by name). The text features and
the pooled vector reach it as the model keywords ``context`` and
``pooled``."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def build(cfg: dict, weights: Dict[str, torch.Tensor], device) -> nn.Module:
    """The program's MMDiT for ``cfg`` on ``device`` holding ``weights``."""
    from torchebm_tpu_torch.models import JointTransformer2D

    with torch.device(device):
        model = JointTransformer2D(
            in_channels=cfg["in_channels"], out_channels=cfg["out_channels"],
            sample_size=cfg["sample_size"], patch_size=cfg["patch_size"],
            embed_dim=cfg["num_attention_heads"] * cfg["attention_head_dim"],
            depth=cfg["num_layers"], num_heads=cfg["num_attention_heads"],
            context_dim=cfg["joint_attention_dim"], pooled_dim=cfg["pooled_projection_dim"],
            pos_embed_max_size=cfg["pos_embed_max_size"], mlp_ratio=cfg["mlp_ratio"],
            frequency_embedding_size=cfg["frequency_embedding_size"],
            dtype=getattr(torch, cfg["dtype"]))
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise KeyError(f"parameters differ from the layout: {sorted(set(params) ^ set(weights))}")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != weights[name].shape:
                raise ValueError(f"{name}: {tuple(p.shape)} against {tuple(weights[name].shape)}")
            p.copy_(weights[name])
    return model
