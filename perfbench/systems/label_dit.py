"""The label-conditioned DiT of the library's CFG example
(``examples/90-showcase/dit_cfg_digits/main.py``), composed of the port's
``MLPTimestepEmbedder``, ``LabelEmbedder`` and ``ConditionalTransformer2D``:
the conditioning is the timestep embedding plus the label embedding.

``drop`` (bool, one per row), passed as a model keyword, replaces labels by
the null label through the embedder's ``force_drop_mask``: the traffic draws
classifier-free guidance's label dropout, so the program and the reference
drop the same rows.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def build(cfg: dict, weights: Dict[str, torch.Tensor], device) -> nn.Module:
    """The program's LabelDiT for ``cfg`` on ``device`` holding ``weights``
    (every parameter, by name)."""
    from torchebm_tpu_torch.models import (
        ConditionalTransformer2D,
        LabelEmbedder,
        MLPTimestepEmbedder,
    )

    dtype = getattr(torch, cfg["dtype"])

    class LabelDiT(nn.Module):
        def __init__(self):
            super().__init__()
            self.t_embed = MLPTimestepEmbedder(
                cfg["embed_dim"], frequency_embedding_size=cfg["frequency_embedding_size"],
                dtype=dtype)
            self.y_embed = LabelEmbedder(cfg["num_classes"], cfg["embed_dim"],
                                         dropout_prob=cfg["label_dropout"])
            self.dit = ConditionalTransformer2D(
                in_channels=cfg["in_channels"], out_channels=cfg["out_channels"],
                input_size=cfg["input_size"], patch_size=cfg["patch_size"],
                embed_dim=cfg["embed_dim"], depth=cfg["depth"], num_heads=cfg["num_heads"],
                cond_dim=cfg["cond_dim"], mlp_ratio=cfg["mlp_ratio"], dtype=dtype)

        def forward(self, x, t, *, y, drop=None):
            c = self.t_embed(t) + self.y_embed(y, force_drop_mask=drop)
            return self.dit(x, c)

    with torch.device(device):
        model = LabelDiT()
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise KeyError(f"parameters differ from the layout: {sorted(set(params) ^ set(weights))}")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != weights[name].shape:
                raise ValueError(f"{name}: {tuple(p.shape)} against {tuple(weights[name].shape)}")
            p.copy_(weights[name])
    return model
