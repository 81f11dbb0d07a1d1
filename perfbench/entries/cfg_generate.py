"""Class-conditional generation: ``FlowSampler(model=LabelClassifierFreeGuidance(
LabelDiT), integrator="euler").sample`` of one batch; one call is one batch.

The check takes ``check_calls`` calls of the window, drawn from the seed,
and ``check_rows`` of each call's rows, drawn from the seed (a row's samples
depend on its own start and label alone), and runs the reference's guided
Euler over those rows' starts and labels. The number compared is the widest
per-row gap, ``|x - x_ref| / |x_ref|`` over the row's samples.
"""

from __future__ import annotations


import torch

from perfbench import generate
from perfbench.counts import dit as dit_counts
from perfbench.entries import Reservoir, free, sync
from perfbench.reference import dit as ref_dit
from perfbench.reference import lowered, strict_float32
from perfbench.systems import label_dit


class Cell:
    def __init__(self, config, traffic, seed, device):
        from torchebm_tpu_torch.models import LabelClassifierFreeGuidance
        from torchebm_tpu_torch.samplers import FlowSampler

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        net = label_dit.build(config, generate.make_weights(ref_dit.param_layout(config), seed,
                                                             device), device)
        guided = LabelClassifierFreeGuidance(base=net, null_label_id=net.y_embed.null_label_id,
                                             cfg_scale=traffic["cfg_scale"],
                                             guide_channels=traffic["guide_channels"])
        self.sampler = FlowSampler(model=guided, integrator="euler")
        self.gen = generate.generator(seed, "sampler", device)
        self.pool = generate.make_pool(traffic, config, seed, device)
        self.units = traffic["batch"]
        self.work = {"flops_per_call": dit_counts.cfg_generation_flops(
            config, traffic["batch"], traffic["n_steps"]), "peak": "bf16_flops"}
        self.keep = Reservoir(traffic["check_calls"], generate.subseed(seed, "keep"))
        for i in range(traffic["warmup_calls"]):
            self._sample(i)
        self.offset = traffic["warmup_calls"]
        sync(device)

    def _sample(self, i):
        b = self.pool[i % len(self.pool)]
        return self.sampler.sample(self.gen, x=b["x"], n_steps=self.traffic["n_steps"],
                                   model_kwargs={"y": b["y"]})

    def call(self, i):
        slot = self.keep.slot()
        out = self._sample(self.offset + i)
        if slot is not None:
            self.keep.kept[slot] = ((self.offset + i) % len(self.pool), out)
        return out

    def _rows(self):
        g = generate.generator(self.seed, "rows", "cpu")
        return torch.randperm(self.traffic["batch"], generator=g)[:self.traffic["check_rows"]]

    def readings(self) -> dict:
        rows = self._rows().to(self.device)
        return {slot: (k, out[rows].clone()) for slot, (k, out) in self.keep.kept.items()}

    def release(self):
        self.sampler = self.pool = None
        self.keep.kept = {}
        free(self.device)

    def reference(self, got, precision=None) -> dict:
        """The reference's samples of the rows of the calls in ``got``."""
        cfg, tr = self.config, self.traffic
        weights = generate.make_weights(ref_dit.param_layout(cfg), self.seed, self.device)
        pool = generate.make_pool(tr, cfg, self.seed, self.device)
        rows = self._rows().to(self.device)
        out = {}
        with strict_float32():
            for slot, (k, _) in got.items():
                b = pool[k]
                out[slot] = (k, ref_dit.cfg_euler(weights, cfg, b["x"][rows], b["y"][rows],
                                                  tr["n_steps"], tr["cfg_scale"],
                                                  tr["guide_channels"], lowered(precision)))
        return out


def compare(got: dict, want: dict) -> dict:
    gaps = []
    for slot, (k, x) in got.items():
        kw, ref = want[slot]
        if kw != k:
            raise ValueError(f"slot {slot}: batch {k} against the reference's {kw}")
        per_row = (torch.linalg.vector_norm((x - ref).flatten(1), dim=1)
                   / torch.linalg.vector_norm(ref.flatten(1), dim=1))
        gaps.append(float(per_row.max()))
    return {"sample_gap": max(gaps)}


def setup(config, traffic, seed, device):
    return Cell(config, traffic, seed, device)
