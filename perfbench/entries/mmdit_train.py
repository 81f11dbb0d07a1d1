"""``BaseTrainer.train_step`` of SD3's MMDiT with ``EquilibriumMatchingLoss``,
AdamW and an EMA: one call is one step on one batch of latents, text
features and pooled vectors.

As :mod:`perfbench.entries.eqm_train`, on the text-conditioned model: set-up
builds one trainer and state, drives it through the checked steps and the
warm-up steps, and hands that state to the window; the check compares those
first steps with the reference on the same weights, batches and draws, by
:func:`perfbench.entries.eqm_train.compare`. At 2.03 B parameters each
tensor reading (a change of the parameters or of the EMA, the reference's
first gradients) is 8.1 GB: the program's are kept in host memory while the
window runs, and the reference's on the card, where nothing else is left
when it runs.
"""

from __future__ import annotations

import functools
import time

import torch

from perfbench import generate
from perfbench.counts import mmdit as mmdit_counts
from perfbench.entries import free, stamp, sync
from perfbench.entries.eqm_train import _norms, compare  # noqa: F401  (the harness's compare)
from perfbench.reference import lowered, strict_float32
from perfbench.reference import mmdit as ref_mmdit
from perfbench.systems import sd3_mmdit


def _batch(pool, i):
    b = pool[i % len(pool)]
    return b["x"], {"context": b["context"], "pooled": b["pooled"]}


class Cell:
    def __init__(self, config, traffic, seed, device):
        from torchebm_tpu_torch.core import BaseTrainer
        from torchebm_tpu_torch.losses import EquilibriumMatchingLoss

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        t = time.perf_counter()
        opt, eqm = config["optimizer"], config["eqm"]
        weights = generate.make_weights(ref_mmdit.param_layout(config), seed, device)
        t = stamp("weights", t)
        model = sd3_mmdit.build(config, weights, device)
        t = stamp("model", t)
        loss = EquilibriumMatchingLoss(
            model, prediction=eqm["prediction"], energy_type=eqm["energy_type"],
            interpolant=eqm["interpolant"], coupling=eqm["coupling"],
            ct_threshold=eqm["ct_threshold"], ct_multiplier=eqm["ct_multiplier"],
            time_invariant=eqm["time_invariant"])
        self.trainer = BaseTrainer(
            loss, functools.partial(torch.optim.AdamW, lr=opt["lr"], betas=tuple(opt["betas"]),
                                    eps=opt["eps"], weight_decay=opt["weight_decay"]),
            ema_decay=opt["ema_decay"], cuda_graph=config["cuda_graph"])
        self.state = self.trainer.init_state(model, generate.generator(seed, "draws", device))
        self.pool = generate.make_pool(traffic, config, seed, device)
        self.units = traffic["batch"]
        self.work = {"flops_per_call": mmdit_counts.train_step_flops(config, traffic["batch"]),
                     "peak": "bf16_flops"}
        t = stamp("trainer and inputs", t)
        losses = []
        n_check = traffic["check_steps"]
        for i in range(n_check):
            self.state, metrics = self.trainer.train_step(self.state, _batch(self.pool, i))
            losses.append(metrics["loss"])
            if i == 0:
                # AdamW's first moment after one step is (1 - beta1) times the
                # gradient it got
                moments = self.state.optimizer.state
                self._grad = _norms({
                    n: moments[p]["exp_avg"] / (1 - opt["betas"][0]) if "exp_avg" in moments[p]
                    else torch.zeros_like(p) for n, p in model.named_parameters()})
        self._losses = [float(v) for v in losses]
        self._update = {n: (p.detach() - weights[n]).cpu() for n, p in model.named_parameters()}
        self._ema = {n: (e - weights[n]).cpu() for n, e in self.state.ema_params.items()}
        del weights
        free(device)
        t = stamp("checked steps", t)
        self.offset = n_check
        for i in range(traffic["warmup_steps"]):
            self.call(i)
        self.offset += traffic["warmup_steps"]
        sync(device)
        stamp("warm-up steps", t)

    def call(self, i):
        self.state, metrics = self.trainer.train_step(self.state,
                                                      _batch(self.pool, self.offset + i))
        return metrics["loss"]

    def readings(self) -> dict:
        return {"losses": self._losses, "grad": self._grad, "update": self._update,
                "ema": self._ema}

    def release(self):
        self.state = self.trainer = self.pool = None
        free(self.device)

    def reference(self, got, precision=None, half_batch=False) -> dict:
        """The reference's readings; ``half_batch`` plants a fault in it:
        each step on the first half of its batch's rows."""
        cfg, tr, dev = self.config, self.traffic, self.device
        weights = generate.make_weights(ref_mmdit.param_layout(cfg), self.seed, dev)
        pool = generate.make_pool(tr, cfg, self.seed, dev)
        rows = tr["batch"] // 2 if half_batch else tr["batch"]
        batches = [(b["x"][:rows], b["context"][:rows], b["pooled"][:rows])
                   for b in pool[:tr["check_steps"]]]
        del pool
        with strict_float32():
            out = ref_mmdit.train(weights, cfg, cfg["optimizer"], cfg["eqm"], batches,
                                  generate.generator(self.seed, "draws", dev), tr["check_steps"],
                                  tr["reference_block_rows"], lowered(precision))
        del weights, batches
        free(dev)
        return out


def setup(config, traffic, seed, device):
    return Cell(config, traffic, seed, device)
