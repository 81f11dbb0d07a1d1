"""``BaseTrainer.train_step`` with ``EquilibriumMatchingLoss``, AdamW and an
EMA: one call is one step on one batch.

Set-up builds one trainer and state, drives it through the checked steps
(``check_steps`` batches of the pool, all different) and the warm-up steps,
and hands that same state to the window. The check compares those first
steps with the reference on the same weights, batches and draws (the loss's
noise and times come from the state's generator, seeded by the run): each
step's loss, each parameter's gradient norm as the optimizer got it (AdamW's
first moment after one step over ``1 - beta1``), and the norms of each
parameter's and EMA entry's change after the last checked step. A norm is
compared as the gap between the program's and the reference's over the
larger of the reference's norm of that leaf and the median leaf's; leaves
whose reference gradient is under a thousandth of the median leaf's are left
out, and so are the entries whose reference gradient is under a thousandth
of the median leaf's root mean square (a key's bias under softmax, the
label rows a batch does not use): they move by round-off alone under Adam.
"""

from __future__ import annotations

import functools
import statistics
import time

import torch

from perfbench import generate
from perfbench.entries import free, stamp, sync
from perfbench.counts import dit as dit_counts
from perfbench.reference import dit as ref_dit
from perfbench.reference import lowered, strict_float32
from perfbench.systems import label_dit

#: leaves whose reference gradient norm is under this share of the median
#: leaf's are not compared
SILENT_LEAF = 1e-3


def _batch(pool, i):
    b = pool[i % len(pool)]
    return b["x"], {"y": b["y"], "drop": b["drop"]}


class Cell:
    def __init__(self, config, traffic, seed, device):
        from torchebm_tpu_torch.core import BaseTrainer
        from torchebm_tpu_torch.losses import EquilibriumMatchingLoss

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        t = time.perf_counter()
        opt, eqm = config["optimizer"], config["eqm"]
        weights = generate.make_weights(ref_dit.param_layout(config), seed, device)
        t = stamp("weights", t)
        model = label_dit.build(config, weights, device)
        t = stamp("model", t)
        loss = EquilibriumMatchingLoss(
            model, prediction=eqm["prediction"], energy_type=eqm["energy_type"],
            interpolant=eqm["interpolant"], coupling=eqm["coupling"],
            ct_threshold=eqm["ct_threshold"], ct_multiplier=eqm["ct_multiplier"],
            time_invariant=eqm["time_invariant"])
        self.trainer = BaseTrainer(
            loss, functools.partial(torch.optim.AdamW, lr=opt["lr"], betas=tuple(opt["betas"]),
                                    eps=opt["eps"], weight_decay=opt["weight_decay"]),
            ema_decay=opt["ema_decay"])
        self.state = self.trainer.init_state(model, generate.generator(seed, "draws", device))
        self.pool = generate.make_pool(traffic, config, seed, device)
        self.units = traffic["batch"]
        self.work = {"flops_per_call": dit_counts.train_step_flops(config, traffic["batch"]),
                     "peak": "bf16_flops"}
        t = stamp("trainer and inputs", t)
        losses = []
        n_check = traffic["check_steps"]
        for i in range(n_check):
            self.state, metrics = self.trainer.train_step(self.state, _batch(self.pool, i))
            losses.append(metrics["loss"])
            if i == 0:
                # AdamW's first moment after one step is (1 - beta1) times the
                # gradient it got; a parameter it holds no state for got none
                moments = self.state.optimizer.state
                self._grad = _norms({
                    n: moments[p]["exp_avg"] / (1 - opt["betas"][0]) if "exp_avg" in moments[p]
                    else torch.zeros_like(p) for n, p in model.named_parameters()})
        self._losses = [float(v) for v in losses]
        self._update = {n: (p.detach() - weights[n]).cpu() for n, p in model.named_parameters()}
        self._ema = {n: (e - weights[n]).cpu() for n, e in self.state.ema_params.items()}
        del weights
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
        weights = generate.make_weights(ref_dit.param_layout(cfg), self.seed, dev)
        pool = generate.make_pool(tr, cfg, self.seed, dev)
        rows = tr["batch"] // 2 if half_batch else tr["batch"]
        batches = [(b["x"][:rows], b["y"][:rows], b["drop"][:rows])
                   for b in pool[:tr["check_steps"]]]
        with strict_float32():
            return ref_dit.train(weights, cfg, cfg["optimizer"], cfg["eqm"], batches,
                                 generate.generator(self.seed, "draws", dev), tr["check_steps"],
                                 tr["reference_block_rows"], lowered(precision))


def _norms(tensors) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def _leaf_gap(got: dict, want: dict, keep) -> float:
    floor = statistics.median(want[k] for k in keep)
    return max(abs(got[k] - want[k]) / max(want[k], floor) for k in keep)


def _masked_norms(tensors: dict, masks: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(tensors[k].to(m.device)[m].double()))
            for k, m in masks.items()}


def compare(got: dict, want: dict) -> dict:
    med = statistics.median(want["grad"].values())
    keep = [k for k, v in want["grad"].items() if v >= SILENT_LEAF * med]
    rms = statistics.median(float(torch.linalg.vector_norm(g) / g.numel() ** 0.5)
                            for g in want["grad_t"].values())
    masks = {k: want["grad_t"][k].abs() >= SILENT_LEAF * rms for k in keep}
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
           "grad_norm_gap": _leaf_gap(got["grad"], want["grad"], keep)}
    for key in ("update", "ema"):
        out[f"{key}_norm_gap"] = _leaf_gap(_masked_norms(got[key], masks),
                                           _masked_norms(want[key], masks), keep)
    return out


def setup(config, traffic, seed, device):
    return Cell(config, traffic, seed, device)
