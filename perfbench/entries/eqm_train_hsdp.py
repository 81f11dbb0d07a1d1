"""``BaseTrainer.train_step`` of the DiT with ``EquilibriumMatchingLoss``,
AdamW and an EMA, sharded HSDP over four cards: one call is one step of the
whole mesh on one global batch.

The mesh is ``("data", "fsdp") = (2, 2)`` (``parallel.make_mesh``), the model
sharded by ``parallel.fsdp_shard_params`` (FSDP2 over ``"fsdp"``, replicated
over ``"data"``), on NCCL between cards (gloo on the CPU). Rank 0 is the
harness's process on its device; ``setup`` starts ranks 1 to 3 as spawned
processes on cards 1 to 3, joined through a TCP store on localhost. Every
rank runs :class:`_Replica`: the same set-up, checked steps, gathers and
warm-up steps, then one step per call index that rank 0 puts in the store;
``release`` puts a stop there and joins them. A rank that fails ends the
run: rank 0 watches the others and leaves at once (exit code 6) when one
dies, and a rank whose parent dies, or whose store goes away, leaves too.

Each global batch is an entry of the pool (the traffic's ``batch`` rows a
card times four), drawn alike on every rank from the seed; rank ``r`` steps
on rows ``[r·B, (r + 1)·B)`` with its own generator (``draws.<r>``) for the
loss's noise and times. The check holds the first ``check_steps`` steps
against the reference on the whole global batch, each rank's rows with that
rank's draws: the losses (the ranks' mean), the first step's gradients and
the changes of the parameters and the EMA, their shards gathered onto rank
0, by :func:`perfbench.entries.eqm_train.compare`. The fault the reference
can plant (``half_batch``): each step on the rows of one data replica
(ranks 0 and 1) alone.
"""

from __future__ import annotations

import functools
import math
import os
import threading
import time
from datetime import timedelta

import torch

from perfbench import generate
from perfbench.counts import dit as dit_counts
from perfbench.entries import free, stamp, sync
from perfbench.entries.eqm_train import _norms, compare  # noqa: F401  (the harness's compare)
from perfbench.reference import dit as ref_dit
from perfbench.reference import lowered, strict_float32
from perfbench.reference import mmdit as ref_mmdit
from perfbench.systems import label_dit

#: mesh axes and shape, and the world they cover
AXES, SHAPE = ("data", "fsdp"), (2, 2)
WORLD = math.prod(SHAPE)
#: seconds a rank waits for the store, for the process group's collectives,
#: and for the other ranks to stop
STORE_S, COLLECTIVE_S, JOIN_S = 600.0, 300.0, 60.0
#: what rank 0 puts under a call's key to stop the other ranks
STOP = "stop"
#: exit code of rank 0 when another rank died
LOST_RANK = 6


def _rows(traffic, rank):
    b = traffic["batch"]
    return slice(rank * b, (rank + 1) * b)


def _global_traffic(traffic):
    """The traffic with ``batch`` the global batch, for the pool's draws."""
    return {**traffic, "batch": traffic["batch"] * WORLD}


def _full(t):
    """A DTensor gathered whole on every rank (a collective), or ``t``."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


class _Replica:
    """One rank's trainer and state; every rank builds it alike, and the
    gathers of the checked steps are collectives that all ranks make."""

    def __init__(self, config, traffic, seed, device, rank):
        import torch.distributed as dist

        from torchebm_tpu_torch.core import BaseTrainer
        from torchebm_tpu_torch.losses import EquilibriumMatchingLoss
        from torchebm_tpu_torch.parallel import fsdp_shard_params, make_mesh

        self.traffic, self.device, self.rank = traffic, device, rank
        t = time.perf_counter()
        opt, eqm = config["optimizer"], config["eqm"]
        mesh = make_mesh(AXES, SHAPE, devices=device.type)
        weights = generate.make_weights(ref_dit.param_layout(config), seed, device)
        model = fsdp_shard_params(label_dit.build(config, weights, device), mesh)
        loss = EquilibriumMatchingLoss(
            model, prediction=eqm["prediction"], energy_type=eqm["energy_type"],
            interpolant=eqm["interpolant"], coupling=eqm["coupling"],
            ct_threshold=eqm["ct_threshold"], ct_multiplier=eqm["ct_multiplier"],
            time_invariant=eqm["time_invariant"])
        self.trainer = BaseTrainer(
            loss, functools.partial(torch.optim.AdamW, lr=opt["lr"], betas=tuple(opt["betas"]),
                                    eps=opt["eps"], weight_decay=opt["weight_decay"]),
            ema_decay=opt["ema_decay"])
        self.state = self.trainer.init_state(
            model, generate.generator(seed, f"draws.{rank}", device))
        self.pool = generate.make_pool(_global_traffic(traffic), config, seed, device)
        self.rows = _rows(traffic, rank)
        if rank == 0:
            t = stamp("mesh, model and inputs", t)
        losses = []
        n_check = traffic["check_steps"]
        for i in range(n_check):
            self.state, metrics = self.trainer.train_step(self.state, self.batch(i))
            losses.append(metrics["loss"].detach().float())
            if i == 0:
                moments = self.state.optimizer.state
                grad = {n: _full(moments[p]["exp_avg"]) / (1 - opt["betas"][0])
                        if "exp_avg" in moments[p] else torch.zeros_like(_full(p))
                        for n, p in model.named_parameters()}
                self.grad = _norms(grad) if rank == 0 else None
                del grad
        mean = torch.stack(losses)
        dist.all_reduce(mean, op=dist.ReduceOp.SUM)
        self.losses = [float(v) / WORLD for v in mean]
        update, ema = {}, {}
        for n, p in model.named_parameters():
            full = _full(p.detach())
            e = _full(self.state.ema_params[n])
            if rank == 0:
                update[n], ema[n] = (full - weights[n]).cpu(), (e - weights[n]).cpu()
        self.update, self.ema = update, ema
        del weights
        if rank == 0:
            t = stamp("checked steps", t)
        self.offset = n_check
        for i in range(traffic["warmup_steps"]):
            self.step(i)
        self.offset += traffic["warmup_steps"]
        sync(device)
        if rank == 0:
            stamp("warm-up steps", t)

    def batch(self, i):
        b = self.pool[i % len(self.pool)]
        return b["x"][self.rows], {"y": b["y"][self.rows], "drop": b["drop"][self.rows]}

    def step(self, i):
        self.state, metrics = self.trainer.train_step(self.state, self.batch(self.offset + i))
        return metrics["loss"]


def _device(kind: str, rank: int) -> torch.device:
    return torch.device("cuda", rank) if kind == "cuda" else torch.device("cpu")


def _init_group(store, rank: int, device: torch.device) -> None:
    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.PrefixStore("group", store), rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=COLLECTIVE_S))


def _watch_parent(parent: int) -> None:
    """Leave at once when the process that started this one is gone."""
    while True:
        if os.getppid() != parent:
            os._exit(1)
        time.sleep(0.5)


def _worker(rank, port, kind, config, traffic, seed, parent):
    """Rank ``rank`` of the mesh, started by rank 0's ``setup``."""
    import torch.distributed as dist

    threading.Thread(target=_watch_parent, args=(parent,), daemon=True).start()
    if kind == "cpu":
        torch.set_num_threads(1)
    store = dist.TCPStore("localhost", port, WORLD, is_master=False,
                          timeout=timedelta(seconds=STORE_S))
    device = _device(kind, rank)
    _init_group(store, rank, device)
    replica = _Replica(config, traffic, seed, device, rank)
    n = 0
    while True:
        said = store.get(f"call.{n}").decode()
        if said == STOP:
            break
        replica.step(int(said))
        n += 1
    sync(device)
    dist.destroy_process_group()


class Cell:
    def __init__(self, config, traffic, seed, device):
        import multiprocessing

        import torch.distributed as dist

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.units = traffic["batch"] * WORLD
        self.work = {"flops_per_call": dit_counts.train_step_flops(config, self.units),
                     "peak": "bf16_flops", "chips": WORLD}
        if device.type == "cuda":
            # built once here, before three more processes would build it too
            from torchebm_tpu_torch.ops import _build

            _build.load_library()
        self.store = dist.TCPStore("localhost", 0, WORLD, is_master=True,
                                   timeout=timedelta(seconds=STORE_S), wait_for_workers=False)
        ctx = multiprocessing.get_context("spawn")
        self.workers = [ctx.Process(target=_worker, daemon=True,
                                    args=(r, self.store.port, device.type, config, traffic, seed,
                                          os.getpid()))
                        for r in range(1, WORLD)]
        for w in self.workers:
            w.start()
        self._stopping = False
        threading.Thread(target=self._watch, daemon=True).start()
        _init_group(self.store, 0, device)
        self.replica = _Replica(config, traffic, seed, device, 0)
        self.n = 0

    def _watch(self):
        """Leave at once (exit code :data:`LOST_RANK`) when another rank dies
        before it was told to stop."""
        import sys

        while not self._stopping:
            dead = [(r + 1, w.exitcode) for r, w in enumerate(self.workers)
                    if w.exitcode is not None]
            if dead and not self._stopping:
                print(f"rank(s) {dead} ended before the run: leaving", file=sys.stderr,
                      flush=True)
                os._exit(LOST_RANK)
            time.sleep(0.2)

    def call(self, i):
        self.store.set(f"call.{self.n}", str(i))
        self.n += 1
        return self.replica.step(i)

    def readings(self) -> dict:
        r = self.replica
        return {"losses": r.losses, "grad": r.grad, "update": r.update, "ema": r.ema}

    def release(self):
        """Stops ranks 1 to 3 (killing any that has not stopped after
        :data:`JOIN_S` seconds), leaves the process group and frees rank 0's
        state; raises if a rank stopped otherwise than when told to."""
        import torch.distributed as dist

        sync(self.device)
        self._stopping = True
        self.store.set(f"call.{self.n}", STOP)
        self.replica = None
        for w in self.workers:
            w.join(JOIN_S)
        for w in self.workers:
            if w.is_alive():
                w.kill()
                w.join()
        bad = [w.exitcode for w in self.workers if w.exitcode != 0]
        if dist.is_initialized():
            dist.destroy_process_group()
        free(self.device)
        if bad:
            raise RuntimeError(f"ranks 1-{WORLD - 1} stopped with exit codes {bad}")

    def reference(self, got, precision=None, half_batch=False) -> dict:
        """The reference's readings on the global batch, each rank's rows
        with that rank's draws; ``half_batch`` plants a fault in it: each
        step on the rows of one data replica (ranks 0 and 1) alone. The
        reference's training loop (``reference.mmdit.train``) on the DiT's
        per-sample losses, with a generator for each rank's share of the
        rows."""
        cfg, tr, dev = self.config, self.traffic, self.device
        weights = generate.make_weights(ref_dit.param_layout(cfg), self.seed, dev)
        pool = generate.make_pool(_global_traffic(tr), cfg, self.seed, dev)
        ranks = range(WORLD // SHAPE[0] if half_batch else WORLD)
        draws = [generate.generator(self.seed, f"draws.{r}", dev) for r in ranks]
        rows = slice(0, tr["batch"] * len(draws))
        batches = [(b["x"][rows], b["y"][rows], b["drop"][rows]) for b in pool[:tr["check_steps"]]]
        with strict_float32():
            return ref_mmdit.train(weights, cfg, cfg["optimizer"], cfg["eqm"], batches, draws,
                                   tr["check_steps"], tr["reference_block_rows"],
                                   lowered(precision), sample_losses=ref_dit.eqm_sample_losses)


def setup(config, traffic, seed, device):
    return Cell(config, traffic, seed, device)
