#!/usr/bin/env python3
"""Readings from which a cell's correctness limits are set, on a card.

    python3 perfbench/calibrate.py --workload <name> --seeds 1 2 ... [--controls 3]
        [--calls 3] [--faults] [--out <file.jsonl>]

For each seed: the cell's set-up, ``--calls`` calls of its timed path, then
its check's numbers against the reference (the lower readings). For the
first ``--controls`` seeds also the control: the reference computed in the
nearest precision below the configuration's (bf16 for float32, fp8 for
bf16), in the program's place (the upper readings). ``--faults`` adds, on
those seeds, the faults the cell's entry can plant in the reference (a
training step on half of its batch). One JSON line per reading.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONTROL = {"float32": "bf16", "bfloat16": "fp8"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--faults", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import run

    run._environment()
    import torch

    manifest = run._json(ROOT / "BENCHMARK.json")
    spec = {w["name"]: w for w in manifest["workloads"]}[args.workload]
    config = run._json(ROOT / "perfbench" / "configs" / f"{spec['config']}.json")
    traffic = run._json(ROOT / "perfbench" / "traffic" / f"{spec['traffic']}.json")
    entry = importlib.import_module(f"perfbench.entries.{traffic['entry']}")
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, numbers, seconds):
        line = json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                           "numbers": numbers, "seconds": round(seconds, 3),
                           "card": torch.cuda.get_device_name(device)})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for n, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        cell = entry.setup(config, traffic, seed, device)
        for i in range(args.calls):
            cell.call(i)
        torch.cuda.synchronize()
        got = cell.readings()
        cell.release()
        t1 = time.perf_counter()
        want = cell.reference(got)
        emit("program", seed, entry.compare(got, want), time.perf_counter() - t1)
        if n < args.controls:
            t1 = time.perf_counter()
            ctl = cell.reference(got, CONTROL[config["dtype"]])
            emit(f"control_{CONTROL[config['dtype']]}", seed, entry.compare(ctl, want),
                 time.perf_counter() - t1)
            del ctl
            if args.faults and traffic["entry"] == "eqm_train":
                t1 = time.perf_counter()
                emit("fault_half_batch", seed,
                     entry.compare(cell.reference(got, half_batch=True), want),
                     time.perf_counter() - t1)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        del cell, got, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
