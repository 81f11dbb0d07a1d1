#!/usr/bin/env python3
"""Readings from which a training cell's correctness limits are set, on a
card, the planted fault included for every training entry.

    python3 perfbench/calibrate_train.py --workload <name> --seeds 1 2 ...
        [--controls 3] [--calls 3] [--out <file.jsonl>]

As ``perfbench/calibrate.py`` (the program's readings against the reference
on every seed; the control, the reference in the nearest precision below the
configuration's, on the first ``--controls`` seeds), and on those seeds also
the fault the entry's reference plants with ``half_batch=True`` (a step on
half of its batch's rows, or on one data replica's rows). Before a control
or a fault runs, the reference's tensor readings move to host memory, so
that a second reference has the card to itself. One JSON line per reading,
in ``calibrate.py``'s form, with the program's and the reference's peak
memory on the program's line.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _host(reading):
    """A reading, its tensors (alone or in a dict) in host memory."""
    if isinstance(reading, dict):
        return {k: _host(v) for k, v in reading.items()}
    return reading.cpu() if hasattr(reading, "cpu") else reading


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import run
    from perfbench.calibrate import CONTROL

    run._environment()
    import torch

    manifest = run._json(ROOT / "BENCHMARK.json")
    spec = {w["name"]: w for w in manifest["workloads"]}[args.workload]
    config = run._json(ROOT / "perfbench" / "configs" / f"{spec['config']}.json")
    traffic = run._json(ROOT / "perfbench" / "traffic" / f"{spec['traffic']}.json")
    entry = importlib.import_module(f"perfbench.entries.{traffic['entry']}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    control = CONTROL[config["dtype"]]
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, numbers, seconds, **extra):
        line = json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                           "numbers": numbers, "seconds": round(seconds, 3),
                           "card": torch.cuda.get_device_name(device), **extra})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for n, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(device)
        cell = entry.setup(config, traffic, seed, device)
        for i in range(args.calls):
            cell.call(i)
        torch.cuda.synchronize()
        program_peak = torch.cuda.max_memory_allocated(device)
        got = cell.readings()
        cell.release()
        torch.cuda.reset_peak_memory_stats(device)
        t1 = time.perf_counter()
        want = cell.reference(got)
        emit("program", seed, entry.compare(got, want), time.perf_counter() - t1,
             program_peak_bytes=program_peak,
             reference_peak_bytes=torch.cuda.max_memory_allocated(device))
        if n < args.controls:
            want = {k: _host(v) for k, v in want.items()}
            torch.cuda.empty_cache()
            for kind, kw in ((f"control_{control}", {"precision": control}),
                             ("fault_half_batch", {"half_batch": True})):
                t1 = time.perf_counter()
                emit(kind, seed, entry.compare(cell.reference(got, **kw), want),
                     time.perf_counter() - t1)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        del cell, got, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
