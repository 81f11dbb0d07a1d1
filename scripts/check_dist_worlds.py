#!/usr/bin/env python3
"""Apply ``tests/test_torch_parallel.py``'s assertions to the results of
``tests/torch_dist_worker.py`` worlds run elsewhere, e.g. over NCCL with one
process per card:

    torchrun --standalone --nproc_per_node 2 tests/torch_dist_worker.py data OUT/w2
    torchrun --standalone --nproc_per_node 4 tests/torch_dist_worker.py hsdp OUT/w4
    python3 scripts/check_dist_worlds.py OUT/w2 OUT/w4

Each test of that file that reads the spawned worlds runs once per
parameter on the ranks' ``rank<r>.json`` files; the script prints one line
per test (passed, or the assertion) and each sampler check's largest output
and statistic differences, and exits with 1 if any test fails. Imports no
JAX.
"""

from __future__ import annotations

import inspect
import json
import os
import sys
import traceback

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]

import test_torch_parallel as T  # noqa: E402


#: tests that hold the CPU worlds' own setting, not a result: not run here
CPU_ONLY = {"test_init_distributed_from_torchrun_environment":
            "asserts the CPU worlds' gloo backend (the header line prints the backend)"}


def load(out_dir: str) -> list:
    files = sorted(f for f in os.listdir(out_dir) if f.startswith("rank") and f.endswith(".json"))
    return [json.load(open(os.path.join(out_dir, f))) for f in files]


def main() -> None:
    worlds = {"data": load(sys.argv[1]), "hsdp": load(sys.argv[2])}
    for kind, ranks in worlds.items():
        print(f"world {kind}: {len(ranks)} ranks, devices "
              f"{sorted({r['init'].get('device') for r in ranks})}, backend "
              f"{ranks[0]['init']['backend']}")
        for name, per_fused in ranks[0].get("check_samplers", {}).items():
            if "error" in per_fused:
                continue
            worst = {f: (max(r["outputs"].values()), max(r["stats"].values()))
                     for f, r in per_fused.items()}
            print(f"  {kind} {name}: " + ", ".join(
                f"fused={f} outputs {o:.2e}, statistics {s:.2e}" for f, (o, s) in worst.items()))
    failed = 0
    for name, fn in sorted(vars(T).items()):
        if not name.startswith("test_") or "worlds" not in inspect.signature(fn).parameters:
            continue
        if name in CPU_ONLY:
            print(f"not run {name}: {CPU_ONLY[name]}")
            continue
        combos = [{}]
        for m in getattr(fn, "pytestmark", []):
            if m.name != "parametrize":
                continue
            keys = [a.strip() for a in m.args[0].split(",")]
            combos = [dict(c, **dict(zip(keys, v if len(keys) > 1 else [v])))
                      for c in combos for v in m.args[1]]
        for kw in combos:
            label = f"{name}[{'-'.join(str(v) for v in kw.values())}]" if kw else name
            try:
                fn(worlds, **kw)
                print(f"passed {label}")
            except Exception:
                failed += 1
                print(f"FAILED {label}\n{traceback.format_exc()[-1500:]}")
    print(f"{failed} failed")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
