#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on a CUDA card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (from process start to the first timed call) builds the cell from
its configuration and traffic files, makes its inputs and weights on the
card from the seed and warms up every shape the window uses. The window is a
closed loop: one client calls back to back for ``--seconds`` seconds, each
call timed on the host clock until a synchronise on the card; the last call
is the first to end past the deadline. Rates are the window's work over the
window's time, ``call_ms_p95`` the 95th percentile of every call's latency.
With ``--trace 1`` the same window runs, then a traced sub-window of the
traffic's ``trace_calls`` calls under ``torch.profiler``, and the line holds
the cell's per-layer metrics, the device's busy and window seconds and the
breakdown. Then the check: the program's state is freed and the plain
reference recomputes what the timed path produced; each number compared is
printed beside its limit on standard error and under ``checks``, the last
key of the result, which is the last line of standard output.

Exits without a result when there is no CUDA card (or fewer than the cell
asks for), and when ``jax``, ``jaxlib``, ``flax``, ``optax`` or the JAX
package ``torchebm_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "torchebm_tpu")
#: caches of the program and of PyTorch, at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "cuda_compute"}


def _since_start() -> float:
    """Seconds from this process's start (in /proc, to 10 ms) to now."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(float(Path("/proc/uptime").read_text().split()[0]) - started, 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


#: seconds from process start to _T0: the interpreter's own start-up
_BEFORE_T0 = _since_start() - (time.perf_counter() - _T0)


def _environment() -> None:
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    if str(HERE) in sys.path:
        sys.path.remove(str(HERE))


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def end_to_end(name: str, window: dict, setup_s: float):
    """An end-to-end metric by its name, up to its first dot: ``setup_s``;
    ``call_ms_p<q>``, the q-th percentile of the calls' latencies;
    ``*_per_s``, the window's work over its time."""
    base = name.split(".")[0]
    if base == "setup_s":
        return setup_s
    if base.startswith("call_ms_p"):
        q = int(base[len("call_ms_p"):])
        return statistics.quantiles(window["latency"], n=100, method="inclusive")[q - 1] * 1e3
    if base.endswith("_per_s"):
        return window["units"] * window["calls"] / window["seconds"]
    raise KeyError(f"no rule for the end-to-end metric {name!r}")


def _closed_loop(cell, sync, device, seconds: float, first: int = 0) -> dict:
    latency = []
    start = time.perf_counter()
    deadline = start + seconds
    i = first
    while True:
        t0 = time.perf_counter()
        cell.call(i)
        sync(device)
        t1 = time.perf_counter()
        latency.append(t1 - t0)
        i += 1
        if t1 >= deadline:
            break
    return {"start": start, "seconds": t1 - start, "calls": i - first, "latency": latency,
            "units": cell.units}


def _phase(name: str) -> None:
    """A line on standard error: seconds from process start to the end of
    set-up phase ``name``."""
    print(f"phase {name}: {_BEFORE_T0 + time.perf_counter() - _T0:.3f} s", file=sys.stderr,
          flush=True)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def main(argv=None, *, root: Path = ROOT, require_cuda: bool = True) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    import torch

    _phase("import torch")

    from perfbench import trace
    from perfbench.entries import sync

    manifest = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell_spec = cells[args.workload]
    chips = int(cell_spec["chips"])
    if require_cuda:
        available = torch.cuda.is_available()
        _phase("cuda available")
        if not available or torch.cuda.device_count() < chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"the cell needs {chips} CUDA card(s); found {found}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        kind = torch.cuda.get_device_name(device)
        _phase("device")
        torch.zeros(1, device=device)
        _phase("cuda context")
    else:
        device, kind = torch.device("cpu"), "cpu"
    bench = root / "perfbench"
    config = _json(bench / "configs" / f"{cell_spec['config']}.json")
    traffic = _json(bench / "traffic" / f"{cell_spec['traffic']}.json")
    entry = importlib.import_module(f"perfbench.entries.{traffic['entry']}")

    cell = entry.setup(config, traffic, args.seed, device)
    _phase("cell")
    win = _closed_loop(cell, sync, device, args.seconds)
    setup_s = _BEFORE_T0 + (win["start"] - _T0)
    result_device = {"platform": "gpu" if require_cuda else "cpu", "kind": kind, "count": chips}
    metrics, breakdown = {}, None
    if args.trace:
        n = int(traffic["trace_calls"])
        first = win["calls"]

        def run():
            for j in range(n):
                cell.call(first + j)
                sync(device)

        tr = trace.traced(run, lambda: sync(device), device.type == "cuda")
        tr["calls"] = n
        peaks = _json(bench / "peaks.json").get(kind)
        ctx = {"window": win, "trace": tr, "work": cell.work, "peaks": peaks,
               "classes": _json(bench / "kernel_classes.json"), "config": config,
               "traffic": traffic}
        for m in manifest["per_layer"]:
            if not _applies(m, args.workload):
                continue
            value = _load(bench / "metrics" / f"{m['name']}.py",
                          f"perfbench_metric_{len(metrics)}").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result_device["busy_s"] = tr["busy_s"]
        result_device["window_s"] = tr["window_s"]
        breakdown = {"device_ops": trace.top(tr["device_ops"]),
                     "idle_gaps": trace.top(tr["idle_gaps"])}
    else:
        for m in manifest["end_to_end"]:
            if _applies(m, args.workload):
                metrics[m["name"]] = {"value": end_to_end(m["name"], win, setup_s),
                                      "unit": m["unit"]}
    result_device["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(device))
                                          if device.type == "cuda" else 0)

    got = cell.readings()
    cell.release()
    numbers = entry.compare(got, cell.reference(got))
    limits = bench / "limits" / f"{args.workload}.json"
    limits = _json(limits)["numbers"] if limits.exists() else {}
    checks = {}
    for name, spec in sorted(limits.items()):
        value = numbers.get(name)
        # a number that is missing or not finite fails, and is printed as null
        checks[name] = {"value": value if value is not None and math.isfinite(value) else None,
                        "limit": spec["limit"]}
    correct = bool(checks) and all(c["value"] is not None and c["value"] <= c["limit"]
                                   for c in checks.values())

    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    out = {"correct": correct, "attempted": win["calls"], "failed": 0, "metrics": metrics,
           "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    sys.stdout.flush()
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    if not checks:
        print(f"check: no limits for {args.workload}; readings {numbers}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
