#!/usr/bin/env python3
"""Spreads of a cell's metrics over sets of runs, for setting bounds.

    python3 perfbench/spread.py <set A result files...> -- <set B result files...>

Each file holds a run's standard output; its last line is the result. For
each metric and set: the median, and the spread, the distance between the
first and third quartiles (``statistics.quantiles(values, n=4)``) over the
median; then the wider spread of the two sets and five times it, the bound
that spread gives (at least 1%).
"""

from __future__ import annotations

import json
import statistics
import sys


def _results(paths):
    out = []
    for p in paths:
        with open(p) as f:
            out.append(json.loads(f.read().strip().splitlines()[-1]))
    return out


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv) -> int:
    split = argv.index("--") if "--" in argv else len(argv)
    sets = [_results(argv[:split]), _results(argv[split + 1:])]
    sets = [s for s in sets if s]
    names = sorted({m for s in sets for r in s for m in r["metrics"]})
    for name in names:
        cols, widest = [], 0.0
        for s in sets:
            vals = [r["metrics"][name]["value"] for r in s if name in r["metrics"]]
            sp = spread(vals) if len(vals) >= 2 else float("nan")
            widest = max(widest, sp)
            cols.append(f"median {statistics.median(vals):.6g} spread {sp:.4%} (n={len(vals)})")
        print(f"{name}: " + " | ".join(cols) + f" | widest {widest:.4%}, 5x {max(5 * widest, 0.01):.4%}")
    correct = [r["correct"] for s in sets for r in s]
    print(f"correct: {sum(correct)} of {len(correct)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
