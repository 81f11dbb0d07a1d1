"""On a card, at each cell's own size: the program's numbers keep within the
cell's limits and the control's (the reference computed in the nearest
precision below the configuration's, in the program's place) do not.

    python -m pytest perfbench/tests/test_perfbench_controls.py -m gpu
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CONTROL = {"float32": "bf16", "bfloat16": "fp8"}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_program_within_and_control_beyond_the_limits(card, cell):
    w = {x["name"]: x for x in MANIFEST["workloads"]}[cell]
    config = json.loads((BENCH / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())["numbers"]
    entry = importlib.import_module(f"perfbench.entries.{traffic['entry']}")
    c = entry.setup(config, traffic, 2**31 + 77, card)
    for i in range(int(traffic.get("check_calls", 0))):
        c.call(i)
    got = c.readings()
    c.release()
    want = c.reference(got)
    program = entry.compare(got, want)
    control = entry.compare(c.reference(got, CONTROL[config["dtype"]]), want)
    assert all(program[k] <= v["limit"] for k, v in limits.items()), program
    assert any(control[k] > v["limit"] for k, v in limits.items()), control
