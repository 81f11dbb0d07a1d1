"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its files."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|proj|head|embed).*|.*_(dim|rank|size)$")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_entry_keys():
    assert set(MANIFEST) == TOP
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    for section, keys in KEYS.items():
        for entry in MANIFEST[section]:
            extra = set(entry) - keys
            assert set(entry) >= keys and extra <= ({"workloads"} if section in (
                "end_to_end", "per_layer") else set()), (section, entry["name"])


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word


def test_names_units_and_lines():
    seen = set()
    for section in KEYS:
        for entry in MANIFEST[section]:
            assert NAME.fullmatch(entry["name"]), entry["name"]
            assert (section, entry["name"]) not in seen
            seen.add((section, entry["name"]))
            if "unit" in entry:
                assert UNIT.fullmatch(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert _line(entry[key]), (entry["name"], key)
    for w in MANIFEST["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])


def test_configs():
    files = set()
    for c in MANIFEST["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"] not in files
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) and not WIDTHS.fullmatch(k) for k in c["reduced"])
        assert c["source"].startswith("https://")
        assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])
        cfg = json.loads(path.read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]


def test_cells_and_their_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = [w["name"] for w in MANIFEST["workloads"]]
    assert 1 <= len(cells) <= 24 and len(set(cells)) == len(cells)
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= max(1, len(cells) // 4)
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25

    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert all(c in cells for c in m.get("workloads", ()))
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for c in m.get("workloads", cells):
            assert c in cells and reports(e2e[m["moves"]], c), (m["name"], c)
    for c in cells:
        assert sum(reports(m, c) for m in MANIFEST["end_to_end"]) >= 2
        assert any(reports(m, c) for m in MANIFEST["per_layer"])


def test_run_seconds_fit_the_check():
    r = MANIFEST["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_finds_its_files(cell):
    w = {x["name"]: x for x in MANIFEST["workloads"]}[cell]
    bench = ROOT / "perfbench"
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    config = json.loads((bench / "configs" / f"{w['config']}.json").read_text())
    assert (bench / "entries" / f"{traffic['entry']}.py").is_file()
    assert (bench / "systems" / f"{config['system']}.py").is_file()
    assert (bench / "reference" / f"{config['reference']}.py").is_file()
    limits = json.loads((bench / "limits" / f"{cell}.json").read_text())["numbers"]
    assert limits and all(v["limit"] >= 0 for v in limits.values())
    for m in MANIFEST["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert (bench / "metrics" / f"{m['name']}.py").is_file(), m["name"]
