"""Fixtures of the benchmark's tests: a tiny copy of the benchmark's data
(every cell at a size the CPU runs in seconds) that the harness runs from,
and the card, when a test needs one."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"

#: the tiny sizes; widths, heads and classes cut, every other setting kept
TINY_DIT = dict(in_channels=2, out_channels=2, input_size=8, patch_size=2, embed_dim=64,
                depth=2, num_heads=4, cond_dim=64, frequency_embedding_size=32, num_classes=10)
TINY_TRAFFIC = {
    "train_bf16": dict(batch=8, pool=4, reference_block_rows=4, trace_calls=2),
    "cfg_gen_bf16": dict(batch=8, pool=4, n_steps=3, check_rows=4, guide_channels=2),
    "hmc_10k": dict(n_chains=64, n_steps=20, warmup_calls=2, trace_calls=3),
    "langevin_10k": dict(n_chains=64, n_steps=20, warmup_calls=2, trace_calls=3),
}
#: limits of the tiny cells on the CPU (bf16 against the float32 reference
#: at these widths reads about a tenth of each)
TINY_LIMITS = {
    "dit_b2_eqm.train_bf16": {"loss_gap": 1e-3, "grad_norm_gap": 3e-2,
                              "update_norm_gap": 5e-2, "ema_norm_gap": 5e-2},
    "dit_b2_eqm.cfg_gen_bf16": {"sample_gap": 3e-2},
    "eight_gaussians_2d.langevin_10k": {"state_gap_max": 1e-3},
    "eight_gaussians_2d.hmc_10k": {"state_gap_median": 1e-3, "chains_off": 0.2},
}


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A checkout root holding ``BENCHMARK.json`` and ``perfbench/`` with the
    tiny configurations, traffic and limits, and the real metric readers and
    tables."""
    bench = tmp_path / "perfbench"
    bench.mkdir()
    for name in ("metrics", "peaks.json", "kernel_classes.json"):
        src = BENCH / name
        (shutil.copytree if src.is_dir() else shutil.copy)(src, bench / name)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    dit = _json(BENCH / "configs" / "dit_b2_eqm.json")
    dit.update(TINY_DIT)
    write_json(bench / "configs" / "dit_b2_eqm.json", dit)
    shutil.copy(BENCH / "configs" / "eight_gaussians_2d.json", bench / "configs")
    for name, sizes in TINY_TRAFFIC.items():
        traffic = _json(BENCH / "traffic" / f"{name}.json")
        traffic.update(sizes)
        write_json(bench / "traffic" / f"{name}.json", traffic)
    for cell, limits in TINY_LIMITS.items():
        write_json(bench / "limits" / f"{cell}.json",
                   {"numbers": {k: {"limit": v} for k, v in limits.items()}})
    return tmp_path


@pytest.fixture
def card():
    """The first CUDA device; the test skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
