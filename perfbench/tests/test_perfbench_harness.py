"""The harness end to end on the CPU at tiny sizes: each cell runs, prints
one result line and comes out correct; with the timed path broken
underneath (each fault the cell can have) it comes out not correct; a cell,
a configuration, a traffic mix and a metric added as files alone are found.

The card's look is skipped (``require_cuda=False``); the chain cells run
the kernels' plain versions, which the samplers take on the CPU with
``fused="force"``. The exchange between chips is a fault no cell can have:
every cell takes one chip.
"""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from perfbench import run
from perfbench.tests.conftest import write_json

SEED = 3000000019


def _run(root, cell, capsys, trace=0, monkeypatch=None):
    if monkeypatch is not None:
        monkeypatch.setattr(run, "FORBIDDEN", ())  # pytest's plugins may load JAX
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.5",
                   "--trace", str(trace)], root=root, require_cuda=False)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


CELLS = ["dit_b2_eqm.train_bf16", "dit_b2_eqm.cfg_gen_bf16", "eight_gaussians_2d.langevin_10k",
         "eight_gaussians_2d.hmc_10k"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(tiny_root, cell, trace, capsys, monkeypatch):
    res = _run(tiny_root, cell, capsys, trace, monkeypatch)
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks" and res["checks"]
    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    section = "per_layer" if trace else "end_to_end"
    if not trace:
        want = {m["name"] for m in manifest[section]
                if cell in m.get("workloads", [cell])}
        assert set(res["metrics"]) == want
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res


def _break_train_state(monkeypatch):
    from torchebm_tpu_torch.core import trainer

    def unchanged(self, state):
        state.optimizer.zero_grad(set_to_none=True)

    monkeypatch.setattr(trainer.BaseTrainer, "_optimizer_step", unchanged)


def _break_train_half(monkeypatch):
    from torchebm_tpu_torch.core import trainer

    split = trainer._split_batch

    def half(batch):
        x, mk = split(batch)
        n = x.shape[0] // 2
        return x[:n], {k: v[:n] for k, v in mk.items()}

    monkeypatch.setattr(trainer, "_split_batch", half)


def _wrap_sample(monkeypatch, cls, change):
    original = cls.sample

    def sample(self, generator, x=None, *args, **kw):
        return change(x, original(self, generator, x, *args, **kw))

    monkeypatch.setattr(cls, "sample", sample)


def _half_rows(x, out):
    out = out.clone()
    out[x.shape[0] // 2:] = x[x.shape[0] // 2:]
    return out


def _one_altered(x, out):
    out = out.clone()
    out[0] += 0.5
    return out


def _all_altered(x, out):
    return out + 0.5


def _scaled(x, out):
    return out * 1.1


def _sampler(name):
    from torchebm_tpu_torch import samplers

    return getattr(samplers, name)


FAULTS = {
    ("dit_b2_eqm.train_bf16", "state unchanged"): _break_train_state,
    ("dit_b2_eqm.train_bf16", "half the batch"): _break_train_half,
    ("dit_b2_eqm.cfg_gen_bf16", "state unchanged"):
        lambda mp: _wrap_sample(mp, _sampler("FlowSampler"), lambda x, out: x),
    ("dit_b2_eqm.cfg_gen_bf16", "half the batch"):
        lambda mp: _wrap_sample(mp, _sampler("FlowSampler"), _half_rows),
    # the check compares a sample of each checked call's rows: every row is
    # altered, so that the sample holds altered rows whatever the seed
    ("dit_b2_eqm.cfg_gen_bf16", "an answer altered"):
        lambda mp: _wrap_sample(mp, _sampler("FlowSampler"), _scaled),
    ("eight_gaussians_2d.langevin_10k", "state unchanged"):
        lambda mp: _wrap_sample(mp, _sampler("LangevinDynamics"), lambda x, out: x),
    ("eight_gaussians_2d.langevin_10k", "half the batch"):
        lambda mp: _wrap_sample(mp, _sampler("LangevinDynamics"), _half_rows),
    ("eight_gaussians_2d.langevin_10k", "an answer altered"):
        lambda mp: _wrap_sample(mp, _sampler("LangevinDynamics"), _one_altered),
    ("eight_gaussians_2d.hmc_10k", "state unchanged"):
        lambda mp: _wrap_sample(mp, _sampler("HamiltonianMonteCarlo"), lambda x, out: x),
    ("eight_gaussians_2d.hmc_10k", "half the batch"):
        lambda mp: _wrap_sample(mp, _sampler("HamiltonianMonteCarlo"), _half_rows),
    # a single chain off the reference's path cannot be told from the few
    # percent that rounding sends off it (perfbench/entries/chain_sample.py);
    # a whole call's answer altered can
    ("eight_gaussians_2d.hmc_10k", "an answer altered"):
        lambda mp: _wrap_sample(mp, _sampler("HamiltonianMonteCarlo"), _all_altered),
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_fault_makes_the_cell_incorrect(tiny_root, cell, fault, capsys, monkeypatch):
    FAULTS[(cell, fault)](monkeypatch)
    res = _run(tiny_root, cell, capsys, 0, monkeypatch)
    assert res["correct"] is False, res["checks"]


def test_files_alone_add_a_cell(tiny_root, capsys, monkeypatch):
    bench = tiny_root / "perfbench"
    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    config = json.loads((bench / "configs" / "eight_gaussians_2d.json").read_text())
    config.update(radius=3.0, scale=0.5)
    write_json(bench / "configs" / "ring_wide.json", config)
    traffic = json.loads((bench / "traffic" / "langevin_10k.json").read_text())
    traffic.update(n_chains=32, step_size=0.02)
    write_json(bench / "traffic" / "langevin_small.json", traffic)
    shutil.copy(bench / "limits" / "eight_gaussians_2d.langevin_10k.json",
                bench / "limits" / "ring_wide.langevin_small.json")
    (bench / "metrics" / "calls_traced.py").write_text(
        "def read(ctx):\n    return float(ctx['trace']['calls'])\n")
    manifest["configs"].append({"name": "ring_wide", "source": "https://example.org",
                                "file": "perfbench/configs/ring_wide.json", "reduced": [],
                                "why": "a test"})
    manifest["workloads"].append({"name": "ring_wide.langevin_small", "config": "ring_wide",
                                  "traffic": "langevin_small", "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"]:
        if m["name"] == "transitions_per_s.langevin":
            m["workloads"].append("ring_wide.langevin_small")
    manifest["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                                  "source": "device_trace", "layer": "device",
                                  "moves": "transitions_per_s.langevin",
                                  "workloads": ["ring_wide.langevin_small"]})
    write_json(tiny_root / "BENCHMARK.json", manifest)
    res = _run(tiny_root, "ring_wide.langevin_small", capsys, 1, monkeypatch)
    assert res["correct"] is True
    assert res["metrics"]["calls_traced"]["value"] == traffic["trace_calls"]


def test_same_seed_same_inputs():
    from perfbench import generate

    traffic = {"pool": 2, "batch": 3, "inputs": {
        "x": {"dist": "normal", "shape": ["batch", 2]},
        "y": {"dist": "randint", "high": "classes", "shape": ["batch"]},
        "d": {"dist": "bernoulli", "p": 0.5, "shape": ["batch"]}}}
    a = generate.make_pool(traffic, {"classes": 7}, 2**31 + 5, "cpu")
    b = generate.make_pool(traffic, {"classes": 7}, 2**31 + 5, "cpu")
    c = generate.make_pool(traffic, {"classes": 7}, 2**31 + 6, "cpu")
    assert all(torch.equal(a[i][k], b[i][k]) for i in range(2) for k in "xyd")
    assert not torch.equal(a[0]["x"], c[0]["x"])
    assert a[0]["x"].shape == c[0]["x"].shape == (3, 2)
