"""The two training cells written with SD3's MMDiT, on the CPU at tiny
sizes: ``sd3_medium_eqm.text_train_bf16`` through the harness (correct, and
not correct under each fault the timed path can have), its frozen FLOP count
against PyTorch's counter, its joint attention's reader, and
``dit_b2_eqm.train_bf16_hsdp4``'s four ranks on a gloo world: the harness's
run, the start, call and stop protocol, the planted fault, and a rank that
dies ending the run at once. ``BENCHMARK.json`` does not list the four-card
cell until it has run on four cards, so the tests list it in their copy."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from perfbench.tests.conftest import BENCH, ROOT, TINY_DIT, TINY_LIMITS, write_json
from perfbench.tests.test_perfbench_harness import SEED, _break_train_half, _break_train_state, _run

MMDIT = "sd3_medium_eqm.text_train_bf16"
HSDP = "dit_b2_eqm.train_bf16_hsdp4"
#: the four-card cell's entry, held out of BENCHMARK.json until it has run
HSDP_CELL = {"name": HSDP, "config": "dit_b2_eqm", "traffic": "train_bf16_hsdp4", "chips": 4,
             "why": "train_step on a (2, 2) HSDP mesh, 256 latents a card: FSDP2's gathers and "
                    "reduce-scatters and the data axis's all-reduce, which exist only across cards"}
#: the tiny MMDiT: widths, heads, depth and tokens cut, every other setting kept
TINY_MMDIT = dict(num_layers=2, num_attention_heads=2, attention_head_dim=32,
                  joint_attention_dim=32, pooled_projection_dim=16, in_channels=4,
                  out_channels=4, latent_size=8, sample_size=16, pos_embed_max_size=12,
                  context_tokens=6, frequency_embedding_size=32)
TINY_TRAFFIC = {"text_train_bf16": dict(batch=2, pool=4, reference_block_rows=1, trace_calls=2),
                "train_bf16_hsdp4": dict(batch=2, pool=4, reference_block_rows=4, trace_calls=2)}
#: the tiny cells' limits: those of the tiny one-card train cell (bf16
#: against the float32 reference reads about a tenth of each)
LIMITS = TINY_LIMITS["dit_b2_eqm.train_bf16"]


def _json(path):
    return json.loads(path.read_text())


@pytest.fixture
def root(tiny_root):
    """The tiny checkout with the MMDiT configuration and both cells'
    traffic and limits at tiny sizes."""
    bench = tiny_root / "perfbench"
    cfg = _json(BENCH / "configs" / "sd3_medium_eqm.json")
    cfg.update(TINY_MMDIT)
    write_json(bench / "configs" / "sd3_medium_eqm.json", cfg)
    for name, sizes in TINY_TRAFFIC.items():
        traffic = _json(BENCH / "traffic" / f"{name}.json")
        traffic.update(sizes)
        write_json(bench / "traffic" / f"{name}.json", traffic)
    for cell in (MMDIT, HSDP):
        write_json(bench / "limits" / f"{cell}.json",
                   {"numbers": {k: {"limit": v} for k, v in LIMITS.items()}})
    manifest = _json(tiny_root / "BENCHMARK.json")
    manifest["workloads"].append(HSDP_CELL)
    for m in manifest["end_to_end"]:
        if m["name"] in ("train_samples_per_s", "call_ms_p95"):
            m["workloads"].append(HSDP)
    write_json(tiny_root / "BENCHMARK.json", manifest)
    return tiny_root


def _config(root, name):
    return _json(root / "perfbench" / "configs" / f"{name}.json")


def _traffic(root, name):
    return _json(root / "perfbench" / "traffic" / f"{name}.json")


@pytest.mark.parametrize("trace", [0, 1])
def test_mmdit_cell_runs_and_is_correct(root, trace, capsys, monkeypatch):
    res = _run(root, MMDIT, capsys, trace, monkeypatch)
    assert res["correct"] is True and res["attempted"] >= 1
    assert set(res["checks"]) == set(LIMITS)
    if not trace:
        assert set(res["metrics"]) == {"train_samples_per_s", "call_ms_p95", "setup_s"}
    else:
        # on the CPU the spans carry no device time and the card no peak
        assert res["metrics"] == {} and {"busy_s", "window_s"} <= set(res["device"])


@pytest.mark.parametrize("fault", [_break_train_state, _break_train_half],
                         ids=["state unchanged", "half the batch"])
def test_fault_makes_the_mmdit_cell_incorrect(root, fault, capsys, monkeypatch):
    fault(monkeypatch)
    res = _run(root, MMDIT, capsys, 0, monkeypatch)
    assert res["correct"] is False, res["checks"]


def test_mmdit_count_matches_torch_flop_counter(root, monkeypatch):
    """The frozen count against ``torch.utils.flop_counter`` on the tiny
    model's forward: equal, the embeddings and head included (attention in
    its einsum form, whose products the counter sees on the CPU)."""
    from torch.utils.flop_counter import FlopCounterMode

    from torchebm_tpu_torch.models.components import transformer

    from perfbench import generate
    from perfbench.counts import mmdit as counts
    from perfbench.reference import mmdit as ref
    from perfbench.systems import sd3_mmdit

    monkeypatch.setattr(transformer, "_attention", transformer._einsum_attention)
    cfg = _config(root, "sd3_medium_eqm")
    net = sd3_mmdit.build(cfg, generate.make_weights(ref.param_layout(cfg), 1, "cpu"), "cpu")
    b, p = 3, cfg["latent_size"]
    x = torch.randn(b, cfg["in_channels"], p, p)
    ctx = torch.randn(b, cfg["context_tokens"], cfg["joint_attention_dim"])
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net(x, torch.zeros(b), context=ctx, pooled=torch.randn(b, cfg["pooled_projection_dim"]))
    assert fc.get_total_flops() == b * counts.forward_flops(cfg)
    assert counts.train_step_flops(cfg, b) == 3 * b * counts.forward_flops(cfg)


def test_published_count():
    """SD3-medium at 32 x 32 latents and 154 text tokens: 578.44 GFLOP a
    sample forward, 55.5 TFLOP a step of 32."""
    from perfbench.counts import mmdit as counts

    cfg = _json(BENCH / "configs" / "sd3_medium_eqm.json")
    assert counts.forward_flops(cfg) == 578_435_260_416
    assert round(counts.train_step_flops(cfg, 32) / 1e12, 1) == 55.5


def _reader(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"reader_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_joint_attention_reader():
    """``joint_attention_ms.mmdit`` sums the attention kernels' device time
    (forward and backward) over the traced steps, per step; None where none
    ran."""
    classes = _json(BENCH / "kernel_classes.json")
    ctx = {"classes": classes,
           "trace": {"calls": 2, "device_ops": {"pytorch_flash::flash_fwd_kernel": 0.004,
                                                "fmha_cutlassB_bf16_aligned": 0.006,
                                                "nvjet_tst_128x256_gemm": 1.0,
                                                "adaln_modulate_kernel": 0.5}}}
    assert _reader("joint_attention_ms.mmdit")(ctx) == pytest.approx(5.0)
    ctx["trace"]["device_ops"] = {"nvjet_tst_128x256_gemm": 1.0}
    assert _reader("joint_attention_ms.mmdit")(ctx) is None


def test_hsdp_readers():
    ctx = {"trace": {"calls": 2, "device_ops": {"ncclDevKernel_AllGather": 0.004,
                                                "ncclKernel_ReduceScatter": 0.002, "gemm": 1.0}}}
    assert _reader("collective_ms.hsdp4")(ctx) == pytest.approx(3.0)
    ctx["trace"]["device_ops"] = {"gemm": 1.0}
    assert _reader("collective_ms.hsdp4")(ctx) is None


@pytest.mark.parametrize("trace", [0, 1])
def test_hsdp_cell_runs_on_a_gloo_world_and_is_correct(root, trace, capsys, monkeypatch):
    res = _run(root, HSDP, capsys, trace, monkeypatch)
    assert res["correct"] is True and res["attempted"] >= 1
    if trace:  # the traced sub-window drives all four ranks too (no peak to read on the CPU)
        assert res["device"]["window_s"] > 0 and "breakdown" in res
    else:
        assert set(res["metrics"]) == {"train_samples_per_s", "call_ms_p95", "setup_s"}


def test_hsdp_start_call_stop_and_the_planted_fault(root):
    """Four ranks come up, step on each call index rank 0 sends, stop when
    told (exit code 0 each) within the time limits; the reference on one
    data replica's rows fails the limits the program keeps."""
    from perfbench.entries import eqm_train_hsdp as hsdp

    cfg, tr = _config(root, "dit_b2_eqm"), _traffic(root, "train_bf16_hsdp4")
    t0 = time.perf_counter()
    cell = hsdp.setup(cfg, tr, SEED, torch.device("cpu"))
    assert all(w.is_alive() for w in cell.workers) and len(cell.workers) == hsdp.WORLD - 1
    for i in range(3):
        assert torch.isfinite(cell.call(i))
    got = cell.readings()
    cell.release()
    assert [w.exitcode for w in cell.workers] == [0] * (hsdp.WORLD - 1)
    assert time.perf_counter() - t0 < 120
    assert not torch.distributed.is_initialized()
    want = cell.reference(got)
    sound = hsdp.compare(got, want)
    assert all(sound[k] <= v for k, v in LIMITS.items()), sound
    fault = hsdp.compare(cell.reference(got, half_batch=True), want)
    assert any(fault[k] > v for k, v in LIMITS.items()), fault


def test_a_rank_that_dies_ends_the_run_at_once(root, tmp_path):
    """Rank 1 killed after set-up: rank 0 leaves within seconds, by the
    collective's error or by its watch (the exit code ``LOST_RANK``), and
    the other ranks go with it."""
    from perfbench.entries import eqm_train_hsdp as hsdp

    script = tmp_path / "die.py"
    script.write_text(textwrap.dedent(f"""
        import json, sys, time
        sys.path.insert(0, {str(ROOT)!r})
        import torch
        from perfbench.entries import eqm_train_hsdp as hsdp

        if __name__ == "__main__":
            cfg = json.load(open({str(root / 'perfbench' / 'configs' / 'dit_b2_eqm.json')!r}))
            tr = json.load(open({str(root / 'perfbench' / 'traffic' / 'train_bf16_hsdp4.json')!r}))
            cell = hsdp.setup(cfg, tr, 5, torch.device("cpu"))
            print(json.dumps([w.pid for w in cell.workers]), flush=True)
            cell.workers[0].kill()
            cell.call(0)
            time.sleep(60)
        """))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode not in (0, None), proc.stderr[-2000:]
    assert time.perf_counter() - t0 < 90
    pids = json.loads(proc.stdout.strip().splitlines()[-1])
    deadline = time.perf_counter() + 10
    while time.perf_counter() < deadline and any(_alive(p) for p in pids):
        time.sleep(0.2)
    assert not any(_alive(p) for p in pids)


def _alive(pid: int) -> bool:
    import os

    try:
        os.kill(pid, 0)
    except OSError:
        return False
    with open(f"/proc/{pid}/stat") as f:
        return f.read().split(")")[-1].split()[0] != "Z"
