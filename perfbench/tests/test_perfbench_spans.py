"""The readers of the port's spans and counters: each gives the mean over
the last ``calls`` roots of synthetic spans, and None where there is nothing
to read (no roots, no device time, another cell's kernel, a program without
spans); the harness's ``--trace 1`` CPU run of each chain cell prints them."""

from __future__ import annotations

import importlib.util

import pytest

from perfbench.tests.conftest import BENCH
from perfbench.tests.test_perfbench_harness import _run
from torchebm_tpu_torch.utils import profiling

TRAIN = {"forward_ms.train": "trainer.forward", "backward_ms.train": "trainer.backward",
         "optimizer_ms.train": "trainer.optimizer"}
CHAINS = {"hmc": "mixture_hmc_chain", "langevin": "mixture_langevin_chain"}


def _reader(name):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class _Events:
    """Stands in for a phase's CUDA events: ``ms`` between them."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms


def _record(name, call, parent, start_ns, end_ns, counts=None, device_ms=None):
    rec = profiling.SpanRecord(name, call, parent)
    rec.start_ns, rec.end_ns, rec.counts = start_ns, end_ns, counts or {}
    if device_ms is not None:
        rec._events = (_Events(0.0), _Events(device_ms))
    return rec


def _train_roots(n, device=True):
    roots = []
    for i in range(n):
        root = _record("trainer.train_step", i, None, 0, 100)
        for j, phase in enumerate(TRAIN.values()):
            # call i's phase j took 10 * (j + 1) + i ms on the card
            root.children.append(_record(phase, i, root.name, 10 * j, 10 * j + 5,
                                         device_ms=10.0 * (j + 1) + i if device else None))
        roots.append(root)
    return roots


def _chain_roots(kernel, n):
    roots = []
    for i in range(n):
        root = _record("sampler.sample", i, None, 1_000_000 * i, 1_000_000 * i + 900_000,
                       counts={"host_reads": i % 2 + 1})
        # call i's launch is queued (100 + 10 i) µs after its start
        for k, name in enumerate(("sampler.start", "sampler.dispatch", "sampler.seed")):
            root.children.append(_record(name, i, root.name, root.start_ns + 10_000 * k,
                                         root.start_ns + 10_000 * (k + 1)))
        root.children.append(_record(f"ops.{kernel}", i, root.name, root.start_ns + 30_000,
                                     root.start_ns + 100_000 + 10_000 * i))
        roots.append(root)
    return roots


def _ctx(calls, kernel=None):
    return {"trace": {"calls": calls}, "work": {} if kernel is None else {"kernel": kernel}}


def _with(monkeypatch, roots):
    flat = [c for r in roots for c in r.children] + roots
    monkeypatch.setattr(profiling, "spans", lambda: list(flat))


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_train_phase_mean_of_the_last_calls(name, monkeypatch):
    j = list(TRAIN).index(name)
    _with(monkeypatch, _train_roots(5))
    # the last 2 of calls 0..4: 10 (j + 1) + 3 and + 4
    assert _reader(name)(_ctx(2)) == pytest.approx(10.0 * (j + 1) + 3.5)
    assert _reader(name)(_ctx(5)) == pytest.approx(10.0 * (j + 1) + 2.0)


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_train_phase_none_without_device_time(name, monkeypatch):
    _with(monkeypatch, _train_roots(3, device=False))
    assert _reader(name)(_ctx(3)) is None
    _with(monkeypatch, [])
    assert _reader(name)(_ctx(3)) is None


@pytest.mark.parametrize("kind", sorted(CHAINS))
def test_prelaunch_mean_of_the_last_calls(kind, monkeypatch):
    read = _reader(f"prelaunch_ms.{kind}")
    _with(monkeypatch, _chain_roots(CHAINS[kind], 4))
    # calls 2 and 3: 0.12 and 0.13 ms from the root's start to the launch's end
    assert read(_ctx(2, CHAINS[kind])) == pytest.approx(0.125)
    assert read(_ctx(4, CHAINS[kind])) == pytest.approx(0.115)
    other = CHAINS["hmc" if kind == "langevin" else "langevin"]
    assert read(_ctx(4, other)) is None
    _with(monkeypatch, [])
    assert read(_ctx(4, CHAINS[kind])) is None


@pytest.mark.parametrize("kind", sorted(CHAINS))
def test_host_syncs_mean_of_the_last_calls(kind, monkeypatch):
    read = _reader(f"host_syncs_per_call.{kind}")
    _with(monkeypatch, _chain_roots(CHAINS[kind], 5))
    # host_reads per call 1, 2, 1, 2, 1
    assert read(_ctx(1, CHAINS[kind])) == 1.0
    assert read(_ctx(2, CHAINS[kind])) == 1.5
    assert read(_ctx(5, CHAINS[kind])) == pytest.approx(7 / 5)
    _with(monkeypatch, [])
    assert read(_ctx(5, CHAINS[kind])) is None


@pytest.mark.parametrize("name", [*TRAIN, *(f"{m}.{k}" for m in ("prelaunch_ms",
                                                                  "host_syncs_per_call")
                                            for k in CHAINS)])
def test_none_from_a_program_without_spans(name, monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    kernel = next((v for k, v in CHAINS.items() if name.endswith(k)), None)
    assert _reader(name)(_ctx(3, kernel)) is None


@pytest.mark.parametrize("kind", sorted(CHAINS))
def test_traced_chain_cell_prints_its_span_metrics(kind, tiny_root, capsys, monkeypatch):
    res = _run(tiny_root, f"eight_gaussians_2d.{kind}_10k", capsys, 1, monkeypatch)
    got = res["metrics"]
    # the seed and the mixture's scale, and Langevin's schedule table copied to the device
    syncs = {"hmc": 2.0, "langevin": 3.0}[kind]
    assert got[f"host_syncs_per_call.{kind}"] == {"value": syncs, "unit": "count"}
    assert got[f"prelaunch_ms.{kind}"]["unit"] == "ms" and got[f"prelaunch_ms.{kind}"]["value"] > 0


def test_traced_train_cell_leaves_out_device_phases_on_the_cpu(tiny_root, capsys, monkeypatch):
    res = _run(tiny_root, "dit_b2_eqm.train_bf16", capsys, 1, monkeypatch)
    assert not set(TRAIN) & set(res["metrics"])
    roots = [s for s in profiling.spans() if s.name == "trainer.train_step"]
    assert len(roots) >= 2 and all(c.device_ms is None for r in roots for c in r.children)
