"""The port's spans and counters (:mod:`torchebm_tpu_torch.utils.profiling`).

- With no profiler running a span records nothing and enters no annotation.
- Under ``torch.profiler`` an HMC and a Langevin call on their kernels'
  plain versions (``fused="force"``) each record one root ``sampler.sample``
  and its phases start → dispatch → seed → ``ops.*``, in order, without
  overlap, under the root's call id; ``host_reads`` rises at the mixture's
  scale (dispatch), the seed and, for Langevin, the schedule's copy to the
  device (the wrapper).
- On the card (``gpu``, skipped here) ``host_reads`` equals the stream
  synchronisations that ``torch.cuda.set_sync_debug_mode`` reports in one
  call of each sampler and one train step.
- The annotated spans lie on the profiler's clock: each recorded start and
  end contain the profiler's event of the same name, within 1 ms.
- ``BaseTrainer.train_step`` records ``trainer.forward``, ``.backward`` and
  ``.optimizer`` in order under one root; their device time is None on the
  CPU and a time on the card (``gpu``, skipped here).
- The buffer stays bounded; kernel wrappers keep their names and launch counts.

This file imports neither JAX nor the JAX package; its card test runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -m gpu
"""

import functools
import time
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torchebm_tpu_torch.core import BaseTrainer, GaussianMixtureEnergy
from torchebm_tpu_torch.losses import EquilibriumMatchingLoss
from torchebm_tpu_torch.models import MLPVelocityField
from torchebm_tpu_torch.ops import _build, fused_langevin
from torchebm_tpu_torch.samplers import HamiltonianMonteCarlo, LangevinDynamics
from torchebm_tpu_torch.utils import profiling

PHASES = ["sampler.start", "sampler.dispatch", "sampler.seed"]
KERNELS = {"langevin": "ops.mixture_langevin_chain", "hmc": "ops.mixture_hmc_chain"}
# host_reads in each phase of a call: start, dispatch (the mixture's scale),
# seed, the wrapper (Langevin's schedule table copied to the device)
READS = {"langevin": [0, 1, 1, 1], "hmc": [0, 1, 1, 0]}


@pytest.fixture(autouse=True)
def _empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _sampler(kind, energy):
    if kind == "langevin":
        return LangevinDynamics(energy, step_size=0.05, fused="force")
    return HamiltonianMonteCarlo(energy, step_size=0.3, n_leapfrog_steps=3, fused="force")


def _call(kind, energy=None, g=None):
    energy = GaussianMixtureEnergy.eight_gaussians() if energy is None else energy
    g = torch.Generator().manual_seed(0) if g is None else g
    return _sampler(kind, energy).sample(g, x=torch.randn(16, 2, generator=g), n_steps=4)


def _roots(name):
    return [s for s in profiling.spans() if s.parent is None and s.name == name]


def _raise(*args, **kwargs):
    raise AssertionError("entered a profiler annotation with no profiler running")


@pytest.mark.parametrize("kind", ["langevin", "hmc"])
def test_no_profiler_records_nothing(kind, monkeypatch):
    monkeypatch.setattr(profiling, "_annotation", _raise)
    monkeypatch.setattr(profiling, "record_function", _raise)
    reads = profiling.counters()["host_reads"]
    _call(kind)
    assert profiling.spans() == []
    assert profiling.span("sampler.sample") is profiling.span("trainer.forward")
    # the counter is always on
    assert profiling.counters()["host_reads"] - reads == sum(READS[kind])


@pytest.mark.parametrize("kind", ["langevin", "hmc"])
def test_chain_call_phases(kind):
    energy, g = GaussianMixtureEnergy.eight_gaussians(), torch.Generator().manual_seed(1)
    with profile(activities=[ProfilerActivity.CPU]):
        _call(kind, energy, g)
        _call(kind, energy, g)
    first, second = _roots("sampler.sample")
    assert len(profiling.spans()) == 2 * 5
    for root in (first, second):
        names = [c.name for c in root.children]
        assert names == PHASES + [KERNELS[kind]]
        assert all(c.call == root.call and c.parent == "sampler.sample" for c in root.children)
        ends = [root.start_ns] + [t for c in root.children for t in (c.start_ns, c.end_ns)]
        assert ends == sorted(ends) and root.children[-1].end_ns <= root.end_ns
        assert [c.counts for c in root.children] == [{"host_reads": n} for n in READS[kind]]
        assert root.counts == {"host_reads": sum(READS[kind])}
    assert first.call != second.call


def test_spans_share_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call("langevin")
        _call("hmc")
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    annotated = [s for s in profiling.spans() if s.parent is not None]
    assert len(annotated) == 8
    for s in annotated:
        e = events[s.name].pop(0)
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        assert s.start_ns <= start <= s.start_ns + 1_000_000
        assert end <= s.end_ns <= end + 1_000_000
    # the roots are kept in memory only
    assert "sampler.sample" not in events


def _trainer(seed=0):
    torch.manual_seed(seed)
    net = MLPVelocityField(2, (16, 16))
    eqm = EquilibriumMatchingLoss(model=net)
    trainer = BaseTrainer(eqm, functools.partial(torch.optim.Adam, lr=1e-3), ema_decay=0.9)
    return trainer, trainer.init_state(net, torch.Generator().manual_seed(seed))


def test_train_step_phases():
    trainer, state = _trainer()
    x = torch.randn(32, 2, generator=torch.Generator().manual_seed(2))
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            state, _ = trainer.train_step(state, x)
    roots = _roots("trainer.train_step")
    assert len(roots) == 2 and state.step == 2
    for root in roots:
        names = [c.name for c in root.children]
        assert names == ["trainer.forward", "trainer.backward", "trainer.optimizer"]
        ends = [t for c in root.children for t in (c.start_ns, c.end_ns)]
        assert ends == sorted(ends) and root.start_ns <= ends[0] and ends[-1] <= root.end_ns
        assert all(c.call == root.call for c in root.children)
        assert [c.device_ms for c in root.children] == [None] * 3
        assert root.device_ms is None


def test_buffer_is_bounded():
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(profiling.SPAN_BUFFER + 10):
            with profiling.span("root"):
                pass
    got = profiling.spans()
    assert len(got) == profiling.SPAN_BUFFER
    # the oldest are dropped: the last call ids remain
    assert got[-1].call - got[0].call == profiling.SPAN_BUFFER - 1


def test_span_ends_on_an_error():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with profiling.span("root"):
                with profiling.span("inner"):
                    raise ValueError("raised inside a span")
        with profiling.span("next"):
            pass
    inner, root, after = profiling.spans()
    assert (inner.parent, root.parent, after.parent) == ("root", None, None)
    assert root.children == [inner] and after.call != root.call


def test_counter_rises_by_what_is_counted():
    before = profiling.counters()
    profiling.count("host_reads")
    assert profiling.counters()["host_reads"] == before["host_reads"] + 1
    with pytest.raises(KeyError):
        profiling.count("no_such_counter")


def test_wrappers_keep_names_and_launch_counts(monkeypatch):
    counts = _build.launch_counts()
    assert fused_langevin.mixture_langevin_chain.__name__ == "mixture_langevin_chain"
    with profile(activities=[ProfilerActivity.CPU]):
        _call("langevin")
    assert _build.launch_counts() == counts  # the CPU path launches no kernel
    profiling.clear_spans()
    # a launch through the wrapper raises its count once, traced or not
    monkeypatch.setattr(fused_langevin, "_mixture_run",
                        lambda name, x0, *a, **k: (None, x0, True))
    means = GaussianMixtureEnergy.eight_gaussians().means
    before = fused_langevin.mixture_langevin_chain.launches
    fused_langevin.mixture_langevin_chain(torch.zeros(4, 2), means, 3, 0.1)
    with profile(activities=[ProfilerActivity.CPU]):
        fused_langevin.mixture_langevin_chain(torch.zeros(4, 2), means, 3, 0.1)
    assert fused_langevin.mixture_langevin_chain.launches == before + 2
    assert [s.name for s in profiling.spans()] == ["ops.mixture_langevin_chain"]


@pytest.mark.gpu
def test_train_step_device_time_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.manual_seed(0)
    net = MLPVelocityField(2, (256, 256)).cuda()
    trainer = BaseTrainer(EquilibriumMatchingLoss(model=net),
                          functools.partial(torch.optim.Adam, lr=1e-3), ema_decay=0.9)
    state = trainer.init_state(net, torch.Generator("cuda").manual_seed(0))
    x = torch.randn(256, 2, device="cuda")
    state, _ = trainer.train_step(state, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t0 = time.time_ns()
        state, _ = trainer.train_step(state, x)
        torch.cuda.synchronize()
        wall_ms = (time.time_ns() - t0) / 1e6
    (root,) = _roots("trainer.train_step")
    ms = [c.device_ms for c in root.children]
    assert all(m is not None and m > 0 for m in ms)
    assert sum(ms) <= wall_ms


def _count_syncs(fn):
    """``(stream synchronisations reported by the sync debug mode, rise of
    host_reads)`` over ``fn()``."""
    torch.cuda.synchronize()
    before = profiling.counters()["host_reads"]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchronizing" in str(w.message) for w in caught)
    return syncs, profiling.counters()["host_reads"] - before


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["langevin", "hmc", "train"])
def test_host_reads_count_every_sync_on_the_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator("cuda").manual_seed(0)
    if kind == "train":
        torch.manual_seed(0)
        net = MLPVelocityField(2, (256, 256)).cuda()
        trainer = BaseTrainer(EquilibriumMatchingLoss(model=net),
                              functools.partial(torch.optim.AdamW, lr=1e-3), ema_decay=0.9)
        state = trainer.init_state(net, g)
        x = torch.randn(256, 2, device="cuda", generator=g)
        call = functools.partial(trainer.train_step, state, x)
    else:
        sampler = _sampler(kind, GaussianMixtureEnergy.eight_gaussians().to("cuda"))
        x = torch.randn(4096, 2, device="cuda", generator=g)
        call = functools.partial(sampler.sample, g, x=x, n_steps=8)
    call()  # builds and loads the kernel, sets up the optimizer's state
    syncs, reads = _count_syncs(call)
    assert syncs == reads == (0 if kind == "train" else sum(READS[kind]))
