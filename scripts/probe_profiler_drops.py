"""Count the device events that ``torch.profiler`` loses on a short call.

The call is ``chip_smoke.py``'s AIS kernel path (``annealed_importance_sampling``
on the 8-Gaussians ring, 16,384 chains x 200 rungs: one kernel and about 30
small device operations, 0.2 ms of device time). For ``SECONDS`` seconds it
loads the card with twenty 8,192 x 8,192 products, then profiles the call
twice: in a session that stops right after its ``synchronize()`` and in one
padded by 20 ms of host sleep before the call and after the
``synchronize()``. Each session prints its device events, its device busy
time and where its first and last device events sit against its host
events; the last lines count, for each padding, the sessions that recorded
no device event. Needs a CUDA device:

    python3 scripts/probe_profiler_drops.py 240
"""

import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from torchebm_tpu_torch.core import GaussianEnergy, GaussianMixtureEnergy  # noqa: E402
from torchebm_tpu_torch.samplers import annealed_importance_sampling  # noqa: E402

PADS = (0.0, 0.02)
CUDA = torch.autograd.DeviceType.CUDA


def session(fn, pad: float) -> tuple:
    """One profiled call of ``fn()`` with ``pad`` seconds of host sleep on
    each side: (device events, busy us, first device start - first host
    start us, last host end - last device end us)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if pad:
            time.sleep(pad)
        fn()
        torch.cuda.synchronize()
        if pad:
            time.sleep(pad)
    evs = prof.events()
    dev_ev = [e for e in evs if e.device_type == CUDA]
    cpu_ev = [e for e in evs if e.device_type != CUDA]
    busy = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == CUDA)
    lead = lag = None
    if dev_ev and cpu_ev:
        lead = min(e.time_range.start for e in dev_ev) - min(e.time_range.start for e in cpu_ev)
        lag = max(e.time_range.end for e in cpu_ev) - max(e.time_range.end for e in dev_ev)
    return len(dev_ev), busy, lead, lag


def main() -> None:
    seconds = float(sys.argv[1]) if sys.argv[1:] else 240.0
    if not torch.cuda.is_available():
        raise SystemExit("probe_profiler_drops.py needs a CUDA device and none is visible")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    g = torch.Generator(dev).manual_seed(6)
    kw = dict(base=GaussianEnergy.create(torch.zeros(2), 9 * torch.eye(2)).to(dev),
              n_samples=16384, n_rungs=200, step_size=0.05)

    def fn():
        annealed_importance_sampling(g, mix, **kw)

    fn()
    torch.cuda.synchronize()
    a = torch.randn(8192, 8192, device=dev)
    started = time.perf_counter()
    rows = {pad: [] for pad in PADS}
    while time.perf_counter() - started < seconds:
        for _ in range(20):
            a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()
        for pad in PADS:
            n, busy, lead, lag = session(fn, pad)
            rows[pad].append((n, busy, lead, lag))
            print(f"t {time.perf_counter() - started:7.1f} s pad {pad}: device events {n}, busy "
                  f"{busy / 1e3:.3f} ms, first device event - first host event {lead} us, "
                  f"last host end - last device end {lag} us", flush=True)
    for pad, r in rows.items():
        full = max(x[0] for x in r)
        zero = sum(1 for x in r if x[0] == 0)
        part = sum(1 for x in r if 0 < x[0] < full)
        leads = [x[2] for x in r if x[2] is not None]
        print(f"SUMMARY pad {pad}: sessions {len(r)}, with no device events {zero}, with some "
              f"lost (fewer than {full}) {part}, lead min {min(leads) if leads else None} "
              f"median {statistics.median(leads) if leads else None}")


if __name__ == "__main__":
    main()
