"""Device busy time of a profiled call read two ways, and what each costs.

``chip_smoke.py::device_busy_ms`` sums the durations of the CUDA events
that ``torch.profiler`` records, read from the session's raw events. This
script reads the same sessions through ``key_averages()`` as well (the self
device time of the CUDA events, ``chip_smoke.device_events``), on three
calls: the Langevin kernel path (10,000 chains x 1,000 steps), 20
transitions of HMC's generic loop and 5 NUTS transitions (256 chains),
and prints both sums with the host seconds each read took. Needs a CUDA
device:

    python3 scripts/compare_device_busy.py
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from torchebm_tpu_torch.core import GaussianMixtureEnergy  # noqa: E402
from torchebm_tpu_torch.samplers import (  # noqa: E402
    HamiltonianMonteCarlo,
    LangevinDynamics,
    NoUTurnSampler,
)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn((10_000, 2), generator=g, device=dev)
    lang = LangevinDynamics(mix, step_size=0.05)
    hmc = HamiltonianMonteCarlo(mix, step_size=0.3, n_leapfrog_steps=8, fused="off")
    nuts = NoUTurnSampler(cs._corr_gaussian(dev), step_size=0.5, max_tree_depth=8)
    x2 = torch.randn((256, 2), generator=g, device=dev)
    calls = {"langevin kernel": lambda: lang.sample(g, x=x, n_steps=1000),
             "hmc loop 20": lambda: hmc.sample(g, x=x, n_steps=20),
             "nuts 5": lambda: nuts.sample(g, x=x2, n_steps=5)}
    cuda = torch.autograd.DeviceType.CUDA
    for label, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        for _ in range(2):
            prof = cs.profiled(fn)
            t0 = time.perf_counter()
            tables = sum(e.self_device_time_total for e in cs.device_events(prof)) / 1e3
            t1 = time.perf_counter()
            raw = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                      if e.device_type() == cuda and not e.is_user_annotation()) / 1e6
            t2 = time.perf_counter()
            print(f"busy check {label}: key_averages {tables:.4f} ms ({t1 - t0:.2f} s), raw "
                  f"{raw:.4f} ms ({t2 - t1:.2f} s) | {cs.card_line()}", flush=True)


if __name__ == "__main__":
    main()
