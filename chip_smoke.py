#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``torchebm_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and the exit code is
not 0:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the CUDA kernels compiled from ``torchebm_tpu_torch/ops/csrc``
   into a clean ``build/torch_kernels/``, with each kernel's registers and
   spills;
3. check: every kernel against its plain PyTorch version on the card, on
   injected noise and on the Philox stream, at the main shapes (10,000 x 2,
   8 components; 4,096 x 32 double well) and at d=32 with full covariance,
   with and without schedule, clamp and thinning;
4. main path: ``LangevinDynamics(GaussianMixtureEnergy.eight_gaussians(),
   step_size=0.05).sample(generator, dim=2, n_samples=10_000,
   n_steps=1_000, return_diagnostics=True)`` and the slice's other kernel
   rows, with launch counts, the ring's mean radius and the generic loop
   (``fused="off"``) as reference;
5. timing: CUDA events, medians after warm-up: each kernel against its
   plain version, and the sampler paths, as chain-updates/s beside the
   card's name and power limit.

The line before the last is the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script raises
before it runs anything.
"""

from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import time

#: kernel-vs-plain tolerance (absolute, float32): the kernels contract
#: multiply-adds and take the mixture softmax online in one pass, the plain
#: versions do neither, so results differ by rounding; at these step sizes the
#: chains contract, so rounding does not grow over the checked steps.
TOL = 1e-4
CHECK_STEPS = 50
N_CHAINS, N_STEPS = 10_000, 1_000
DW_SHAPE = (4096, 32)

KERNELS = {
    "mixture_langevin_chain": "torchebm_tpu/ops/fused_langevin.py:1227",
    "mixture_langevin_chain_trajectory": "torchebm_tpu/ops/fused_langevin.py:1381",
    "doublewell_langevin_chain": "torchebm_tpu/ops/fused_langevin.py:442",
    "doublewell_langevin_chain_trajectory": "torchebm_tpu/ops/fused_langevin.py:716",
}
SOURCE = "torchebm_tpu_torch/ops/csrc/fused_langevin.cu"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, warmup: int, reps: int) -> float:
    """Median milliseconds of ``fn()`` between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got, want) -> float:
    import torch

    if isinstance(got, tuple):
        return max(max_err(g, w) for g, w in zip(got, want))
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    return float((got - want).abs().max())


def phase_build(build_mod) -> None:
    shutil.rmtree(build_mod.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    build_mod.load_library()
    seconds = time.perf_counter() - t0
    print(f"build: nvcc sm_90a into {build_mod.BUILD_DIR.name}/ in {seconds:.1f} s from clean")
    log = build_mod.library_path().with_suffix(".log").read_text()
    entry, spills = None, "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"((?:mixture|doublewell)_chain_kernel)I(\w*?)EEv", m.group(1))
            entry = f"{k.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', k.group(2)))}>" \
                if k else m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            print(f"build:   {entry}: {m.group(1)} registers, {spills} bytes spill stores")
            entry, spills = None, "?"


def phase_check(fl, dev, errors: dict) -> None:
    import torch

    g = torch.Generator(dev).manual_seed(1234)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)

    def check(name, args, kwargs, label):
        kernel = getattr(fl, name)
        before = kernel.launches
        got = kernel(*args, **kwargs)
        torch.cuda.synchronize()
        if kernel.launches != before + 1:
            raise AssertionError(f"{name} did not launch its kernel")
        want = getattr(fl, name + "_plain")(*args, **kwargs)
        err = max_err(got, want)
        errors[name] = max(errors.get(name, 0.0), err)
        print(f"check: {name} [{label}] max|kernel - plain| = {err:.3e} (tol {TOL:g})")
        if not err <= TOL:
            raise AssertionError(f"{name} [{label}] disagrees with its plain version: {err}")

    from torchebm_tpu_torch.core import GaussianMixtureEnergy

    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    steps = CHECK_STEPS
    sched = torch.linspace(0.06, 0.02, steps, device=dev)
    # The 8-Gaussians checks start at exact draws of the target with
    # noise_scale 0.5, so each chain stays in its mode, where the chain
    # contracts. On a saddle between modes the drift multiplies float32
    # rounding about 5-fold per step at η = 0.05 (30-fold at the origin), so
    # there a difference measures the dynamics, not the kernel; the full-noise
    # chain is held to the generic loop by its distribution in the main path.
    x2 = mix.sample(g, N_CHAINS)
    mix_kw = dict(scale=float(mix.scale), log_weights=mix.log_weights)
    d = 32
    a = randn(d, d, scale=0.1)
    gauss_kw = dict(precision=(a @ a.T + torch.eye(d, device=dev)).contiguous(), seed=7)
    x32, mean32 = randn(N_CHAINS, d), randn(1, d)
    xdw = randn(*DW_SHAPE, scale=0.5)
    dw_label = f"{DW_SHAPE[0]}x{DW_SHAPE[1]}"
    for label, noise2, noise32, noisedw in (
        ("injected noise", randn(steps, N_CHAINS, 2), randn(steps, N_CHAINS, d),
         randn(steps, *DW_SHAPE)),
        ("philox", None, None, None),
    ):
        for traj in (False, True):
            suffix = "_trajectory" if traj else ""
            tkw = dict(thin=3) if traj else {}
            check("mixture_langevin_chain" + suffix, (x2, mix.means, steps, 0.05, 0.5),
                  dict(**mix_kw, **tkw, seed=11, noise=noise2), f"8gauss const, {label}")
            check("mixture_langevin_chain" + suffix, (x2, mix.means, steps, sched, 0.5),
                  dict(**mix_kw, **tkw, seed=12, clamp=(-4.5, 4.5), noise=noise2),
                  f"8gauss sched+clamp, {label}")
            check("mixture_langevin_chain" + suffix, (x32, mean32, steps, 0.05),
                  dict(**gauss_kw, **tkw, noise=noise32), f"d=32 full cov, {label}")
            tkw = dict(thin=7) if traj else {}
            check("doublewell_langevin_chain" + suffix, (xdw, steps, 0.01),
                  dict(**tkw, seed=13, noise=noisedw), f"{dw_label} const, {label}")
            check("doublewell_langevin_chain" + suffix, (xdw, steps, sched / 5, 0.7),
                  dict(**tkw, seed=14, clamp=(-1.5, 1.5), noise=noisedw),
                  f"{dw_label} sched+clamp, {label}")


def phase_main_path(fl, dev, card: str) -> dict:
    import torch

    from torchebm_tpu_torch.core import DoubleWellEnergy, GaussianMixtureEnergy
    from torchebm_tpu_torch.samplers import LangevinDynamics

    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    sampler = LangevinDynamics(mix, step_size=0.05)
    dw = LangevinDynamics(DoubleWellEnergy(), step_size=0.01)

    fl.reset_launch_counts()
    samples, diag = sampler.sample(
        torch.Generator(dev).manual_seed(0), dim=2, n_samples=N_CHAINS, n_steps=N_STEPS,
        return_diagnostics=True,
    )
    final = sampler.sample(torch.Generator(dev).manual_seed(1), dim=2, n_samples=N_CHAINS,
                           n_steps=N_STEPS)
    dw_final = dw.sample(torch.Generator(dev).manual_seed(2), dim=DW_SHAPE[1],
                         n_samples=DW_SHAPE[0], n_steps=N_STEPS)
    dw_traj = dw.sample(torch.Generator(dev).manual_seed(3), dim=DW_SHAPE[1],
                        n_samples=DW_SHAPE[0], n_steps=N_STEPS, thin=10,
                        return_trajectory=True)
    torch.cuda.synchronize()
    launches = fl.launch_counts()
    print(f"main path: kernel launches {launches}")
    missing = [k for k, v in launches.items() if v < 1]
    if missing:
        raise AssertionError(f"the main path launched no {missing} kernel")

    shapes = {k: tuple(v.shape) for k, v in diag.items()}
    if shapes != {"mean": (N_STEPS, 2), "var": (N_STEPS, 2), "energy": (N_STEPS,)}:
        raise AssertionError(f"diagnostics shapes {shapes}")
    for name, t in (("samples", samples), ("final", final), ("double well", dw_final),
                    ("double-well trajectory", dw_traj), *diag.items()):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{name} is not finite")
    dw_kept = (DW_SHAPE[0], N_STEPS // 10, DW_SHAPE[1])
    if samples.shape != (N_CHAINS, 2) or dw_traj.shape != dw_kept:
        raise AssertionError(f"shapes {tuple(samples.shape)}, {tuple(dw_traj.shape)}")
    radius = float(samples.norm(dim=-1).mean())
    radius_final = float(final.norm(dim=-1).mean())
    exact = float(mix.sample(torch.Generator(dev).manual_seed(4), 100_000).norm(dim=-1).mean())
    loop, loop_diag = LangevinDynamics(mix, step_size=0.05, fused="off").sample(
        torch.Generator(dev).manual_seed(0), dim=2, n_samples=N_CHAINS, n_steps=N_STEPS,
        return_diagnostics=True,
    )
    if {k: tuple(v.shape) for k, v in loop_diag.items()} != shapes:
        raise AssertionError("the generic loop's diagnostics have other shapes")
    radius_loop = float(loop.norm(dim=-1).mean())
    dw_abs = float(dw_final.abs().mean())
    print(f"main path: mean radius {radius:.4f} (kernel, diagnostics) {radius_final:.4f} "
          f"(kernel) {radius_loop:.4f} (generic loop) {exact:.4f} (exact draws); "
          f"double well E|x| {dw_abs:.4f} | {card}")
    if not 3.0 < radius < 5.0:
        raise AssertionError(f"sampler off-distribution: mean radius {radius}")
    if abs(radius - radius_loop) > 0.05 or abs(radius_final - radius_loop) > 0.05:
        raise AssertionError("kernel path and generic loop disagree on the mean radius")
    if not 0.5 < dw_abs < 1.5:
        raise AssertionError(f"double-well chain off-distribution: E|x| = {dw_abs}")
    return launches


def phase_timing(fl, dev, card: str) -> dict:
    import torch

    from torchebm_tpu_torch.core import GaussianMixtureEnergy
    from torchebm_tpu_torch.samplers import LangevinDynamics

    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    g = torch.Generator(dev).manual_seed(5)
    x2 = torch.randn((N_CHAINS, 2), generator=g, device=dev)
    xdw = 0.5 * torch.randn(DW_SHAPE, generator=g, device=dev)
    mix_args = (x2, mix.means, N_STEPS, 0.05)
    mix_kw = dict(scale=float(mix.scale), log_weights=mix.log_weights, seed=21)
    dw_args, dw_kw = (xdw, N_STEPS, 0.01), dict(seed=22)
    calls = {
        "mixture_langevin_chain": (mix_args, mix_kw, N_CHAINS),
        "mixture_langevin_chain_trajectory": (mix_args, dict(mix_kw, thin=1), N_CHAINS),
        "doublewell_langevin_chain": (dw_args, dw_kw, xdw.numel()),
        "doublewell_langevin_chain_trajectory": (dw_args, dict(dw_kw, thin=10), xdw.numel()),
    }
    times = {}
    for name, (args, kw, n) in calls.items():
        kernel, plain = getattr(fl, name), getattr(fl, name + "_plain")
        ms = cuda_ms(lambda: kernel(*args, **kw), warmup=2, reps=10)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), warmup=1, reps=3)
        times[name] = (ms, plain_ms)
        print(f"timing: {name} {n}x{N_STEPS} steps: kernel {ms:.3f} ms "
              f"({n * N_STEPS / ms * 1e3:.4e} chain-updates/s), plain {plain_ms:.3f} ms "
              f"({n * N_STEPS / plain_ms * 1e3:.4e} chain-updates/s) | {card}")

    def sampler_call(fused, diagnostics):
        s = LangevinDynamics(mix, step_size=0.05, fused=fused)
        return lambda: s.sample(g, dim=2, n_samples=N_CHAINS, n_steps=N_STEPS,
                                return_diagnostics=diagnostics)

    for label, fused, diagnostics in (
        ("sample() kernel path", "auto", False),
        ("sample() kernel path + diagnostics", "auto", True),
        ("sample() generic loop", "off", False),
        ("sample() generic loop + diagnostics", "off", True),
    ):
        ms = cuda_ms(sampler_call(fused, diagnostics), warmup=1, reps=3)
        print(f"timing: {label} {N_CHAINS}x{N_STEPS}: {ms:.3f} ms "
              f"({N_CHAINS * N_STEPS / ms * 1e3:.4e} chain-updates/s) | {card}")
    return times


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device and none is visible")
    from torchebm_tpu_torch.ops import _build
    from torchebm_tpu_torch.ops import fused_langevin as fl

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False

    phase_build(_build)
    errors: dict = {}
    phase_check(fl, dev, errors)
    launches = phase_main_path(fl, dev, card)
    times = phase_timing(fl, dev, card)

    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errors[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, replaces in KERNELS.items()
    ]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
