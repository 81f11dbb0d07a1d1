#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``torchebm_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and the exit code is
not 0:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the CUDA kernels compiled from ``torchebm_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, in parallel) into a clean
   ``build/torch_kernels/``, with each kernel instance's registers and spills;
3. check: every kernel against its plain PyTorch version on the card, on
   injected randomness and on the Philox stream, at the main shapes (10,000
   x 2, 8 components; 4,096 x 32 double well) and at d=32 with full
   covariance, with and without schedule, clamp, diagonal mass and thinning;
   MALA and HMC also at the ESS protocol's own instances and steps (the
   correlated Gaussian at MALA's pilot step and HMC's adapted steps and
   mass, thin 4), with each check's mean acceptance.
   The MALA and HMC chains take a Metropolis decision per step; a chain whose
   uniform lies within rounding of its acceptance probability may decide
   differently in kernel and plain version and then differs by a whole
   proposal, so those checks allow at most 0.1% of the chains to differ
   (printed as "flipped") and hold every other chain to the tolerance;
4. main path, each path with the launch counts set to 0 just before it and
   read just after:
   - Langevin: ``LangevinDynamics(GaussianMixtureEnergy.eight_gaussians(),
     step_size=0.05).sample(generator, dim=2, n_samples=10_000,
     n_steps=1_000, return_diagnostics=True)`` and the slice's other rows;
   - HMC: ``HamiltonianMonteCarlo(eight_gaussians, step_size=0.3,
     n_leapfrog_steps=8).sample(...)`` at 10,000 x 1,000, and the ESS protocol
     on the correlated Gaussian (cov [[1, .8], [.8, 1]]): ``warmup``,
     ``replace(step_size=eps).sample(..., return_trajectory=True)`` (1,000
     kept draws of 4,000, and 1,000 consecutive draws),
     ``summarize_chains``, again with ``warmup(adapt_mass=True)``;
   - MALA: the same two calls (pilot-tuned step on the correlated Gaussian);
   - gradient descent on the Langevin mixture row at noise 0;
   with the ring's mean radius and the Metropolis acceptance against the
   generic loop (``fused="off"``), and the correlated Gaussian's covariance,
   R-hat and ESS (over consecutive draws, R-hat within 0.005 of the loop's);
5. timing: CUDA events, medians after warm-up: each kernel against its
   plain version, and the sampler paths, beside the card's name and power
   limit;
6. profile: wall time, device busy time (``torch.profiler``) and idle share
   of the sampler paths, the HMC warmup and ``summarize_chains``.

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

#: the most chains a Metropolis check may flip (0.1% of N_CHAINS)
MAX_FLIPPED = N_CHAINS // 1000
HMC_LEAPFROG = 8
CORR_COV = ((1.0, 0.8), (0.8, 1.0))
#: the ESS protocol's R-hat gate reads 1,000 draws kept of 4,000 (thin 4):
#: split-R-hat over n draws per half-chain is about 1 + (tau - 1) / (2n) for an
#: integrated autocorrelation time tau, so over 1,000 consecutive draws a
#: chain with tau above about 11 reads above 1.01 however long it has mixed;
#: R-hat over 1,000 consecutive draws is printed beside the loop's and held
#: to it
ESS_DRAWS, ESS_THIN = 4 * N_STEPS, 4

_CSRC = "torchebm_tpu_torch/ops/csrc/"
#: wrapper -> (module, CUDA source, the TPU kernel it replaces)
KERNELS = {
    "mixture_langevin_chain":
        ("fused_langevin", _CSRC + "fused_langevin.cu", "torchebm_tpu/ops/fused_langevin.py:1227"),
    "mixture_langevin_chain_trajectory":
        ("fused_langevin", _CSRC + "fused_langevin.cu", "torchebm_tpu/ops/fused_langevin.py:1381"),
    "doublewell_langevin_chain":
        ("fused_langevin", _CSRC + "fused_langevin.cu", "torchebm_tpu/ops/fused_langevin.py:442"),
    "doublewell_langevin_chain_trajectory":
        ("fused_langevin", _CSRC + "fused_langevin.cu", "torchebm_tpu/ops/fused_langevin.py:716"),
    "mixture_mala_chain":
        ("fused_mala", _CSRC + "fused_mala.cu", "torchebm_tpu/ops/fused_mala.py:209"),
    "mixture_mala_chain_trajectory":
        ("fused_mala", _CSRC + "fused_mala.cu", "torchebm_tpu/ops/fused_mala.py:314"),
    "mixture_hmc_chain":
        ("fused_hmc", _CSRC + "fused_hmc.cu", "torchebm_tpu/ops/fused_hmc.py:370"),
    "mixture_hmc_chain_trajectory":
        ("fused_hmc", _CSRC + "fused_hmc.cu", "torchebm_tpu/ops/fused_hmc.py:238"),
}


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
    sources = ", ".join(p.name for p in build_mod._sources())
    print(f"build: nvcc sm_90a, one process per source ({sources}), into "
          f"{build_mod.BUILD_DIR.name}/ in {seconds:.1f} s from clean")
    log = build_mod.library_path().with_suffix(".log").read_text()
    entry, spills = None, "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"((?:mixture|doublewell|mala|hmc)_chain_kernel)I(\w*?)EEv",
                          m.group(1))
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


def path_langevin(ops, dev, card: str) -> dict:
    import torch

    from torchebm_tpu_torch.core import DoubleWellEnergy, GaussianMixtureEnergy
    from torchebm_tpu_torch.samplers import LangevinDynamics

    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    sampler = LangevinDynamics(mix, step_size=0.05)
    dw = LangevinDynamics(DoubleWellEnergy(), step_size=0.01)

    ops.reset_launch_counts()
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
    launches = read_counts(ops, "Langevin", [k for k, v in KERNELS.items()
                                             if v[0] == "fused_langevin"])

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



def _mala_pilot_step(dev) -> float:
    """MALA's step on the correlated Gaussian: the trial closest to the 0.574
    optimal-scaling acceptance on the loop (diagnostics take the loop), as
    the JAX package's ESS protocol picks it."""
    import torch

    from torchebm_tpu_torch.samplers import MetropolisAdjustedLangevin

    best, gap = None, 2.0
    for trial in (0.1, 0.25, 0.5, 0.9):
        _, diag = MetropolisAdjustedLangevin(_corr_gaussian(dev), step_size=trial).sample(
            torch.Generator(dev).manual_seed(80), dim=2, n_samples=N_CHAINS, n_steps=100,
            return_diagnostics=True)
        trial_gap = abs(float(diag["acceptance_rate"][-1]) - 0.574)
        if trial_gap < gap:
            best, gap = trial, trial_gap
    return best


def _hmc_warmup(dev, adapt_mass: bool):
    """The ESS protocol's HMC warmup on the correlated Gaussian:
    ``(sampler, (x0, step, [mass]))``."""
    import torch

    from torchebm_tpu_torch.samplers import HamiltonianMonteCarlo

    hmc = HamiltonianMonteCarlo(_corr_gaussian(dev), step_size=0.2,
                                n_leapfrog_steps=HMC_LEAPFROG, dual_averaging=True)
    g = torch.Generator(dev).manual_seed(61 + adapt_mass)
    return hmc, g, hmc.warmup(g, dim=2, n_warmup=200, n_samples=N_CHAINS,
                              adapt_mass=adapt_mass)


def phase_check_metropolis(ops, dev, errors: dict) -> None:
    """The MALA and HMC kernels against their plain versions (flip rule in
    the module docstring), each with the plain version's mean acceptance."""
    import torch

    from torchebm_tpu_torch.core import GaussianMixtureEnergy
    from torchebm_tpu_torch.samplers.base import _gaussian_target

    g = torch.Generator(dev).manual_seed(4321)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)

    def check(name, args, kwargs, label):
        module = getattr(ops, KERNELS[name][0])
        kernel = getattr(module, name)
        before = kernel.launches
        got = kernel(*args, **kwargs)
        torch.cuda.synchronize()
        if kernel.launches != before + 1:
            raise AssertionError(f"{name} did not launch its kernel")
        want = getattr(module, name + "_plain")(*args, **kwargs)
        n = args[0].shape[0]
        flipped = torch.zeros(n, dtype=torch.bool, device=dev)
        diffs = []
        for gt, wt in zip(got, want):
            if not torch.isfinite(gt).all():
                raise AssertionError(f"{name} [{label}]: kernel output is not finite")
            d = (gt - wt).abs()
            d = d.amax(dim=(0, 2)) if d.ndim == 3 else (d.amax(dim=1) if d.ndim == 2 else d)
            diffs.append(d)
            flipped |= d > TOL
        n_flipped = int(flipped.sum())
        err = max(float(torch.where(flipped, 0.0, d).max()) for d in diffs)
        errors[name] = max(errors.get(name, 0.0), err)
        print(f"check: {name} [{label}] max|kernel - plain| = {err:.3e} over the "
              f"{n - n_flipped} chains that agree (tol {TOL:g}); flipped chains {n_flipped} "
              f"(at most {MAX_FLIPPED}); mean acceptance {float(want[-1].mean()):.4f}")
        if not err <= TOL or n_flipped > MAX_FLIPPED:
            raise AssertionError(f"{name} [{label}] disagrees with its plain version")

    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    steps = CHECK_STEPS
    # start at exact draws of the target with small steps, where the chains
    # contract (a leapfrog run across a saddle multiplies rounding)
    x2 = mix.sample(g, N_CHAINS)
    mix_kw = dict(scale=float(mix.scale), log_weights=mix.log_weights)
    d = 32
    a = randn(d, d, scale=0.1)
    gauss_kw = dict(precision=(a @ a.T + torch.eye(d, device=dev)).contiguous())
    mean32 = randn(1, d)
    x32 = mean32 + randn(N_CHAINS, d, scale=0.7)
    mass2 = torch.tensor([0.5, 2.0], device=dev)
    mass32 = 0.5 + 1.5 * torch.rand(d, generator=g, device=dev)
    # the ESS protocol's kernel instances (d=2 precision, thin 4) at its own
    # steps, from exact draws of the correlated Gaussian: MALA's pilot step and
    # HMC's adapted steps and mass, where a material share of proposals is
    # rejected. The ring's HMC step 0.3 is not checked this way: over 50 draws
    # the mixture's leapfrog multiplies rounding past the tolerance on about
    # 0.7% of the chains, an error that grows smoothly rather than a flip.
    corr_means, corr_prec = _gaussian_target(_corr_gaussian(dev))
    corr_kw = dict(precision=corr_prec.contiguous())
    chol = torch.linalg.cholesky(torch.tensor(CORR_COV, device=dev))
    xc = (randn(N_CHAINS, 2) @ chol.T).contiguous()
    mala_step = _mala_pilot_step(dev)
    eps_unit = _hmc_warmup(dev, False)[2][1]
    _, _, (_, eps_mass, mass_adapted) = _hmc_warmup(dev, True)
    print(f"check: correlated Gaussian at MALA step {mala_step}, HMC steps {eps_unit:.5f} "
          f"(unit mass) and {eps_mass:.5f} (adapted mass "
          f"{[round(float(m), 5) for m in mass_adapted]})")
    for label, inject in (("injected", True), ("philox", False)):
        def rand_kw(dim, seed):
            if not inject:
                return dict(seed=seed)
            return dict(noise=randn(steps, N_CHAINS, dim),
                        uniforms=torch.rand((steps, N_CHAINS), generator=g, device=dev))

        for traj in (False, True):
            sfx = "_trajectory" if traj else ""
            tkw = dict(thin=3) if traj else {}
            check("mixture_mala_chain" + sfx, (x2, mix.means, steps, 0.05),
                  dict(**mix_kw, **tkw, **rand_kw(2, 31)), f"8gauss, {label}")
            check("mixture_mala_chain" + sfx, (x32, mean32, steps, 0.05),
                  dict(**gauss_kw, **tkw, **rand_kw(d, 32)), f"d=32 full cov, {label}")
            for mass_label, m2, m32 in (("unit mass", None, None),
                                        ("diagonal mass", mass2, mass32)):
                check("mixture_hmc_chain" + sfx, (x2, mix.means, steps, 0.05, HMC_LEAPFROG),
                      dict(**mix_kw, **tkw, mass=m2, **rand_kw(2, 33)),
                      f"8gauss, {mass_label}, {label}")
                check("mixture_hmc_chain" + sfx, (x32, mean32, steps, 0.05, HMC_LEAPFROG),
                      dict(**gauss_kw, **tkw, mass=m32, **rand_kw(d, 34)),
                      f"d=32 full cov, {mass_label}, {label}")
            tkw = dict(thin=ESS_THIN) if traj else {}
            check("mixture_mala_chain" + sfx, (xc, corr_means, steps, mala_step),
                  dict(**corr_kw, **tkw, **rand_kw(2, 36)), f"corr-Gaussian, {label}")
            for mass_label, eps, m in (("unit mass", eps_unit, None),
                                       ("adapted mass", eps_mass, mass_adapted)):
                check("mixture_hmc_chain" + sfx, (xc, corr_means, steps, eps, HMC_LEAPFROG),
                      dict(**corr_kw, **tkw, mass=m, **rand_kw(2, 37)),
                      f"corr-Gaussian, {mass_label}, {label}")


def read_counts(ops, path: str, expected) -> dict:
    """The launch counts after a path (synchronised), failing if any of the
    path's ``expected`` kernels was not launched."""
    import torch

    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"main path [{path}]: kernel launches {launches}")
    missing = [k for k in expected if launches[k] < 1]
    if missing:
        raise AssertionError(f"the {path} path launched no {missing} kernel")
    return launches


def _corr_gaussian(dev):
    import torch

    from torchebm_tpu_torch.core import GaussianEnergy

    return GaussianEnergy.create(torch.zeros(2), torch.tensor(CORR_COV)).to(dev)


def _check_corr_trajectory(name: str, traj, traj_loop, consecutive, card: str) -> None:
    """Covariance, R-hat and ESS of a correlated-Gaussian trajectory
    ``(n_chains, n_draws, 2)`` from the kernel, beside the loop's; and R-hat
    and ESS over ``N_STEPS`` consecutive draws, ``consecutive = (kernel,
    loop)`` trajectories, where the kernel must read what the loop reads."""
    import torch

    from torchebm_tpu_torch.samplers import summarize_chains

    for t in (traj, *consecutive):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{name}: trajectory is not finite")
    s1, s1_loop = summarize_chains(consecutive[0]), summarize_chains(consecutive[1])
    rhat1, rhat1_loop = float(s1["r_hat"].max()), float(s1_loop["r_hat"].max())
    print(f"main path: {name} {tuple(consecutive[0].shape)} consecutive draws: max R-hat "
          f"{rhat1:.5f} (generic loop {rhat1_loop:.5f}), min ESS {float(s1['ess'].min()):.1f} "
          f"(generic loop {float(s1_loop['ess'].min()):.1f}) | {card}")
    if not abs(rhat1 - rhat1_loop) <= 0.005:
        raise AssertionError(f"{name}: R-hat over consecutive draws {rhat1}, loop {rhat1_loop}")
    # float64: a float32 covariance over 1e7 draws loses about 1.5% to rounding
    cov = torch.cov(traj.reshape(-1, 2).T.double())
    err = float((cov - torch.tensor(CORR_COV, device=traj.device, dtype=cov.dtype)).abs().max())
    s, s_loop = summarize_chains(traj), summarize_chains(traj_loop)
    rhat, ess = float(s["r_hat"].max()), float(s["ess"].min())
    print(f"main path: {name} {tuple(traj.shape)}: covariance "
          f"[[{cov[0, 0]:.4f}, {cov[0, 1]:.4f}], [{cov[1, 0]:.4f}, {cov[1, 1]:.4f}]] "
          f"(max |error| {err:.4f}), max R-hat {rhat:.5f} (generic loop "
          f"{float(s_loop['r_hat'].max()):.5f}), min ESS {ess:.1f} (generic loop "
          f"{float(s_loop['ess'].min()):.1f}) | {card}")
    if not err <= 0.05:
        raise AssertionError(f"{name}: sample covariance off by {err}")
    if not rhat < 1.01:
        raise AssertionError(f"{name}: max R-hat {rhat} >= 1.01")


def _ring_against_loop(name, sampler_cls, kernel, kw, kernel_args, dev, card) -> None:
    """Mean radius and acceptance of a direct kernel call on the 8-Gaussians
    ring, against the generic loop at the same settings and start."""
    import torch

    from torchebm_tpu_torch.core import GaussianMixtureEnergy

    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    g = torch.Generator(dev).manual_seed(50)
    x0 = torch.randn((N_CHAINS, 2), generator=g, device=dev)
    samples, accept = kernel(x0, mix.means, N_STEPS, *kernel_args, scale=float(mix.scale),
                             log_weights=mix.log_weights, seed=51)
    loop, diag = sampler_cls(mix, fused="off", **kw).sample(
        g, x=x0, n_steps=N_STEPS, thin=N_STEPS // 10, return_diagnostics=True)
    r, r_loop = float(samples.norm(dim=-1).mean()), float(loop.norm(dim=-1).mean())
    acc, acc_loop = float(accept.mean()), float(diag["acceptance_rate"].mean())
    print(f"main path: {name} 8gauss {N_CHAINS}x{N_STEPS}: mean radius {r:.4f} (kernel) "
          f"{r_loop:.4f} (generic loop); mean acceptance {acc:.4f} (kernel) "
          f"{acc_loop:.4f} (generic loop, every {N_STEPS // 10}th step) | {card}")
    if not torch.isfinite(samples).all() or abs(r - r_loop) > 0.05:
        raise AssertionError(f"{name}: kernel and generic loop disagree on the mean radius")


def path_hmc(ops, dev, card: str) -> dict:
    import torch

    from torchebm_tpu_torch.core import GaussianMixtureEnergy
    from torchebm_tpu_torch.ops import fused_hmc
    from torchebm_tpu_torch.samplers import HamiltonianMonteCarlo

    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    ops.reset_launch_counts()
    ring = HamiltonianMonteCarlo(mix, step_size=0.3, n_leapfrog_steps=HMC_LEAPFROG).sample(
        torch.Generator(dev).manual_seed(60), dim=2, n_samples=N_CHAINS, n_steps=N_STEPS)
    runs = []
    for adapt_mass in (False, True):
        hmc, g, (x0, eps, *mass) = _hmc_warmup(dev, adapt_mass)
        tuned = hmc.replace(step_size=eps, mass=mass[0] if mass else None)
        traj = tuned.sample(g, x=x0, n_steps=ESS_DRAWS, thin=ESS_THIN, return_trajectory=True)
        consecutive = tuned.sample(g, x=x0, n_steps=N_STEPS, return_trajectory=True)
        runs.append((tuned, x0, eps, traj, consecutive))
    launches = read_counts(ops, "HMC", ["mixture_hmc_chain", "mixture_hmc_chain_trajectory"])
    if ring.shape != (N_CHAINS, 2) or not torch.isfinite(ring).all():
        raise AssertionError("HMC ring samples are malformed")
    print(f"main path: HMC 8gauss sample() mean radius {float(ring.norm(dim=-1).mean()):.4f}")
    _ring_against_loop("HMC", HamiltonianMonteCarlo,
                       fused_hmc.mixture_hmc_chain,
                       dict(step_size=0.3, n_leapfrog_steps=HMC_LEAPFROG), (0.3, HMC_LEAPFROG),
                       dev, card)
    for (tuned, x0, eps, traj, consecutive), label in zip(
            runs, ("unit mass", "adapted diagonal mass")):
        print(f"main path: HMC warmup ({label}): step size {eps:.5f}, mass "
              f"{None if tuned.mass is None else [round(float(m), 5) for m in tuned.mass]}")
        looped = tuned.replace(fused="off")
        g = torch.Generator(dev).manual_seed(70)
        loop = looped.sample(g, x=x0, n_steps=ESS_DRAWS, thin=ESS_THIN, return_trajectory=True)
        loop1 = looped.sample(g, x=x0, n_steps=N_STEPS, return_trajectory=True)
        _check_corr_trajectory(f"HMC corr-Gaussian, {label}", traj, loop, (consecutive, loop1),
                               card)
    return launches


def path_mala(ops, dev, card: str) -> dict:
    import torch

    from torchebm_tpu_torch.core import GaussianMixtureEnergy
    from torchebm_tpu_torch.ops import fused_mala
    from torchebm_tpu_torch.samplers import MetropolisAdjustedLangevin

    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    best = _mala_pilot_step(dev)
    mala = MetropolisAdjustedLangevin(_corr_gaussian(dev), step_size=best)
    g = torch.Generator(dev).manual_seed(81)
    ops.reset_launch_counts()
    ring = MetropolisAdjustedLangevin(mix, step_size=0.05).sample(
        torch.Generator(dev).manual_seed(82), dim=2, n_samples=N_CHAINS, n_steps=N_STEPS)
    x0 = mala.sample(g, dim=2, n_samples=N_CHAINS, n_steps=200)  # burn-in
    traj = mala.sample(g, x=x0, n_steps=ESS_DRAWS, thin=ESS_THIN, return_trajectory=True)
    consecutive = mala.sample(g, x=x0, n_steps=N_STEPS, return_trajectory=True)
    launches = read_counts(ops, "MALA", ["mixture_mala_chain", "mixture_mala_chain_trajectory"])
    if ring.shape != (N_CHAINS, 2) or not torch.isfinite(ring).all():
        raise AssertionError("MALA ring samples are malformed")
    print(f"main path: MALA 8gauss sample() mean radius {float(ring.norm(dim=-1).mean()):.4f}; "
          f"corr-Gaussian pilot step {best}")
    _ring_against_loop("MALA", MetropolisAdjustedLangevin, fused_mala.mixture_mala_chain,
                       dict(step_size=0.05), (0.05,), dev, card)
    looped, g = mala.replace(fused="off"), torch.Generator(dev).manual_seed(83)
    loop = looped.sample(g, x=x0, n_steps=ESS_DRAWS, thin=ESS_THIN, return_trajectory=True)
    loop1 = looped.sample(g, x=x0, n_steps=N_STEPS, return_trajectory=True)
    _check_corr_trajectory("MALA corr-Gaussian", traj, loop, (consecutive, loop1), card)
    return launches


def path_gradient_descent(ops, dev, card: str) -> dict:
    import torch

    from torchebm_tpu_torch.core import GaussianMixtureEnergy
    from torchebm_tpu_torch.samplers import GradientDescentSampler

    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    x0 = torch.randn((N_CHAINS, 2), generator=torch.Generator(dev).manual_seed(90), device=dev)
    ops.reset_launch_counts()
    out = GradientDescentSampler(mix, step_size=0.05).sample(
        torch.Generator(dev).manual_seed(91), x=x0, n_steps=N_STEPS)
    launches = read_counts(ops, "gradient descent", ["mixture_langevin_chain"])
    loop = GradientDescentSampler(mix, step_size=0.05, fused="off").sample(
        torch.Generator(dev).manual_seed(91), x=x0, n_steps=N_STEPS)
    err = float((out - loop).abs().max())
    print(f"main path: gradient descent {N_CHAINS}x{N_STEPS}: mean radius "
          f"{float(out.norm(dim=-1).mean()):.4f}, max |kernel - generic loop| {err:.3e} | {card}")
    if not err <= TOL:
        raise AssertionError("gradient descent: kernel and generic loop disagree")
    return launches


def phase_timing(ops, dev, card: str) -> dict:
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
    hmc_args = (x2, mix.means, N_STEPS, 0.3, HMC_LEAPFROG)
    mh_kw = dict(scale=float(mix.scale), log_weights=mix.log_weights, seed=23)
    metropolis = {
        "mixture_mala_chain": ((x2, mix.means, N_STEPS, 0.05), mh_kw, N_CHAINS),
        "mixture_mala_chain_trajectory":
            ((x2, mix.means, N_STEPS, 0.05), dict(mh_kw, thin=1), N_CHAINS),
        "mixture_hmc_chain": (hmc_args, mh_kw, N_CHAINS),
        "mixture_hmc_chain_trajectory": (hmc_args, dict(mh_kw, thin=1), N_CHAINS),
    }
    times = {}
    for name, (args, kw, n) in {**calls, **metropolis}.items():
        module = getattr(ops, KERNELS[name][0])
        kernel, plain = getattr(module, name), getattr(module, name + "_plain")
        ms = cuda_ms(lambda: kernel(*args, **kw), warmup=2, reps=10)
        # the plain MALA and HMC versions take seconds per call: one warm-up, one repetition
        plain_reps = (1, 3) if name in calls else (1, 1)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), *plain_reps)
        times[name] = (ms, plain_ms)
        unit = "draws" if "hmc" in name else "steps"
        print(f"timing: {name} {n}x{N_STEPS} {unit}: kernel {ms:.3f} ms "
              f"({n * N_STEPS / ms * 1e3:.4e} chain-updates/s), plain {plain_ms:.3f} ms "
              f"({n * N_STEPS / plain_ms * 1e3:.4e} chain-updates/s; warm-up "
              f"{plain_reps[0]}, repetitions {plain_reps[1]}) | {card}")

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

    from torchebm_tpu_torch.samplers import HamiltonianMonteCarlo, MetropolisAdjustedLangevin

    for label, sampler in (
        ("MALA sample()", MetropolisAdjustedLangevin(mix, step_size=0.05)),
        ("HMC sample()", HamiltonianMonteCarlo(mix, step_size=0.3,
                                               n_leapfrog_steps=HMC_LEAPFROG)),
    ):
        for fused in ("auto", "off"):
            s = sampler.replace(fused=fused)
            ms = cuda_ms(lambda: s.sample(g, x=x2, n_steps=N_STEPS), warmup=1,
                         reps=3 if fused == "auto" else 1)
            path = "kernel path" if fused == "auto" else "generic loop, one repetition"
            print(f"timing: {label} {path} {N_CHAINS}x{N_STEPS}: {ms:.3f} ms "
                  f"({N_CHAINS * N_STEPS / ms * 1e3:.4e} chain-updates/s) | {card}")
    hmc = HamiltonianMonteCarlo(_corr_gaussian(dev), step_size=0.2,
                                n_leapfrog_steps=HMC_LEAPFROG)
    ms = cuda_ms(lambda: hmc.warmup(g, dim=2, n_warmup=200, n_samples=N_CHAINS), warmup=1,
                 reps=1)
    print(f"timing: HMC warmup (generic loop, dual averaging) {N_CHAINS} chains x 200: "
          f"{ms:.3f} ms, one repetition | {card}")
    return times


def device_busy_ms(fn) -> float:
    """Device time of one call of ``fn()``: the sum of the CUDA kernels' and
    copies' self time that ``torch.profiler`` records (0.0 when it records
    none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def phase_profile(dev, card: str) -> None:
    """Wall time (host clock around ``synchronize()``, median of 3 after one
    warm-up), device busy time (one more call under ``torch.profiler``) and
    the idle share 1 - busy / wall of the sampler paths and the diagnostics."""
    import torch

    from torchebm_tpu_torch.core import GaussianMixtureEnergy
    from torchebm_tpu_torch.samplers import (
        HamiltonianMonteCarlo,
        LangevinDynamics,
        MetropolisAdjustedLangevin,
        summarize_chains,
    )

    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    g = torch.Generator(dev).manual_seed(6)
    x2 = torch.randn((N_CHAINS, 2), generator=g, device=dev)
    lang = LangevinDynamics(mix, step_size=0.05)
    hmc = HamiltonianMonteCarlo(mix, step_size=0.3, n_leapfrog_steps=HMC_LEAPFROG)
    mala = MetropolisAdjustedLangevin(mix, step_size=0.05)
    corr, _, (x0, eps) = _hmc_warmup(dev, False)
    corr = corr.replace(step_size=eps)
    traj = corr.sample(g, x=x0, n_steps=ESS_DRAWS, thin=ESS_THIN, return_trajectory=True)
    n, loop_steps = N_CHAINS, 200
    calls = {
        f"Langevin sample() kernel path {n}x{N_STEPS}":
            lambda: lang.sample(g, x=x2, n_steps=N_STEPS),
        f"Langevin sample() kernel path + diagnostics {n}x{N_STEPS}":
            lambda: lang.sample(g, x=x2, n_steps=N_STEPS, return_diagnostics=True),
        f"Langevin sample() generic loop {n}x{N_STEPS}":
            lambda: lang.replace(fused="off").sample(g, x=x2, n_steps=N_STEPS),
        f"HMC sample() kernel path {n}x{N_STEPS}": lambda: hmc.sample(g, x=x2, n_steps=N_STEPS),
        f"MALA sample() kernel path {n}x{N_STEPS}":
            lambda: mala.sample(g, x=x2, n_steps=N_STEPS),
        f"HMC sample() generic loop {n}x{loop_steps}":
            lambda: hmc.replace(fused="off").sample(g, x=x2, n_steps=loop_steps),
        f"MALA sample() generic loop {n}x{loop_steps}":
            lambda: mala.replace(fused="off").sample(g, x=x2, n_steps=loop_steps),
        f"HMC warmup (generic loop) {n}x{loop_steps}":
            lambda: corr.warmup(g, dim=2, n_warmup=loop_steps, n_samples=n),
        f"HMC ESS trajectory kernel path {n}x{ESS_DRAWS} thin {ESS_THIN}":
            lambda: corr.sample(g, x=x0, n_steps=ESS_DRAWS, thin=ESS_THIN,
                                return_trajectory=True),
        f"summarize_chains {tuple(traj.shape)}": lambda: summarize_chains(traj),
        f"summarize_chains(rank_normalized=True) {tuple(traj.shape)}":
            lambda: summarize_chains(traj, rank_normalized=True),
    }
    for label, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls)
        busy = device_busy_ms(fn)
        device = (f"device busy {busy:.3f} ms, idle share {1.0 - busy / wall:.3f}" if busy > 0
                  else "device busy not measured (the profile recorded no device events)")
        print(f"profile: {label}: wall {wall:.3f} ms, {device} | {card}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device and none is visible")
    from torchebm_tpu_torch import ops
    from torchebm_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build(_build)
    errors: dict = {}
    phase_check(ops.fused_langevin, dev, errors)
    phase_check_metropolis(ops, dev, errors)
    launches = {name: 0 for name in KERNELS}
    for path in (path_langevin, path_hmc, path_mala, path_gradient_descent):
        for name, n in path(ops, dev, card).items():
            launches[name] += n
    times = phase_timing(ops, dev, card)
    phase_profile(dev, card)

    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errors[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (_, source, replaces) in KERNELS.items()
    ]}
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
