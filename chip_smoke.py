#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``torchebm_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py

(``python3 chip_smoke.py --ess-shape`` times only rows 7 and 9 at the ESS
protocol's shape, rows 10-11 at their main shape, row 14 (the Sinkhorn
kernel's per-iteration slope at (256, 256) and (1,024, 1,024), and the flow
path's gated call) and row 13 (the neural chain at the CD path's 256 x 2 and
at 4,096 x 2), through the public wrappers, against whichever package is
imported:
``PYTHONPATH=<checkout> python3 -P chip_smoke.py --ess-shape`` times an
earlier checkout's kernels on the same card. ``--ais-shape`` does the same
for row 12 at its main shapes, ``--dw-shape`` for rows 2-3 at 4,096 x 32 x
1,000 (an int seed and a constant schedule, which earlier wrappers also
take); ``--ais`` runs only the build and row 12's checks, timings, plan
sweep and sync count; ``--dit`` only the build and the DiT family's and score
matching's profile lines and paths; ``--mcmc`` only the build, the RMHMC,
NUTS and NUTS->HMC handoff paths and their sync counts; ``--parallel`` only
the build and the distributed layer's path; ``--gaps`` only the build, the
paths of BASELINE config 4, Energy Matching, the other couplings, the CD
variants and the flow modes, and ``FlowSampler`` sharded on a NCCL world of
one; ``--offset-shape`` times rows
2-13 but 1 (every kernel with a chain offset) at their main shapes through
the public wrappers, against whichever package is imported, as
``--ess-shape`` does.)

Phases, each printing its lines; any failure raises and the exit code is
not 0:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the CUDA kernels compiled from ``torchebm_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, in parallel) into a clean
   ``build/torch_kernels/``, with each kernel instance's registers and spills
   (an HMC, MALA, ladder or AIS instance of the d <= 2 bucket, the main
   paths', and any neural chain or double-well instance must not spill), and
   the SASS (``cuobjdump -sass``): every neural chain instance must hold
   TF32 ``HMMA`` instructions, and the double-well instances' Philox
   multiplies and special functions are counted and may hold no integer
   division;
3. check: every kernel against its plain PyTorch version on the card, on
   injected randomness and on the Philox stream, at the main shapes (10,000
   x 2, 8 components; 4,096 x 32 double well), on rings of 12 and 33
   components and at d=32 with full covariance, with and without schedule,
   clamp, diagonal mass and thinning;
   MALA and HMC also at the ESS protocol's own instances and steps (the
   correlated Gaussian at MALA's pilot step and HMC's adapted steps and
   mass, thin 4), with each check's mean acceptance; parallel tempering
   (R = 4) from the ring's modes and on a Gaussian; the MALA and HMC chains
   and their trajectory twins at every group of lanes per chain they are
   built for (the ring, the ESS protocol's Gaussian, a d=16 Gaussian, a d=16
   mixture, 1,001 chains; Philox and injected; for HMC unit and diagonal
   mass); the ladder and its trajectory twin at every group of lanes per
   replica they are built for (the ring from its modes at R = 3, 4 and 8,
   1,001 chains, a d=16 mixture and a d=16 Gaussian; Philox and injected;
   final ladder, trajectory and acceptance); AIS at every group of lanes
   per chain it is built for, at the main path's shapes (the ring from its
   modes at 16,384 chains with 1 and 2 transitions per rung, the two
   Gaussians at 65,536, a 201-entry beta table), at 1,001 chains, a d=16
   mixture, a d=16 and a d=32 Gaussian (Philox with a device seed, and
   injected); the one-step op at 4,096 x 32 and 16M
   elements; the neural (SiLU-MLP) chain at the CD path's 256 x 2 on
   MLP(128, 128), at 4,096 x 2, at d=32 with three hidden layers, with a
   clamp, at hidden (512, 512) and (256, 256) (weights streamed), at ragged
   widths and a narrow layer between wide ones, 10 steps, each on
   ``extract_mlp_layers``' views and on arrays of the JAX layout, on
   injected noise, an int seed and a device seed, at every (tile, warps,
   route) that fits; the
   Sinkhorn kernel at (256, 256) with ``reg`` 0.05 (50 iterations at ``tol``
   0, and gated at ``tol`` 1e-3), damped at (64, 192), at ragged shapes, at
   (1,024, 1,024) and on the cost matrix of the flow path's own batch, each
   through the launch plan and at every cluster size of 1, 2, 4, 8 and 16
   blocks: equal iteration counts, the log plan, and the gated plans'
   marginals.
   The MALA, HMC and AIS chains take a Metropolis decision per step, the
   tempering ladder an exchange decision per pair and sweep; a chain whose
   uniform lies within rounding of its acceptance probability may decide
   differently in kernel and plain version and then differs by a whole
   proposal, so those checks allow at most 0.1% of each check's chains to
   differ (printed as "flipped") and hold every other chain to the
   tolerance;
4. main path, each path with the launch counts set to 0 just before it and
   read just after:
   - Langevin: ``LangevinDynamics(GaussianMixtureEnergy.eight_gaussians(),
     step_size=0.05).sample(generator, dim=2, n_samples=10_000,
     n_steps=1_000, return_diagnostics=True)`` and the slice's other rows;
     the double well at 4,096 x 32 x 1,000, its E|x| and E x^2 within
     DW_MOMENT_TOL of the generic loop's;
   - HMC: ``HamiltonianMonteCarlo(eight_gaussians, step_size=0.3,
     n_leapfrog_steps=8).sample(...)`` at 10,000 x 1,000, and the ESS protocol
     on the correlated Gaussian (cov [[1, .8], [.8, 1]]): ``warmup``,
     ``replace(step_size=eps).sample(..., return_trajectory=True)`` (1,000
     kept draws of 4,000, and 1,000 consecutive draws),
     ``summarize_chains``, again with ``warmup(adapt_mass=True)``;
   - RMHMC (on the generic loop, no kernel): the identity metric on the
     correlated Gaussian against ``HamiltonianMonteCarlo(fused="off")`` from
     one generator seed, 4,096 chains x 50 draws x 5 leapfrog steps, to
     1e-5; the radial metric G(x) = (1 + |x|^2) I on N(0, I), 4,096 x 600
     draws (last acceptance above 0.5, means within 5 standard errors of 0,
     variances within 10% of 1); one call at d = 16; one draw profiled;
   - NUTS at the sampler shootout's protocol (``benchmarks/headline.py:
     333-361``): 256 chains on the correlated Gaussian, ``max_tree_depth=8``,
     ``warmup`` of 200 transitions, 250 draws, with unit and with adapted
     mass (means within 5 standard errors, variances within 10%, the
     correlation within 0.05 of 0.8, the last acceptance within 0.1 of the
     target, divergences below 1%; step, tree depth, ESS, ms per draw,
     ESS/s); one draw profiled;
   - the NUTS->HMC handoff: ``tune_trajectory_length`` on the same target
     (256 chains), then ``HamiltonianMonteCarlo`` at the tuned step,
     ``n_leapfrog`` and mass over the ESS protocol's draws: exactly one
     ``mixture_hmc_chain_trajectory`` launch, checked like the HMC path's
     ESS runs against the loop; row 9 timed at the tuned ``n_leapfrog``;
     the tuning call profiled;
   - MALA: the same two calls (pilot-tuned step on the correlated Gaussian);
   - gradient descent on the Langevin mixture row at noise 0;
   - parallel tempering (the JAX package's headline configuration,
     ``benchmarks/headline.py:178-220``): ``ParallelTemperingLangevin(
     eight_gaussians, temperatures=(1.0, 1.6, 2.56, 4.1), step_size=0.05,
     swap_every=5).sample(..., n_samples=10_000, n_steps=1_000)``, with
     ``return_trajectory=True``, and ``run_replicas`` on a (4, 10,000, 2)
     ladder; cold-chain radius and last-sweep swap acceptance against the loop;
   - AIS (``headline.py:223-289``): ``annealed_importance_sampling(generator,
     eight_gaussians, base=GaussianEnergy(0, 9 I), n_samples=16_384,
     n_rungs=200, step_size=0.05)``, |log Z| < 0.02, and the same call on a
     full-covariance and an isotropic Gaussian, log Z within 0.02 of
     ``log_z()``, each against the loop;
   - ``ops.fused_langevin_step`` at the JAX self-test's 4,096 x 32 double well
     and at 16M elements;
   - CD training (BASELINE config 3, ``benchmarks/headline.py:474-491``):
     ``ContrastiveDivergenceTrainer(ContrastiveDivergence(model=e,
     sampler=LangevinDynamics(e, step_size=0.01, fused_neural="auto"),
     k_steps=10), learning_rate=1e-4)`` on ``as_energy(MLPEnergy(2, (128,
     128)))`` over ``EightGaussiansDataset`` batches of 256, 300 steps, one
     neural chain launch per step, and the same with ``fused_neural="off"``,
     none; the JAX e2e quality gate (two moons, CD-20, 250 steps) through the
     kernel and through the loop; PCD with a 10,000-sample buffer warmed up
     through the kernel, then 20 train steps;
   - EqM training and generation (BASELINE config 5,
     ``benchmarks/headline.py:617-710``): ``BaseTrainer(
     EquilibriumMatchingLoss(model=MLPVelocityField(2, (128, 128, 128)),
     interpolant=LinearInterpolant(), coupling=SinkhornCoupling(n_iters=50,
     reg=0.05)), Adam 1e-3)`` on a batch of 256 draws of N((2, 0), I), 300
     steps, one Sinkhorn kernel launch per step, and with ``fused="off"``,
     none, the last 100 steps' mean loss both ways over seeds; then
     ``FlowSampler(model, integrator="euler", negate_velocity=True)``, 4,096
     samples x 50 steps, and one ``dopri5`` generation; the JAX e2e quality
     gate (8 Gaussians, batch 512, Adam 2e-3, 800 steps,
     ``coupling="sinkhorn"``) through the kernel and through the loop: the
     energy distance of 1,024 generated samples to fresh data below 0.3 of the
     prior's, through ``FlowSampler`` and through ``EqMEnergy.from_loss`` with
     200 Langevin steps, every mode holding more than 10 samples;
   - the DiT family (``benchmarks/headline.py:547-606``): the DiT-768x12
     flow-matching train step at batch 256 in float32, then bfloat16 compute
     (ms per step by CUDA events, peak memory, the FLOPs that
     ``torch.utils.flop_counter`` counts and their share of the card's dense
     peak); the card against the CPU port on one set of random flax-shaped
     weights at batch 8 (the f32 forward, the parameter gradients, bf16
     against f32); an EquilibriumMatchingLoss step of the same DiT under
     config 5's Sinkhorn coupling (one kernel launch and no host sync per
     step, the loss falling over 30 steps on rendered two-moons images);
     class-conditional generation through LabelClassifierFreeGuidance and
     FlowSampler (2 forwards per step, the guided field checked); DSM on
     config 3's net over two moons, then 10,000 Langevin chains x 1,000
     steps through the neural chain kernel (one launch, nearer held-out
     data than the untrained energy's), and ms per DSM, SSM and exact-SM
     step;
   - PCD on ``ConvEnergy2D(channels=(32, 64, 64))`` (BASELINE config 4,
     ``benchmarks/headline.py:502-546``): 28 x 28, batch 64, k = 40 at step
     10 clamped to (-1, 1), buffer 4,096, Adam 1e-4, through the trainer and
     the generic loop, in float32 and bf16 end to end (buffer and data
     bf16), on the reference's normal data and on rendered two-moons images:
     ms per step, device busy time, idle share and host syncs per step, the
     buffer's dtype and clamp kept; the energy and input gradient of a fixed
     batch on the card against the CPU port (1e-4 in f32, the bf16 band in
     bf16) and one f32 train step from injected starts: its loss and
     parameter gradients to 1e-4, its negatives after 40 steps to 1e-5 and
     the parameters after Adam to 1e-5 of the CPU port's;
   - EnergyMatchingLoss on config 5's batch through the trainer with the
     auction (``"ot"``, its host syncs per step) and with config 5's
     SinkhornCoupling (one row-14 launch per step), the flow term against
     the CPU port on injected draws; UnbalancedSinkhornCoupling through row
     14 damped (against ``fused="off"``), the auction and greedy
     permutations equal to the CPU port's, ReflowCoupling through config
     5's field against the CPU port; PersistentContrastiveDivergence (one
     row-13 launch per step) and ParallelTemperingCD (persistent ladders,
     swap acceptance) on config 3's net; generation from config 5's field
     through heun, midpoint, rk4, bosh3, adaptive_heun and dopri8 and its
     ``log_prob``, each against the CPU port; SDE generation and
     ``log_prob`` (exact and Hutchinson) on the exact velocity of config 5's
     data law, against its ODE mean and its density;
   - the distributed layer (``torchebm_tpu_torch.parallel``) on a real NCCL
     world of one brought up by ``init_distributed`` from torchrun's
     variables, meshes ``("data",) = (1,)`` and ``("data", "fsdp") = (1,
     1)``: config 1 sharded through ``sample`` (final state and trajectory)
     against the unsharded call, rows 4-5 as two launches at chain offsets 0
     and 5,000 against one, the second against its plain version; every
     other sampler on a sharded batch at its main shape (MALA, HMC, PT's
     ``sample`` and ``run_replicas`` with the ladder sharded on its chains,
     AIS on a replicated schedule, the double well, gradient descent, NUTS
     at 256 chains, RMHMC, the HMC warmup) bitwise the unsharded call, its
     pooled statistics to 1e-6; rows 2-3 and 6-12 as two launches at chain
     offsets 0 and n/2 against one, bitwise, the second half against its
     plain version (the flip rule for Metropolis and exchange decisions);
     ``FlowSampler`` (Euler, dopri5, SDE, ``log_prob`` exact and
     Hutchinson) and ``ReflowCoupling`` on a sharded batch, bitwise;
     config 3's
     CD step under HSDP (weights from the flax layout) for 20 steps against
     the unsharded trainer to 1e-6, row 13 split the same way, both steps
     profiled, a DCP save and restore of the sharded state (bitwise, then
     one more step); the DiT-768x12 step under HSDP in f32 and bf16 against
     the unsharded step (loss and gradients; ms per step of each); config
     5's Sinkhorn coupling on a sharded batch through row 14;
   with the ring's mean radius and the Metropolis acceptance against the
   generic loop (``fused="off"``), and the correlated Gaussian's covariance,
   R-hat and ESS (over consecutive draws, R-hat within 0.005 of the loop's);
5. timing: CUDA events, medians after warm-up: each kernel against its
   plain version, rows 2-3 also by device time per call (the ``--dw-shape``
   lines), the mixture, MALA and HMC chains and their trajectory
   twins at each number of lanes per chain the kernels are built for, the
   MALA and HMC trajectories at the ESS protocol's shape with their bound,
   the MALA and HMC plan sweeps (device time per call at every built group
   over 37 and 42 shapes of rings, mixtures, Gaussians, chain counts and,
   for HMC, leapfrog steps, beside the launch plan's pick), rows 10-11 at
   each group of lanes per replica and row 10 at each block size, the PT
   plan sweep (34 shapes of ladders, rings, mixtures, Gaussians, chain
   counts and swap intervals), PT per ladder step, AIS per
   rung, row 12 at each group of lanes per chain at its main shapes, its
   per-rung slope over 50, 200 and 1,000 rungs and its plan sweep (45
   shapes of rings, mixtures, Gaussians, chain counts, rung counts and
   transitions per rung), the one-step op in GB/s beside ``torch.add`` (device time per call
   in batches queued behind a spin, and per call with the host's launch
   work), the neural chain also at
   4,096 chains (its per-step slope and intercept over 1, 10 and 40 steps
   at 256 and 4,096 chains, and its plan sweep: device time per call at
   every (tile, warps, route) over 12 shapes beside the plan's pick), the
   CD train step with the kernel and on the loop, the
   Sinkhorn kernel gated and at fixed work (its per-iteration slope and
   intercept over 1, 10 and 50 iterations), beside 100 ``torch.logsumexp``
   calls, at every cluster size (slopes at three shapes, device time at the
   14 shapes its launch plan is read from, beside the plan's pick), the EqM
   train step with the kernel, on the loop and with
   ``IndependentCoupling``, the generation in samples/s, and the sampler
   paths, beside the card's name and power limit;
6. profile (run right after the checks; the run's other profiler sessions
   are the advanced HMC paths' own: one RMHMC and one NUTS draw, the d = 16
   RMHMC call and the tuning call):
   wall time, device busy time (``torch.profiler``) and idle share
   of the CD and EqM train steps, the flow generation, the DiT train steps
   (f32, bf16), the DiT EqM step, CFG generation (f32, bf16), the DSM train
   step, the sampler paths,
   the HMC warmup and ``summarize_chains`` (the kernel paths first, each of
   which must record device events); for the Langevin kernel calls (the
   headline's, the double well's final state and trajectory) and the AIS
   kernel path also their host operations with the most self CPU time;
7. syncs: the host's synchronising calls per EqM train step (none through
   the Sinkhorn kernel), per auction and greedy assignment, per dopri5
   generation, and per CD train step through the neural kernel and on the
   loop, with where each comes from, none in the neural sampler's call
   (its seed stays on the device), none in the AIS call on each of its
   targets, none in the double-well ``sample()`` calls (final state and
   trajectory) and in an RMHMC draw, at most one per doubling after the
   first in a NUTS transition, each after a warm-up call
   (``torch.cuda.set_sync_debug_mode``);
8. bound: for each kernel the least time the card could take for the timed
   call: the larger of its bytes (inputs read once, outputs written once)
   over 3.35 TB/s and, per instruction class counted from the CUDA source
   (``torchebm_tpu_torch/ops/_counts.py``), the count over the class's rate
   at the card's maximum SM clock (the neural chain's tensor-core products
   over the dense TF32 rate, 495 TFLOP/s).

The run's total time is printed before the card's name and power limit;
the line before the last is the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script raises
before it runs anything.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: kernel-vs-plain tolerance (absolute, float32): the kernels contract
#: multiply-adds and take the mixture softmax online in one pass, the plain
#: versions do neither, so results differ by rounding; at these step sizes the
#: chains contract, so rounding does not grow over the checked steps.
TOL = 1e-4
CHECK_STEPS = 50
N_CHAINS, N_STEPS = 10_000, 1_000
#: the profile phase's sessions: a session that stopped right after its
#: ``synchronize()`` lost all of a short call's device events in 8 of 443
#: sessions and some of them in 4 more (the AIS kernel path, 0.2 ms of device
#: time, on an H100 with torch 2.11), where one padded by 20 ms of host sleep
#: on each side of the call lost none (``scripts/probe_profiler_drops.py``).
#: So every session is padded by PROFILE_PAD_S, and a call whose session
#: records no device event is profiled again, up to PROFILE_SESSIONS times
PROFILE_PAD_S, PROFILE_SESSIONS = 0.02, 3
DW_SHAPE = (4096, 32)
#: the double-well kernel path's E|x| and E x^2 against the generic loop's
#: over the 131,072 elements of DW_SHAPE, independent seeds: about 4.7
#: standard errors of the difference
DW_MOMENT_TOL = 0.01

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
    "pt_langevin_chain":
        ("fused_pt", _CSRC + "fused_pt.cu", "torchebm_tpu/ops/fused_pt.py:382"),
    "pt_langevin_chain_trajectory":
        ("fused_pt", _CSRC + "fused_pt.cu", "torchebm_tpu/ops/fused_pt.py:492"),
    "mixture_ais_run":
        ("fused_ais", _CSRC + "fused_ais.cu", "torchebm_tpu/ops/fused_ais.py:199"),
    "fused_langevin_step":
        ("fused_langevin", _CSRC + "fused_step.cu", "torchebm_tpu/ops/fused_langevin.py:316"),
    "mlp_langevin_chain":
        ("fused_mlp_langevin", _CSRC + "fused_mlp_langevin.cu",
         "torchebm_tpu/ops/fused_mlp_langevin.py:169"),
    "sinkhorn_log_fused":
        ("fused_sinkhorn", _CSRC + "fused_sinkhorn.cu", "torchebm_tpu/ops/fused_sinkhorn.py:118"),
}
#: the plain versions that are not named ``<wrapper>_plain``
PLAIN_NAMES = {"sinkhorn_log_fused": "sinkhorn_log_plain"}

#: rings checked beside the 8-Gaussians one: K not a power of two, above the
#: mixture kernel's lanes per chain, and past the 4 logits per lane it keeps
#: in registers
RING_CHECK_K = (12, 33)

#: (K, chains) of the rings timed by lanes per chain beside the main shape:
#: the shapes the mixture kernel's launch plan is read from
PLAN_SHAPES = ((3, N_CHAINS), (12, N_CHAINS), (33, N_CHAINS), (8, 100_000))
#: the MALA and HMC chains' plan sweeps beside rows 6-9's main shape and the
#: ESS protocol's: rings of K components at 10,000 chains; random means of K
#: components at d; rings at 100,000 and 300,000 chains (200 steps or
#: draws); the full-covariance Gaussian at d; for HMC, the ring and the ESS
#: shape at other numbers of leapfrog steps per draw
SWEEP_RING_K = (2, 3, 4, 6, 8, 12, 16, 24, 33)
SWEEP_MIX_D, SWEEP_MIX_K = (3, 5, 8, 16), (2, 4, 8, 16)
SWEEP_LARGE_K, SWEEP_LARGE_N, SWEEP_LARGE_DRAWS = (8, 12, 16, 33), (100_000, 300_000), 200
SWEEP_GAUSS_D = (4, 8, 16)
SWEEP_LEAPFROG = (1, 16)
#: the PT plan sweep beside rows 10-11's main shape (the ring, R = 4, swap
#: every 5, 10,000 chains x 1,000 steps): the ring's ladder at other R, rings
#: of K components, swapping every step, random means of K components at d,
#: the full-covariance Gaussian at d (R = 4), and (chains, R, K, swap every)
#: at 200 steps
SWEEP_PT_R = (2, 3, 4, 8, 16)
SWEEP_PT_RING_K = (2, 4, 12, 16, 24, 33)
SWEEP_PT_SWAP1_R = (2, 4, 8)
SWEEP_PT_MIX_D, SWEEP_PT_MIX_K = (3, 8, 16), (2, 8, 16)
SWEEP_PT_GAUSS_D = (2, 4, 8, 16)
SWEEP_PT_LARGE = ((100_000, 4, 8, 5), (100_000, 4, 16, 5), (100_000, 4, 33, 5),
                  (100_000, 2, 8, 5), (100_000, 8, 8, 5), (100_000, 4, 8, 1),
                  (300_000, 4, 8, 5))

#: the parallel-tempering and AIS configurations of the JAX package's headline
#: benchmarks (benchmarks/headline.py:178-289), at full width
PT_TEMPS, PT_SWAP_EVERY = (1.0, 1.6, 2.56, 4.1), 5
AIS_CHAINS, AIS_RUNGS, AIS_BASE_VAR = 16_384, 200, 9.0
#: the Gaussian AIS gates read 4x the ring's chains: the estimator's
#: Monte-Carlo error (a standard deviation of about 0.008 at 16,384 chains on
#: these targets, read from six seeds of the plain version on a CPU) halves,
#: so a 0.02 gate sits at 5 sigma
AIS_GAUSS_CHAINS = 4 * AIS_CHAINS
#: row 12's timing: the rung counts of the ring's per-rung slope
AIS_SLOPE_RUNGS = (50, 200, 1000)
#: the one-step op at 16M elements (64 MB per tensor), where it is bound by memory
STEP_ELEMS = 1 << 24
#: the step op's timing: (warm-up, readings, calls per reading), each reading
#: a batch queued behind a device spin of SPIN_CYCLES (about 1 ms at 1.98 GHz)
STEP_REPS, SPIN_CYCLES = (20, 50, 10), 2_000_000

#: CD/PCD training, BASELINE config 3 (the JAX headline benchmark,
#: benchmarks/headline.py:474-491): MLPEnergy(128, 128) on 2-D data, batch
#: 256, CD-10 with Langevin negatives at step 0.01, Adam; CD_STEPS train steps
#: over EightGaussiansDataset batches
CD_HIDDEN, CD_BATCH, CD_K, CD_STEP, CD_LR, CD_STEPS = (128, 128), 256, 10, 0.01, 1e-4, 300
#: config 3 is run through the kernel and through the loop once per seed of
#: the chains' draws (weights and batches alike): the two sets' means of the
#: last-epoch data and negative energies agree within CD_SIGMAS standard
#: errors of their difference (two sets of runs alike fall beyond with a
#: chance of about 2e-5: Student's t with 30 degrees of freedom at 5)
CD_NOISE_SEEDS, CD_SIGMAS = tuple(range(1, 17)), 5.0
#: the neural chain's checks: (chains, widths (d, H_1, ...), clamp), each at
#: every (tile, warps, route) that fits: the CD path's, the knee, a
#: tensor-core first layer, a clamp on a ragged last tile, streamed weights,
#: ragged widths, a narrow layer between wide ones
MLP_CHECKS = ((CD_BATCH, (2, *CD_HIDDEN), None), (4096, (2, *CD_HIDDEN), None),
              (1000, (32, 64, 64, 64), None), (37, (2, *CD_HIDDEN), (-1.0, 1.0)),
              (1024, (2, 512, 512), None), (300, (2, 256, 256), None),
              (100, (10, 40, 24), None), (77, (9, 300), None), (40, (2, 4, 130, 2), None))
#: row 13's timing: the chain lengths of its per-step slope; the shapes of
#: its plan sweep (chains, widths): the CD path's, more chains up to where
#: tiles of 32 fill the card several times, three hidden layers at d = 32,
#: and the streamed (256, 256) and (512, 512)
MLP_SLOPE_STEPS = (1, 10, 40)
MLP_SWEEP = ((256, (2, *CD_HIDDEN)), (1000, (2, *CD_HIDDEN)), (2048, (2, *CD_HIDDEN)),
             (4096, (2, *CD_HIDDEN)), (8192, (2, *CD_HIDDEN)), (16_900, (2, *CD_HIDDEN)),
             (65_536, (2, *CD_HIDDEN)), (1000, (32, 64, 64, 64)), (4096, (32, 64, 64, 64)),
             (1024, (2, 256, 256)), (512, (2, 512, 512)), (8190, (2, 512, 512)))
#: the quality gate: the JAX e2e recipe (tests/e2e/test_training_quality.py:90-125)
#: at MLP(128, 128): two moons, step 0.05, CD-20, Adam 2e-3, 250 steps
QG_STEP, QG_K, QG_LR, QG_STEPS = 0.05, 20, 2e-3, 250
#: PCD: a 10,000-sample buffer warmed up by 100 steps, then PCD_STEPS train steps
PCD_BUFFER, PCD_INIT_STEPS, PCD_CHUNK, PCD_STEPS = 10_000, 100, 1024, 20

#: EqM training and generation, BASELINE config 5 (the JAX headline benchmark,
#: benchmarks/headline.py:617-710): MLPVelocityField(128, 128, 128) on 2-D
#: data, one fixed batch of 256 draws of N((2, 0), I), the linear interpolant,
#: SinkhornCoupling(n_iters=50, reg=0.05) at its default tol 1e-3, Adam 1e-3;
#: then Euler generation of 4,096 samples in 50 steps
FLOW_HIDDEN, FLOW_BATCH, FLOW_ITERS, FLOW_REG, FLOW_TOL = (128, 128, 128), 256, 50, 0.05, 1e-3
FLOW_LR, FLOW_STEPS, GEN_SAMPLES, GEN_STEPS = 1e-3, 300, 4096, 50
#: config 5 runs through the kernel once per seed of FLOW_SEEDS and through the
#: loop once per seed of FLOW_LOOP_SEEDS (weights and draws), disjoint seeds, so
#: that the two sides' pairs are independent draws (on shared seeds both sides
#: drew the same pairs and read 0.00 standard errors apart: a gate that could
#: not fail): the two sets' means of the last FLOW_TAIL steps' loss agree
#: within CD_SIGMAS standard errors of their difference
FLOW_SEEDS, FLOW_TAIL = tuple(range(1, 9)), 100
FLOW_LOOP_SEEDS = tuple(s + 100 for s in FLOW_SEEDS)
#: the flow quality gate: the JAX e2e recipe
#: (tests/e2e/test_training_quality.py:139-188): 8 Gaussians, batch 512, Adam
#: 2e-3, 800 steps, coupling "sinkhorn" (reg 0.05, 100 iterations, tol 1e-3);
#: 1,024 samples by 100 Euler steps, then 200 Langevin steps at 0.01, noise 0.3
FQ_BATCH, FQ_LR, FQ_STEPS, FQ_SAMPLES, FQ_GEN_STEPS, FQ_MCMC_STEPS = 512, 2e-3, 800, 1024, 100, 200
#: the Sinkhorn kernel's checks: (shape, reg, iterations, tol, damping): the
#: training shape at fixed work and gated, the damped update of the unbalanced
#: coupling (rho 0.5, reg 0.1), ragged shapes, and the largest matrix it takes
SINKHORN_CHECKS = (
    ((256, 256), 0.05, 50, 0.0, 1.0), ((256, 256), 0.05, 50, 1e-3, 1.0),
    ((64, 192), 0.1, 80, 0.0, 0.5 / 0.6), ((8, 128), 0.05, 60, 0.0, 1.0),
    ((17, 33), 0.05, 60, 0.0, 1.0), ((5, 200), 0.05, 60, 0.0, 1.0),
    ((200, 333), 0.05, 60, 0.0, 1.0), ((200, 333), 0.05, 60, 1e-3, 1.0),
    ((128, 128), 0.1, 500, 1e-4, 1.0),
    ((1024, 1024), 0.05, 50, 0.0, 1.0), ((1024, 1024), 0.05, 100, 1e-3, 1.0),
)
#: a gated balanced plan's row and column sums, relative to 1/n and 1/m
#: (tests/ops/test_sinkhorn_parity.py:44-55)
MARGINAL_RTOL = 2e-3
#: row 14's timing: the iteration counts of its per-iteration slope; the
#: shapes of the cluster-size sweep's slopes, and of the plan sweep (ragged,
#: square, wide, tall, the flow path's and the largest), at a fixed count
SINKHORN_SLOPE_ITERS = (1, 10, 50)
SINKHORN_SWEEP_SLOPES = ((256, 256), (200, 333), (1024, 1024))
SINKHORN_SWEEP = ((8, 128), (5, 200), (17, 33), (64, 64), (64, 192), (128, 128), (128, 512),
                  (256, 256), (200, 333), (512, 512), (1024, 1024), (4096, 64), (64, 4096),
                  (70_000, 3))
SINKHORN_SWEEP_ITERS = 20

#: the DiT family at the JAX headline's width (benchmarks/headline.py:547-606):
#: DiT-768x12 (patch 4, 12 heads, cond 768) on 1 x 32 x 32 images, batch 256,
#: AdamW 1e-4 (optax.adamw's weight decay 1e-4), an MSE onto a fresh normal
#: target per step; CUDA events, the median of DIT_STEPS steps after
#: DIT_WARMUP; the card's dense peaks by compute dtype (H100 SXM data sheet)
DIT_KW = dict(in_channels=1, out_channels=1, input_size=32, patch_size=4, embed_dim=768,
              depth=12, num_heads=12, cond_dim=768)
DIT_BATCH, DIT_LR, DIT_DECAY, DIT_WARMUP, DIT_STEPS = 256, 1e-4, 1e-4, 3, 10
DIT_PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
#: card against CPU on one flax-shaped set of random weights (every leaf
#: N(0, 0.02^2), numpy seed): the f32 forward within PARITY_FWD_RTOL and the
#: flow-matching loss's parameter gradients within PARITY_GRAD_RTOL (each the
#: largest difference over the largest reference entry, per tensor), at
#: batch PARITY_BATCH; bf16 against f32 on the card within BF16_RTOL: bf16
#: keeps 8 bits of mantissa (unit roundoff 2^-9, about 2e-3), each of the 12
#: blocks rounds about 8 activations, and 100 roundings adding as a random
#: walk give about 10 x 2e-3 = 2e-2; the gate allows 2.5 times that. It
#: also reads at least BF16_FLOOR: a "bf16" model that computed in float32
#: would read about 1e-6, as the card's f32 forward does against the CPU's
PARITY_BATCH, PARITY_FWD_RTOL, PARITY_GRAD_RTOL, BF16_RTOL = 8, 1e-4, 1e-3, 5e-2
BF16_FLOOR = 1e-4
#: and the parameter gradients of a second-order loss (the mean square of
#: EqM's dot energy's input gradient, which differentiates the attention's
#: backward) at SECOND_ORDER_BATCH, within PARITY_GRAD_RTOL
SECOND_ORDER_BATCH = 2
#: the DiT's EqM step (config 5's loss and coupling): scalar t through the
#: t= lift, SinkhornCoupling(n_iters=50, reg=0.05) over the flattened images,
#: config 5's Adam 1e-3, EQM_DIT_STEPS steps on one structured batch (two-moons
#: points rendered as blobs); the mean loss of the last EQM_DIT_TAIL steps must
#: fall below the first's
EQM_DIT_STEPS, EQM_DIT_TAIL = 30, 5
#: class-conditional generation: the example's LabelDiT (examples/90-showcase/
#: dit_cfg_digits/main.py:37-64) at the width above, 10 classes, label dropout
#: 0.1, through LabelClassifierFreeGuidance(cfg_scale=2.5, guide_channels=1)
#: and FlowSampler(integrator="euler"): CFG_SAMPLES samples in CFG_STEPS steps
CFG_CLASSES, CFG_SCALE, CFG_SAMPLES, CFG_STEPS = 10, 2.5, 256, 20
#: DSM on config 3's net (MLPEnergy(128, 128)): two moons, batch 256,
#: noise_scale 0.1, Adam 1e-3, DSM_STEPS steps through BaseTrainer; then
#: DSM_CHAINS chains x DSM_SAMPLE_STEPS Langevin steps at DSM_SAMPLE_STEP on the
#: trained energy and on the untrained one, against held-out data
DSM_NOISE, DSM_LR, DSM_STEPS = 0.1, 1e-3, 200
DSM_CHAINS, DSM_SAMPLE_STEPS, DSM_SAMPLE_STEP = 10_000, 1_000, 0.005
#: the neural chain's check at the DSM sampler's site: DSM_CHAINS chains on
#: MLP(128, 128) at DSM_SAMPLE_STEP for MLP_LONG_STEPS steps, at least three
#: windows of the Philox normals the kernel stages in shared memory (z_steps
#: steps a window, up to 32), so that the refills after the first window and
#: the barriers around them are compared too; CD_K steps stay inside one
MLP_LONG_STEPS = 100

#: the adaLN-Zero kernels (ops/fused_adaln.py), timed at DiT-B/2's token
#: stream (B, N, D) = (256, 256, 768): the benchmark's train step and each
#: of its CFG generation's forwards (batch 256 both), in bf16 and in float32
ADALN_SHAPE = (256, 256, 768)
ADALN_DTYPES = ("bfloat16", "float32")
#: and at a batch below the card's multiprocessors, where the backward
#: kernels split each sample's tokens over blocks and a second pass adds
#: their partial sums (``fused_adaln.launch_plan``'s ``chunks``), in bf16
ADALN_CHUNKED_SHAPE = (8, 256, 768)
#: wrapper -> (CUDA source, what it replaces) of the adaLN kernels' rows in
#: the summary: no TPU kernel (XLA fuses the chain in the JAX package)
ADALN_KERNELS = {
    "adaln_modulate": (_CSRC + "fused_adaln.cu", "none (XLA fusion)"),
    "gated_residual": (_CSRC + "fused_gated_residual.cu", "none (XLA fusion)"),
    "adaln_modulate_backward": (_CSRC + "fused_adaln.cu", "none (XLA fusion)"),
    "gated_residual_backward": (_CSRC + "fused_gated_residual.cu", "none (XLA fusion)"),
}
#: adaLN launches of a DiT-768x12 forward (12 blocks x 2 modulations and the
#: head's; 12 x 2 gated residuals) and of a train step (forward and backward)
DIT_ADALN_FORWARD = {"adaln_modulate": 25, "gated_residual": 24,
                     "adaln_modulate_backward": 0, "gated_residual_backward": 0}
DIT_ADALN_STEP = {"adaln_modulate": 25, "gated_residual": 24,
                  "adaln_modulate_backward": 25, "gated_residual_backward": 24}

#: the distributed layer on the card (PR 17): a real NCCL world of one,
#: meshes ("data",) = (1,) and ("data", "fsdp") = (1, 1); config 3's CD step
#: under HSDP for PAR_CD_STEPS steps against the unsharded trainer (loss and
#: parameters within PAR_CD_TOL); the DiT step under HSDP timed over
#: PAR_DIT_STEPS after DIT_WARMUP; the sharded Sinkhorn coupling on a batch
#: of FLOW_BATCH
PAR_CD_STEPS, PAR_CD_TOL, PAR_DIT_STEPS = 20, 1e-6, 5

#: the card's memory rate, the per-SM instruction rates per clock of its
#: FP32 lanes, INT32 lanes and special-function units, and its dense TF32
#: tensor-core rate in operations per second (H100 SXM)
HBM_BYTES_PER_S = 3.35e12
RATE_PER_SM_CLOCK = {"fp32": 128, "int32": 64, "sfu": 16}
TF32_OPS_PER_S = 495e12
N_SMS = 132


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_times(fn, warmup: int, reps: int, batch: int = 0) -> list:
    """Milliseconds of ``fn()`` between two CUDA events, ``reps`` readings
    after ``warmup`` calls. With ``batch`` > 0 each reading is ``batch``
    back-to-back calls queued behind a 1 ms device spin, over ``batch``: the
    device time per call, without the host's launch work (which a reading of
    one call includes while the device waits for it)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if batch:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(max(batch, 1)):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / max(batch, 1))
    return times


def device_ms(fn) -> float:
    """Device time per call of ``fn()``: CUDA events around 2 calls queued
    behind a device spin, median of 3 readings after one call. A call that
    waits for the device on the host (the Langevin wrappers' synchronous
    copy of the schedule table) adds the host's launch work after the wait.
    The profiler is not used here: after its very large sessions (the
    profile phase's loops and HMC warmup) later sessions of a process drop
    device events, on an H100 with torch 2.11."""
    return statistics.median(cuda_times(fn, 1, 3, batch=2))


def host_ms(fn, reps: int = 10) -> float:
    """Host milliseconds of one call of ``fn()`` up to its return, before
    the device finishes it: median of ``reps`` calls, each after a
    synchronize and one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def max_err(got, want) -> float:
    import torch

    if isinstance(got, tuple):
        return max(max_err(g, w) for g, w in zip(got, want))
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    return float((got - want).abs().max())


def phase_build(build_mod) -> dict:
    """Build from clean and print each kernel instance's registers and spill
    stores; returns ``{instance: (registers, spill bytes)}``."""
    shutil.rmtree(build_mod.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    build_mod.load_library()
    seconds = time.perf_counter() - t0
    sources = ", ".join(p.name for p in build_mod._sources())
    print(f"build: nvcc sm_90a, one process per source ({sources}), into "
          f"{build_mod.BUILD_DIR.name}/ in {seconds:.1f} s from clean")
    log = build_mod.library_path().with_suffix(".log").read_text()
    entry, spills, instances = None, "?", {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"((?:mixture|doublewell|mala|hmc|pt|mlp)_chain_kernel|ais_kernel"
                          r"|langevin_step_kernel|sinkhorn_kernel|adaln_modulate_kernel"
                          r"|adaln_modulate_backward_kernel|gated_residual_kernel"
                          r"|gated_residual_backward_kernel|column_sums_kernel)I(\w*?)EEv",
                          m.group(1))
            args = re.findall(r"L[ib](\d+)E", k.group(2)) if k else []
            if k and k.group(1) in ADALN_INSTANCES:  # the storage type first
                args = ["bf16" if "bfloat16" in k.group(2) else
                        "f16" if "__half" in k.group(2) else "f32", *args]
            entry = f"{k.group(1)}<{','.join(args)}>" if k else m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            print(f"build:   {entry}: {m.group(1)} registers, {spills} bytes spill stores")
            instances[entry] = (int(m.group(1)), int(spills) if spills.isdigit() else -1)
            entry, spills = None, "?"
    return instances


#: the adaLN kernels' instances (storage type, values a pack, pack items a
#: lane); those at DiT-B/2's width (D = 768: 3 items of 8 bf16, 6 of 4 f32)
#: may not spill
ADALN_INSTANCES = ("adaln_modulate_kernel", "adaln_modulate_backward_kernel",
                   "gated_residual_kernel", "gated_residual_backward_kernel", "column_sums_kernel")
ADALN_MAIN = ("<bf16,8,3>", "<f32,4,6>", "<bf16,8>", "<f32,4>", "<bf16>", "<f32>")


def check_instances(instances: dict) -> None:
    """The HMC, MALA, ladder and AIS instances of the d <= 2 bucket, the
    main paths' among them (the ring's and the ESS protocol's correlated
    Gaussian's, chain and trajectory, and the AIS path's Gaussians, at every
    group), and no neural chain or double-well instance may spill; every
    instance's registers and spills are printed with the build."""
    for kernel in ("hmc_chain_kernel", "mala_chain_kernel", "pt_chain_kernel", "ais_kernel"):
        bucket2 = {name: v for name, v in instances.items()
                   if name.startswith(f"{kernel}<2,")}
        spilled = {name: v[1] for name, v in instances.items()
                   if name.startswith(kernel) and v[1] != 0}
        print(f"build: {len(bucket2)} {kernel} instances of the d <= 2 bucket, at most "
              f"{max(v[0] for v in bucket2.values())} registers; {kernel} instances that "
              f"spill: {spilled or 'none'}")
        if any(v[1] != 0 for v in bucket2.values()):
            raise AssertionError(f"a {kernel} instance of the main path's d <= 2 bucket spills")
    dw = {name: v for name, v in instances.items() if name.startswith("doublewell_chain_kernel")}
    print(f"build: doublewell_chain_kernel<TRAJ> instances: "
          + ", ".join(f"{n} {r} registers, {sp} bytes spill stores"
                      for n, (r, sp) in sorted(dw.items())))
    if len(dw) != 2 or any(v[1] != 0 for v in dw.values()):
        raise AssertionError(f"a doublewell_chain_kernel instance spills or is missing: {dw}")
    mlp = {name: v for name, v in instances.items() if name.startswith("mlp_chain_kernel")}
    print(f"build: {len(mlp)} mlp_chain_kernel instances, at most "
          f"{max(v[0] for v in mlp.values())} registers; instances that spill: "
          f"{ {n: v[1] for n, v in mlp.items() if v[1] != 0} or 'none'}")
    if any(v[1] != 0 for v in mlp.values()):
        raise AssertionError("an mlp_chain_kernel instance spills")
    for kernel in ADALN_INSTANCES:
        found = {n: v for n, v in instances.items() if n.startswith(f"{kernel}<")}
        main = {n: v for n, v in found.items() if n.endswith(ADALN_MAIN)}
        spilled = {n: v[1] for n, v in found.items() if v[1] != 0}
        print(f"build: {len(found)} {kernel} instances, at most "
              f"{max(v[0] for v in found.values())} registers; at D = 768 "
              + ", ".join(f"{n} {r} registers, {sp} bytes spill stores"
                          for n, (r, sp) in sorted(main.items()))
              + f"; instances that spill: {spilled or 'none'}")
        if not main or any(v[1] != 0 for v in main.values()):
            raise AssertionError(f"a {kernel} instance at D = 768 spills or is missing: {main}")


#: SASS opcodes counted in each double-well instance: Philox's multiplies
#: (a 32 x 32 -> 64 product in one IMAD.WIDE.U32, or IMAD.HI and IMAD),
#: its xors and adds, the special functions, and I2F.U32.RP, the reciprocal
#: an integer division starts with
DW_SASS_OPS = ("IMAD.WIDE.U32", "IMAD.HI.U32", "LOP3.LUT", "IADD3", "MUFU", "I2F.U32.RP", "BRA")


def _dw_sass_counts(section: str) -> dict:
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", section)
    counts = {op: sum(1 for o in ops if o == op or o.startswith(op + ".")) for op in DW_SASS_OPS}
    counts["instructions"] = len(ops)
    return counts


def phase_sass(build_mod) -> None:
    """The neural chain kernel runs its products on the tensor cores in
    3xTF32: every ``mlp_chain_kernel`` instance of the built library holds
    ``HMMA`` instructions on TF32 operands (``cuobjdump -sass``), and none
    spills. Each double-well instance's Philox, special-function and branch
    instructions are counted (``DW_SASS_OPS``: two Philox blocks, the first
    quad's and the loop's, whatever n_steps), and none may divide."""
    cuobjdump = Path(build_mod.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build_mod.library_path())], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts, dw = {}, {}
    for section in re.split(r"\n\s*Function : ", sass):
        name = section.split("\n", 1)[0].strip()
        k = re.search(r"doublewell_chain_kernelILb(\d)E", name)
        if k:
            dw[f"doublewell_chain_kernel<{k.group(1)}>"] = _dw_sass_counts(section)
        k = re.search(r"mlp_chain_kernelI(\w*?)EEv", name)
        if k:
            entry = f"mlp_chain_kernel<{','.join(re.findall(r'L[ib](\d+)E', k.group(1)))}>"
            counts[entry] = (len(re.findall(r"\bHMMA(?:\.\w+)*\.TF32\b", section)),
                             len(re.findall(r"\bHMMA\b", section)))
    print(f"build: SASS of mlp_chain_kernel<resident, n8 fragments, warps> (cuobjdump -sass), "
          f"HMMA instructions on TF32 operands / all HMMA: "
          + ", ".join(f"{e} {tf}/{hm}" for e, (tf, hm) in sorted(counts.items())))
    if not counts or any(tf == 0 for tf, _ in counts.values()):
        raise AssertionError(f"an mlp_chain_kernel instance has no TF32 HMMA: {counts}")
    for entry, c in sorted(dw.items()):
        print(f"build: SASS of {entry}: {c}")
    if len(dw) != 2 or any(c["I2F.U32.RP"] for c in dw.values()):
        raise AssertionError(f"a doublewell_chain_kernel instance divides or is missing: {dw}")


def _ring(k: int):
    """The 8-Gaussians ring's radius and scale with ``k`` modes."""
    import torch

    from torchebm_tpu_torch.core import GaussianMixtureEnergy

    ang = torch.arange(k, dtype=torch.float32) * (2 * math.pi / k)
    return GaussianMixtureEnergy.create(4.0 * torch.stack([torch.cos(ang), torch.sin(ang)], -1),
                                        scale=0.4)


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
    rings = {kr: _ring(kr).to(dev) for kr in RING_CHECK_K}
    x_rings = {kr: ring.sample(g, N_CHAINS) for kr, ring in rings.items()}
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
            # rings of K not a power of two, from their modes: 12 components
            # (three per lane at G = 4) and 33 (G = 8, past the four logits
            # each lane keeps in registers)
            for kr, ring in rings.items():
                check("mixture_langevin_chain" + suffix,
                      (x_rings[kr], ring.means, steps, sched, 0.5),
                      dict(scale=float(ring.scale), log_weights=ring.log_weights, **tkw, seed=18,
                           clamp=(-4.5, 4.5), noise=noise2),
                      f"ring K={kr} G={fl.mixture_launch_plan(N_CHAINS, 2, kr, False)[0]}, {label}")
            tkw = dict(thin=7) if traj else {}
            check("doublewell_langevin_chain" + suffix, (xdw, steps, 0.01),
                  dict(**tkw, seed=13, noise=noisedw), f"{dw_label} const, {label}")
            check("doublewell_langevin_chain" + suffix, (xdw, steps, sched / 5, 0.7),
                  dict(**tkw, seed=14, clamp=(-1.5, 1.5), noise=noisedw),
                  f"{dw_label} sched+clamp, {label}")
        if noisedw is None:
            # the sampler's form of the seed: a 0-d int64 tensor read on the card
            seed_t = torch.tensor(13, device=dev)
            check("doublewell_langevin_chain", (xdw, steps, 0.01), dict(seed=seed_t),
                  f"{dw_label} const, philox, device seed")
            check("doublewell_langevin_chain_trajectory", (xdw, steps, 0.01),
                  dict(thin=7, seed=seed_t), f"{dw_label} const, philox, device seed")
        # the one-step op at the double-well shape and at 16M elements
        xs, gs = randn(*DW_SHAPE), randn(*DW_SHAPE)
        big_x, big_g = randn(STEP_ELEMS), randn(STEP_ELEMS)
        check("fused_langevin_step", (xs, gs, 0.01, 1.0),
              dict(seed=15, noise=noisedw if noisedw is None else noisedw[0]),
              f"{dw_label}, {label}")
        check("fused_langevin_step", (xs, gs, 0.01, 0.7),
              dict(seed=16, clamp=(-1.0, 1.0), noise=noisedw if noisedw is None else noisedw[1]),
              f"{dw_label} clamp, {label}")
        check("fused_langevin_step", (big_x, big_g, 0.05, 1.0 if noisedw is None else 0.0),
              dict(seed=17), f"{STEP_ELEMS} elements, noise scale "
              f"{1.0 if noisedw is None else 0.0}")


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
                                             if v[1].endswith("fused_langevin.cu")])

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
    dw_loop = dw.replace(fused="off").sample(torch.Generator(dev).manual_seed(7),
                                             dim=DW_SHAPE[1], n_samples=DW_SHAPE[0],
                                             n_steps=N_STEPS)
    dw_abs = float(dw_final.abs().mean())
    dw_moments = {name: (float(x.abs().mean()), float((x * x).mean()))
                  for name, x in (("kernel", dw_final), ("generic loop", dw_loop))}
    print(f"main path: mean radius {radius:.4f} (kernel, diagnostics) {radius_final:.4f} "
          f"(kernel) {radius_loop:.4f} (generic loop) {exact:.4f} (exact draws); "
          f"double well {DW_SHAPE[0]}x{DW_SHAPE[1]}x{N_STEPS} E|x|, E x^2: "
          + ", ".join(f"{a:.5f}, {b:.5f} ({name})" for name, (a, b) in dw_moments.items())
          + f" (tol {DW_MOMENT_TOL}) | {card}")
    if not 3.0 < radius < 5.0:
        raise AssertionError(f"sampler off-distribution: mean radius {radius}")
    if abs(radius - radius_loop) > 0.05 or abs(radius_final - radius_loop) > 0.05:
        raise AssertionError("kernel path and generic loop disagree on the mean radius")
    if not 0.5 < dw_abs < 1.5:
        raise AssertionError(f"double-well chain off-distribution: E|x| = {dw_abs}")
    (k_abs, k_sq), (l_abs, l_sq) = dw_moments.values()
    if abs(k_abs - l_abs) > DW_MOMENT_TOL or abs(k_sq - l_sq) > DW_MOMENT_TOL:
        raise AssertionError(f"the double-well kernel path and the generic loop disagree: "
                             f"{dw_moments}")
    return launches



@functools.lru_cache
def _mala_pilot_step(dev) -> float:
    """MALA's step on the correlated Gaussian: the trial closest to the 0.574
    optimal-scaling acceptance on the loop (diagnostics take the loop), as
    the JAX package's ESS protocol picks it (the same on every call)."""
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


def _flips(got, want, n: int, label: str):
    """``(flipped chains, largest error over the rest, 0-d errors)`` of the
    outputs ``got`` against ``want`` over ``n`` chains: a chain flips where
    any of its state, trajectory or acceptance differs by more than TOL."""
    import torch

    flipped = torch.zeros(n, dtype=torch.bool, device=got[0].device)
    diffs, scalars = [], []
    for gt, wt in zip(got, want):
        if not torch.isfinite(gt).all():
            raise AssertionError(f"{label}: kernel output is not finite")
        d = (gt - wt).abs()
        if d.ndim == 0:
            scalars.append(float(d))
            continue
        d = d.amax(dim=(0, 2)) if d.ndim == 3 else (d.amax(dim=1) if d.ndim == 2 else d)
        diffs.append(d)
        flipped |= d > TOL
    err = max(float(torch.where(flipped, 0.0, d).max()) for d in diffs)
    return int(flipped.sum()), err, scalars


def _check_flips(ops, name, args, kwargs, label, errors: dict, n: int) -> None:
    """A kernel with a Metropolis or exchange decision per step against its
    plain version (flip rule in the module docstring), over ``n`` chains. A
    0-d output (the ladder's acceptance, a mean over chains) may move by
    1/n for each flipped chain beyond the tolerance."""
    import torch

    module = getattr(ops, KERNELS[name][0])
    kernel = getattr(module, name)
    before = kernel.launches
    got = kernel(*args, **kwargs)
    torch.cuda.synchronize()
    if kernel.launches != before + 1:
        raise AssertionError(f"{name} did not launch its kernel")
    want = getattr(module, name + "_plain")(*args, **kwargs)
    n_flipped, err, scalars = _flips(got, want, n, f"{name} [{label}]")
    max_flipped = n // 1000
    scalar_ok = all(s <= TOL + n_flipped / n for s in scalars)
    errors[name] = max(errors.get(name, 0.0), err, *(s for s in scalars if n_flipped == 0))
    print(f"check: {name} [{label}] max|kernel - plain| = {err:.3e} over the "
          f"{n - n_flipped} chains that agree (tol {TOL:g}); flipped chains {n_flipped} "
          f"(at most {max_flipped})"
          + (f"; |acceptance kernel - plain| {max(scalars):.3e}" if scalars else "")
          + f"; mean acceptance {float(want[-1].mean()):.4f}")
    if not err <= TOL or n_flipped > max_flipped or not scalar_ok:
        raise AssertionError(f"{name} [{label}] disagrees with its plain version")


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
        _check_flips(ops, name, args, kwargs, label, errors, args[0].shape[0])

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


def phase_check_groups(ops, dev, errors: dict) -> None:
    """Rows 6-9 at every group of lanes per chain their kernels are built for
    (``fused_mala.mala_groups``, ``fused_hmc.hmc_groups``), whichever the
    launch plans pick, against their plain versions (flip rule in the module
    docstring): the ring from exact draws at step 0.05, the ESS protocol's
    correlated Gaussian at MALA's pilot step and HMC's adapted step and mass
    (thin 4; precision in registers), a d=16 full-covariance Gaussian
    (precision in shared memory), a d=16 mixture (the groups' largest
    bucket: four Philox blocks per step, drawn by the lanes) and 1,001 chains
    of the ring (groups past the last chain in a partial last warp), each
    with Philox and injected randomness, final state and trajectory, and for
    HMC with unit and diagonal mass."""
    import torch

    from torchebm_tpu_torch.core import GaussianMixtureEnergy
    from torchebm_tpu_torch.samplers.base import _gaussian_target

    g = torch.Generator(dev).manual_seed(8642)
    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    ring_kw = dict(scale=float(mix.scale), log_weights=mix.log_weights)
    x2 = mix.sample(g, N_CHAINS)
    corr_means, corr_prec = _gaussian_target(_corr_gaussian(dev))
    chol = torch.linalg.cholesky(torch.tensor(CORR_COV, device=dev))
    xc = (torch.randn((N_CHAINS, 2), generator=g, device=dev) @ chol.T).contiguous()
    _, _, (_, eps, mass_adapted) = _hmc_warmup(dev, True)
    mala_step = _mala_pilot_step(dev)
    means16 = 2.0 * torch.randn((8, 16), generator=g, device=dev)
    x16 = (means16[torch.randint(0, 8, (N_CHAINS,), generator=g, device=dev)]
           + 0.4 * torch.randn((N_CHAINS, 16), generator=g, device=dev)).contiguous()
    a16 = 0.1 * torch.randn((16, 16), generator=g, device=dev)
    prec16 = (a16 @ a16.T + torch.eye(16, device=dev)).contiguous()
    xg16 = torch.linalg.solve_triangular(  # exact draws of N(0, prec16^-1)
        torch.linalg.cholesky(prec16).T, torch.randn((16, N_CHAINS), generator=g, device=dev),
        upper=True).T.contiguous()
    # (label, x0, means, target keywords, thin, gaussian, MALA step, HMC step,
    # HMC diagonal mass)
    cases = (
        ("8gauss", x2, mix.means, ring_kw, 3, False, 0.05, 0.05,
         torch.tensor([0.5, 2.0], device=dev)),
        ("8gauss 1001 chains", x2[:1001].contiguous(), mix.means, ring_kw, 3, False, 0.05, 0.05,
         torch.tensor([0.5, 2.0], device=dev)),
        ("d=16 K=8", x16, means16, dict(scale=0.4), 3, False, 0.05, 0.05,
         0.5 + torch.rand(16, generator=g, device=dev)),
        ("corr-Gaussian", xc, corr_means, dict(precision=corr_prec.contiguous()), ESS_THIN, True,
         mala_step, eps, mass_adapted),
        ("Gaussian d=16", xg16, torch.zeros((1, 16), device=dev), dict(precision=prec16), 3, True,
         0.05, 0.05, 0.5 + torch.rand(16, generator=g, device=dev)),
    )
    n_checks = 0
    for label, x0, means, target_kw, thin, gaussian, mala_step, hmc_step, mass_diag in cases:
        n, d = x0.shape
        for inject in (True, False):
            rand = dict(seed=35) if not inject else dict(
                noise=torch.randn((CHECK_STEPS, n, d), generator=g, device=dev),
                uniforms=torch.rand((CHECK_STEPS, n), generator=g, device=dev))
            # (family, module, leading arguments, keywords per mass)
            for family, module, args, variants in (
                ("mala", ops.fused_mala, (x0, means, CHECK_STEPS, mala_step), ({},)),
                ("hmc", ops.fused_hmc, (x0, means, CHECK_STEPS, hmc_step, HMC_LEAPFROG),
                 (dict(mass=None), dict(mass=mass_diag))),
            ):
                groups = getattr(module, f"{family}_groups")(d, means.shape[0], gaussian)
                for variant in variants:
                    for t in (None, thin):
                        name = f"mixture_{family}_chain" + ("" if t is None else "_trajectory")
                        kw = dict(target_kw, **variant, **rand)
                        want = getattr(module, name + "_plain")(
                            *args, **kw, **({} if t is None else dict(thin=t)))
                        for group in groups:
                            traj, out, acc, launched = module._run(
                                *args, **run_kw(family, **kw, thin=t), group=group)
                            torch.cuda.synchronize()
                            got = (out, acc) if t is None else (traj, out, acc)
                            mass_label = ("" if family == "mala" else "diagonal mass, "
                                          if variant["mass"] is not None else "unit mass, ")
                            what = (f"{name} [{label}, G={group}, {mass_label}"
                                    f"{'injected' if inject else 'philox'}]")
                            n_flipped, err, _ = _flips(got, want, n, what)
                            errors[name] = max(errors.get(name, 0.0), err)
                            n_checks += 1
                            print(f"check: {what} max|kernel - plain| = {err:.3e} over the "
                                  f"{n - n_flipped} chains that agree (tol {TOL:g}); flipped "
                                  f"chains {n_flipped} (at most {n // 1000})")
                            if not launched or not err <= TOL or n_flipped > n // 1000:
                                raise AssertionError(f"{what} disagrees with its plain version")
    print(f"check: {n_checks} group checks of rows 6-9 within the flip rule")


def phase_check_tempering(ops, dev, errors: dict) -> None:
    """The parallel-tempering and AIS kernels against their plain versions
    (flip rule in the module docstring). The ring checks start at exact
    draws of the ring, PT at noise scale 0.5, so that even the hottest
    replica (T = 4.1, effective temperature about 1) stays in its mode; the
    ladders at every group (:func:`_check_pt_groups`), AIS at every group
    (:func:`_check_ais_groups`)."""
    import torch

    from torchebm_tpu_torch.core import GaussianMixtureEnergy

    g = torch.Generator(dev).manual_seed(2468)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)

    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    mix_kw = dict(scale=float(mix.scale), log_weights=mix.log_weights)
    n_rep, steps, n = len(PT_TEMPS), CHECK_STEPS, N_CHAINS
    betas = tuple(1.0 / t for t in PT_TEMPS)
    d = 32
    a = randn(d, d, scale=0.1)
    gauss_kw = dict(precision=(a @ a.T + torch.eye(d, device=dev)).contiguous())
    mean32 = randn(1, d)
    ring = mix.sample(g, n_rep * n).view(n_rep, n, 2)
    ladder32 = (mean32 + randn(n_rep, n, d, scale=0.7)).contiguous()

    for label, inject in (("injected", True), ("philox", False)):
        def pt_rand(dim, seed):
            if not inject:
                return dict(seed=seed)
            return dict(noise=randn(steps, n_rep, n, dim), swap_uniform=torch.rand(
                (steps // PT_SWAP_EVERY, n_rep - 1, n), generator=g, device=dev))

        for traj in (False, True):
            name = "pt_langevin_chain" + ("_trajectory" if traj else "")
            tkw = dict(thin=3) if traj else {}
            _check_flips(ops, name, (ring, mix.means, steps, 0.05, 0.5, betas, PT_SWAP_EVERY),
                         dict(**mix_kw, **tkw, **pt_rand(2, 41)), f"8gauss R=4, {label}",
                         errors, n)
            if not inject:
                _check_flips(ops, name, (ring, mix.means, steps, 0.05, 0.5, betas, 3),
                             dict(**mix_kw, **tkw, clamp=(-4.5, 4.5), seed=42),
                             "8gauss R=4 swap every 3 + clamp, philox", errors, n)
            _check_flips(ops, name, (ladder32, mean32, steps, 0.02, 1.0, betas, PT_SWAP_EVERY),
                         dict(**gauss_kw, **tkw, **pt_rand(d, 43)), f"d=32 full cov R=4, {label}",
                         errors, n)
    _check_pt_groups(ops, dev, errors)
    _check_ais_groups(ops, dev, errors)


def _check_pt_groups(ops, dev, errors: dict) -> None:
    """Rows 10-11 at every group of lanes per replica their kernel is built
    for (``fused_pt.pt_groups``), whichever the launch plan picks, against
    their plain versions (flip rule in the module docstring): the ring from
    its modes at noise scale 0.5 with R = 4 (PT_TEMPS), R = 3 (a padded
    replica group in every chain) and R = 8 (:func:`pt_ladder`, the warp
    bounding the group at 4), 1,001 chains of the ring (a partial last
    warp), a d=16 mixture (four Philox blocks per step, drawn by the lanes)
    and a d=16 full-covariance Gaussian (precision in shared memory) at R =
    4, each with Philox and injected randomness, final ladder, trajectory
    (thin 3) and per-chain acceptance."""
    import torch

    from torchebm_tpu_torch.core import GaussianMixtureEnergy

    fp = ops.fused_pt
    g = torch.Generator(dev).manual_seed(9753)
    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    ring_kw = dict(scale=float(mix.scale), log_weights=mix.log_weights, precision=None)
    n, steps = N_CHAINS, CHECK_STEPS

    def ring(n_rep, n_chains=n):
        return mix.sample(g, n_rep * n_chains).view(n_rep, n_chains, 2)

    means16 = 2.0 * torch.randn((8, 16), generator=g, device=dev)
    x16 = (means16[torch.randint(0, 8, (4 * n,), generator=g, device=dev)]
           + 0.4 * torch.randn((4 * n, 16), generator=g, device=dev)).view(4, n, 16)
    a16 = 0.1 * torch.randn((16, 16), generator=g, device=dev)
    prec16 = (a16 @ a16.T + torch.eye(16, device=dev)).contiguous()
    xg16 = torch.linalg.solve_triangular(  # exact draws of N(0, prec16^-1)
        torch.linalg.cholesky(prec16).T, torch.randn((16, 4 * n), generator=g, device=dev),
        upper=True).T.reshape(4, n, 16)
    betas4 = tuple(1.0 / t for t in PT_TEMPS)
    # (label, replicas, means, target keywords, betas, noise scale, gaussian)
    cases = (
        ("8gauss R=4", ring(4), mix.means, ring_kw, betas4, 0.5, False),
        ("8gauss R=3", ring(3), mix.means, ring_kw, betas4[:3], 0.5, False),
        ("8gauss R=8", ring(8), mix.means, ring_kw, pt_ladder(8), 0.5, False),
        ("8gauss R=4 1001 chains", ring(4, 1001), mix.means, ring_kw, betas4, 0.5, False),
        ("d=16 K=8 R=4", x16.contiguous(), means16, dict(scale=0.4, log_weights=None,
                                                         precision=None), betas4, 0.5, False),
        ("Gaussian d=16 R=4", xg16.contiguous(), torch.zeros((1, 16), device=dev),
         dict(scale=1.0, log_weights=None, precision=prec16), betas4, 1.0, True),
    )
    n_checks = 0
    for label, reps, means, target_kw, betas, noise_scale, gaussian in cases:
        n_rep, n_c, d = reps.shape
        groups = fp.pt_groups(n_rep, d, means.shape[0], gaussian)
        args = (reps, means, steps, 0.05, noise_scale, betas, PT_SWAP_EVERY)
        for inject in (True, False):
            rand = dict(seed=48, noise=None, swap_uniform=None) if not inject else dict(
                seed=48, noise=torch.randn((steps, n_rep, n_c, d), generator=g, device=dev),
                swap_uniform=torch.rand((steps // PT_SWAP_EVERY, n_rep - 1, n_c), generator=g,
                                        device=dev))
            for thin in (None, 3):
                name = "pt_langevin_chain" + ("" if thin is None else "_trajectory")
                kw = dict(**target_kw, **rand, clamp=None)
                want = fp._run(*args, thin, **kw, kernel=False)
                want = want[1:] if thin is None else want
                for group in groups:
                    traj, out, acc = fp._run(*args, thin, **kw, kernel=True, group=group)
                    torch.cuda.synchronize()
                    got = (out, acc) if thin is None else (traj, out, acc)
                    what = (f"{name} [{label}, G={group}, "
                            f"{'injected' if inject else 'philox'}]")
                    n_flipped, err, _ = _flips(got, want, n_c, what)
                    errors[name] = max(errors.get(name, 0.0), err)
                    n_checks += 1
                    print(f"check: {what} max|kernel - plain| = {err:.3e} over the "
                          f"{n_c - n_flipped} chains that agree (tol {TOL:g}); flipped chains "
                          f"{n_flipped} (at most {n_c // 1000}); mean acceptance "
                          f"{float(want[-1].mean()):.4f}")
                    if not err <= TOL or n_flipped > n_c // 1000:
                        raise AssertionError(f"{what} disagrees with its plain version")
    print(f"check: {n_checks} group checks of rows 10-11 within the flip rule")


def _ais_kernel_target(target) -> tuple:
    """The AIS kernel's ``means`` and target keywords for ``target``, as the
    sampler passes them (``_fused_target_kwargs``)."""
    from torchebm_tpu_torch.samplers.ais import _fused_target_kwargs

    kw = _fused_target_kwargs(target)
    return kw.pop("means"), kw


def _check_ais_groups(ops, dev, errors: dict) -> None:
    """Row 12 at every group of lanes per chain its kernel is built for
    (``fused_ais.ais_groups``) against its plain version (flip rule in the
    module docstring), with the AIS_RUNGS + 1 entry beta table and the base
    N(0, AIS_BASE_VAR I): the ring (the sampler's arguments) from its modes
    at AIS_CHAINS chains at step 0.005 (at 0.01 the chains that the weak
    early-rung target lets reach a saddle grew rounding to 9.7e-5 over 50
    rungs) with 1 and 2 transitions per rung, and its first 1,001 chains
    (groups past the last chain in a partial last warp); the full-covariance
    (``precision=``) and the isotropic Gaussian (a one-component mixture) at
    AIS_GAUSS_CHAINS from draws of the base, where they contract everywhere;
    an 8-component mixture at d=16 from its modes and a d=16
    full-covariance Gaussian at N_CHAINS (four Philox blocks per transition,
    drawn by the lanes); the d=32 full-covariance Gaussian (one lane, its
    own base). Each with Philox (the seed a device tensor; an int at d=32)
    and injected randomness; the plan's group through the public wrapper
    and its launch count, every other through ``fused_ais._run``."""
    import torch

    fa = ops.fused_ais
    g = torch.Generator(dev).manual_seed(2469)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)

    betas = torch.linspace(0.0, 1.0, AIS_RUNGS + 1, device=dev)
    s0 = AIS_BASE_VAR ** 0.5
    zero2, zero16 = torch.zeros(2, device=dev), torch.zeros(16, device=dev)
    targets = _ais_targets(dev)
    ring, n_ring = targets["8gauss ring"]
    x_ring = ring.sample(g, n_ring)
    ring_means, ring_kw = _ais_kernel_target(ring)
    # (label, x0, base mean, base scale, means, step, keywords)
    cases = [(f"8gauss ring {n_ring} chains, {n_tr} transitions", x_ring, zero2, s0, ring_means,
              0.005, dict(ring_kw, n_transitions=n_tr)) for n_tr in (1, 2)]
    cases.append(("8gauss ring 1001 chains", x_ring[:1001].contiguous(), zero2, s0, ring_means,
                  0.005, ring_kw))
    for name in ("full-cov Gaussian", "isotropic Gaussian"):
        target, n_g = targets[name]
        means, kw = _ais_kernel_target(target)
        cases.append((f"{name} {n_g} chains", randn(n_g, 2, scale=s0), zero2, s0, means, 0.05,
                      kw))
    means16 = randn(8, 16, scale=2.0)
    x16 = (means16[torch.randint(0, 8, (N_CHAINS,), generator=g, device=dev)]
           + randn(N_CHAINS, 16, scale=0.4)).contiguous()
    cases.append((f"d=16 K=8 {N_CHAINS} chains", x16, zero16, s0, means16, 0.005,
                  dict(scale=0.4)))
    a16 = randn(16, 16, scale=0.1)
    cases.append((f"Gaussian d=16 {N_CHAINS} chains", randn(N_CHAINS, 16, scale=s0), zero16, s0,
                  torch.zeros((1, 16), device=dev), 0.05,
                  dict(precision=(a16 @ a16.T + torch.eye(16, device=dev)).contiguous(),
                       log_norm_t=0.0)))
    a32 = randn(32, 32, scale=0.1)
    mean32 = randn(1, 32)
    cases.append((f"d=32 full cov {N_CHAINS} chains", (mean32 + randn(N_CHAINS, 32, scale=0.7)),
                  mean32[0], 2.0, mean32, 0.02,
                  dict(precision=(a32 @ a32.T + torch.eye(32, device=dev)).contiguous())))
    n_checks = 0
    for label, x0, mu0, scale0, means, step, kw in cases:
        n, d = x0.shape
        k, gaussian = means.shape[0], kw.get("precision") is not None
        n_tr = kw.get("n_transitions", 1)
        pick = fa.ais_launch_plan(n, d, k, gaussian)[0]
        args = (x0, mu0, scale0, means, betas, step)
        for inject in (True, False):
            if inject:
                rand = dict(noise=randn(AIS_RUNGS * n_tr, n, d), uniforms=torch.rand(
                    (AIS_RUNGS * n_tr, n), generator=g, device=dev))
            else:
                rand = dict(seed=47 if d == 32 else torch.tensor(44, device=dev))
            want = fa.mixture_ais_run_plain(*args, **kw, **rand)
            for group in fa.ais_groups(d, k, gaussian):
                if group == pick:
                    before = fa.mixture_ais_run.launches
                    got = fa.mixture_ais_run(*args, **kw, **rand)
                    launched = fa.mixture_ais_run.launches == before + 1
                else:
                    *got, launched = fa._run(*args, **kw, **rand, group=group)
                torch.cuda.synchronize()
                what = (f"mixture_ais_run [{label}, {AIS_RUNGS} rungs, step {step}, G={group}"
                        f"{' (the plan)' if group == pick else ''}, "
                        f"{'injected' if inject else 'philox'}]")
                n_flipped, err, _ = _flips(tuple(got), want, n, what)
                errors["mixture_ais_run"] = max(errors.get("mixture_ais_run", 0.0), err)
                n_checks += 1
                print(f"check: {what} max|kernel - plain| = {err:.3e} over the "
                      f"{n - n_flipped} chains that agree (tol {TOL:g}); flipped chains "
                      f"{n_flipped} (at most {n // 1000}); mean acceptance "
                      f"{float(want[-1].mean()):.4f}")
                if not launched or not err <= TOL or n_flipped > n // 1000:
                    raise AssertionError(f"{what} disagrees with its plain version")
    print(f"check: {n_checks} group checks of row 12 within the flip rule")


def _ais_targets(dev) -> dict:
    """The AIS main path's targets: ``{name: (energy, chains)}``."""
    import torch

    from torchebm_tpu_torch.core import GaussianEnergy, GaussianMixtureEnergy

    return {
        "8gauss ring": (GaussianMixtureEnergy.eight_gaussians().to(dev), AIS_CHAINS),
        "full-cov Gaussian": (GaussianEnergy.create(
            torch.tensor([0.5, -0.5]), torch.tensor([[2.0, 1.6], [1.6, 2.0]])).to(dev),
            AIS_GAUSS_CHAINS),
        "isotropic Gaussian": (GaussianEnergy.create(
            torch.tensor([1.0, -1.0]), 2.0 * torch.eye(2)).to(dev), AIS_GAUSS_CHAINS),
    }


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
    # one chain launch per ring sample(), one trajectory launch per ESS call
    if (launches["mixture_hmc_chain"], launches["mixture_hmc_chain_trajectory"]) != (1, 4):
        raise AssertionError(f"the HMC path made {launches} launches, not 1 chain and 4 "
                             "trajectory launches")
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


#: the advanced HMC samplers' paths, after the HMC path. RMHMC at 4,096
#: chains: the identity metric on the correlated Gaussian against HMC's
#: generic loop from one generator seed (50 draws of 5 leapfrog steps, equal
#: to RMHMC_TOL), the radial metric G(x) = (1 + |x|^2) I of
#: tests/samplers/test_rmhmc_moments.py:102-120 on N(0, I) (600 draws), and
#: one call at d = 16, the cap of benchmarks/registry.py:114 (3 steps)
RMHMC_CHAINS, RMHMC_LEAPFROG, RMHMC_ID_DRAWS, RMHMC_DRAWS = 4096, 5, 50, 600
RMHMC_WIDE_D, RMHMC_WIDE_LEAPFROG, RMHMC_WIDE_DRAWS = 16, 3, 10
RMHMC_TOL = 1e-5
#: NUTS at the sampler shootout's protocol (benchmarks/headline.py:333-361):
#: 256 chains on the correlated Gaussian, step 0.2 before warmup, tree depth
#: at most 8, 200 warmup transitions, 250 draws; the NUTS->HMC handoff
#: (tune_trajectory_length) tunes on the same 256 chains
NUTS_CHAINS, NUTS_STEP, NUTS_DEPTH, NUTS_WARMUP, NUTS_DRAWS = 256, 0.2, 8, 200, 250


def _identity_metric(x):
    import torch

    d = x.shape[-1]
    return torch.eye(d, dtype=x.dtype, device=x.device).expand(x.shape[0], d, d)


def _radial_metric(x):
    import torch

    scale = 1.0 + torch.sum(x * x, dim=-1, keepdim=True)
    return torch.diag_embed(scale.expand(x.shape))


def _timed(fn):
    """``(fn(), host milliseconds to the end of its device work)``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _moments(name: str, traj, corr_want, card: str):
    """Gates of a sampler's trajectory ``(chains, draws, d)`` on a Gaussian of
    unit variances: each mean within 5 standard errors of 0 (the standard
    error from ``summarize_chains``' ESS), each variance within 10% of 1,
    the correlation of the first two coordinates within 0.05 of
    ``corr_want`` (when given); returns the minimum ESS."""
    import torch

    from torchebm_tpu_torch.samplers import summarize_chains

    if not torch.isfinite(traj).all():
        raise AssertionError(f"{name}: trajectory is not finite")
    flat = traj.reshape(-1, traj.shape[-1]).double()
    mean, var = flat.mean(0), flat.var(0)
    ess = summarize_chains(traj)["ess"].double()
    se = torch.sqrt(var / ess)
    corr = float(torch.corrcoef(flat[:, :2].T)[0, 1])
    print(f"main path: {name} {tuple(traj.shape)}: mean {[round(float(v), 5) for v in mean]} "
          f"(standard error {[round(float(v), 5) for v in se]}), variance "
          f"{[round(float(v), 5) for v in var]}, correlation {corr:.5f}, min ESS "
          f"{float(ess.min()):.1f} | {card}")
    if not bool((mean.abs() <= 5.0 * se).all()):
        raise AssertionError(f"{name}: a mean lies beyond 5 standard errors of 0")
    if not bool(((var - 1.0).abs() <= 0.1).all()):
        raise AssertionError(f"{name}: a variance lies beyond 10% of 1")
    if corr_want is not None and not abs(corr - corr_want) <= 0.05:
        raise AssertionError(f"{name}: correlation {corr}, not within 0.05 of {corr_want}")
    return float(ess.min())


def path_rmhmc(ops, dev, card: str) -> dict:
    """Riemannian-manifold HMC on the generic loop (no kernel row claims it):
    the identity metric against HMC's loop from one seed, the radial metric's
    moments, one call at d = 16, and one draw's wall time, device busy time
    and idle share."""
    import torch

    from torchebm_tpu_torch.core import GaussianEnergy
    from torchebm_tpu_torch.samplers import HamiltonianMonteCarlo, RiemannianManifoldHMC

    corr = _corr_gaussian(dev)
    ops.reset_launch_counts()
    kw = dict(step_size=0.3, n_leapfrog_steps=RMHMC_LEAPFROG)
    run = dict(dim=2, n_samples=RMHMC_CHAINS, n_steps=RMHMC_ID_DRAWS, return_trajectory=True,
               return_diagnostics=True)
    rm = RiemannianManifoldHMC(corr, metric_fn=_identity_metric, **kw)
    (got, diag), wall = _timed(lambda: rm.sample(torch.Generator(dev).manual_seed(90), **run))
    want, diag_hmc = HamiltonianMonteCarlo(corr, fused="off", **kw).sample(
        torch.Generator(dev).manual_seed(90), **run)
    err = float((got - want).abs().max())
    acc_err = float((diag["acceptance_rate"] - diag_hmc["acceptance_rate"]).abs().max())
    print(f"main path: RMHMC identity metric, corr-Gaussian {RMHMC_CHAINS}x{RMHMC_ID_DRAWS} "
          f"draws x {RMHMC_LEAPFROG} leapfrog: against HMC(fused='off') from one seed max |error| "
          f"{err:.3e} over the trajectory, acceptance {acc_err:.3e} (tol {RMHMC_TOL:g}); "
          f"mean acceptance {float(diag['acceptance_rate'].mean()):.4f}; {wall:.1f} ms, "
          f"{wall / RMHMC_ID_DRAWS:.3f} ms per draw | {card}")
    if not torch.isfinite(got).all() or not err <= RMHMC_TOL or not acc_err <= RMHMC_TOL:
        raise AssertionError(f"RMHMC with the identity metric is not HMC: {err}, {acc_err}")

    radial = RiemannianManifoldHMC(GaussianEnergy.standard(2).to(dev), metric_fn=_radial_metric,
                                   step_size=0.15, n_leapfrog_steps=RMHMC_LEAPFROG)
    g = torch.Generator(dev).manual_seed(91)
    (traj, diag), wall = _timed(lambda: radial.sample(
        g, dim=2, n_samples=RMHMC_CHAINS, n_steps=RMHMC_DRAWS, return_trajectory=True,
        return_diagnostics=True))
    acc = float(diag["acceptance_rate"][-1])
    print(f"main path: RMHMC radial metric, N(0, I) {RMHMC_CHAINS}x{RMHMC_DRAWS} draws x "
          f"{RMHMC_LEAPFROG} leapfrog at 0.15: last acceptance {acc:.4f}; {wall:.1f} ms, "
          f"{wall / RMHMC_DRAWS:.3f} ms per draw | {card}")
    if not acc > 0.5:
        raise AssertionError(f"RMHMC radial metric: last acceptance {acc} <= 0.5")
    _moments("RMHMC radial metric", traj, None, card)

    x_last = traj[:, -1].contiguous()
    wide = RiemannianManifoldHMC(GaussianEnergy.standard(RMHMC_WIDE_D).to(dev),
                                 metric_fn=_identity_metric, step_size=0.3,
                                 n_leapfrog_steps=RMHMC_WIDE_LEAPFROG)
    x_wide = torch.randn((RMHMC_CHAINS, RMHMC_WIDE_D), generator=g, device=dev)
    wide_label = (f"RMHMC identity metric d={RMHMC_WIDE_D} {RMHMC_CHAINS}x{RMHMC_WIDE_DRAWS} "
                  f"draws x {RMHMC_WIDE_LEAPFROG} leapfrog")
    rows = profile_calls({
        f"RMHMC draw, radial metric {RMHMC_CHAINS} chains x {RMHMC_LEAPFROG} leapfrog":
            lambda: radial.sample(g, x=x_last, n_steps=1),
        wide_label: lambda: wide.sample(g, x=x_wide, n_steps=RMHMC_WIDE_DRAWS),
    }, card, require_events=True)
    wall, busy = rows[wide_label]
    print(f"main path: {wide_label}: {wall / RMHMC_WIDE_DRAWS:.3f} ms per draw, device busy "
          f"{busy / RMHMC_WIDE_DRAWS:.3f} ms per draw, idle share {1.0 - busy / wall:.3f} "
          f"| {card}")
    return read_counts(ops, "RMHMC", [])


def _nuts_run(dev, adapt_mass: bool):
    """The shootout protocol's NUTS: ``(tuned sampler, warmed x, trajectory,
    diagnostics, ms of the 250 draws)``."""
    import torch

    from torchebm_tpu_torch.samplers import NoUTurnSampler

    nuts = NoUTurnSampler(_corr_gaussian(dev), step_size=NUTS_STEP, max_tree_depth=NUTS_DEPTH)
    g = torch.Generator(dev).manual_seed(95 + adapt_mass)
    x0, eps, *mass = nuts.warmup(g, dim=2, n_warmup=NUTS_WARMUP, n_samples=NUTS_CHAINS,
                                 adapt_mass=adapt_mass)
    tuned = nuts.replace(step_size=eps, mass=mass[0] if mass else None)
    (traj, diag), wall = _timed(lambda: tuned.sample(
        g, x=x0, n_steps=NUTS_DRAWS, return_trajectory=True, return_diagnostics=True))
    return tuned, x0, traj, diag, wall


def path_nuts(ops, dev, card: str) -> dict:
    """NUTS at the sampler shootout's protocol (``benchmarks/headline.py:
    333-361``), with unit and with adapted diagonal mass: the moment,
    acceptance and divergence gates, the adapted step, mean tree depth, min
    ESS, ms per draw and ESS/s, and one draw's wall time, device busy time
    and idle share."""
    import torch

    ops.reset_launch_counts()
    for adapt_mass in (False, True):
        tuned, x0, traj, diag, wall = _nuts_run(dev, adapt_mass)
        label = "adapted diagonal mass" if adapt_mass else "unit mass"
        name = f"NUTS corr-Gaussian, {label}"
        min_ess = _moments(name, traj, CORR_COV[0][1], card)
        acc = float(diag["acceptance_rate"][-1])
        div = float(diag["divergence_rate"].mean())
        mass = None if tuned.mass is None else [round(float(m), 5) for m in tuned.mass]
        print(f"main path: {name} {NUTS_CHAINS}x{NUTS_DRAWS} draws after {NUTS_WARMUP} warmup "
              f"transitions: step size {tuned.step_size:.5f}, mass {mass}, mean tree depth "
              f"{float(diag['tree_depth'].mean()):.4f} (largest per-draw mean "
              f"{float(diag['tree_depth'].max()):.4f}), last acceptance {acc:.4f} (target "
              f"{tuned.target_accept}), divergence rate {div:.5f}, min ESS {min_ess:.1f}, "
              f"{wall / NUTS_DRAWS:.3f} ms per draw (diagnostics and trajectory included), "
              f"ESS/s {min_ess / (wall / 1e3):.1f} | {card}")
        if not abs(acc - tuned.target_accept) <= 0.1:
            raise AssertionError(f"{name}: last acceptance {acc} not within 0.1 of the target")
        if not div < 0.01:
            raise AssertionError(f"{name}: divergence rate {div} >= 1%")
    g = torch.Generator(dev).manual_seed(97)
    profile_calls({f"NUTS draw, corr-Gaussian {NUTS_CHAINS} chains, tree depth <= {NUTS_DEPTH}":
                   lambda: tuned.sample(g, x=x0, n_steps=1)}, card, require_events=True)
    return read_counts(ops, "NUTS", [])


def path_handoff(ops, dev, card: str) -> dict:
    """The NUTS->HMC handoff: ``tune_trajectory_length`` on the correlated
    Gaussian (256 chains), then ``HamiltonianMonteCarlo`` at the tuned step,
    trajectory length and mass over the ESS protocol's draws, one
    ``mixture_hmc_chain_trajectory`` launch, gated against the same HMC on
    the generic loop; row 9 timed at the tuned trajectory length; the
    tuning call's wall time, device busy time and idle share."""
    import torch

    from torchebm_tpu_torch.ops import fused_hmc
    from torchebm_tpu_torch.ops._counts import work
    from torchebm_tpu_torch.samplers import (
        HamiltonianMonteCarlo,
        summarize_chains,
        tune_trajectory_length,
    )
    from torchebm_tpu_torch.samplers.base import _gaussian_target

    corr = _corr_gaussian(dev)

    def tune():
        return tune_trajectory_length(torch.Generator(dev).manual_seed(100), corr, dim=2,
                                      n_samples=NUTS_CHAINS)

    ops.reset_launch_counts()
    t, tune_wall = _timed(tune)
    hmc = HamiltonianMonteCarlo(corr, step_size=t.step_size, n_leapfrog_steps=t.n_leapfrog,
                                mass=t.mass)
    g = torch.Generator(dev).manual_seed(101)
    before = fused_hmc.mixture_hmc_chain_trajectory.launches
    traj, wall = _timed(lambda: hmc.sample(g, x=t.x, n_steps=ESS_DRAWS, thin=ESS_THIN,
                                           return_trajectory=True))
    if fused_hmc.mixture_hmc_chain_trajectory.launches != before + 1:
        raise AssertionError("the handoff's HMC call did not launch mixture_hmc_chain_trajectory "
                             "exactly once")
    consecutive = hmc.sample(g, x=t.x, n_steps=N_STEPS, return_trajectory=True)
    launches = read_counts(ops, "NUTS->HMC handoff", ["mixture_hmc_chain_trajectory"])
    # one trajectory launch for the ESS draws, one for the consecutive draws
    if (launches["mixture_hmc_chain"], launches["mixture_hmc_chain_trajectory"]) != (0, 2):
        raise AssertionError(f"the handoff made {launches} launches, not 2 trajectory launches")
    group = fused_hmc.hmc_launch_plan(NUTS_CHAINS, 2, 1, True)[0]
    print(f"main path: NUTS->HMC handoff: tune_trajectory_length (corr-Gaussian, {NUTS_CHAINS} "
          f"chains, NUTS warmup 200, pilot 100, HMC warmup 200) {tune_wall:.1f} ms: mean tree "
          f"depth {t.mean_tree_depth:.4f}, n_leapfrog {t.n_leapfrog}, step size "
          f"{t.step_size:.5f}; the HMC plan's group G={group} | {card}")
    looped = hmc.replace(fused="off")
    g = torch.Generator(dev).manual_seed(102)
    loop = looped.sample(g, x=t.x, n_steps=ESS_DRAWS, thin=ESS_THIN, return_trajectory=True)
    loop1 = looped.sample(g, x=t.x, n_steps=N_STEPS, return_trajectory=True)
    _check_corr_trajectory("NUTS->HMC handoff", traj, loop, (consecutive, loop1), card)
    min_ess = float(summarize_chains(traj)["ess"].min())
    print(f"main path: NUTS->HMC handoff production draws {tuple(traj.shape)} (one kernel "
          f"launch, its first call): {wall:.3f} ms, min ESS {min_ess:.1f}, ESS/s "
          f"{min_ess / (wall / 1e3):.1f} | {card}")

    # row 9 at the tuned trajectory length, at the handoff's chains and at
    # the ESS protocol's 10,000
    means, prec = _gaussian_target(corr)
    kw = dict(thin=ESS_THIN, precision=prec.contiguous(), mass=t.mass, seed=21)
    clock = max_sm_clock_mhz()
    name = "mixture_hmc_chain_trajectory"
    for x0 in (t.x, torch.randn((N_CHAINS, 2), generator=g, device=dev)):
        args = (x0.contiguous(), means, ESS_DRAWS, t.step_size, t.n_leapfrog)
        run = functools.partial(fused_hmc.mixture_hmc_chain_trajectory, *args, **kw)
        b_ms, b_by = bound_of(work(name, args, kw, run()), clock)
        ms = statistics.median(cuda_times(run, 2, 10))
        dev_ms = device_ms(run)
        print(f"timing: {name} at the handoff's tuning (corr-Gaussian d=2, {x0.shape[0]}x"
              f"{ESS_DRAWS} thin {ESS_THIN}, n_leapfrog {t.n_leapfrog}, step {t.step_size:.5f}, "
              f"G={fused_hmc.hmc_launch_plan(x0.shape[0], 2, 1, True)[0]}): {ms:.4f} ms per "
              f"call, device {dev_ms:.4f} ms; bound {b_ms:.5f} ms by {b_by} "
              f"({b_ms / dev_ms:.3f} of the bound's rate by device time) | {card}", flush=True)
    busy, sessions = device_busy_ms(tune)
    if busy <= 0:
        raise AssertionError(f"profile: tune_trajectory_length: {sessions} profiles recorded no "
                             "device events")
    print(f"profile: tune_trajectory_length corr-Gaussian {NUTS_CHAINS} chains (the path's "
          f"call): wall {tune_wall:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{1.0 - busy / tune_wall:.3f} | {card}")
    return launches


#: the advanced HMC samplers' paths, in the order they run
MCMC_PATHS = (path_rmhmc, path_nuts, path_handoff)


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


def _radius(x) -> float:
    return float(x.norm(dim=-1).mean())


def path_pt(ops, dev, card: str) -> dict:
    """The PT configuration: ``sample`` (ladder kernel), ``sample(...,
    return_trajectory=True)`` (trajectory kernel) and ``run_replicas`` on a
    (4, 10,000, 2) ladder, against the generic loop: cold-chain mean radius
    within 0.05 and last-sweep swap acceptance within 0.02 (its standard
    error over 10,000 chains is about 0.003)."""
    import torch

    from torchebm_tpu_torch.core import GaussianMixtureEnergy
    from torchebm_tpu_torch.samplers import ParallelTemperingLangevin

    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    pt = ParallelTemperingLangevin(mix, temperatures=PT_TEMPS, step_size=0.05,
                                   swap_every=PT_SWAP_EVERY)
    ladder0 = torch.randn((len(PT_TEMPS), N_CHAINS, 2),
                          generator=torch.Generator(dev).manual_seed(100), device=dev)
    ops.reset_launch_counts()
    cold = pt.sample(torch.Generator(dev).manual_seed(101), dim=2, n_samples=N_CHAINS,
                     n_steps=N_STEPS)
    traj = pt.sample(torch.Generator(dev).manual_seed(102), dim=2, n_samples=N_CHAINS,
                     n_steps=N_STEPS, return_trajectory=True)
    ladder, acc = pt.run_replicas(torch.Generator(dev).manual_seed(103), ladder0, N_STEPS)
    launches = read_counts(ops, "parallel tempering",
                           ["pt_langevin_chain", "pt_langevin_chain_trajectory"])
    loop = pt.replace(fused="off")
    cold_loop = loop.sample(torch.Generator(dev).manual_seed(101), dim=2, n_samples=N_CHAINS,
                            n_steps=N_STEPS)
    ladder_loop, acc_loop = loop.run_replicas(torch.Generator(dev).manual_seed(103), ladder0,
                                              N_STEPS)
    if (cold.shape, traj.shape, ladder.shape) != ((N_CHAINS, 2), (N_CHAINS, N_STEPS, 2),
                                                  (len(PT_TEMPS), N_CHAINS, 2)):
        raise AssertionError("parallel tempering outputs have the wrong shapes")
    for name, t in (("cold", cold), ("trajectory", traj), ("ladder", ladder)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"parallel tempering {name} is not finite")
    r, r_traj, r_ladder = _radius(cold), _radius(traj[:, N_STEPS // 2:]), _radius(ladder[0])
    r_loop, r_ladder_loop = _radius(cold_loop), _radius(ladder_loop[0])
    print(f"main path: PT 8gauss {N_CHAINS}x{N_STEPS}, R={len(PT_TEMPS)}: cold mean radius "
          f"{r:.4f} (kernel) {r_loop:.4f} (generic loop), trajectory's last {N_STEPS // 2} "
          f"steps {r_traj:.4f}; run_replicas cold radius {r_ladder:.4f} (kernel) "
          f"{r_ladder_loop:.4f} (generic loop), last-sweep swap acceptance {float(acc):.4f} "
          f"(kernel) {float(acc_loop):.4f} (generic loop) | {card}")
    if not 3.0 < r < 5.0:
        raise AssertionError(f"PT cold chain off-distribution: mean radius {r}")
    if max(abs(r - r_loop), abs(r_traj - r_loop), abs(r_ladder - r_ladder_loop)) > 0.05:
        raise AssertionError("PT kernel path and generic loop disagree on the mean radius")
    if abs(float(acc) - float(acc_loop)) > 0.02:
        raise AssertionError("PT kernel path and generic loop disagree on the swap acceptance")
    return launches


def path_ais(ops, dev, card: str) -> dict:
    """The AIS configuration on the ring (true log Z = 0), and the same call
    on a full-covariance (``precision=``) and an isotropic Gaussian, whose
    ``log_z()`` is exact: each estimate within 0.02 of the truth, and the
    kernel within 0.03 of the generic loop (two independent estimates)."""
    import torch

    from torchebm_tpu_torch.core import GaussianEnergy, GaussianMixtureEnergy
    from torchebm_tpu_torch.samplers import annealed_importance_sampling

    base = GaussianEnergy.create(torch.zeros(2), AIS_BASE_VAR * torch.eye(2)).to(dev)
    targets = _ais_targets(dev)

    def run(fused):
        return {name: annealed_importance_sampling(
            torch.Generator(dev).manual_seed(110 + i), t, base=base, n_samples=n,
            n_rungs=AIS_RUNGS, step_size=0.05, fused=fused)
            for i, (name, (t, n)) in enumerate(targets.items())}

    ops.reset_launch_counts()
    kernel = run("auto")
    launches = read_counts(ops, "AIS", ["mixture_ais_run"])
    loop = run("off")
    for name, (t, n) in targets.items():
        truth = 0.0 if isinstance(t, GaussianMixtureEnergy) else float(t.log_z())
        k, lp = kernel[name], loop[name]
        if k.samples.shape != (n, 2) or not torch.isfinite(k.log_weights).all():
            raise AssertionError(f"AIS {name}: malformed output")
        print(f"main path: AIS {name} {n} chains x {AIS_RUNGS} rungs: log Z {float(k.log_z):.5f} "
              f"(kernel) {float(lp.log_z):.5f} (generic loop) {truth:.5f} (exact); ESS "
              f"{float(k.ess):.1f} ({float(lp.ess):.1f}); acceptance "
              f"{float(k.acceptance_rate):.4f} ({float(lp.acceptance_rate):.4f}) | {card}")
        if abs(float(k.log_z) - truth) >= 0.02 or abs(float(lp.log_z) - truth) >= 0.02:
            raise AssertionError(f"AIS {name}: log Z off the truth by 0.02 or more")
        if abs(float(k.log_z) - float(lp.log_z)) > 0.03:
            raise AssertionError(f"AIS {name}: kernel and generic loop disagree")
    return launches


def path_step(ops, dev, card: str) -> dict:
    """``fused_langevin_step`` at the JAX self-test (4,096 x 32 double well,
    injected noise, against the eager update to 1e-6, ``fused_langevin.py:1617-1628``)
    and at 16M elements on the Philox stream (the normals it added have mean 0
    and variance 1 to 6 standard errors)."""
    import torch

    from torchebm_tpu_torch.core import DoubleWellEnergy

    g = torch.Generator(dev).manual_seed(120)
    x = torch.randn(DW_SHAPE, generator=g, device=dev)
    grad = DoubleWellEnergy().gradient(x)
    eps = torch.randn(DW_SHAPE, generator=g, device=dev)
    big_x = torch.randn(STEP_ELEMS, generator=g, device=dev)
    big_g = torch.randn(STEP_ELEMS, generator=g, device=dev)
    ops.reset_launch_counts()
    fused = ops.fused_langevin_step(x, grad, 0.01, 1.0, noise=eps)
    drawn = ops.fused_langevin_step(big_x, big_g, 0.01, 1.0, seed=7)
    launches = read_counts(ops, "one step", ["fused_langevin_step"])
    err = float((fused - (x - 0.01 * grad + math.sqrt(0.02) * eps)).abs().max())
    z = ((drawn - (big_x - 0.01 * big_g)) / math.sqrt(0.02)).double()
    mean, var = float(z.mean()), float(z.var())
    print(f"main path: fused_langevin_step {DW_SHAPE[0]}x{DW_SHAPE[1]} max|fused - eager| "
          f"{err:.3e}; {STEP_ELEMS} elements on the Philox stream: normals mean {mean:.2e} "
          f"variance {var:.5f} | {card}")
    if not err < 1e-6:
        raise AssertionError("fused_langevin_step disagrees with the eager update")
    se = 1.0 / math.sqrt(STEP_ELEMS)
    if abs(mean) > 6 * se or abs(var - 1.0) > 6 * math.sqrt(2.0) * se:
        raise AssertionError("fused_langevin_step's normals are not standard")
    return launches


def _mlp_layers(dev, widths, seed: int):
    """The layers of a random ``MLPEnergy(widths[0], widths[1:])`` on the card
    (flax's default init from ``seed``, biases drawn too so that the checks
    cover them), as the sampler hands them to the kernel."""
    import torch

    from torchebm_tpu_torch.models import MLPEnergy
    from torchebm_tpu_torch.ops.fused_mlp_langevin import extract_mlp_layers

    torch.manual_seed(seed)
    net = MLPEnergy(widths[0], widths[1:]).to(dev)
    with torch.no_grad():
        for layer in net.layers:
            layer.bias.normal_(0.0, 0.1)
    return extract_mlp_layers(net)


def _mlp_arrays(dev, widths, seed: int):
    """Layers of the JAX layout: ``(in, out)`` arrays (LeCun-scaled weights,
    small biases) made on the CPU from ``seed``, which the wrapper copies to
    ``nn.Linear``'s layout."""
    import torch

    g = torch.Generator().manual_seed(seed)
    dims = list(widths) + [1]
    return [((torch.randn((i, o), generator=g) * i ** -0.5).to(dev),
             (0.1 * torch.randn(o, generator=g)).to(dev)) for i, o in zip(dims[:-1], dims[1:])]


def phase_check_mlp(ops, dev, errors: dict) -> None:
    """The neural chain kernel against its plain version at MLP_CHECKS: the CD
    path's 256 x 2 on MLP(128, 128), 4,096 chains (the knee of the JAX
    package's batch study, BASELINE.md:256-258), d = 32 with three hidden
    layers (a tensor-core first layer), a clamp on a ragged last tile,
    (512, 512) and (256, 256), whose weights stream through shared memory,
    ragged widths and a narrow hidden layer between wide ones; each with
    ``extract_mlp_layers``' views of an MLPEnergy and with arrays of the JAX
    layout; CD_K steps at CD_STEP, on injected noise, on the Philox stream
    keyed by an int and by a device seed; then the DSM sampler's DSM_CHAINS
    chains for MLP_LONG_STEPS steps at DSM_SAMPLE_STEP, three windows or more
    of staged normals at every setting; at every (tile, warps, route) whose
    shared memory fits, the plan's own pick through the public wrapper (one
    counted launch each). Fails unless the checks cover every setting the
    plan can take. TOL holds: the kernel's 3xTF32 products drop the lo.lo
    term (2^-22 relative) and sum in another order than the plain version's
    FP32 matrix products, a rounding difference of about 1e-7 relative in
    each gradient, which enters the state times the step size; ten steps of
    a chain started in its basin do not grow it, and a hundred grow it to
    about 1e-6 (weights moved by 2e-7 relative, on the CPU)."""
    import torch

    mod = ops.fused_mlp_langevin
    kernel = mod.mlp_langevin_chain
    g = torch.Generator(dev).manual_seed(3579)
    smem_bytes, n_sms = mod._card_limits(dev)
    print(f"check: mlp_langevin_chain plans for {n_sms} SMs and {smem_bytes} bytes of shared "
          f"memory per block")
    settings = [mod.MlpPlan(*setting) for setting in mod.SETTINGS]
    checked = set()
    long_widths = (2, *CD_HIDDEN)
    windows = {plan: mod._smem_layout(long_widths, plan.tile, plan.warps, plan.resident).z_steps
               for plan in settings if mod.fits(long_widths, plan, dev)}
    if MLP_LONG_STEPS < 3 * max(windows.values()):
        raise AssertionError(f"MLP_LONG_STEPS covers fewer than three windows of {windows}")
    cases = [(n, widths, clamp, CD_K, CD_STEP) for n, widths, clamp in MLP_CHECKS]
    cases.append((DSM_CHAINS, long_widths, None, MLP_LONG_STEPS, DSM_SAMPLE_STEP))
    for i, (n, widths, clamp, n_steps, step_size) in enumerate(cases):
        d = widths[0]
        x0 = torch.randn((n, d), generator=g, device=dev)
        noise = torch.randn((n_steps, n, d), generator=g, device=dev)
        pick = mod.launch_plan(n, widths, dev)
        for layout, layers in (("views", _mlp_layers(dev, widths, 40 + i)),
                               ("jax", _mlp_arrays(dev, widths, 40 + i))):
            for plan in settings:
                if not mod.fits(widths, plan, dev):
                    continue
                errs = []
                for label, kw in (("injected", dict(seed=50 + i, noise=noise)),
                                  ("philox", dict(seed=50 + i)),
                                  ("device seed", dict(seed=torch.tensor(50 + i, device=dev)))):
                    if plan == pick:
                        before = kernel.launches
                        got = kernel(x0, layers, n_steps, step_size, 1.0, clamp=clamp, **kw)
                        if kernel.launches != before + 1:
                            raise AssertionError("mlp_langevin_chain did not launch its kernel")
                    else:
                        got = mod._launch(x0, layers, list(widths), n_steps, step_size, 1.0,
                                          kw["seed"], clamp, kw.get("noise"), plan)
                    torch.cuda.synchronize()
                    err = max_err(got, mod.mlp_langevin_chain_plain(
                        x0, layers, n_steps, step_size, 1.0, clamp=clamp, **kw))
                    errors["mlp_langevin_chain"] = max(errors.get("mlp_langevin_chain", 0.0), err)
                    errs.append(f"{label} {err:.3e}")
                    if not err <= TOL:
                        raise AssertionError(f"mlp_langevin_chain disagrees with its plain "
                                             f"version at {plan}: {err}")
                checked.add(plan)
                print(f"check: mlp_langevin_chain [{n}x{d}, hidden {widths[1:]}, clamp {clamp}, "
                      f"{n_steps} steps at {step_size:g}, {layout} weights; tile {plan.tile}, "
                      f"{plan.warps} warps, windows of "
                      f"{mod._smem_layout(widths, plan.tile, plan.warps, plan.resident).z_steps} "
                      f"steps, weights "
                      f"{'resident' if plan.resident else 'streamed'}"
                      f"{', the plan' if plan == pick else ''}] max|kernel - plain| = "
                      f"{', '.join(errs)} (tol {TOL:g})")
    if set(settings) - checked:
        raise AssertionError(f"the neural chain's checks miss {sorted(set(settings) - checked)}")


def _cd_trainer(dev, step_size: float, k_steps: int, lr: float, fused_neural: str, seed: int,
                **cd_kw):
    """``(trainer, net, energy)``: a ContrastiveDivergenceTrainer over a fresh
    MLPEnergy(2, CD_HIDDEN) on the card, its weights from ``seed``."""
    import torch

    from torchebm_tpu_torch.core import as_energy
    from torchebm_tpu_torch.core.trainer import ContrastiveDivergenceTrainer
    from torchebm_tpu_torch.losses import ContrastiveDivergence
    from torchebm_tpu_torch.models import MLPEnergy
    from torchebm_tpu_torch.samplers import LangevinDynamics

    torch.manual_seed(seed)
    net = MLPEnergy(2, CD_HIDDEN).to(dev)
    energy = as_energy(net)
    sampler = LangevinDynamics(energy, step_size=step_size, fused_neural=fused_neural)
    cd = ContrastiveDivergence(model=energy, sampler=sampler, k_steps=k_steps, **cd_kw)
    return ContrastiveDivergenceTrainer(cd, learning_rate=lr), net, energy


def _cd_batches(dev, g, n_steps: int, seed: int) -> list:
    """``n_steps`` shuffled batches of CD_BATCH from an EightGaussiansDataset
    on the card (epochs of 100 batches)."""
    from torchebm_tpu_torch.datasets import EightGaussiansDataset

    data = EightGaussiansDataset(n_samples=100 * CD_BATCH, seed=seed, device=dev)
    batches = []
    while len(batches) < n_steps:
        batches.extend(data.batches(g, CD_BATCH))
    return batches[:n_steps]


def _cd_run(dev, fused_neural: str, n_steps: int, noise_seed: int = CD_NOISE_SEEDS[0]):
    """Config 3 for ``n_steps`` train steps, from the same weights and
    batches whatever ``noise_seed``, which seeds the chains' draws: ``(state,
    mean metrics, ms per step)``, the host clock around the epoch, first step
    included."""
    import torch

    trainer, net, _ = _cd_trainer(dev, CD_STEP, CD_K, CD_LR, fused_neural, seed=0)
    batches = _cd_batches(dev, torch.Generator(dev).manual_seed(0), n_steps, seed=0)
    g = torch.Generator(dev).manual_seed(noise_seed)
    state = trainer.init_state(net, g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = trainer.train_epoch(state, batches)
    torch.cuda.synchronize()
    return state, metrics, (time.perf_counter() - t0) * 1e3 / n_steps


def _quality_gate(ops, dev, fused_neural: str, card: str) -> None:
    """The JAX e2e gate on the recipe of QG_*: after training, the mean
    energy of two-moons data lies below that of uniform points on [-3, 3]^2
    by more than 0.5. With the kernel, one launch per train step."""
    import torch

    from torchebm_tpu_torch.datasets import make_two_moons

    trainer, net, energy = _cd_trainer(dev, QG_STEP, QG_K, QG_LR, fused_neural, seed=7)
    g = torch.Generator(dev).manual_seed(8)
    state = trainer.init_state(net, g)
    ops.reset_launch_counts()
    for _ in range(QG_STEPS):
        state, _ = trainer.train_step(state, make_two_moons(g, CD_BATCH))
    launches = ops.launch_counts()["mlp_langevin_chain"]
    with torch.no_grad():
        e_data = float(energy(make_two_moons(g, 512)).mean())
        e_off = float(energy(torch.rand((512, 2), generator=g, device=dev) * 6 - 3).mean())
    print(f"main path: CD quality gate, fused_neural={fused_neural!r}: two moons, MLP{CD_HIDDEN}, "
          f"step {QG_STEP}, CD-{QG_K}, Adam {QG_LR}, {QG_STEPS} steps: mean energy on data "
          f"{e_data:.4f}, on uniform off-manifold points {e_off:.4f} (gate: data < off - 0.5); "
          f"mlp_langevin_chain launches {launches} | {card}")
    if launches != (QG_STEPS if fused_neural == "auto" else 0):
        raise AssertionError(f"quality gate: {launches} neural chain launches")
    if not e_data < e_off - 0.5:
        raise AssertionError(f"CD quality gate failed ({fused_neural}): {e_data} vs {e_off}")


def path_cd(ops, dev, card: str) -> dict:
    """CD/PCD training (BASELINE config 3) through the trainer: CD_STEPS train
    steps with ``fused_neural="auto"``, exactly one neural chain launch per
    step, and the same run with ``"off"``, none; both once more per seed of
    CD_NOISE_SEEDS, and the kernel's last-epoch energies held to the loop's;
    the quality gate through the kernel and through the loop; PCD with a
    PCD_BUFFER buffer warmed up by the kernel (one launch per chunk), then
    PCD_STEPS train steps."""
    import torch

    ops.reset_launch_counts()
    state, metrics, ms = _cd_run(dev, "auto", CD_STEPS)
    launches = read_counts(ops, "CD, config 3", ["mlp_langevin_chain"])
    if launches["mlp_langevin_chain"] != CD_STEPS:
        raise AssertionError(f"{launches['mlp_langevin_chain']} neural chain launches in "
                             f"{CD_STEPS} CD steps, expected one per step")
    ops.reset_launch_counts()
    loop_runs = [_cd_run(dev, "off", CD_STEPS, s)[1:] for s in CD_NOISE_SEEDS]
    off = ops.launch_counts()["mlp_langevin_chain"]
    metrics_off, ms_off = loop_runs[0]
    kernel_runs = [(metrics, ms)] + [_cd_run(dev, "auto", CD_STEPS, s)[1:]
                                     for s in CD_NOISE_SEEDS[1:]]
    print(f"main path: CD config 3 (MLP{CD_HIDDEN}, batch {CD_BATCH}, CD-{CD_K} at step "
          f"{CD_STEP}, Adam {CD_LR}, 8 Gaussians), {CD_STEPS} steps: {ms:.3f} ms per train step "
          f"with the kernel (launches {launches['mlp_langevin_chain']}), {ms_off:.3f} ms on the "
          f"generic loop (launches {off}), first step included; last-epoch means kernel "
          f"{metrics}, loop {metrics_off} | {card}")
    if off != 0:
        raise AssertionError("fused_neural='off' launched the neural chain kernel")
    for m, _ in (*kernel_runs, *loop_runs):
        if not all(torch.isfinite(torch.tensor(v)) for v in m.values()):
            raise AssertionError(f"CD metrics are not finite: {m}")
    for key in ("pos_energy", "neg_energy"):
        kern, loop = (torch.tensor([m[key] for m, _ in runs], dtype=torch.float64)
                      for runs in (kernel_runs, loop_runs))
        gap = float(kern.mean() - loop.mean())
        se = math.sqrt(float(kern.var()) / len(kern) + float(loop.var()) / len(loop))
        print(f"main path: CD config 3, last-epoch mean {key} over {len(CD_NOISE_SEEDS)} seeds of "
              f"the chains' draws: kernel {float(kern.mean()):.6f} (sd {float(kern.std()):.6f}, "
              f"range {float(kern.min()):.6f}..{float(kern.max()):.6f}), loop "
              f"{float(loop.mean()):.6f} (sd {float(loop.std()):.6f}, range "
              f"{float(loop.min()):.6f}..{float(loop.max()):.6f}); kernel - loop {gap:.6f} = "
              f"{gap / se:.2f} standard errors (bound {CD_SIGMAS:g}) | {card}")
        if not abs(gap) <= CD_SIGMAS * se:
            raise AssertionError(f"CD through the kernel drifts from the loop in {key}: "
                                 f"{gap} at a standard error of {se}")
    if not all(torch.isfinite(p).all() for p in state.model.parameters()):
        raise AssertionError("CD parameters are not finite")

    for mode in ("auto", "off"):
        _quality_gate(ops, dev, mode, card)

    trainer, net, _ = _cd_trainer(dev, CD_STEP, CD_K, CD_LR, "auto", seed=9, persistent=True,
                                  buffer_size=PCD_BUFFER, init_steps=PCD_INIT_STEPS)
    g = torch.Generator(dev).manual_seed(10)
    batches = _cd_batches(dev, g, PCD_STEPS, seed=9)
    ops.reset_launch_counts()
    buf = trainer.loss_fn.init_buffer(g, (2,), chunk_size=PCD_CHUNK)
    warm = ops.launch_counts()["mlp_langevin_chain"]
    state = trainer.init_state(net, g, loss_state=buf)
    for b in batches:
        state, m = trainer.train_step(state, b)
    pcd = read_counts(ops, "PCD", ["mlp_langevin_chain"])["mlp_langevin_chain"]
    chunks = -(-PCD_BUFFER // PCD_CHUNK)
    samples = state.loss_state.samples
    print(f"main path: PCD buffer {PCD_BUFFER} warmed {PCD_INIT_STEPS} steps in {chunks} chunks: "
          f"{warm} neural chain launches; then {PCD_STEPS} train steps: {pcd - warm} launches; "
          f"buffer pointer {state.loss_state.ptr}, mean radius {float(samples.norm(dim=-1).mean()):.4f}, "
          f"loss {float(m['loss']):.5f} | {card}")
    if warm != chunks or pcd != chunks + PCD_STEPS:
        raise AssertionError("PCD did not take one neural chain launch per chunk and step")
    if state.loss_state.ptr != PCD_STEPS * CD_BATCH % PCD_BUFFER or not torch.isfinite(samples).all():
        raise AssertionError("PCD buffer is malformed")
    return launches


def _pair_cost(g, dev, n: int, m: int):
    """A max-normalised squared-distance matrix between ``n`` standard normal
    points and ``m`` shifted ones in 2-D, as the JAX package's parity tests
    build theirs."""
    import torch

    x0 = torch.randn((n, 2), generator=g, device=dev)
    x1 = torch.randn((m, 2), generator=g, device=dev) + 1.0
    cost = torch.sum((x0[:, None, :] - x1[None, :, :]) ** 2, dim=-1)
    return (cost / cost.max()).contiguous()


def phase_check_sinkhorn(ops, dev, errors: dict) -> None:
    """The Sinkhorn kernel against its plain version at SINKHORN_CHECKS and on
    the cost matrix ``compute_cost`` gives the flow path's batch, through the
    public wrapper (the launch plan's cluster) and at every cluster size the
    kernel takes (``BLOCK_SIZES`` up to one block per row): the same number
    of iterations, every entry of the log plan within TOL, and for a gated
    balanced plan row and column sums within MARGINAL_RTOL of 1/n and 1/m.
    TOL holds: the kernel sums a row's exponentials across lanes and a
    column's across bands, in base 2, the plain version in ``logsumexp``'s
    order, a rounding difference of about 1e-7 relative in each potential,
    of order 20 at these ``reg``; the fixed point contracts, so it does not
    grow over the iterations (the entries of the log plan lie above -45
    here). Also prints whether the card can hold the flow path's 16-block
    cluster (``cudaOccupancyMaxActiveClusters``)."""
    import torch

    from torchebm_tpu_torch.couplings import SinkhornCoupling

    mod = ops.fused_sinkhorn
    kernel = mod.sinkhorn_log_fused
    main_plan = mod.launch_plan(FLOW_BATCH, FLOW_BATCH)
    print(f"check: sinkhorn_log_fused plan at {FLOW_BATCH}x{FLOW_BATCH}: {main_plan}; the card "
          f"holds {mod.max_active_clusters(main_plan, dev)} such clusters at once")
    g = torch.Generator(dev).manual_seed(2468)
    x0 = torch.randn((FLOW_BATCH, 2), generator=g, device=dev)
    x1 = torch.randn((FLOW_BATCH, 2), generator=g, device=dev) + torch.tensor([2.0, 0.0],
                                                                              device=dev)
    flow_cost = SinkhornCoupling().compute_cost(x0, x1).contiguous()
    cases = [(_pair_cost(g, dev, *shape), "pair cost", reg, iters, tol, phi)
             for shape, reg, iters, tol, phi in SINKHORN_CHECKS]
    cases += [(flow_cost, "compute_cost of the flow batch", FLOW_REG, FLOW_ITERS, tol, 1.0)
              for tol in (0.0, FLOW_TOL)]
    for cost, label, reg, iters, tol, phi in cases:
        n, m = cost.shape
        want, p_iters = mod.sinkhorn_log_plain(cost, reg, iters, tol, phi, return_iters=True)
        before = kernel.launches
        runs = {"plan": kernel(cost, reg, iters, tol, phi, return_iters=True)}
        if kernel.launches != before + 1:
            raise AssertionError("sinkhorn_log_fused did not launch its kernel")
        for blocks in mod.BLOCK_SIZES:
            if blocks <= n:
                runs[blocks] = mod._run(cost, reg, iters, tol, phi, blocks=blocks)
        torch.cuda.synchronize()
        plan = mod.launch_plan(n, m)
        found = []
        for blocks, (got, k_iters) in runs.items():
            err = max_err(got, want)
            errors["sinkhorn_log_fused"] = max(errors.get("sinkhorn_log_fused", 0.0), err)
            rows = float((torch.exp(got).sum(1) * n - 1.0).abs().max())
            cols = float((torch.exp(got).sum(0) * m - 1.0).abs().max())
            found.append(f"{blocks}: {int(k_iters)} it, {err:.2e}, marginals {rows:.1e} / "
                         f"{cols:.1e}")
            where = f"sinkhorn_log_fused [{n}x{m}, {blocks} blocks]"
            if int(k_iters) != int(p_iters):
                raise AssertionError(f"{where} ran {int(k_iters)} iterations, its plain version "
                                     f"{int(p_iters)}")
            if not err <= TOL:
                raise AssertionError(f"{where} disagrees with its plain version: {err}")
            if tol > 0.0 and phi == 1.0:
                if not int(k_iters) < iters:
                    raise AssertionError(f"{where} did not converge in {iters}")
                if not max(rows, cols) <= MARGINAL_RTOL:
                    raise AssertionError(f"{where}: the gated plan's marginals are off by {rows} "
                                         f"(rows), {cols} (columns)")
        print(f"check: sinkhorn_log_fused [{n}x{m} {label}, reg {reg}, cap {iters}, tol {tol:g}, "
              f"damping {phi:.4f}; plan {plan.blocks} blocks, M "
              f"{'in shared memory' if plan.resident else 'in L2'}, exchange through "
              f"{'shared memory' if plan.pairs_smem else 'L2'}] plain {int(p_iters)} iterations, "
              f"lowest entry {float(want.min()):.1f}; by cluster (iterations, max|kernel - "
              f"plain| (tol {TOL:g}), row / column marginals): {'; '.join(found)}")


def _flow_trainer(dev, seed: int, coupling, lr: float = FLOW_LR):
    """``(trainer, net, loss)``: a BaseTrainer with Adam around the EqM loss of
    a fresh MLPVelocityField(2, FLOW_HIDDEN) on the card, its weights from
    ``seed``."""
    import torch

    from torchebm_tpu_torch.core.trainer import BaseTrainer
    from torchebm_tpu_torch.interpolants import LinearInterpolant
    from torchebm_tpu_torch.losses import EquilibriumMatchingLoss
    from torchebm_tpu_torch.models import MLPVelocityField

    torch.manual_seed(seed)
    net = MLPVelocityField(2, FLOW_HIDDEN).to(dev)
    loss = EquilibriumMatchingLoss(model=net, interpolant=LinearInterpolant(), coupling=coupling)
    return BaseTrainer(loss, functools.partial(torch.optim.Adam, lr=lr)), net, loss


def _config5_coupling(fused: str):
    from torchebm_tpu_torch.couplings import SinkhornCoupling

    return SinkhornCoupling(n_iters=FLOW_ITERS, reg=FLOW_REG, fused=fused)


def _flow_batch(dev):
    """Config 5's one batch: FLOW_BATCH draws of N((2, 0), I), from seed 0."""
    import torch

    g = torch.Generator(dev).manual_seed(0)
    return torch.randn((FLOW_BATCH, 2), generator=g, device=dev) + torch.tensor([2.0, 0.0],
                                                                                device=dev)


def _flow_run(dev, fused: str, n_steps: int, seed: int):
    """Config 5 for ``n_steps`` train steps from ``seed`` (weights and draws):
    ``(net, mean loss of the last FLOW_TAIL steps, ms per step)``, the host
    clock around the run, first step included."""
    import torch

    trainer, net, _ = _flow_trainer(dev, seed, _config5_coupling(fused))
    state = trainer.init_state(net, torch.Generator(dev).manual_seed(seed))
    data = _flow_batch(dev)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, metrics = trainer.train_step(state, data)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n_steps
    return net, float(torch.stack(losses[-FLOW_TAIL:]).mean()), ms


def _energy_distance(x, y) -> float:
    """E-statistic 2 E|X-Y| - E|X-X'| - E|Y-Y'| (0 iff the laws agree)."""
    import torch

    def mean_pdist(a, b):
        return torch.cdist(a, b).mean()

    return float(2 * mean_pdist(x, y) - mean_pdist(x, x) - mean_pdist(y, y))


def _flow_quality_gate(ops, dev, fused: str, card: str) -> None:
    """The JAX e2e gate on the recipe of FQ_*: after training, the energy
    distance of generated samples to fresh 8-Gaussians data lies below 0.3 of
    the N(0, I) prior's, through FlowSampler on the field and through Langevin
    on its EqMEnergy, and every mode holds more than 10 of the Langevin
    samples. With the kernel, one Sinkhorn launch per train step."""
    import torch

    from torchebm_tpu_torch.couplings import get_coupling
    from torchebm_tpu_torch.datasets import make_8gaussians
    from torchebm_tpu_torch.models import EqMEnergy
    from torchebm_tpu_torch.samplers import FlowSampler, LangevinDynamics

    trainer, net, loss = _flow_trainer(dev, 21, get_coupling("sinkhorn", fused=fused), lr=FQ_LR)
    g = torch.Generator(dev).manual_seed(22)
    state = trainer.init_state(net, g)
    ops.reset_launch_counts()
    for _ in range(FQ_STEPS):
        state, _ = trainer.train_step(state, make_8gaussians(g, FQ_BATCH))
    launches = ops.launch_counts()["sinkhorn_log_fused"]
    data = make_8gaussians(g, FQ_SAMPLES)
    prior = torch.randn((FQ_SAMPLES, 2), generator=g, device=dev)
    ed_prior = _energy_distance(prior, data)
    flow = FlowSampler(model=net, negate_velocity=True, integrator="euler")
    gen_field = flow.sample(g, dim=2, n_samples=FQ_SAMPLES, n_steps=FQ_GEN_STEPS)
    ed_field = _energy_distance(gen_field, data)
    lang = LangevinDynamics(EqMEnergy.from_loss(loss), step_size=0.01, noise_scale=0.3)
    gen_mcmc = lang.sample(g, x=gen_field, n_steps=FQ_MCMC_STEPS)
    ed_mcmc = _energy_distance(gen_mcmc, data)
    ang = torch.arange(8, device=dev) * (2 * math.pi / 8)
    centers = 2.0 * torch.stack([torch.cos(ang), torch.sin(ang)], -1)
    counts = torch.bincount(torch.cdist(gen_mcmc, centers).argmin(1), minlength=8).tolist()
    print(f"main path: EqM quality gate, fused={fused!r}: 8 Gaussians, MLPVelocityField"
          f"{FLOW_HIDDEN}, batch {FQ_BATCH}, Adam {FQ_LR}, {FQ_STEPS} steps, coupling 'sinkhorn': "
          f"energy distance to data: prior {ed_prior:.4f}, FlowSampler {ed_field:.4f}, EqMEnergy + "
          f"Langevin {ed_mcmc:.4f} (gate: below {0.3 * ed_prior:.4f}); samples per mode {counts} "
          f"(gate: each above 10); sinkhorn_log_fused launches {launches} | {card}")
    if launches != (FQ_STEPS if fused == "auto" else 0):
        raise AssertionError(f"EqM quality gate: {launches} Sinkhorn kernel launches")
    if not (ed_field < 0.3 * ed_prior and ed_mcmc < 0.3 * ed_prior):
        raise AssertionError(f"EqM quality gate failed ({fused}): {ed_field}, {ed_mcmc} against "
                             f"{ed_prior}")
    if not min(counts) > 10:
        raise AssertionError(f"EqM quality gate ({fused}): a mode is missing: {counts}")


def path_flow(ops, dev, card: str) -> dict:
    """EqM training and generation (BASELINE config 5) through the trainer and
    FlowSampler: FLOW_STEPS train steps with the coupling's ``fused="auto"``,
    exactly one Sinkhorn kernel launch per step, and the same with ``"off"``,
    none; the kernel once per seed of FLOW_SEEDS, the loop once per seed of
    FLOW_LOOP_SEEDS, and the kernel's tail losses held to the loop's; Euler
    and dopri5 generation from the trained field; the quality gate through
    the kernel and through the loop."""
    import torch

    from torchebm_tpu_torch.samplers import FlowSampler

    ops.reset_launch_counts()
    net, loss0, ms = _flow_run(dev, "auto", FLOW_STEPS, FLOW_SEEDS[0])
    launches = read_counts(ops, "EqM, config 5", ["sinkhorn_log_fused"])
    if launches["sinkhorn_log_fused"] != FLOW_STEPS:
        raise AssertionError(f"{launches['sinkhorn_log_fused']} Sinkhorn kernel launches in "
                             f"{FLOW_STEPS} EqM steps, expected one per step")
    g = torch.Generator(dev).manual_seed(31)
    flow = FlowSampler(model=net, integrator="euler", negate_velocity=True)
    gen = flow.sample(g, dim=2, n_samples=GEN_SAMPLES, n_steps=GEN_STEPS)
    gen5, diag5 = FlowSampler(model=net, negate_velocity=True).sample(
        g, dim=2, n_samples=GEN_SAMPLES, n_steps=GEN_STEPS, return_diagnostics=True)
    for name, out in (("euler", gen), ("dopri5", gen5)):
        if tuple(out.shape) != (GEN_SAMPLES, 2) or not torch.isfinite(out).all():
            raise AssertionError(f"FlowSampler({name}) output is malformed")
    gap = float((gen.mean(0) - gen5.mean(0)).norm())
    print(f"main path: FlowSampler generation {GEN_SAMPLES} x {GEN_STEPS} steps from the trained "
          f"field: euler mean {[round(v, 4) for v in gen.mean(0).tolist()]}, dopri5 mean "
          f"{[round(v, 4) for v in diag5['mean'][0].tolist()]} (apart by {gap:.4f}, gate 0.2; the "
          f"data's mean is (2, 0)) | {card}")
    if not gap < 0.2:
        raise AssertionError(f"euler and dopri5 generation disagree in the mean by {gap}")

    ops.reset_launch_counts()
    loop_runs = [_flow_run(dev, "off", FLOW_STEPS, s)[1:] for s in FLOW_LOOP_SEEDS]
    off = ops.launch_counts()["sinkhorn_log_fused"]
    kernel_runs = [(loss0, ms)] + [_flow_run(dev, "auto", FLOW_STEPS, s)[1:]
                                   for s in FLOW_SEEDS[1:]]
    if off != 0:
        raise AssertionError("fused='off' launched the Sinkhorn kernel")
    kern, loop = (torch.tensor([r[0] for r in runs], dtype=torch.float64)
                  for runs in (kernel_runs, loop_runs))
    if not (torch.isfinite(kern).all() and torch.isfinite(loop).all()):
        raise AssertionError("EqM losses are not finite")
    diff = float(kern.mean() - loop.mean())
    se = math.sqrt(float(kern.var()) / len(kern) + float(loop.var()) / len(loop))
    print(f"main path: EqM config 5 (MLPVelocityField{FLOW_HIDDEN}, batch {FLOW_BATCH}, Sinkhorn "
          f"reg {FLOW_REG} cap {FLOW_ITERS} tol {FLOW_TOL:g}, Adam {FLOW_LR}), {FLOW_STEPS} steps: "
          f"{ms:.3f} ms per train step with the kernel (launches "
          f"{launches['sinkhorn_log_fused']}), {loop_runs[0][1]:.3f} ms on the loop (launches "
          f"{off}), first step included; mean loss of the last {FLOW_TAIL} steps over "
          f"{len(FLOW_SEEDS)} seeds each way (the loop's disjoint from the kernel's): kernel "
          f"{float(kern.mean()):.5f} (sd {float(kern.std()):.5f}), "
          f"loop {float(loop.mean()):.5f} (sd {float(loop.std()):.5f}); kernel - loop {diff:.5f} = "
          f"{diff / max(se, 1e-12):.2f} standard errors (bound {CD_SIGMAS:g}) | {card}")
    if not abs(diff) <= CD_SIGMAS * se:
        raise AssertionError(f"EqM through the kernel drifts from the loop: {diff} at a standard "
                             f"error of {se}")

    for mode in ("auto", "off"):
        _flow_quality_gate(ops, dev, mode, card)
    return launches



# ------------------------------------------------------------- the DiT family


def _release() -> None:
    """Free what the card's caching allocator holds of dropped tensors."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _dit(dev, dtype_name: str, seed: int):
    """A fresh DiT_KW DiT computing in ``dtype_name``, its weights initialised
    on the card from ``seed``."""
    import torch

    from torchebm_tpu_torch.models import ConditionalTransformer2D

    torch.manual_seed(seed)
    with torch.device(dev):
        return ConditionalTransformer2D(**DIT_KW, dtype=getattr(torch, dtype_name))


def _dit_train_step(dev, dtype_name: str, seed: int):
    """``(step, model, x, cond)``: the JAX headline's flow-matching train step
    of a fresh DiT: random x and cond from a seeded generator, a fresh normal
    target per step, the MSE, AdamW; ``step()`` returns the loss."""
    import torch

    model = _dit(dev, dtype_name, seed)
    g = torch.Generator(dev).manual_seed(seed)
    size = DIT_KW["input_size"]
    x = torch.randn((DIT_BATCH, DIT_KW["in_channels"], size, size), generator=g, device=dev)
    cond = torch.randn((DIT_BATCH, DIT_KW["cond_dim"]), generator=g, device=dev)
    opt = torch.optim.AdamW(model.parameters(), lr=DIT_LR, weight_decay=DIT_DECAY)

    def step():
        target = torch.randn(x.shape, generator=g, device=dev)
        loss = torch.mean(torch.square(model(x, cond) - target))
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    return step, model, x, cond


def _counted_flops(fn) -> int:
    """The floating-point operations of one call of ``fn()`` that
    ``torch.utils.flop_counter`` counts from the shapes the call runs: its
    matrix products and attention, forward and backward."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _rel(got, want) -> float:
    """The largest difference over the largest reference entry."""
    return float((got - want).abs().max() / want.abs().max())


def _flax_dit_tree(rng) -> dict:
    """A flax-shaped DIT_KW parameter tree (the JAX package's layout), every
    leaf N(0, 0.02^2) from the numpy generator ``rng``."""
    import numpy as np

    d, cd, p2 = DIT_KW["embed_dim"], DIT_KW["cond_dim"], DIT_KW["patch_size"] ** 2

    def dense(n_in, n_out):
        return {"kernel": 0.02 * rng.standard_normal((n_in, n_out), dtype=np.float32),
                "bias": 0.02 * rng.standard_normal(n_out, dtype=np.float32)}

    tree = {"ConvPatchEmbed2d_0": {"proj": dense(DIT_KW["in_channels"] * p2, d)},
            "head": {"modulation": dense(cd, 2 * d), "proj": dense(d, p2 * DIT_KW["out_channels"])}}
    for i in range(DIT_KW["depth"]):
        tree[f"block_{i}"] = {
            "modulation": dense(cd, 6 * d),
            "MultiheadSelfAttention_0": {"qkv": dense(d, 3 * d), "out_proj": dense(d, d)},
            "FeedForward_0": {"Dense_0": dense(d, 4 * d), "Dense_1": dense(4 * d, d)},
        }
    return {"params": tree}


def _dit_parity(dev, card: str) -> None:
    """The card against the CPU port on one flax-shaped set of random weights
    converted by ``conditional_transformer_2d_from_flax``, at PARITY_BATCH:
    the f32 forward, the flow-matching loss's parameter gradients, those of
    a second-order loss (through the attention's differentiable backward),
    and bf16 against f32 on the card."""
    import numpy as np
    import torch

    from torchebm_tpu_torch.utils import conditional_transformer_2d_from_flax

    rng = np.random.default_rng(71)
    tree = _flax_dit_tree(rng)
    size = DIT_KW["input_size"]
    x = rng.standard_normal((PARITY_BATCH, DIT_KW["in_channels"], size, size), dtype=np.float32)
    cond = rng.standard_normal((PARITY_BATCH, DIT_KW["cond_dim"]), dtype=np.float32)
    target = rng.standard_normal((PARITY_BATCH, DIT_KW["out_channels"], size, size),
                                 dtype=np.float32)
    kw = dict(num_heads=DIT_KW["num_heads"], input_size=size, patch_size=DIT_KW["patch_size"])
    runs = []
    for where in (torch.device("cpu"), dev):
        net = conditional_transformer_2d_from_flax(tree, device=where, **kw)
        xx, cc, tt = (torch.from_numpy(a).to(where) for a in (x, cond, target))
        out = net(xx, cc)
        torch.mean(torch.square(out - tt)).backward()
        first = {n: p.grad.cpu() for n, p in net.named_parameters()}
        net.zero_grad()  # new grad tensors: on the CPU, first holds the old ones
        x2 = xx[:SECOND_ORDER_BATCH].clone().requires_grad_()
        (gx,) = torch.autograd.grad(torch.sum(x2 * net(x2, cc[:SECOND_ORDER_BATCH])), x2,
                                    create_graph=True)
        torch.mean(torch.square(gx)).backward()
        runs.append((out.detach().cpu(), first,
                     {n: p.grad.cpu() for n, p in net.named_parameters() if p.grad is not None}))
    (cpu_out, cpu_grads, cpu_second), (card_out, card_grads, card_second) = runs
    fwd = _rel(card_out, cpu_out)
    grads = {n: _rel(card_grads[n], cpu_grads[n]) for n in cpu_grads}
    worst = max(grads, key=grads.get)
    second = {n: _rel(card_second[n], cpu_second[n]) for n in cpu_second
              if cpu_second[n].abs().max() > 0}
    worst2 = max(second, key=second.get)
    bf16 = conditional_transformer_2d_from_flax(tree, device=dev, dtype=torch.bfloat16, **kw)
    with torch.no_grad():
        bf16_out = bf16(torch.from_numpy(x).to(dev), torch.from_numpy(cond).to(dev)).cpu()
    bf = _rel(bf16_out, card_out)
    print(f"check: DiT-768x12 on converted flax weights (every leaf N(0, 0.02^2)), batch "
          f"{PARITY_BATCH}: the card's f32 forward against the CPU port's {fwd:.3e} relative "
          f"(gate {PARITY_FWD_RTOL:g}); the flow-matching loss's parameter gradients, worst of "
          f"{len(grads)} tensors {grads[worst]:.3e} ({worst}; gate {PARITY_GRAD_RTOL:g}); the "
          f"parameter gradients of the mean square of EqM's dot-energy input gradient (a "
          f"second-order derivative, batch {SECOND_ORDER_BATCH}), worst of {len(second)} "
          f"{second[worst2]:.3e} ({worst2}; gate {PARITY_GRAD_RTOL:g}); bf16 "
          f"against f32 on the card {bf:.3e} (gate {BF16_FLOOR:g} to {BF16_RTOL:g}); output max |.| "
          f"{float(cpu_out.abs().max()):.4f} | {card}")
    if not (torch.isfinite(card_out).all() and torch.isfinite(bf16_out).all()):
        raise AssertionError("the DiT's output on the card is not finite")
    if not fwd <= PARITY_FWD_RTOL:
        raise AssertionError(f"the DiT forward on the card differs from the CPU port's: {fwd}")
    if not grads[worst] <= PARITY_GRAD_RTOL:
        raise AssertionError(f"the DiT gradient {worst} differs from the CPU port's: "
                             f"{grads[worst]}")
    if not second[worst2] <= PARITY_GRAD_RTOL:
        raise AssertionError(f"the DiT's second-order gradient {worst2} differs from the CPU "
                             f"port's: {second[worst2]}")
    if not BF16_FLOOR <= bf <= BF16_RTOL:
        raise AssertionError(f"the bf16 DiT differs from the f32 one by {bf}, outside "
                             f"[{BF16_FLOOR}, {BF16_RTOL}]")


def path_dit(ops, dev, card: str) -> dict:
    """The JAX headline's DiT train step (``benchmarks/headline.py:547-606``)
    in float32, then bfloat16 (the first model released before the second):
    ms per step, peak memory, counted FLOPs and their share of the card's
    dense peak; the adaLN kernels' launches in one more train step and
    forward (DIT_ADALN_STEP, DIT_ADALN_FORWARD); then the card against the
    CPU port."""
    import torch

    launches = dict.fromkeys(ops.launch_counts(), 0)
    for dtype_name in ("float32", "bfloat16"):
        _release()
        torch.cuda.reset_peak_memory_stats()
        step, model, x, cond = _dit_train_step(dev, dtype_name, seed=61)
        ms = statistics.median(cuda_times(step, DIT_WARMUP, DIT_STEPS))
        peak = torch.cuda.max_memory_allocated()
        train = _counted_flops(step)
        with torch.no_grad():
            fwd = _counted_flops(lambda: model(x, cond))
            out = model(x, cond)
        loss = float(step())
        ops.reset_launch_counts()
        step()
        with torch.no_grad():
            model(x, cond)
        counts = read_counts(ops, f"DiT {dtype_name}", list(ADALN_KERNELS))
        adaln = {k: counts[k] for k in ADALN_KERNELS}
        want = {k: DIT_ADALN_STEP[k] + DIT_ADALN_FORWARD[k] for k in ADALN_KERNELS}
        if adaln != want:
            raise AssertionError(f"DiT {dtype_name}: adaLN launches {adaln} in a train step and "
                                 f"a forward, expected {want}")
        for name, n in counts.items():
            launches[name] += n
        rate = train / (ms * 1e-3)
        precision = (f"; float32 matmul precision {torch.get_float32_matmul_precision()!r}"
                     if dtype_name == "float32" else "")
        print(f"main path: DiT-768x12 flow-matching train step, {dtype_name} compute over "
              f"float32 parameters (batch {DIT_BATCH}, 1x32x32, patch 4, AdamW {DIT_LR}): "
              f"{ms:.3f} ms per step (CUDA events, median of {DIT_STEPS} after {DIT_WARMUP}); "
              f"peak memory {peak / 2**30:.3f} GiB (max_memory_allocated); counted "
              f"{fwd / 1e12:.4f} TFLOP per forward, {train / 1e12:.4f} per train step "
              f"(torch.utils.flop_counter): {rate / 1e12:.2f} TFLOP/s, "
              f"{rate / DIT_PEAK_FLOPS[dtype_name]:.3f} of the dense {dtype_name} peak "
              f"{DIT_PEAK_FLOPS[dtype_name] / 1e12:g} TFLOP/s{precision}; loss {loss:.5f}; adaLN "
              f"launches in a train step and a forward {adaln} | {card}")
        if tuple(out.shape) != tuple(x.shape) or out.dtype != torch.float32:
            raise AssertionError(f"DiT output {tuple(out.shape)} {out.dtype}")
        if not math.isfinite(loss):
            raise AssertionError(f"the DiT train step's loss is not finite: {loss}")
        del step, model, x, cond, out
    _release()
    _dit_parity(dev, card)
    _release()
    return launches


def _moons_images(dev, n: int, seed: int, size: int = DIT_KW["input_size"]):
    """``n`` structured 1 x ``size`` x ``size`` images in [-1, 1]: each a blob
    (standard deviation 1.5 pixels) at a two-moons point mapped onto the
    central 3/4 of the pixels (24 x 24 of 32 x 32)."""
    import torch

    from torchebm_tpu_torch.datasets import make_two_moons

    pts = make_two_moons(torch.Generator(dev).manual_seed(seed), n)
    lo = torch.tensor([-1.25, -0.75], device=dev)
    hi = torch.tensor([2.25, 1.25], device=dev)
    centres = size / 8 + 0.75 * size * (pts - lo) / (hi - lo)
    axis = torch.arange(size, dtype=torch.float32, device=dev)
    dx = axis[None, None, :] - centres[:, 0, None, None]
    dy = axis[None, :, None] - centres[:, 1, None, None]
    return (2.0 * torch.exp(-(dx**2 + dy**2) / (2 * 1.5**2)) - 1.0)[:, None]


def _dit_eqm_step(dev, seed: int):
    """``(trainer, state, batch)``: BaseTrainer with config 5's Adam around
    its EquilibriumMatchingLoss (SinkhornCoupling(n_iters=50, reg=0.05), the
    kernel by default) on a fresh f32 DiT, and one structured batch."""
    import torch

    from torchebm_tpu_torch.core.trainer import BaseTrainer
    from torchebm_tpu_torch.couplings import SinkhornCoupling
    from torchebm_tpu_torch.losses import EquilibriumMatchingLoss

    model = _dit(dev, "float32", seed)
    loss = EquilibriumMatchingLoss(model=model,
                                   coupling=SinkhornCoupling(n_iters=FLOW_ITERS, reg=FLOW_REG))
    trainer = BaseTrainer(loss, functools.partial(torch.optim.Adam, lr=FLOW_LR))
    state = trainer.init_state(model, torch.Generator(dev).manual_seed(seed + 1))
    return trainer, state, _moons_images(dev, DIT_BATCH, seed + 2)


def path_dit_eqm(ops, dev, card: str) -> dict:
    """An EquilibriumMatchingLoss step of the DiT (scalar t through the t=
    lift, the images flattened into the coupling's cost): EQM_DIT_STEPS
    steps, one Sinkhorn kernel launch each, no host sync, the tail's mean
    loss below the head's."""
    import torch

    _release()
    trainer, state, batch = _dit_eqm_step(dev, 81)
    ops.reset_launch_counts()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EQM_DIT_STEPS):
        state, metrics = trainer.train_step(state, batch)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / EQM_DIT_STEPS
    launches = read_counts(ops, "DiT EqM", ["sinkhorn_log_fused"])
    syncs = sync_sites(lambda: trainer.train_step(state, batch))
    curve = torch.stack(losses).tolist()
    head, tail = (statistics.fmean(v) for v in (curve[:EQM_DIT_TAIL], curve[-EQM_DIT_TAIL:]))
    print(f"main path: DiT-768x12 EqM step (f32, batch {DIT_BATCH} structured 1x32x32 images, "
          f"t= lift, SinkhornCoupling(n_iters={FLOW_ITERS}, reg={FLOW_REG}), Adam {FLOW_LR}), "
          f"{EQM_DIT_STEPS} steps: {ms:.3f} ms per step (host clock, first step included); "
          f"sinkhorn_log_fused launches {launches['sinkhorn_log_fused']}; host syncs in one more "
          f"step {len(syncs)} {syncs}; mean loss of the first {EQM_DIT_TAIL} steps {head:.5f}, of "
          f"the last {tail:.5f} | {card}")
    if launches["sinkhorn_log_fused"] != EQM_DIT_STEPS:
        raise AssertionError(f"{launches['sinkhorn_log_fused']} Sinkhorn launches in "
                             f"{EQM_DIT_STEPS} DiT EqM steps, expected one per step")
    if syncs:
        raise AssertionError(f"the DiT EqM step syncs: {syncs}")
    if not (all(math.isfinite(v) for v in curve) and tail < head):
        raise AssertionError(f"the DiT EqM loss did not fall: {curve}")
    del trainer, state, batch
    _release()
    return launches


def _label_dit(dtype_name: str):
    """The example's LabelDiT (``examples/90-showcase/dit_cfg_digits/main.py:37-64``)
    at DIT_KW's width: timestep embedding plus label embedding (label dropout
    0.1) as the DiT's conditioning."""
    import torch
    from torch import nn

    from torchebm_tpu_torch.models import (
        ConditionalTransformer2D,
        LabelEmbedder,
        MLPTimestepEmbedder,
    )

    class LabelDiT(nn.Module):
        def __init__(self, dtype):
            super().__init__()
            self.t_embed = MLPTimestepEmbedder(DIT_KW["embed_dim"], dtype=dtype)
            self.y_embed = LabelEmbedder(CFG_CLASSES, DIT_KW["embed_dim"], dropout_prob=0.1)
            self.dit = ConditionalTransformer2D(**DIT_KW, dtype=dtype)

        def forward(self, x, t, *, y, train=False, generator=None):
            c = self.t_embed(t) + self.y_embed(y, train=train, generator=generator)
            return self.dit(x, c)

    return LabelDiT(getattr(torch, dtype_name))


def _label_dits(dev, seed: int) -> dict:
    """``{dtype name: LabelDiT}`` in float32 and bfloat16 on one set of
    weights: the init with every parameter moved by N(0, 0.02^2) (a fresh
    adaLN-Zero DiT outputs zero)."""
    import torch

    torch.manual_seed(seed)
    nets = {}
    g = torch.Generator(dev).manual_seed(seed)
    for name in ("float32", "bfloat16"):
        with torch.device(dev):
            nets[name] = _label_dit(name)
    with torch.no_grad():
        for p in nets["float32"].parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g, device=dev))
    nets["bfloat16"].load_state_dict(nets["float32"].state_dict())
    return nets


def _cfg_sampler(net, cfg_scale: float):
    from torchebm_tpu_torch.models import LabelClassifierFreeGuidance
    from torchebm_tpu_torch.samplers import FlowSampler

    cfg = LabelClassifierFreeGuidance(base=net, null_label_id=net.y_embed.null_label_id,
                                      cfg_scale=cfg_scale, guide_channels=1)
    return FlowSampler(model=cfg, integrator="euler")


def _cfg_generate(sampler, g, labels):
    size = DIT_KW["input_size"]
    return sampler.sample(g, dim=(DIT_KW["in_channels"], size, size), n_samples=len(labels),
                          n_steps=CFG_STEPS, model_kwargs={"y": labels})


def path_cfg(ops, dev, card: str) -> dict:
    """Class-conditional generation through LabelClassifierFreeGuidance and
    FlowSampler(integrator="euler"), in f32 and bf16: ms per step, forward
    hooks counting 2 forwards per step (1 at cfg_scale 1), and the guided
    field against uncond + scale (cond - uncond) at one step."""
    import torch

    _release()
    nets = _label_dits(dev, 91)
    g = torch.Generator(dev).manual_seed(92)
    labels = torch.arange(CFG_SAMPLES, device=dev) % CFG_CLASSES
    null = torch.full_like(labels, nets["float32"].y_embed.null_label_id)
    size = DIT_KW["input_size"]
    for name, net in nets.items():
        calls = []
        hook = net.register_forward_hook(lambda *_: calls.append(1))
        guided = _cfg_sampler(net, CFG_SCALE)
        _cfg_generate(guided, g, labels)
        guided_calls = len(calls)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = _cfg_generate(guided, g, labels)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / CFG_STEPS
        calls.clear()
        _cfg_generate(_cfg_sampler(net, 1.0), g, labels)
        plain_calls = len(calls)
        x = torch.randn((CFG_SAMPLES, DIT_KW["in_channels"], size, size), generator=g, device=dev)
        t = torch.full((CFG_SAMPLES,), 0.3, device=dev)
        with torch.no_grad():
            field = guided.model(x, t, y=labels)
            cond, uncond = net(x, t, y=labels), net(x, t, y=null)
        err = float((field - (uncond + CFG_SCALE * (cond - uncond))).abs().max())
        hook.remove()
        print(f"main path: CFG generation, LabelDiT-768x12 {name} ({CFG_CLASSES} classes, "
              f"cfg_scale {CFG_SCALE}, guide_channels 1), FlowSampler euler {CFG_SAMPLES} x "
              f"{CFG_STEPS} steps: {ms:.3f} ms per step (host clock, one generation after a "
              f"warm-up one); forwards {guided_calls} ({plain_calls} at cfg_scale 1); guided "
              f"field at t 0.3 against uncond + {CFG_SCALE} (cond - uncond): {err:.3e} (gate "
              f"1e-5); samples mean {float(gen.mean()):.4f}, std {float(gen.std()):.4f} | {card}")
        if tuple(gen.shape) != (CFG_SAMPLES, DIT_KW["in_channels"], size, size) or not bool(
                torch.isfinite(gen).all()):
            raise AssertionError(f"CFG generation ({name}) is malformed")
        if guided_calls != 2 * CFG_STEPS or plain_calls != CFG_STEPS:
            raise AssertionError(f"CFG ({name}) ran {guided_calls} and {plain_calls} forwards "
                                 f"in {CFG_STEPS} steps")
        if not err <= 1e-5:
            raise AssertionError(f"the guided field ({name}) is off by {err}")
    del nets
    _release()
    return {}


def _sm_trainer(dev, seed: int, loss_cls, **kw):
    """``(trainer, net, energy)``: BaseTrainer with Adam around ``loss_cls`` on
    a fresh MLPEnergy(2, CD_HIDDEN) on the card, its weights from ``seed``."""
    import torch

    from torchebm_tpu_torch.core import as_energy
    from torchebm_tpu_torch.core.trainer import BaseTrainer
    from torchebm_tpu_torch.models import MLPEnergy

    torch.manual_seed(seed)
    net = MLPEnergy(2, CD_HIDDEN).to(dev)
    energy = as_energy(net)
    trainer = BaseTrainer(loss_cls(model=energy, **kw),
                          functools.partial(torch.optim.Adam, lr=DSM_LR))
    return trainer, net, energy


def path_score(ops, dev, card: str) -> dict:
    """DSM on config 3's net over two moons through BaseTrainer (no host
    sync per step), then LangevinDynamics on the trained energy: one neural
    chain launch, and samples nearer held-out data (energy distance) than
    those of the untrained energy; then ms per DSM, SSM and exact-SM step."""
    import copy

    import torch

    from torchebm_tpu_torch.datasets import make_two_moons
    from torchebm_tpu_torch.losses import (
        DenoisingScoreMatching,
        ScoreMatching,
        SlicedScoreMatching,
    )
    from torchebm_tpu_torch.samplers import LangevinDynamics

    trainer, net, energy = _sm_trainer(dev, 101, DenoisingScoreMatching, noise_scale=DSM_NOISE)
    untrained = copy.deepcopy(energy)
    g = torch.Generator(dev).manual_seed(102)
    state = trainer.init_state(net, g)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DSM_STEPS):
        state, metrics = trainer.train_step(state, make_two_moons(g, CD_BATCH))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) * 1e3 / DSM_STEPS
    batch = make_two_moons(g, CD_BATCH)
    syncs = sync_sites(lambda: trainer.train_step(state, batch))
    curve = torch.stack(losses).tolist()

    held = make_two_moons(torch.Generator(dev).manual_seed(103), DSM_CHAINS)
    ops.reset_launch_counts()
    trained = LangevinDynamics(energy, step_size=DSM_SAMPLE_STEP, fused_neural="auto").sample(
        g, dim=2, n_samples=DSM_CHAINS, n_steps=DSM_SAMPLE_STEPS)
    launches = read_counts(ops, "DSM sampling", ["mlp_langevin_chain"])
    base = LangevinDynamics(untrained, step_size=DSM_SAMPLE_STEP, fused_neural="auto").sample(
        g, dim=2, n_samples=DSM_CHAINS, n_steps=DSM_SAMPLE_STEPS)
    ed_trained, ed_base = _energy_distance(trained, held), _energy_distance(base, held)

    steps = {}
    for label, (cls, kw) in {
            "DSM": (DenoisingScoreMatching, dict(noise_scale=DSM_NOISE)),
            "SSM (5 Rademacher projections)": (SlicedScoreMatching, dict(n_projections=5)),
            "exact SM": (ScoreMatching, {})}.items():
        tr, tnet, _ = _sm_trainer(dev, 104, cls, **kw)
        st = tr.init_state(tnet, torch.Generator(dev).manual_seed(105))
        steps[label] = statistics.median(cuda_times(lambda: tr.train_step(st, batch), 3, 10))
    print(f"main path: DSM config 3 net (MLPEnergy{CD_HIDDEN}, two moons, batch {CD_BATCH}, "
          f"noise_scale {DSM_NOISE}, Adam {DSM_LR}), {DSM_STEPS} steps: {train_ms:.3f} ms per "
          f"step (host clock, first step included); loss first 10 "
          f"{statistics.fmean(curve[:10]):.4f}, last 10 {statistics.fmean(curve[-10:]):.4f}; "
          f"host syncs in one more step {len(syncs)} {syncs} | {card}")
    print(f"main path: LangevinDynamics on the DSM energy, {DSM_CHAINS} chains x "
          f"{DSM_SAMPLE_STEPS} steps at {DSM_SAMPLE_STEP}: mlp_langevin_chain launches "
          f"{launches['mlp_langevin_chain']}; energy distance to held-out two moons: trained "
          f"{ed_trained:.4f}, untrained {ed_base:.4f} | {card}")
    print("timing: score-matching train steps on MLPEnergy" + str(CD_HIDDEN) + f", batch "
          f"{CD_BATCH} (CUDA events, median of 10 after 3): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in steps.items()) + f" | {card}")
    if launches["mlp_langevin_chain"] != 1:
        raise AssertionError(f"{launches['mlp_langevin_chain']} neural chain launches in one "
                             "sampler call on the DSM energy")
    if syncs:
        raise AssertionError(f"the DSM train step syncs: {syncs}")
    if not (all(math.isfinite(v) for v in curve) and bool(torch.isfinite(trained).all())):
        raise AssertionError("DSM training or sampling is not finite")
    if not ed_trained < ed_base:
        raise AssertionError(f"the DSM energy's samples ({ed_trained}) are not nearer the data "
                             f"than the untrained energy's ({ed_base})")
    return launches


# ------------------------------------------------ the paths of the last slice

#: BASELINE config 4 (benchmarks/headline.py:502-546 through _cd_step_factory,
#: :400-437): PCD k=40 on ConvEnergy2D(channels=(32, 64, 64)) over 1 x 28 x 28,
#: batch 64, a 4,096-sample buffer with no warm-up (init_steps=0), Langevin step
#: 10.0 with the state clamped to (-1, 1), Adam 1e-4, one fixed batch of N(0, I)
#: data (the reference's jax.random.normal draws); in float32 and in bf16 end to
#: end (net, chain state, buffer and data, :422-428); through the trainer and
#: the generic loop (no row claims a conv energy). CONV_STEPS steps timed on the
#: host clock after CONV_WARMUP
CONV_CHANNELS, CONV_SHAPE, CONV_BATCH, CONV_K, CONV_BUFFER = (32, 64, 64), (1, 28, 28), 64, 40, 4096
CONV_STEP, CONV_CLAMP, CONV_LR, CONV_WARMUP, CONV_STEPS = 10.0, (-1.0, 1.0), 1e-4, 2, 10
#: the card against the CPU port: the energy and input gradient of the data
#: batch within CONV_RTOL of the largest entry in float32 (bf16 against the
#: CPU's float32 within [BF16_FLOOR, BF16_RTOL], the DiT's rule), and one
#: float32 train step at noise 0 from a buffer of the batch's size (its rows
#: the chains' starts, so every draw of the step is injected): the loss's
#: gradients before Adam (whose first update is about lr * sign(g), so the
#: parameters alone check little more than the gradients' signs) and the loss
#: within CONV_RTOL, the negatives after 40 steps at step 10 within
#: CONV_NEG_TOL (read 0.95e-6-1.2e-6 on an H100), the parameters within
#: CONV_PARAM_TOL
CONV_RTOL, CONV_PARAM_TOL, CONV_NEG_TOL = 1e-4, 1e-5, 1e-5
#: Energy Matching on config 5's batch and Adam 1e-3, config 3's net as the
#: potential, the loss's defaults (200 Langevin steps per population,
#: lambda_cd 2): EM_STEPS train steps with the default "ot" coupling (the
#: auction) and with config 5's SinkhornCoupling
EM_STEPS = 3
#: the flow modes: config 5's EqM field through the other ODE integrators and
#: log_prob, each from one start on the card and on the CPU port; SDE
#: generation and log_prob's known answer on the exact velocity of the linear
#: path from N(0, I) to config 5's data law N((2, 0), I): an EqM field is not a
#: flow's velocity, and the SDE, which turns the velocity into a score,
#: diverges on it (a CPU run: mean -131 after 250 steps), while score fields
#: trained on config 5's one batch put their ODE and SDE means 0.1 to 0.6 apart
#: by the training run (CPU runs). The SDE takes SDE_STEPS Euler-Maruyama
#: steps: at the default 250 they are not stable near t = 1 for this law (a
#: CPU run: standard deviation 3.5 against 1; 0.96 at 1,000). LOGP_RTOL:
#: log_prob of the exact field against log N(x; (2, 0), I), relative to
#: max(1, |log p|), after LOGP_STEPS RK4 steps
FLOW_MODE_INTEGRATORS = ("heun", "midpoint", "rk4", "bosh3", "adaptive_heun", "dopri8")
SDE_STEPS, LOGP_STEPS, LOGP_SAMPLES, LOGP_RTOL = 1000, 100, 1024, 1e-3
#: the CD variants on config 3's net and batches: PersistentContrastiveDivergence
#: and ParallelTemperingCD (PT_TEMPS, swap every PT_SWAP_EVERY), each with a
#: PCD_BUFFER buffer of noise (no warm-up), CDV_STEPS train steps
CDV_STEPS = 10


@functools.lru_cache(maxsize=None)
def _config5_field(dev):
    """Config 5's EqM field of ``path_flow``, trained FLOW_STEPS steps through
    the Sinkhorn kernel from FLOW_SEEDS[0]; cached for the paths that share it."""
    return _flow_run(dev, "auto", FLOW_STEPS, FLOW_SEEDS[0])[0]


def _gauss_velocity(dev):
    """The exact velocity E[x1 - x0 | x_t = x] of the linear path x_t = t x1 +
    (1 - t) x0 from x0 ~ N(0, I) to config 5's data law x1 ~ N(m, I), m = (2,
    0): m + (x - t m)(2t - 1) / (t^2 + (1 - t)^2); and ``log p(x)`` of the data
    law, the answer that ``log_prob`` of its flow must give."""
    import torch

    m = torch.tensor([2.0, 0.0], device=dev)

    def field(x, t):
        s = t[:, None]
        return m + (x - s * m) * (2 * s - 1) / (s**2 + (1 - s) ** 2)

    def log_p(x):
        return -math.log(2 * math.pi) - 0.5 * torch.sum(torch.square(x - m), dim=-1)

    return field, log_p


def _on_cpu(module):
    import copy

    return copy.deepcopy(module).cpu()


def _conv_trainer(dev, dtype, seed: int, **cd_kw):
    """``(trainer, net)``: config 4's ContrastiveDivergenceTrainer around a
    fresh ConvEnergy2D computing in ``dtype`` on ``dev``, its float32 weights
    from ``seed``; ``cd_kw`` overrides the loss's fields, ``noise_scale`` the
    sampler's."""
    import torch

    from torchebm_tpu_torch.core import as_energy
    from torchebm_tpu_torch.core.trainer import ContrastiveDivergenceTrainer
    from torchebm_tpu_torch.losses import PersistentContrastiveDivergence
    from torchebm_tpu_torch.models import ConvEnergy2D
    from torchebm_tpu_torch.samplers import LangevinDynamics

    torch.manual_seed(seed)
    net = ConvEnergy2D(in_channels=CONV_SHAPE[0], image_size=CONV_SHAPE[1:],
                       channels=CONV_CHANNELS, dtype=dtype).to(dev)
    energy = as_energy(net)
    kw = dict(dict(k_steps=CONV_K, buffer_size=CONV_BUFFER, init_steps=0), **cd_kw)
    sampler = LangevinDynamics(energy, step_size=CONV_STEP, clamp=CONV_CLAMP,
                               noise_scale=kw.pop("noise_scale", 1.0))
    cd = PersistentContrastiveDivergence(model=energy, sampler=sampler, **kw)
    return ContrastiveDivergenceTrainer(cd, learning_rate=CONV_LR), net


def _conv_data(dev, kind: str, dtype):
    """Config 4's one batch: the reference's N(0, I) draws (``"normal"``), or
    two-moons blobs rendered at 28 x 28 (``"moons"``); in ``dtype``."""
    import torch

    if kind == "normal":
        x = torch.randn((CONV_BATCH, *CONV_SHAPE), generator=torch.Generator(dev).manual_seed(0),
                        device=dev)
    else:
        x = _moons_images(dev, CONV_BATCH, 61, size=CONV_SHAPE[-1])
    return x.to(dtype)


def _conv_parity(dev, card: str) -> None:
    """Config 4's net on the card against the CPU port: the data batch's
    energies and input gradients in float32 (CONV_RTOL) and in bf16 (against
    the CPU's float32, within [BF16_FLOOR, BF16_RTOL]); one float32 train step
    from injected starts at noise 0: the loss and its parameter gradients
    within CONV_RTOL, the negatives within CONV_NEG_TOL, the parameters after
    Adam within CONV_PARAM_TOL."""
    import torch

    from torchebm_tpu_torch.losses import ReplayBuffer
    from torchebm_tpu_torch.models import ConvEnergy2D

    def energy_and_grad(net, x):
        x = x.detach().requires_grad_(True)
        e = net(x)
        (g,) = torch.autograd.grad(e.sum(), x)
        return e.detach().float().cpu(), g.float().cpu()

    _, net = _conv_trainer(dev, torch.float32, seed=53)
    x = _conv_data(dev, "normal", torch.float32)
    e_cpu, g_cpu = energy_and_grad(_on_cpu(net), x.cpu())
    errs = {}
    e_card, g_card = energy_and_grad(net, x)
    errs["f32"] = (_rel(e_card, e_cpu), _rel(g_card, g_cpu))
    bf16 = ConvEnergy2D(in_channels=CONV_SHAPE[0], image_size=CONV_SHAPE[1:],
                        channels=CONV_CHANNELS, dtype=torch.bfloat16).to(dev)
    bf16.load_state_dict(net.state_dict())
    e_b, g_b = energy_and_grad(bf16, x.to(torch.bfloat16))
    errs["bf16"] = (_rel(e_b, e_cpu), _rel(g_b, g_cpu))

    cpu = torch.device("cpu")
    starts = torch.rand((CONV_BATCH, *CONV_SHAPE), generator=torch.Generator().manual_seed(55))
    data = _conv_data(cpu, "normal", torch.float32)
    steps = []
    for where in (dev, cpu):
        trainer, tnet = _conv_trainer(where, torch.float32, seed=54, noise_scale=0.0,
                                      buffer_size=CONV_BATCH, new_sample_ratio=0.0)
        buf = ReplayBuffer(samples=(2.0 * starts - 1.0).to(where))
        state = trainer.init_state(tnet, torch.Generator(where).manual_seed(56), loss_state=buf)
        # the step's parameter gradients, as its backward pass hands them on
        grads = {}
        hooks = [p.register_hook(lambda gr, i=i: grads.__setitem__(i, gr.detach().cpu()))
                 for i, p in enumerate(tnet.parameters())]
        state, m = trainer.train_step(state, data.to(where))
        for h in hooks:
            h.remove()
        steps.append((float(m["loss"]), state.loss_state.samples.cpu(),
                      [p.detach().cpu() for p in tnet.parameters()],
                      [grads[i] for i in range(len(grads))]))
    (loss_c, neg_c, par_c, grad_c), (loss_h, neg_h, par_h, grad_h) = steps
    par_err = max(float((a - b).abs().max()) for a, b in zip(par_c, par_h))
    # of the largest entry of every gradient (the head's bias gradient is a
    # difference of two means, near 0)
    grad_err = (max(float((a - b).abs().max()) for a, b in zip(grad_c, grad_h))
                / max(float(b.abs().max()) for b in grad_h))
    loss_err = abs(loss_c - loss_h) / max(1.0, abs(loss_h))
    neg_err = float((neg_c - neg_h).abs().max())
    print(f"check: config 4 ConvEnergy2D{CONV_CHANNELS} on the card against the CPU port, batch "
          f"{CONV_BATCH}: f32 energy {errs['f32'][0]:.3e}, input gradient {errs['f32'][1]:.3e} "
          f"(of the largest entry, tol {CONV_RTOL:g}); bf16 against the CPU's f32 energy "
          f"{errs['bf16'][0]:.3e}, input gradient {errs['bf16'][1]:.3e} (within "
          f"[{BF16_FLOOR:g}, {BF16_RTOL:g}]); one f32 train step from injected starts at noise 0 "
          f"(k {CONV_K}, step {CONV_STEP}, clamp {CONV_CLAMP}): negatives {neg_err:.3e} (tol "
          f"{CONV_NEG_TOL:g}), loss {loss_c:.6f} / {loss_h:.6f} ({loss_err:.3e}, tol "
          f"{CONV_RTOL:g}), parameter gradients {grad_err:.3e} of their largest entry "
          f"(tol {CONV_RTOL:g}), parameters after Adam {par_err:.3e} (tol {CONV_PARAM_TOL:g}) "
          f"| {card}")
    if not max(errs["f32"]) <= CONV_RTOL:
        raise AssertionError(f"config 4's f32 energy on the card differs from the CPU: {errs}")
    if not all(BF16_FLOOR <= e <= BF16_RTOL for e in errs["bf16"]):
        raise AssertionError(f"config 4's bf16 energy is outside the bf16 band: {errs}")
    if not (neg_err <= CONV_NEG_TOL and loss_err <= CONV_RTOL and grad_err <= CONV_RTOL
            and par_err <= CONV_PARAM_TOL):
        raise AssertionError(f"config 4's train step on the card differs from the CPU: negatives "
                             f"{neg_err}, loss {loss_err}, gradients {grad_err}, parameters "
                             f"{par_err}")


def path_pcd_conv(ops, dev, card: str) -> dict:
    """BASELINE config 4 (CONV_*) through ``PersistentContrastiveDivergence``
    and the trainer, in float32 and bf16 end to end, on the reference's
    normal data and on rendered two-moons images: ms per step, and on the
    normal data the device busy time, idle share (``profile_calls``) and host
    syncs per step; the buffer keeps its dtype and the clamp, the losses are
    finite; then the card-against-CPU gates (:func:`_conv_parity`)."""
    import torch

    from torchebm_tpu_torch.losses import ReplayBuffer

    ops.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for kind in ("normal", "moons"):
            trainer, net = _conv_trainer(dev, dtype, seed=51)
            g = torch.Generator(dev).manual_seed(52)
            buf = trainer.loss_fn.init_buffer(g, CONV_SHAPE)
            state = trainer.init_state(net, g, loss_state=ReplayBuffer(
                samples=buf.samples.to(dtype)))
            x = _conv_data(dev, kind, dtype)
            losses = []
            for _ in range(CONV_WARMUP):
                state, m = trainer.train_step(state, x)
                losses.append(m["loss"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CONV_STEPS):
                state, m = trainer.train_step(state, x)
                losses.append(m["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / CONV_STEPS
            label = (f"config 4 PCD train step, ConvEnergy2D{CONV_CHANNELS} {name}, batch "
                     f"{CONV_BATCH}, k {CONV_K}, {kind} data")
            extra = ""
            if kind == "normal":
                wall, busy = profile_calls({label: lambda: trainer.train_step(state, x)}, card,
                                           require_events=True)[label]
                syncs = sync_sites(lambda: trainer.train_step(state, x))
                extra = (f"; profiled: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
                         f"{1.0 - busy / wall:.3f}; host syncs per step {len(syncs)} {syncs}")
            samples = state.loss_state.samples
            curve = torch.stack(losses).float().tolist()
            print(f"main path: {label} (step {CONV_STEP}, clamp {CONV_CLAMP}, buffer "
                  f"{CONV_BUFFER} {str(samples.dtype).split('.')[-1]}, Adam {CONV_LR}): "
                  f"{ms:.3f} ms per train step (host clock, {CONV_STEPS} steps after "
                  f"{CONV_WARMUP}){extra}; loss first {curve[0]:.5f}, last {curve[-1]:.5f}; "
                  f"buffer pointer {state.loss_state.ptr} | {card}")
            if samples.dtype != dtype or not bool(torch.isfinite(samples.float()).all()):
                raise AssertionError(f"config 4 ({name}) buffer: {samples.dtype}")
            lo, hi = float(samples.min()), float(samples.max())
            if not (lo >= CONV_CLAMP[0] and hi <= CONV_CLAMP[1]):
                raise AssertionError(f"config 4 ({name}) buffer left the clamp: {lo}, {hi}")
            if not all(math.isfinite(v) for v in curve):
                raise AssertionError(f"config 4 ({name}, {kind}) losses are not finite: {curve}")
            del trainer, net, state, buf
    launches = read_counts(ops, "config 4", [])
    if any(launches.values()):
        raise AssertionError(f"config 4 launched a kernel: {launches}")
    _release()
    _conv_parity(dev, card)
    _release()
    return launches


def _em_trainer(dev, coupling, seed: int, **kw):
    """``(trainer, net)``: BaseTrainer with config 5's Adam around an
    EnergyMatchingLoss of a fresh MLPEnergy(2, CD_HIDDEN) on ``dev``, its
    weights from ``seed``."""
    import torch

    from torchebm_tpu_torch.core import as_energy
    from torchebm_tpu_torch.core.trainer import BaseTrainer
    from torchebm_tpu_torch.losses import EnergyMatchingLoss
    from torchebm_tpu_torch.models import MLPEnergy

    torch.manual_seed(seed)
    net = MLPEnergy(2, CD_HIDDEN).to(dev)
    loss = EnergyMatchingLoss(model=as_energy(net), coupling=coupling, **kw)
    return BaseTrainer(loss, functools.partial(torch.optim.Adam, lr=FLOW_LR)), net


def path_em(ops, dev, card: str) -> dict:
    """EnergyMatchingLoss through BaseTrainer on config 5's batch, EM_STEPS
    steps with the default ``"ot"`` coupling (the auction: no kernel, one
    host sync per bidding round) and with config 5's SinkhornCoupling
    (exactly one row-14 launch per step): ms per step, host syncs in one more
    step, finite losses; then the loss's flow term and its parameter
    gradients on the card against the CPU port on injected ``x0`` and times
    (the identity pairing, sigma 0, lambda_cd 0: every draw injected)."""
    import torch

    data = _flow_batch(dev)
    launches = dict.fromkeys(ops.launch_counts(), 0)
    for label, coupling in (("ot (auction)", "ot"), ("sinkhorn", _config5_coupling("auto"))):
        trainer, net = _em_trainer(dev, coupling, seed=111)
        state = trainer.init_state(net, torch.Generator(dev).manual_seed(112))
        ops.reset_launch_counts()
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EM_STEPS):
            state, m = trainer.train_step(state, data)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / EM_STEPS
        counts = read_counts(ops, f"EM, {label}", [] if coupling == "ot" else
                             ["sinkhorn_log_fused"])
        syncs = count_syncs(lambda: trainer.train_step(state, data))
        curve = torch.stack(losses).tolist()
        print(f"main path: EnergyMatchingLoss, MLPEnergy{CD_HIDDEN} on config 5's batch of "
              f"{FLOW_BATCH}, coupling {label}, lambda_cd 2, 200 Langevin steps per population, "
              f"Adam {FLOW_LR}: {ms:.3f} ms per train step (host clock, {EM_STEPS} steps, first "
              f"included); sinkhorn_log_fused launches {counts['sinkhorn_log_fused']}; host "
              f"syncs in one more step {syncs}; losses {[round(v, 5) for v in curve]} | {card}")
        want = 0 if coupling == "ot" else EM_STEPS
        if counts["sinkhorn_log_fused"] != want:
            raise AssertionError(f"EM ({label}): {counts['sinkhorn_log_fused']} Sinkhorn launches "
                                 f"in {EM_STEPS} steps, expected {want}")
        if not all(math.isfinite(v) for v in curve):
            raise AssertionError(f"EM ({label}) losses are not finite: {curve}")
        for name, n in counts.items():
            launches[name] += n

    g = torch.Generator().manual_seed(113)
    x0 = torch.randn((FLOW_BATCH, 2), generator=g)
    t = torch.rand((FLOW_BATCH,), generator=g)
    out = []
    for where in (dev, torch.device("cpu")):
        trainer, net = _em_trainer(where, "independent", seed=114, sigma=0.0, lambda_cd=0.0)
        loss = trainer.loss_fn(None, data.to(where), torch.Generator(where).manual_seed(0),
                               x0=x0.to(where), t=t.to(where))
        loss.backward()
        # the flow term reads the potential's input gradient: the output bias gets none
        out.append((loss.detach().cpu(),
                    [p.grad.cpu() for p in net.parameters() if p.grad is not None]))
    (loss_card, grads_card), (loss_cpu, grads_cpu) = out
    loss_err = _rel(loss_card, loss_cpu)
    grad_err = max(_rel(a, b) for a, b in zip(grads_card, grads_cpu))
    print(f"check: EnergyMatchingLoss flow term on the card against the CPU port on injected x0 "
          f"and times (identity pairing, sigma 0, lambda_cd 0): loss {float(loss_card):.6f} / "
          f"{float(loss_cpu):.6f} ({loss_err:.3e} relative, tol {PARITY_FWD_RTOL:g}), "
          f"parameter gradients {grad_err:.3e} (tol {PARITY_GRAD_RTOL:g}) | {card}")
    if not (loss_err <= PARITY_FWD_RTOL and grad_err <= PARITY_GRAD_RTOL):
        raise AssertionError(f"EM on the card differs from the CPU: {loss_err}, {grad_err}")
    return launches


def path_couplings(ops, dev, card: str) -> dict:
    """The other couplings on config 5's batch (a (FLOW_BATCH, FLOW_BATCH)
    cost matrix): UnbalancedSinkhornCoupling through row 14 in damped mode
    (one launch per call, its log plan within TOL of ``fused="off"``'s),
    the auction and the greedy assignment (ExactOTCoupling's and
    GreedyCoupling's solvers) equal to the CPU port's permutations on the
    same cost, and ReflowCoupling through config 5's trained field within
    TOL of the CPU port's from the same x0."""
    import torch

    from torchebm_tpu_torch.couplings import (
        ExactOTCoupling,
        GreedyCoupling,
        ReflowCoupling,
        UnbalancedSinkhornCoupling,
        auction_assignment,
        greedy_assignment,
        unbalanced_sinkhorn_log,
    )
    from torchebm_tpu_torch.samplers import FlowSampler

    g = torch.Generator(dev).manual_seed(121)
    x1 = _flow_batch(dev)
    x0 = torch.randn(x1.shape, generator=g, device=dev)
    unb = UnbalancedSinkhornCoupling(reg=FLOW_REG, n_iters=FLOW_ITERS)
    cost = unb.compute_cost(x0, x1).contiguous()
    ops.reset_launch_counts()
    res = unb(x0, x1, generator=g)
    launches = read_counts(ops, "UnbalancedSinkhornCoupling", ["sinkhorn_log_fused"])
    kw = dict(reg=unb.reg, reg_marginal=unb.reg_marginal, n_iters=unb.n_iters, tol=unb.tol)
    plan_err = max_err(unbalanced_sinkhorn_log(cost, fused="auto", **kw),
                       unbalanced_sinkhorn_log(cost, fused="off", **kw))
    weights = res.weights
    timings = {}
    perms = {}
    for name, solve, cls in (("auction", functools.partial(auction_assignment,
                                                           tol=ExactOTCoupling().tol),
                              ExactOTCoupling),
                             ("greedy", greedy_assignment, GreedyCoupling)):
        card_perm, ms = _timed(lambda: solve(cost))
        perms[name] = (card_perm.cpu(), solve(cost.cpu()))
        coupled = cls()(x0, x1)
        timings[name] = ms
        if not torch.equal(coupled.x1, x1[card_perm]):
            raise AssertionError(f"{cls.__name__} does not pair by its solver's permutation")
    field = _config5_field(dev)
    reflow = ReflowCoupling(model=FlowSampler(model=field, negate_velocity=True))
    got = reflow(x0, generator=g).x1
    want = ReflowCoupling(model=FlowSampler(model=_on_cpu(field), negate_velocity=True))(
        x0.cpu(), generator=torch.Generator()).x1
    reflow_err = max_err(got.cpu(), want)
    same = {k: bool(torch.equal(a, b)) for k, (a, b) in perms.items()}
    print(f"check: couplings on config 5's batch ({FLOW_BATCH}x{FLOW_BATCH} cost): "
          f"UnbalancedSinkhornCoupling (reg {FLOW_REG}, rho {unb.reg_marginal}, damping "
          f"{unb.reg_marginal / (unb.reg_marginal + unb.reg):.4f}) "
          f"{launches['sinkhorn_log_fused']} row-14 launch, log plan against fused='off' "
          f"{plan_err:.3e} (tol {TOL}), weights mean {float(weights.mean()):.4f} range "
          f"{float(weights.min()):.4f}..{float(weights.max()):.4f}; "
          f"auction permutation equal to the CPU port's: {same['auction']} "
          f"({timings['auction']:.1f} ms on the card), greedy: {same['greedy']} "
          f"({timings['greedy']:.1f} ms); ReflowCoupling through config 5's EqM field (dopri5) "
          f"against the CPU port {reflow_err:.3e} (tol {TOL}) | {card}")
    if launches["sinkhorn_log_fused"] != 1 or not plan_err <= TOL:
        raise AssertionError("the unbalanced coupling missed row 14 or its plan differs")
    if not all(same.values()):
        raise AssertionError(f"the card's permutations differ from the CPU port's: {same}")
    if not reflow_err <= TOL:
        raise AssertionError(f"ReflowCoupling on the card differs from the CPU by {reflow_err}")
    return launches


def path_cd_variants(ops, dev, card: str) -> dict:
    """PersistentContrastiveDivergence and ParallelTemperingCD on config 3's
    net and batches, CDV_STEPS steps each: PCD through row 13 (one launch per
    step), PT-CD on its persistent ladders through the generic loop (no
    launch), its swap acceptance over a run of its sampler from the buffer's
    ladders; finite losses."""
    import torch

    from torchebm_tpu_torch.core import as_energy
    from torchebm_tpu_torch.core.trainer import ContrastiveDivergenceTrainer
    from torchebm_tpu_torch.losses import ParallelTemperingCD, PersistentContrastiveDivergence
    from torchebm_tpu_torch.models import MLPEnergy
    from torchebm_tpu_torch.samplers import LangevinDynamics, ParallelTemperingLangevin

    launches = dict.fromkeys(ops.launch_counts(), 0)
    report = []
    for label in ("PersistentContrastiveDivergence", "ParallelTemperingCD"):
        torch.manual_seed(131)
        net = MLPEnergy(2, CD_HIDDEN).to(dev)
        energy = as_energy(net)
        if label == "ParallelTemperingCD":
            sampler = ParallelTemperingLangevin(energy, temperatures=PT_TEMPS, step_size=CD_STEP,
                                                swap_every=PT_SWAP_EVERY)
            loss = ParallelTemperingCD(model=energy, sampler=sampler, k_steps=CD_K,
                                       persistent=True, buffer_size=PCD_BUFFER, init_steps=0)
        else:
            sampler = LangevinDynamics(energy, step_size=CD_STEP, fused_neural="auto")
            loss = PersistentContrastiveDivergence(model=energy, sampler=sampler, k_steps=CD_K,
                                                   buffer_size=PCD_BUFFER, init_steps=0)
        trainer = ContrastiveDivergenceTrainer(loss, learning_rate=CD_LR)
        g = torch.Generator(dev).manual_seed(132)
        batches = _cd_batches(dev, g, CDV_STEPS, seed=133)
        state = trainer.init_state(net, g, loss_state=loss.init_buffer(g, (2,)))
        ops.reset_launch_counts()
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            state, m = trainer.train_step(state, b)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / CDV_STEPS
        counts = read_counts(ops, label, ["mlp_langevin_chain"] if label.startswith("Pers") else [])
        curve = torch.stack(losses).tolist()
        line = (f"{label} {ms:.3f} ms per step, mlp_langevin_chain launches "
                f"{counts['mlp_langevin_chain']}, buffer pointer {state.loss_state.ptr}, loss "
                f"last {curve[-1]:.5f}")
        if label == "ParallelTemperingCD":
            ladder = state.loss_state.samples[:CD_BATCH].movedim(0, 1).contiguous()
            _, acc = sampler.run_replicas(g, ladder, CD_K)
            line += (f", last-sweep swap acceptance over {CD_K} steps of {CD_BATCH} ladders "
                     f"from the buffer {float(acc):.4f}")
            if any(counts.values()) or tuple(state.loss_state.samples.shape) != (
                    PCD_BUFFER, len(PT_TEMPS), 2):
                raise AssertionError(f"PT-CD: launches {counts}, buffer "
                                     f"{tuple(state.loss_state.samples.shape)}")
        elif counts["mlp_langevin_chain"] != CDV_STEPS:
            raise AssertionError(f"PCD: {counts['mlp_langevin_chain']} neural chain launches in "
                                 f"{CDV_STEPS} steps")
        if not all(math.isfinite(v) for v in curve):
            raise AssertionError(f"{label} losses are not finite: {curve}")
        report.append(line)
        for name, n in counts.items():
            launches[name] += n
    print(f"main path: CD variants on config 3 (MLPEnergy{CD_HIDDEN}, batch {CD_BATCH}, CD-{CD_K} "
          f"at {CD_STEP}, buffer {PCD_BUFFER} of noise, PT temperatures {PT_TEMPS} swapping every "
          f"{PT_SWAP_EVERY}), {CDV_STEPS} steps each: " + "; ".join(report) + f" | {card}")
    return launches


def path_flow_modes(ops, dev, card: str) -> dict:
    """Generation at GEN_SAMPLES samples, each from one start: config 5's EqM
    field through FLOW_MODE_INTEGRATORS (GEN_STEPS steps, or the controller
    from that grid) on the card and on the CPU port, within TOL, and its
    ``log_prob`` at LOGP_SAMPLES samples, exact, card against the CPU port
    within TOL relative to max(1, |log p|); on the exact Gaussian velocity
    (:func:`_gauss_velocity`), SDE generation (SDE_STEPS Euler-Maruyama steps) with
    its mean within 0.2 (config 5's gate) of its dopri5 ODE mean and of the
    data's, and ``log_prob`` exact (within LOGP_RTOL of the data law's
    density) and Hutchinson (2 probes)."""
    import torch

    from torchebm_tpu_torch.samplers import FlowSampler

    eqm = _config5_field(dev)
    eqm_cpu = _on_cpu(eqm)
    g = torch.Generator(dev).manual_seed(141)
    x0 = torch.randn((GEN_SAMPLES, 2), generator=g, device=dev)
    report, bad = [], []
    for name in FLOW_MODE_INTEGRATORS:
        def run(model, x, name=name):
            return FlowSampler(model=model, negate_velocity=True, integrator=name).sample(
                torch.Generator(x.device), x=x, n_steps=GEN_STEPS)
        got, ms = _timed(lambda: run(eqm, x0))
        err = max_err(got.cpu(), run(eqm_cpu, x0.cpu()))
        report.append(f"{name} {err:.3e} ({ms:.1f} ms)")
        if not err <= TOL:
            bad.append(name)
    xs = x0[:LOGP_SAMPLES]
    lp, lp_ms = _timed(lambda: FlowSampler(model=eqm, negate_velocity=True).log_prob(
        xs, n_steps=LOGP_STEPS))
    lp_cpu = FlowSampler(model=eqm_cpu, negate_velocity=True).log_prob(xs.cpu(),
                                                                       n_steps=LOGP_STEPS)
    lp_err = float((lp.cpu() - lp_cpu).abs().max()) / max(1.0, float(lp_cpu.abs().max()))

    field, log_p = _gauss_velocity(dev)
    ode = FlowSampler(model=field)
    x_ode = ode.sample(g, x=x0, n_steps=GEN_STEPS)
    x_sde, sde_ms = _timed(lambda: FlowSampler(model=field, mode="sde").sample(
        g, x=x0, n_steps=SDE_STEPS))
    data_mean = torch.tensor([2.0, 0.0], device=dev)
    gap = float((x_sde.mean(0) - x_ode.mean(0)).norm())
    gap_data = float((x_sde.mean(0) - data_mean).norm())
    xg = x_ode[:LOGP_SAMPLES]
    want = log_p(xg)
    exact = ode.log_prob(xg, n_steps=LOGP_STEPS)
    exact_err = float((exact - want).abs().max()) / max(1.0, float(want.abs().max()))
    hut = ode.log_prob(xg, generator=g, n_steps=LOGP_STEPS, hutchinson=True, n_probes=2)
    print(f"main path: FlowSampler from config 5's EqM field, {GEN_SAMPLES} x {GEN_STEPS} steps, "
          f"card against the CPU port from one start (tol {TOL}): " + ", ".join(report)
          + f"; its log_prob of {LOGP_SAMPLES} samples ({LOGP_STEPS} RK4 steps, {lp_ms:.1f} ms) "
          f"mean {float(lp.mean()):.4f}, card against the CPU port {lp_err:.3e} relative (tol "
          f"{TOL}) | {card}")
    print(f"main path: FlowSampler on the exact velocity to N((2, 0), I): SDE ({SDE_STEPS} steps, "
          f"{sde_ms:.1f} ms) mean {[round(v, 4) for v in x_sde.mean(0).tolist()]}, std "
          f"{[round(v, 4) for v in x_sde.std(0).tolist()]}, against the ODE's (dopri5) mean "
          f"{[round(v, 4) for v in x_ode.mean(0).tolist()]}: {gap:.4f} apart, {gap_data:.4f} "
          f"from the data's (gate 0.2 each); log_prob of {LOGP_SAMPLES} ODE samples against "
          f"log N(x; (2, 0), I): exact {exact_err:.3e} relative (tol {LOGP_RTOL:g}), Hutchinson "
          f"(2 probes) mean |hutchinson - exact| {float((hut - exact).abs().mean()):.4f} "
          f"| {card}")
    if bad:
        raise AssertionError(f"the card's generation differs from the CPU port's: {bad}")
    if not lp_err <= TOL:
        raise AssertionError(f"log_prob on the card differs from the CPU port by {lp_err}")
    if not (bool(torch.isfinite(x_sde).all()) and gap < 0.2 and gap_data < 0.2):
        raise AssertionError(f"SDE generation misses its ODE's and the data's means: {gap}, "
                             f"{gap_data}")
    if not (exact_err <= LOGP_RTOL and bool(torch.isfinite(hut).all())):
        raise AssertionError(f"log_prob misses the data law's density by {exact_err}")
    return {}


#: the last slice's paths, in the order they run (``--gaps``)
GAP_PATHS = (path_pcd_conv, path_em, path_couplings, path_cd_variants, path_flow_modes)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flax_mlp_tree(rng, widths) -> dict:
    """A flax-shaped MLPEnergy tree (``Dense_0 ... Dense_L``, the JAX
    package's layout) with LeCun-scaled weights from the numpy generator."""
    import numpy as np

    dims = list(widths) + [1]
    return {"params": {f"Dense_{i}": {
        "kernel": (rng.standard_normal((a, b)) * a ** -0.5).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(b)).astype(np.float32)}
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}}


def _rows_in_halves(fn, x0, split: int, *args, **kw):
    """``fn`` over rows ``[0, split)`` and ``[split, n)`` of ``x0``, each at
    its first row as ``chain_offset``, concatenated along the chains (the
    trajectory's dim 1)."""
    import torch

    parts = [fn(x0[:split], *args, chain_offset=0, **kw),
             fn(x0[split:], *args, chain_offset=split, **kw)]
    if isinstance(parts[0], tuple):
        return (torch.cat([parts[0][0], parts[1][0]], dim=1),
                torch.cat([parts[0][1], parts[1][1]], dim=0))
    return torch.cat(parts, dim=0)


def _par_langevin(ops, dev, mesh, card: str) -> dict:
    """Config 1 sharded through ``sample``; rows 4 and 5 as two offset
    launches against one; each half against its plain version."""
    import torch

    from torchebm_tpu_torch.core import GaussianMixtureEnergy
    from torchebm_tpu_torch.parallel import shard_batch
    from torchebm_tpu_torch.samplers import LangevinDynamics

    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    sampler = LangevinDynamics(mix, step_size=0.05)
    x0 = torch.randn((N_CHAINS, 2), generator=torch.Generator(dev).manual_seed(40), device=dev)
    xs = shard_batch(x0, mesh)
    ops.reset_launch_counts()
    final = sampler.sample(torch.Generator(dev).manual_seed(41), x=xs, n_steps=N_STEPS)
    traj = sampler.sample(torch.Generator(dev).manual_seed(42), x=xs, n_steps=N_STEPS, thin=10,
                          return_trajectory=True)
    launches = read_counts(ops, "sharded config 1", ["mixture_langevin_chain",
                                                      "mixture_langevin_chain_trajectory"])
    plain_final = sampler.sample(torch.Generator(dev).manual_seed(41), x=x0, n_steps=N_STEPS)
    plain_traj = sampler.sample(torch.Generator(dev).manual_seed(42), x=x0, n_steps=N_STEPS,
                                thin=10, return_trajectory=True)
    errs = {"sample": max_err(final.full_tensor(), plain_final),
            "sample trajectory": max_err(traj.full_tensor(), plain_traj)}
    if tuple(final.placements) != tuple(xs.placements) or tuple(traj.shape) != (
            N_CHAINS, N_STEPS // 10, 2):
        raise AssertionError(f"sharded sample: {final.placements}, {tuple(traj.shape)}")
    fl = ops.fused_langevin
    half = N_CHAINS // 2
    kw = dict(scale=float(mix.scale), log_weights=mix.log_weights, seed=2**40 + 17)
    # against the plain version from draws of the target at noise 0.5, where
    # the chains contract, as phase_check's 8-Gaussians checks do
    at_target = mix.sample(torch.Generator(dev).manual_seed(43), N_CHAINS)[half:]
    for name, fn, extra in (("row 4", fl.mixture_langevin_chain, {}),
                            ("row 5", fl.mixture_langevin_chain_trajectory, {"thin": 10})):
        whole = fn(x0, mix.means, N_STEPS, 0.05, **extra, **kw)
        halves = _rows_in_halves(fn, x0, half, mix.means, N_STEPS, 0.05, **extra, **kw)
        errs[f"{name} halves"] = max_err(halves, whole)
        plain = getattr(fl, fn.__name__ + "_plain")
        errs[f"{name} at offset {half} against its plain version"] = max_err(
            fn(at_target, mix.means, CHECK_STEPS, 0.05, 0.5, chain_offset=half, **extra, **kw),
            plain(at_target, mix.means, CHECK_STEPS, 0.05, 0.5, chain_offset=half, **extra,
                  **kw))
    print(f"check: parallel, config 1 ({N_CHAINS} x {N_STEPS}) sharded over ('data',) = (1,) "
          f"against unsharded, rows 4-5 as two launches at offsets 0 and {half} against one, "
          f"the second half at offset {half} against its plain version ({CHECK_STEPS} steps "
          f"from draws of the target at noise 0.5): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {TOL}); radius {float(final.to_local().norm(dim=-1).mean()):.4f} | {card}")
    for key, e in errs.items():
        if not e <= TOL:
            raise AssertionError(f"parallel config 1: {key} differs by {e}")
    return launches


def _par_cd_trainer(dev, tree, mesh=None):
    """Config 3's trainer over the MLPEnergy of the flax tree ``tree``
    (``mlp_energy_from_flax``), sharded by FSDP2 over ``mesh`` when given."""
    from torchebm_tpu_torch.core import as_energy
    from torchebm_tpu_torch.core.trainer import ContrastiveDivergenceTrainer
    from torchebm_tpu_torch.losses import ContrastiveDivergence
    from torchebm_tpu_torch.parallel import fsdp_shard_params
    from torchebm_tpu_torch.samplers import LangevinDynamics
    from torchebm_tpu_torch.utils import mlp_energy_from_flax

    net = mlp_energy_from_flax(tree, device=dev)
    energy = as_energy(net)
    if mesh is not None:
        fsdp_shard_params(net, mesh)
    sampler = LangevinDynamics(energy, step_size=CD_STEP, fused_neural="auto")
    cd = ContrastiveDivergence(model=energy, sampler=sampler, k_steps=CD_K)
    return ContrastiveDivergenceTrainer(cd, learning_rate=CD_LR, ema_decay=0.999), net


def _full(t):
    from torchebm_tpu_torch.parallel.mesh import is_dtensor

    return (t.full_tensor() if is_dtensor(t) else t).detach()


def _par_cd(ops, dev, mesh, card: str, tmp: str) -> dict:
    """Config 3's CD step under HSDP, through row 13, against the unsharded
    trainer; row 13 as two offset launches; the profile of both steps; a
    DCP save and restore of the sharded state."""
    import numpy as np
    import torch

    from torchebm_tpu_torch.ops import fused_mlp_langevin as nops
    from torchebm_tpu_torch.parallel import shard_batch

    tree = _flax_mlp_tree(np.random.default_rng(43), (2, *CD_HIDDEN))
    ref, ref_net = _par_cd_trainer(dev, tree)
    trainer, net = _par_cd_trainer(dev, tree, mesh)
    placements = {n: str(tuple(p.placements)) if hasattr(p, "placements") else "plain"
                  for n, p in net.named_parameters()}
    batches = _cd_batches(dev, torch.Generator(dev).manual_seed(44), PAR_CD_STEPS, seed=44)
    ref_state = ref.init_state(ref_net, torch.Generator(dev).manual_seed(45))
    state = trainer.init_state(net, torch.Generator(dev).manual_seed(45))
    losses = []
    for b in batches:
        ref_state, m_ref = ref.train_step(ref_state, b)
    ops.reset_launch_counts()
    for b in batches:
        state, m = trainer.train_step(state, shard_batch(b, mesh))
        losses.append(m["loss"])
    launches = read_counts(ops, "HSDP CD, config 3", ["mlp_langevin_chain"])
    ref_params = dict(ref_net.named_parameters())
    loss_err = abs(float(torch.stack(losses)[-1]) - float(m_ref["loss"]))
    param_err = max(max_err(_full(p), ref_params[n].detach()) for n, p in net.named_parameters())
    ema_err = max(max_err(_full(v), ref_state.ema_params[n])
                  for n, v in state.ema_params.items())
    kept = {n: str(tuple(p.placements)) if hasattr(p, "placements") else "plain"
            for n, p in net.named_parameters()}
    layers = nops.extract_mlp_layers(ref_net)
    x0 = batches[0].contiguous()
    seed = torch.tensor(46, device=dev)
    whole = nops.mlp_langevin_chain(x0, layers, CD_K, CD_STEP, seed=seed)
    half = CD_BATCH // 2
    halves = _rows_in_halves(nops.mlp_langevin_chain, x0, half, layers, CD_K, CD_STEP, seed=seed)
    plain = nops.mlp_langevin_chain_plain(x0[half:], layers, CD_K, CD_STEP, seed=46,
                                          chain_offset=half)
    at_offset = nops.mlp_langevin_chain(x0[half:], layers, CD_K, CD_STEP, seed=seed,
                                        chain_offset=half)
    errs = {"row 13 halves": max_err(halves, whole),
            f"row 13 at offset {half} against its plain version": max_err(at_offset, plain)}
    print(f"check: parallel, config 3's CD step under HSDP over ('data', 'fsdp') = (1, 1) "
          f"(weights from the flax layout by mlp_energy_from_flax; placements {placements}), "
          f"{PAR_CD_STEPS} steps against the unsharded trainer: last loss "
          f"{float(m_ref['loss']):.6f}, "
          f"|loss error| {loss_err:.3e}, parameters {param_err:.3e}, EMA {ema_err:.3e} "
          f"(tol {PAR_CD_TOL:g}); placements kept {kept == placements}; "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (tol {TOL}) | {card}")
    if not (loss_err <= PAR_CD_TOL and param_err <= PAR_CD_TOL and ema_err <= PAR_CD_TOL):
        raise AssertionError("the HSDP CD step drifts from the unsharded trainer")
    if kept != placements or "Shard" not in "".join(placements.values()):
        raise AssertionError(f"HSDP placements: {placements} -> {kept}")
    for key, e in errs.items():
        if not e <= TOL:
            raise AssertionError(f"parallel: {key} differs by {e}")

    b_sharded = shard_batch(batches[-1], mesh)
    profile_calls({
        "CD train step, config 3, neural kernel, unsharded":
            lambda: ref.train_step(ref_state, batches[-1]),
        "CD train step, config 3, neural kernel, HSDP (1, 1)":
            lambda: trainer.train_step(state, b_sharded),
    }, card, require_events=True)

    trainer.save(state, tmp)
    saved = {n: _full(p).clone() for n, p in net.named_parameters()}
    saved_ema = {n: _full(v).clone() for n, v in state.ema_params.items()}
    fresh_trainer, fresh = _par_cd_trainer(
        dev, _flax_mlp_tree(np.random.default_rng(47), (2, *CD_HIDDEN)), mesh)
    restored = fresh_trainer.restore(tmp, fresh_trainer.init_state(
        fresh, torch.Generator(dev).manual_seed(48)))
    exact = (all(torch.equal(_full(p), saved[n]) for n, p in fresh.named_parameters())
             and all(torch.equal(_full(v), saved_ema[n]) for n, v in restored.ema_params.items())
             and restored.step == state.step
             and torch.equal(restored.generator.get_state(), state.generator.get_state()))
    restored, m_next = fresh_trainer.train_step(restored, b_sharded)
    files = sorted(p.name for p in (Path(tmp) / f"step_{state.step:08d}").iterdir())
    print(f"check: parallel, DCP save and restore of the sharded CD state at step {state.step} "
          f"({files}): parameters, EMA, step and generator bitwise {exact}; one more step, loss "
          f"{float(m_next['loss']):.6f} at step {restored.step} | {card}")
    if not exact or restored.step != state.step + 1 or not math.isfinite(float(m_next["loss"])):
        raise AssertionError("the DCP round trip of the sharded CD state failed")
    return launches


def _par_dit(dev, mesh, card: str) -> None:
    """The DiT-768x12 train step under HSDP on the (1, 1) mesh, f32 and bf16:
    loss and gradients against the unsharded model on the same weights
    (``path_dit``'s fresh model with every leaf moved by N(0, 0.02^2)) and
    batch, then ms per step of each by CUDA events, and each step's wall,
    device busy time, idle share and device time by class (profiled)."""
    import torch

    from torchebm_tpu_torch.parallel import fsdp_shard_params, shard_batch

    for dtype_name in ("float32", "bfloat16"):
        _release()
        g = torch.Generator(dev).manual_seed(63)
        ref = _dit(dev, dtype_name, seed=62)
        with torch.no_grad():  # every leaf moved, so that every gradient is nonzero
            for p in ref.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=g, device=dev))
        hsdp = _dit(dev, dtype_name, seed=62)
        hsdp.load_state_dict(ref.state_dict())
        models = {"unsharded": ref, "HSDP": fsdp_shard_params(hsdp, mesh)}
        size = DIT_KW["input_size"]
        x = torch.randn((DIT_BATCH, DIT_KW["in_channels"], size, size), generator=g, device=dev)
        cond = torch.randn((DIT_BATCH, DIT_KW["cond_dim"]), generator=g, device=dev)
        target = torch.randn(x.shape, generator=g, device=dev)
        xs, cs = shard_batch(x, mesh).to_local(), shard_batch(cond, mesh).to_local()
        grads, loss = {}, {}
        for label, model in models.items():
            out = model(xs, cs) if label == "HSDP" else model(x, cond)
            step_loss = torch.mean(torch.square(out - target))
            step_loss.backward()
            loss[label] = step_loss.detach()
            grads[label] = {n: _full(p.grad) for n, p in model.named_parameters()}
        gerr = {n: _rel(grads["HSDP"][n], grads["unsharded"][n]) for n in grads["unsharded"]
                if grads["unsharded"][n].abs().max() > 0}
        worst = max(gerr, key=gerr.get)
        lerr = _rel(loss["HSDP"], loss["unsharded"])
        sharded = sum(hasattr(p, "placements") for p in models["HSDP"].parameters())
        ms, steps = {}, {}
        for label, model in models.items():
            model.zero_grad(set_to_none=True)
            opt = torch.optim.AdamW(model.parameters() if label == "unsharded" else [
                {"params": [p for p in model.parameters() if hasattr(p, "placements")]},
                {"params": [p for p in model.parameters() if not hasattr(p, "placements")]}],
                lr=DIT_LR, weight_decay=DIT_DECAY)
            inputs = (xs, cs) if label == "HSDP" else (x, cond)

            def step(model=model, opt=opt, inputs=inputs):
                torch.mean(torch.square(model(*inputs) - target)).backward()
                opt.step()
                opt.zero_grad(set_to_none=True)

            ms[label] = statistics.median(cuda_times(step, DIT_WARMUP, PAR_DIT_STEPS))
            steps[f"DiT-768x12 train step {dtype_name} (batch {DIT_BATCH}), {label}"] = step
        profile_calls(steps, card, require_events=True)
        print(f"check: parallel, DiT-768x12 train step under HSDP over ('data', 'fsdp') = "
              f"(1, 1), "
              f"{dtype_name} ({sharded} of {len(grads['unsharded'])} parameters sharded by "
              f"FSDP2): loss {float(loss['unsharded']):.5f}, relative error {lerr:.3e} (gate "
              f"{PARITY_FWD_RTOL:g}); gradients, worst of {len(gerr)} {gerr[worst]:.3e} "
              f"({worst}; "
              f"gate {PARITY_GRAD_RTOL:g}); ms per step (CUDA events, median of {PAR_DIT_STEPS} "
              f"after {DIT_WARMUP}): HSDP {ms['HSDP']:.3f}, unsharded {ms['unsharded']:.3f} "
              f"| {card}")
        if not (lerr <= PARITY_FWD_RTOL and gerr[worst] <= PARITY_GRAD_RTOL) or not sharded:
            raise AssertionError(f"the HSDP DiT step ({dtype_name}) differs from the "
                                 "unsharded one")
        del models, grads, ref, hsdp
    _release()


def _par_sinkhorn(ops, dev, mesh, card: str) -> dict:
    """``SinkhornCoupling`` on a sharded batch of FLOW_BATCH through row 14
    against the unsharded call."""
    import torch

    from torchebm_tpu_torch.couplings import SinkhornCoupling
    from torchebm_tpu_torch.parallel import shard_batch

    x1 = _flow_batch(dev)
    x0 = torch.randn(x1.shape, generator=torch.Generator(dev).manual_seed(48), device=dev)
    coupling = _config5_coupling("auto")
    ops.reset_launch_counts()
    got = coupling(shard_batch(x0, mesh), shard_batch(x1, mesh),
                   generator=torch.Generator(dev).manual_seed(49))
    launches = read_counts(ops, "sharded Sinkhorn coupling", ["sinkhorn_log_fused"])
    want = coupling(x0, x1, generator=torch.Generator(dev).manual_seed(49))
    err = max_err(got.x1.full_tensor(), want.x1)
    print(f"check: parallel, SinkhornCoupling (config 5's) on a sharded batch of {x0.shape[0]} "
          f"against the unsharded call: x1 {err:.3e}, placements {tuple(got.x1.placements)}, "
          f"{launches['sinkhorn_log_fused']} row-14 launch | {card}")
    if not err <= TOL or launches["sinkhorn_log_fused"] != 1:
        raise AssertionError("the sharded Sinkhorn coupling differs from the unsharded call")
    return launches


def _on_rows(x, mesh, dim):
    """``x`` split on ``dim`` over the mesh, or replicated (``dim`` None)."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from torchebm_tpu_torch.parallel import replicate

    return replicate(x, mesh) if dim is None else distribute_tensor(x, mesh, [Shard(dim)])


#: the sharded samplers' kernels: every chain kernel with a chain offset
#: that a sampler reaches (row 4 through gradient descent)
PAR_SAMPLER_KERNELS = ("doublewell_langevin_chain", "doublewell_langevin_chain_trajectory",
                       "mixture_langevin_chain", "mixture_mala_chain",
                       "mixture_mala_chain_trajectory", "mixture_hmc_chain",
                       "mixture_hmc_chain_trajectory", "pt_langevin_chain",
                       "pt_langevin_chain_trajectory", "mixture_ais_run")
#: draws and warmup transitions of the loops in the sharded samplers' path
PAR_NUTS_DRAWS, PAR_RMHMC_DRAWS, PAR_WARMUP = 10, 5, 20


def _par_sampler_calls(dev):
    """``{label: (run, x, row dim)}`` of the sharded samplers' path:
    ``run(x, generator)`` returns ``(states, statistics)`` of one call at its
    main shape on the batch ``x`` (plain or sharded; AIS's ``x`` is its
    schedule, replicated)."""
    import torch

    from torchebm_tpu_torch.core import DoubleWellEnergy, GaussianEnergy, GaussianMixtureEnergy
    from torchebm_tpu_torch.samplers import (
        GradientDescentSampler,
        HamiltonianMonteCarlo,
        LangevinDynamics,
        MetropolisAdjustedLangevin,
        NoUTurnSampler,
        ParallelTemperingLangevin,
        RiemannianManifoldHMC,
        annealed_importance_sampling,
    )

    g = torch.Generator(dev).manual_seed(70)
    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    corr = _corr_gaussian(dev)
    x0 = torch.randn((N_CHAINS, 2), generator=g, device=dev)
    mala = MetropolisAdjustedLangevin(mix, step_size=0.05)
    hmc = HamiltonianMonteCarlo(mix, step_size=0.3, n_leapfrog_steps=HMC_LEAPFROG)
    pt = ParallelTemperingLangevin(mix, temperatures=PT_TEMPS, step_size=0.05,
                                   swap_every=PT_SWAP_EVERY)
    dw = LangevinDynamics(DoubleWellEnergy(), step_size=0.01)
    base = GaussianEnergy.create(torch.zeros(2), AIS_BASE_VAR * torch.eye(2)).to(dev)
    nuts = NoUTurnSampler(corr, step_size=NUTS_STEP, max_tree_depth=NUTS_DEPTH)
    warm = HamiltonianMonteCarlo(corr, step_size=0.2, n_leapfrog_steps=HMC_LEAPFROG)
    rmhmc = RiemannianManifoldHMC(corr, metric_fn=_identity_metric, step_size=0.3,
                                  n_leapfrog_steps=RMHMC_LEAPFROG)

    def states(*xs):
        return xs, {}

    def ais(betas, gen):
        r = annealed_importance_sampling(gen, mix, base=base, n_samples=AIS_CHAINS,
                                         step_size=0.05, betas=betas)
        return (r.samples, r.log_weights), {k: getattr(r, k) for k in (
            "log_z", "ess", "acceptance_rate")}

    def run_replicas(ladder, gen):
        out, acc = pt.run_replicas(gen, ladder, N_STEPS)
        return (out,), {"swap acceptance": acc}

    def nuts_draws(x, gen):
        out, diag = nuts.sample(gen, x=x, n_steps=PAR_NUTS_DRAWS, return_diagnostics=True)
        return (out,), diag

    def warmup(x, gen):
        out, eps, mass = warm.warmup(gen, x=x, n_warmup=PAR_WARMUP, adapt_mass=True)
        return (out, mass), {"step size": torch.tensor(eps)}

    traj = dict(thin=10, return_trajectory=True)
    return {
        "MALA sample": (lambda x, gen: states(mala.sample(gen, x=x, n_steps=N_STEPS)), x0, 0),
        "MALA trajectory": (lambda x, gen: states(mala.sample(gen, x=x, n_steps=N_STEPS,
                                                              **traj)), x0, 0),
        "HMC sample": (lambda x, gen: states(hmc.sample(gen, x=x, n_steps=N_STEPS)), x0, 0),
        "HMC trajectory": (lambda x, gen: states(hmc.sample(gen, x=x, n_steps=N_STEPS, **traj)),
                           x0, 0),
        "PT sample": (lambda x, gen: states(pt.sample(gen, x=x, n_steps=N_STEPS)), x0, 0),
        "PT trajectory": (lambda x, gen: states(pt.sample(gen, x=x, n_steps=N_STEPS, **traj)),
                          x0, 0),
        "PT run_replicas": (run_replicas, torch.randn((len(PT_TEMPS), N_CHAINS, 2),
                                                      generator=g, device=dev), 1),
        "AIS": (ais, torch.linspace(0.0, 1.0, AIS_RUNGS + 1, device=dev), None),
        "double well": (lambda x, gen: states(dw.sample(gen, x=x, n_steps=N_STEPS)),
                        0.5 * torch.randn(DW_SHAPE, generator=g, device=dev), 0),
        "double-well trajectory": (lambda x, gen: states(dw.sample(gen, x=x, n_steps=N_STEPS,
                                                                   **traj)),
                                   0.5 * torch.randn(DW_SHAPE, generator=g, device=dev), 0),
        "gradient descent": (lambda x, gen: states(GradientDescentSampler(
            mix, step_size=0.05).sample(gen, x=x, n_steps=N_STEPS)), x0, 0),
        "NUTS": (nuts_draws, torch.randn((NUTS_CHAINS, 2), generator=g, device=dev), 0),
        "RMHMC": (lambda x, gen: states(rmhmc.sample(gen, x=x, n_steps=PAR_RMHMC_DRAWS)),
                  torch.randn((RMHMC_CHAINS, 2), generator=g, device=dev), 0),
        "HMC warmup": (warmup, x0, 0),
    }


def _par_samplers(ops, dev, mesh, card: str) -> dict:
    """Every sampler with a chain kernel (rows 2-3 and 6-12; gradient descent
    through row 4), NUTS and RMHMC on their loops and the HMC warmup, each on
    a batch sharded over ``mesh`` at its main shape, against the unsharded
    call from the same seed: states bitwise, pooled statistics to 1e-6
    relative. Launches are counted over the sharded calls only."""
    import torch

    from torchebm_tpu_torch.parallel.mesh import is_dtensor

    calls = _par_sampler_calls(dev)
    inputs = {label: _on_rows(x, mesh, dim) for label, (_, x, dim) in calls.items()}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = {label: run(inputs[label], torch.Generator(dev).manual_seed(71 + i))
           for i, (label, (run, _, _)) in enumerate(calls.items())}
    launches = read_counts(ops, "sharded samplers", PAR_SAMPLER_KERNELS)
    wall = time.perf_counter() - t0
    report, bad = [], []
    for i, (label, (run, x, dim)) in enumerate(calls.items()):
        want = run(x, torch.Generator(dev).manual_seed(71 + i))
        outs, stats = got[label]
        kept = all(not is_dtensor(o) or tuple(o.placements) == tuple(inputs[label].placements)
                   for o in outs if dim is not None)
        exact = all(torch.equal(o.full_tensor() if is_dtensor(o) else o, w)
                    for o, w in zip(outs, want[0]))
        rel = max((float((v - want[1][k]).abs().max()) / max(1.0, float(want[1][k].abs().max()))
                   for k, v in stats.items()), default=0.0)
        report.append(f"{label} {'bitwise' if exact else 'DIFFERS'}"
                      + (f", statistics {rel:.1e}" if stats else ""))
        if not (exact and kept and rel <= 1e-6):
            bad.append(label)
    print(f"check: parallel, every sampler on a batch sharded over ('data',) = (1,) at its main "
          f"shape ({N_CHAINS} chains x {N_STEPS} steps for MALA, HMC, PT and gradient "
          f"descent, PT's {len(PT_TEMPS)}-replica ladder sharded on its chains, AIS "
          f"{AIS_CHAINS} x {AIS_RUNGS} rungs split over the mesh, the double well "
          f"{DW_SHAPE[0]}x{DW_SHAPE[1]}, NUTS {NUTS_CHAINS} x {PAR_NUTS_DRAWS} draws, RMHMC "
          f"{RMHMC_CHAINS} x {PAR_RMHMC_DRAWS}, the HMC warmup {N_CHAINS} x {PAR_WARMUP}) "
          f"against the unsharded call: " + "; ".join(report)
          + f"; the sharded calls {wall:.2f} s of wall time | {card}")
    if bad:
        raise AssertionError(f"sharded samplers differ from the unsharded calls: {bad}")
    return launches


def _par_offsets(ops, dev, card: str) -> None:
    """Rows 2-3 and 6-12 as two launches over the halves of the main shape's
    batch at their chain offsets (the ladder also at its whole chain count)
    against one launch, bitwise; and the second half at its offset against
    its plain version over CHECK_STEPS steps from draws of the target (the
    flip rule of the module docstring for the Metropolis and exchange
    decisions)."""
    import torch

    from torchebm_tpu_torch.core import GaussianMixtureEnergy

    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    g = torch.Generator(dev).manual_seed(75)
    mix_kw = dict(scale=float(mix.scale), log_weights=mix.log_weights, seed=2**40 + 19)
    x0 = torch.randn((N_CHAINS, 2), generator=g, device=dev)
    at_target = mix.sample(g, N_CHAINS)
    ladder = torch.randn((len(PT_TEMPS), N_CHAINS, 2), generator=g, device=dev)
    ladder_target = torch.stack([mix.sample(g, N_CHAINS) for _ in PT_TEMPS])
    xdw = 0.5 * torch.randn(DW_SHAPE, generator=g, device=dev)
    betas = torch.linspace(0.0, 1.0, AIS_RUNGS + 1, device=dev)
    s0 = AIS_BASE_VAR ** 0.5
    x_ais = s0 * torch.randn((AIS_CHAINS, 2), generator=g, device=dev)
    ais_args = (torch.zeros(2, device=dev), s0, mix.means)
    pt_args = (mix.means, N_STEPS, 0.05, 1.0, tuple(1.0 / t for t in PT_TEMPS), PT_SWAP_EVERY)
    pt_check = (mix.means, CHECK_STEPS, 0.05, 1.0, tuple(1.0 / t for t in PT_TEMPS),
                PT_SWAP_EVERY)
    ais_group = ops.fused_ais.ais_launch_plan(AIS_CHAINS, 2, mix.means.shape[0], False)[0]
    fl, fm, fh, fp, fa = (ops.fused_langevin, ops.fused_mala, ops.fused_hmc, ops.fused_pt,
                          ops.fused_ais)
    # (row, wrapper, whole batch, row dim, per-row elements, args, keywords,
    #  the offset half's start for the plain check, its args)
    rows = [
        ("2", fl.doublewell_langevin_chain, xdw, 0, DW_SHAPE[1], (N_STEPS, 0.01), {},
         xdw, (CHECK_STEPS, 0.01)),
        ("3", fl.doublewell_langevin_chain_trajectory, xdw, 0, DW_SHAPE[1], (N_STEPS, 0.01),
         dict(thin=10), xdw, (CHECK_STEPS, 0.01)),
        ("6", fm.mixture_mala_chain, x0, 0, 1, (mix.means, N_STEPS, 0.05), {},
         at_target, (mix.means, CHECK_STEPS, 0.05)),
        ("7", fm.mixture_mala_chain_trajectory, x0, 0, 1, (mix.means, N_STEPS, 0.05),
         dict(thin=10), at_target, (mix.means, CHECK_STEPS, 0.05)),
        ("8", fh.mixture_hmc_chain, x0, 0, 1, (mix.means, N_STEPS, 0.3, HMC_LEAPFROG), {},
         at_target, (mix.means, CHECK_STEPS, 0.05, HMC_LEAPFROG)),
        ("9", fh.mixture_hmc_chain_trajectory, x0, 0, 1,
         (mix.means, N_STEPS, 0.3, HMC_LEAPFROG), dict(thin=10), at_target,
         (mix.means, CHECK_STEPS, 0.05, HMC_LEAPFROG)),
        ("10", fp.pt_langevin_chain, ladder, 1, 1, pt_args, {}, ladder_target, pt_check),
        ("11", fp.pt_langevin_chain_trajectory, ladder, 1, 1, pt_args, dict(thin=10),
         ladder_target, pt_check),
        # the AIS plan doubles the group while n G <= 32,768: the halves run at
        # the whole batch's group, whose summation order they then share
        ("12", lambda *a, **k: fa._run(*a, group=ais_group, **k)[:3], x_ais, 0, 1,
         (*ais_args, betas, 0.05), {}, x_ais,
         (*ais_args, betas[:CHECK_STEPS + 1] / betas[CHECK_STEPS], 0.05)),
    ]
    report, errors = [], {}
    for row, fn, x, dim, per_row, args, kw, x_check, check_args in rows:
        n = x.shape[dim]
        name = "mixture_ais_run" if row == "12" else fn.__name__
        half = n // 2
        kw = dict(kw, **(dict(seed=2**40 + 19) if row in ("2", "3") else mix_kw))
        if dim == 1:
            kw["total_chains"] = n
        whole = fn(x, *args, **kw)
        parts = [fn(x.narrow(dim, a, b - a).contiguous(), *args, chain_offset=a * per_row, **kw)
                 for a, b in ((0, half), (half, n))]
        whole, *parts = [p if isinstance(p, tuple) else (p,) for p in (whole, *parts)]
        # a trajectory or a ladder holds the chains on dim 1; the ladder's
        # 0-d acceptance is a mean over the chains
        exact = all(torch.equal(torch.cat([a, b], dim=1 if w.ndim == 3 else 0), w)
                    for w, a, b in zip(whole, *parts) if w.ndim)
        # the second half at its offset against its plain version
        xc = x_check.narrow(dim, half, n - half).contiguous()
        ckw = dict(kw, chain_offset=half * per_row)
        if row in ("2", "3"):
            got, want = (fn(xc, *check_args, **ckw),
                         getattr(fl, name + "_plain")(xc, *check_args, **ckw))
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            errors[name] = max(float((u - v).abs().max()) for u, v in zip(got, want))
        else:
            _check_flips(ops, name, (xc, *check_args), ckw, f"offset {half}", errors,
                         xc.shape[dim])
        report.append(f"row {row} halves {'bitwise' if exact else 'DIFFER'}, offset half "
                      f"against plain {errors[name]:.2e}")
        if not exact or not errors[name] <= TOL:
            raise AssertionError(f"row {row}: offset halves bitwise {exact}, plain "
                                 f"{errors[name]}")
    print(f"check: parallel, rows 2-3 and 6-12 as two launches at chain offsets 0 and n/2 "
          f"(per element for the double well; the ladder at total_chains n) against one "
          f"launch at the main shapes, and the offset half against its plain version over "
          f"{CHECK_STEPS} steps from draws of the target (AIS over {CHECK_STEPS} rungs; tol "
          f"{TOL}): " + "; ".join(report) + f" | {card}")


def _par_flow(ops, dev, mesh, card: str) -> dict:
    """``FlowSampler`` on a batch of GEN_SAMPLES sharded over ``mesh`` against
    the unsharded call from the same seed, bitwise: Euler and dopri5
    generation from config 5's EqM field, SDE generation and ``log_prob``
    (exact and Hutchinson, LOGP_SAMPLES samples) from the exact Gaussian
    velocity, and ReflowCoupling through the EqM field; the outputs laid out
    as the input."""
    import torch

    from torchebm_tpu_torch.couplings import ReflowCoupling
    from torchebm_tpu_torch.parallel import shard_batch
    from torchebm_tpu_torch.samplers import FlowSampler

    eqm, ode = _config5_field(dev), FlowSampler(model=_gauss_velocity(dev)[0])
    x0 = torch.randn((GEN_SAMPLES, 2), generator=torch.Generator(dev).manual_seed(151),
                     device=dev)
    cases = {
        "euler": (x0, lambda x, g: FlowSampler(model=eqm, negate_velocity=True, integrator="euler")
                  .sample(g, x=x, n_steps=GEN_STEPS)),
        "dopri5": (x0, lambda x, g: FlowSampler(model=eqm, negate_velocity=True).sample(
            g, x=x, n_steps=GEN_STEPS)),
        "sde": (x0, lambda x, g: FlowSampler(model=ode.model, mode="sde").sample(
            g, x=x, n_steps=SDE_STEPS)),
        "log_prob": (x0[:LOGP_SAMPLES], lambda x, g: ode.log_prob(x, n_steps=LOGP_STEPS)),
        "log_prob hutchinson": (x0[:LOGP_SAMPLES], lambda x, g: ode.log_prob(
            x, generator=g, n_steps=LOGP_STEPS, hutchinson=True, n_probes=2)),
        "reflow": (x0, lambda x, g: ReflowCoupling(model=FlowSampler(
            model=eqm, negate_velocity=True))(x, generator=g).x1),
    }
    report, bad = [], []
    for i, (label, (x, run)) in enumerate(cases.items()):
        xs = shard_batch(x, mesh)
        got = run(xs, torch.Generator(dev).manual_seed(152 + i))
        want = run(x, torch.Generator(dev).manual_seed(152 + i))
        exact = torch.equal(got.full_tensor(), want)
        kept = tuple(got.placements) == tuple(xs.placements)
        report.append(f"{label} {'bitwise' if exact else 'DIFFERS'}"
                      + ("" if kept else f", placements {tuple(got.placements)}"))
        if not (exact and kept):
            bad.append(label)
    print(f"check: parallel, FlowSampler on a batch of {GEN_SAMPLES} ({LOGP_SAMPLES} for log_prob) "
          f"sharded over ('data',) = (1,) against the unsharded call: " + "; ".join(report)
          + f" | {card}")
    if bad:
        raise AssertionError(f"sharded FlowSampler calls differ from the unsharded ones: {bad}")
    return {}


@contextlib.contextmanager
def _world_of_one():
    """A real NCCL world of one, brought up by ``init_distributed`` from
    torchrun's variables (set for the world's lifetime) and torn down after."""
    import os

    import torch.distributed as dist

    from torchebm_tpu_torch.parallel import init_distributed, is_distributed

    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE="1", RANK="0",
               LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        rank_world = init_distributed()
        backend = dist.get_backend()
        if rank_world != (0, 1) or backend != "nccl" or is_distributed():
            raise AssertionError(f"init_distributed gave {rank_world} on {backend}")
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def path_parallel(ops, dev, card: str) -> dict:
    """The distributed layer on the card: a real NCCL world of one brought up
    by ``init_distributed`` from torchrun's environment and torn down at the
    end, meshes ``("data",) = (1,)`` and ``("data", "fsdp") = (1, 1)``;
    sharded config 1 (rows 4-5), every other sampler on a sharded batch at
    its main shape (rows 2-3 and 6-12, gradient descent through row 4; NUTS,
    RMHMC and the HMC warmup on their loops), config 3's CD step under HSDP
    (row 13) with a DCP round trip, the DiT-768x12 step under HSDP, the
    Sinkhorn coupling on a sharded batch (row 14), ``FlowSampler`` and
    ``ReflowCoupling`` on a sharded batch; then rows 2-3 and 6-12 as two
    offset launches against one. Cross-process behaviour is the CPU tests'
    and ``tests/torch_dist_worker.py``'s under ``torchrun``; NCCL takes one
    rank per card."""
    import tempfile

    from torchebm_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    launches = dict.fromkeys(ops.launch_counts(), 0)
    with _world_of_one():
        mesh1 = make_mesh(("data",))
        mesh2 = make_mesh(("data", "fsdp"), (1, 1))
        print(f"main path: parallel: NCCL world of one by init_distributed, meshes "
              f"{mesh1} and {mesh2} | {card}")
        with tempfile.TemporaryDirectory() as tmp:
            for part in (_par_langevin(ops, dev, mesh1, card),
                         _par_samplers(ops, dev, mesh1, card),
                         _par_cd(ops, dev, mesh2, card, tmp),
                         _par_sinkhorn(ops, dev, mesh1, card),
                         _par_flow(ops, dev, mesh1, card)):
                for name, n in part.items():
                    launches[name] += n
        _par_offsets(ops, dev, card)
        _par_dit(dev, mesh2, card)
    print(f"main path: parallel: {time.perf_counter() - t0:.1f} s of wall time, launches "
          f"{ {k: v for k, v in launches.items() if v} } | {card}")
    return launches


def offset_ab(ops, dev, card: str) -> None:
    """Rows 2-13 but 1 by device time per call at their main shapes through
    the public wrappers at their default arguments (no ``chain_offset``: an
    earlier checkout's wrappers take none), against whichever package is
    imported: ``PYTHONPATH=<checkout> python3 -P chip_smoke.py
    --offset-shape``. Rows 2-3: 4,096 x 32 x 1,000 (thin 10), an int seed;
    4-5: config 1's 10,000 x 1,000 ring (thin 10), the schedule as device
    tables; 6-9: the ring at 10,000 x 1,000 (HMC 8 leapfrog steps), thin 10;
    10-11: :func:`pt_main_shape` (thin 10); 12: the ring of
    :func:`ais_main_shapes`; 13: config 3's 256 x 2 x 10 steps on
    MLP(128, 128)."""
    import torch

    from torchebm_tpu_torch.core import GaussianMixtureEnergy
    from torchebm_tpu_torch.ops import fused_mlp_langevin as nops

    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    g = torch.Generator(dev).manual_seed(50)
    x0 = torch.randn((N_CHAINS, 2), generator=g, device=dev)
    kw = dict(scale=float(mix.scale), log_weights=mix.log_weights, seed=51)
    # the schedule as device tables: no pageable copy for the host to wait on
    eta = torch.full((N_STEPS,), 0.05, device=dev)
    one = torch.ones((N_STEPS,), device=dev)
    fl, fm, fh, fp = ops.fused_langevin, ops.fused_mala, ops.fused_hmc, ops.fused_pt
    layers = _mlp_layers(dev, (2, *CD_HIDDEN), seed=52)
    xm = torch.randn((CD_BATCH, 2), generator=g, device=dev)
    xdw = 0.5 * torch.randn(DW_SHAPE, generator=g, device=dev)
    pt_args, pt_kw = pt_main_shape(dev)
    _, ais_args, ais_kw, _ = ais_main_shapes(dev)[0]
    calls = {
        "row 2": lambda: fl.doublewell_langevin_chain(xdw, N_STEPS, 0.01, seed=22),
        "row 3": lambda: fl.doublewell_langevin_chain_trajectory(xdw, N_STEPS, 0.01, thin=10,
                                                                 seed=22),
        "row 4": lambda: fl.mixture_langevin_chain(x0, mix.means, N_STEPS, eta, one, **kw),
        "row 5": lambda: fl.mixture_langevin_chain_trajectory(x0, mix.means, N_STEPS, eta, one,
                                                              thin=10, **kw),
        "row 6": lambda: fm.mixture_mala_chain(x0, mix.means, N_STEPS, 0.05, **kw),
        "row 7": lambda: fm.mixture_mala_chain_trajectory(x0, mix.means, N_STEPS, 0.05,
                                                          thin=10, **kw),
        "row 8": lambda: fh.mixture_hmc_chain(x0, mix.means, N_STEPS, 0.3, HMC_LEAPFROG, **kw),
        "row 9": lambda: fh.mixture_hmc_chain_trajectory(x0, mix.means, N_STEPS, 0.3,
                                                         HMC_LEAPFROG, thin=10, **kw),
        "row 10": lambda: fp.pt_langevin_chain(*pt_args, **pt_kw),
        "row 11": lambda: fp.pt_langevin_chain_trajectory(*pt_args, thin=10, **pt_kw),
        "row 12": lambda: ops.fused_ais.mixture_ais_run(*ais_args, **ais_kw),
        "row 13": lambda: nops.mlp_langevin_chain(xm, layers, CD_K, CD_STEP, seed=53),
    }
    for name, fn in calls.items():
        dev_ms = cuda_times(fn, 3, 7, batch=5)
        call_ms = statistics.median(cuda_times(fn, 3, 20))
        print(f"offset-shape: {name}: device ms per call {statistics.median(dev_ms):.4f} "
              f"(readings of 5 calls queued behind a spin: "
              f"{', '.join(f'{v:.4f}' for v in dev_ms)}), per call with the host's "
              f"work {call_ms:.4f} | {ops.__file__} | {card}", flush=True)


def _dit_family_calls(dev) -> dict:
    """The profile phase's calls of the DiT family and score matching: the
    DiT train step in f32 and bf16, the DiT EqM step, CFG generation in f32
    and bf16, and the DSM train step."""
    import torch

    from torchebm_tpu_torch.datasets import make_two_moons
    from torchebm_tpu_torch.losses import DenoisingScoreMatching

    calls = {}
    for name in ("float32", "bfloat16"):
        step = _dit_train_step(dev, name, seed=62)[0]
        calls[f"DiT-768x12 train step {name} (batch {DIT_BATCH})"] = step
    trainer, state, batch = _dit_eqm_step(dev, 85)
    calls[f"DiT-768x12 EqM step, Sinkhorn kernel (batch {DIT_BATCH})"] = (
        lambda: trainer.train_step(state, batch))
    g = torch.Generator(dev).manual_seed(93)
    labels = torch.arange(CFG_SAMPLES, device=dev) % CFG_CLASSES
    for name, net in _label_dits(dev, 94).items():
        sampler = _cfg_sampler(net, CFG_SCALE)
        calls[f"CFG generation LabelDiT-768x12 {name} {CFG_SAMPLES}x{CFG_STEPS}"] = (
            lambda s=sampler: _cfg_generate(s, g, labels))
    dsm, net, _ = _sm_trainer(dev, 106, DenoisingScoreMatching, noise_scale=DSM_NOISE)
    dsm_state = dsm.init_state(net, g)
    moons = make_two_moons(g, CD_BATCH)
    calls[f"DSM train step config 3 net (batch {CD_BATCH})"] = (
        lambda: dsm.train_step(dsm_state, moons))
    return calls

def run_kw(family: str, **kw) -> dict:
    """``fused_mala._run``'s (``family`` "mala") or ``fused_hmc._run``'s
    ("hmc") keywords: ``kw`` over the final state only, unit scale (and
    mass), no weights, precision or injected randomness, seed 21."""
    base = dict(thin=None, scale=1.0, log_weights=None, precision=None, seed=21, noise=None,
                uniforms=None, **(dict(mass=None) if family == "hmc" else {}))
    return {**base, **kw}


def hmc_ess_shape_cases(dev) -> list:
    """Row 9 at the ESS protocol's shape: ``[(label, step, args, kwargs)]`` of
    ``mixture_hmc_chain_trajectory`` on the correlated Gaussian, 10,000
    chains x 4,000 draws thinned by 4, from the warmup's state at its tuned
    step, with unit and with the adapted diagonal mass."""
    from torchebm_tpu_torch.samplers.base import _gaussian_target

    corr_means, corr_prec = _gaussian_target(_corr_gaussian(dev))
    cases = []
    for adapt_mass, label in ((False, "unit mass"), (True, "adapted mass")):
        _, _, (x0, eps, *mass) = _hmc_warmup(dev, adapt_mass)
        cases.append((label, eps, (x0, corr_means, ESS_DRAWS, eps, HMC_LEAPFROG),
                      dict(thin=ESS_THIN, precision=corr_prec.contiguous(),
                           mass=mass[0] if mass else None, seed=21)))
    return cases


def mala_ess_shape_cases(dev) -> list:
    """Row 7 at the ESS protocol's shape: ``[(label, step, args, kwargs)]`` of
    ``mixture_mala_chain_trajectory`` on the correlated Gaussian, 10,000
    chains x 4,000 steps thinned by 4, from exact draws of it at the pilot
    step (the path's own start is a 200-step burn-in)."""
    import torch

    from torchebm_tpu_torch.samplers.base import _gaussian_target

    corr_means, corr_prec = _gaussian_target(_corr_gaussian(dev))
    chol = torch.linalg.cholesky(torch.tensor(CORR_COV, device=dev))
    g = torch.Generator(dev).manual_seed(84)
    x0 = (torch.randn((N_CHAINS, 2), generator=g, device=dev) @ chol.T).contiguous()
    step = _mala_pilot_step(dev)
    return [("pilot step", step, (x0, corr_means, ESS_DRAWS, step),
             dict(thin=ESS_THIN, precision=corr_prec.contiguous(), seed=21))]


def _chain_sweep_cases(family: str, module, dev, ess: list) -> list:
    """The MALA ("mala") or HMC ("hmc") plan sweep's shapes (``SWEEP_*``; the
    ESS shapes ``ess`` of :func:`mala_ess_shape_cases` or
    :func:`hmc_ess_shape_cases`; for HMC also other leapfrog counts):
    ``[(label, run, (n, d, K, gaussian))]``, ``run(group=G)`` one call of the
    chain kernel at G lanes per chain."""
    import torch

    from torchebm_tpu_torch.core import GaussianMixtureEnergy

    extra = (HMC_LEAPFROG,) if family == "hmc" else ()
    g = torch.Generator(dev).manual_seed(55)
    x2 = torch.randn((N_CHAINS, 2), generator=g, device=dev)
    ring8 = GaussianMixtureEnergy.eight_gaussians().to(dev)
    # (label, args, _run keywords, d, K, gaussian)
    cases = []
    for k in SWEEP_RING_K:
        ring = _ring(k).to(dev)
        cases.append((f"ring K={k} d=2 {N_CHAINS}x{N_STEPS}",
                      (x2, ring.means, N_STEPS, 0.2, *extra),
                      dict(scale=float(ring.scale), log_weights=ring.log_weights), 2, k, False))
    for d in SWEEP_MIX_D:
        xd = torch.randn((N_CHAINS, d), generator=g, device=dev)
        for k in SWEEP_MIX_K:
            means = 2.0 * torch.randn((k, d), generator=g, device=dev)
            cases.append((f"mixture K={k} d={d} {N_CHAINS}x{N_STEPS}",
                          (xd, means, N_STEPS, 0.1, *extra), dict(scale=0.8), d, k, False))
    for k in SWEEP_LARGE_K:
        ring = _ring(k).to(dev)
        for n in SWEEP_LARGE_N:
            xn = torch.randn((n, 2), generator=g, device=dev)
            cases.append((f"ring K={k} d=2 {n}x{SWEEP_LARGE_DRAWS}",
                          (xn, ring.means, SWEEP_LARGE_DRAWS, 0.2, *extra),
                          dict(scale=float(ring.scale), log_weights=ring.log_weights), 2, k, False))
    for d in SWEEP_GAUSS_D:
        a = 0.1 * torch.randn((d, d), generator=g, device=dev)
        xd = torch.randn((N_CHAINS, d), generator=g, device=dev)
        cases.append((f"full-covariance Gaussian d={d} {N_CHAINS}x{N_STEPS}",
                      (xd, torch.zeros((1, d), device=dev), N_STEPS, 0.2, *extra),
                      dict(precision=(a @ a.T + torch.eye(d, device=dev)).contiguous()), d, 1,
                      True))
    for label, _, args, kw in ess:
        cases.append((f"ESS shape (corr-Gaussian d=2, {N_CHAINS}x{ESS_DRAWS} thin {ESS_THIN}, "
                      f"{label})", args, kw, 2, 1, True))
    if family == "hmc":
        label, _, args, kw = ess[0]
        for n_lf in SWEEP_LEAPFROG:
            cases.append((f"ring K=8 d=2 {N_CHAINS}x{N_STEPS}, {n_lf} leapfrog",
                          (x2, ring8.means, N_STEPS, 0.3, n_lf),
                          dict(scale=float(ring8.scale), log_weights=ring8.log_weights), 2, 8,
                          False))
            cases.append((f"ESS shape ({label}), {n_lf} leapfrog", (*args[:4], n_lf), kw, 2, 1,
                          True))
    return [(label, functools.partial(module._run, *args, **run_kw(family, **kw)),
             (args[0].shape[0], d, k, gaussian)) for label, args, kw, d, k, gaussian in cases]


def pt_run(fp, replicas, means, n_steps, betas, swap_every, *, thin=None, scale=1.0,
           log_weights=None, precision=None, group=None):
    """One ladder call through ``fused_pt._run`` on the card: step 0.05, noise
    scale 1, Philox seed 21, no clamp; ``group`` overrides the launch plan's."""
    return fp._run(replicas, means, n_steps, 0.05, 1.0, betas, swap_every, thin, scale=scale,
                   log_weights=log_weights, precision=precision, seed=21, clamp=None,
                   noise=None, swap_uniform=None, kernel=True, group=group)


def pt_ladder(n_rep: int) -> tuple:
    """The inverse temperatures of an R-replica ladder spanning the headline
    configuration's temperatures 1 to 4.1 geometrically (PT_TEMPS, to 0.1%,
    at R = 4)."""
    return tuple(PT_TEMPS[-1] ** (-r / (n_rep - 1)) for r in range(n_rep))


def _pt_sweep_cases(fp, dev) -> list:
    """The PT plan sweep's shapes (``SWEEP_PT_*``): ``[(label, run, (n, R, d, K,
    gaussian))]``, ``run(group=G)`` one ladder call at G lanes per replica,
    from N(0, I), at step 0.05 over :func:`pt_ladder`'s temperatures."""
    import torch

    g = torch.Generator(dev).manual_seed(57)
    cases = []

    def add(label, n, n_rep, n_steps, swap_every, means, kw, gaussian):
        d = means.shape[1]
        reps = torch.randn((n_rep, n, d), generator=g, device=dev)
        cases.append((f"{label} R={n_rep} d={d} {n}x{n_steps} swap every {swap_every}",
                      functools.partial(pt_run, fp, reps, means, n_steps, pt_ladder(n_rep),
                                        swap_every, **kw),
                      (n, n_rep, d, means.shape[0], gaussian)))

    def ring(k):
        r = _ring(k).to(dev)
        return r.means, dict(scale=float(r.scale), log_weights=r.log_weights)

    for n_rep in SWEEP_PT_R:
        add("ring K=8", N_CHAINS, n_rep, N_STEPS, PT_SWAP_EVERY, *ring(8), False)
    for k in SWEEP_PT_RING_K:
        add(f"ring K={k}", N_CHAINS, 4, N_STEPS, PT_SWAP_EVERY, *ring(k), False)
    for n_rep in SWEEP_PT_SWAP1_R:
        add("ring K=8", N_CHAINS, n_rep, N_STEPS, 1, *ring(8), False)
    for d in SWEEP_PT_MIX_D:
        for k in SWEEP_PT_MIX_K:
            add(f"mixture K={k}", N_CHAINS, 4, N_STEPS, PT_SWAP_EVERY,
                2.0 * torch.randn((k, d), generator=g, device=dev), dict(scale=0.8), False)
    for d in SWEEP_PT_GAUSS_D:
        a = 0.1 * torch.randn((d, d), generator=g, device=dev)
        add("full-covariance Gaussian", N_CHAINS, 4, N_STEPS, PT_SWAP_EVERY,
            torch.zeros((1, d), device=dev),
            dict(precision=(a @ a.T + torch.eye(d, device=dev)).contiguous()), True)
    for n, n_rep, k, swap_every in SWEEP_PT_LARGE:
        add(f"ring K={k}", n, n_rep, SWEEP_LARGE_DRAWS, swap_every, *ring(k), False)
    return cases


def plan_sweep(family: str, module, dev, card: str, ess: list) -> None:
    """The shapes the launch plan of ``family`` ("mala", "hmc", "pt" or
    "ais") is read from (:func:`_chain_sweep_cases`, :func:`_pt_sweep_cases`,
    :func:`_ais_sweep_cases`): the
    kernel's device time per call (:func:`device_ms`) at every group of lanes
    (per chain, or per replica) it is built for, with the fastest group and
    the plan's pick, and a count of the shapes where the pick is fastest."""
    groups = getattr(module, f"{family}_groups")
    plan = getattr(module, f"{family}_launch_plan")
    cases = (_pt_sweep_cases(module, dev) if family == "pt"
             else _ais_sweep_cases(module, dev) if family == "ais"
             else _chain_sweep_cases(family, module, dev, ess))
    at_pick = 0
    for label, run, shape in cases:
        ms = {group: device_ms(functools.partial(run, group=group))
              for group in groups(*shape[1:])}
        fastest = min(ms, key=ms.get)
        pick = plan(*shape)[0]
        at_pick += fastest == pick
        print(f"sweep: {family.upper()} {label}: device ms per call " + "; ".join(
            f"G={grp} {t:.4f}" for grp, t in ms.items()) + f"; fastest G={fastest}, the plan "
            f"picks G={pick} ({ms[pick] / ms[fastest] - 1:.1%} slower) | {card}", flush=True)
    print(f"sweep: the {family.upper()} plan's pick is the fastest group at {at_pick} of "
          f"{len(cases)} shapes | {card}")


def pt_main_shape(dev):
    """Rows 10-11's main shape, the JAX package's headline PT configuration
    (benchmarks/headline.py:178-220): ``(args, keywords)`` of the public
    ladder wrappers on the ring, a (4, 10,000, 2) ladder from N(0, I), 1,000
    steps at 0.05, noise scale 1, PT_TEMPS, swap every 5, Philox seed 21."""
    import torch

    from torchebm_tpu_torch.core import GaussianMixtureEnergy

    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    ladder = torch.randn((len(PT_TEMPS), N_CHAINS, 2),
                         generator=torch.Generator(dev).manual_seed(5), device=dev)
    return ((ladder, mix.means, N_STEPS, 0.05, 1.0, tuple(1.0 / t for t in PT_TEMPS),
             PT_SWAP_EVERY), dict(scale=float(mix.scale), log_weights=mix.log_weights, seed=21))


def ais_main_shapes(dev) -> list:
    """Row 12's main shapes, the AIS path's (``headline.py:223-289``):
    ``[(label, args, keywords, (n, d, K, gaussian))]`` of the public wrapper
    on the ring at AIS_CHAINS chains and the full-covariance and isotropic
    Gaussians at AIS_GAUSS_CHAINS, from draws of the base N(0, AIS_BASE_VAR
    I), AIS_RUNGS rungs at step 0.05, Philox seed 21, the target arguments
    the sampler passes (written out, so that an earlier revision takes them
    too)."""
    import torch

    g = torch.Generator(dev).manual_seed(61)
    s0 = AIS_BASE_VAR ** 0.5
    betas = torch.linspace(0.0, 1.0, AIS_RUNGS + 1, device=dev)
    shapes = []
    for name, (target, n) in _ais_targets(dev).items():
        if name == "8gauss ring":
            means = target.means
            kw = dict(scale=float(target.scale), log_weights=target.log_weights)
        elif name == "full-cov Gaussian":
            means, kw = target.mean[None, :], dict(precision=target.cov_inv.contiguous(),
                                                   log_norm_t=0.0)
        else:
            means = target.mean[None, :]
            kw = dict(scale=float(target.cov[0, 0]) ** 0.5, log_norm_t=0.0)
        x0 = s0 * torch.randn((n, 2), generator=g, device=dev)
        shapes.append((f"{name} {n}x{AIS_RUNGS} rungs",
                       (x0, torch.zeros(2, device=dev), s0, means, betas, 0.05),
                       dict(kw, seed=21), (n, 2, means.shape[0], "precision" in kw)))
    return shapes


def ais_ab(ops, dev, card: str) -> None:
    """``chip_smoke.py --ais-shape``: row 12 through the public wrapper at
    its main shapes (:func:`ais_main_shapes`), per call and by device time
    per call, against whichever package is imported, so that an earlier
    checkout can be timed beside this one on the same card."""
    for label, args, kw, _ in ais_main_shapes(dev):
        run = functools.partial(ops.fused_ais.mixture_ais_run, *args, **kw)
        ms = statistics.median(cuda_times(run, 2, 10))
        print(f"ais-shape: mixture_ais_run (package {ops.__file__}, {label}): {ms:.4f} ms per "
              f"call, device {device_ms(run):.4f} ms | {card}", flush=True)


def dw_ab(ops, dev, card: str) -> None:
    """``chip_smoke.py --dw-shape``: rows 2-3 through the public wrappers at
    4,096 x 32 elements x 1,000 steps (the trajectory thin 10), an int seed
    and a constant schedule, per call and by device time per call, against
    whichever package is imported, so that an earlier checkout can be timed
    beside this one on the same card."""
    import torch

    fl = ops.fused_langevin
    x0 = 0.5 * torch.randn(DW_SHAPE, generator=torch.Generator(dev).manual_seed(9), device=dev)
    for name, kw in (("doublewell_langevin_chain", {}),
                     ("doublewell_langevin_chain_trajectory", dict(thin=10))):
        run = functools.partial(getattr(fl, name), x0, N_STEPS, 0.01, seed=22, **kw)
        ms = statistics.median(cuda_times(run, 2, 10))
        print(f"dw-shape: {name} (package {ops.__file__}, {DW_SHAPE[0]}x{DW_SHAPE[1]}x{N_STEPS}"
              f"{', thin 10' if kw else ''}): {ms:.4f} ms per call, device "
              f"{device_ms(run):.4f} ms | {card}", flush=True)


def ais_group_timing(ops, dev, card: str, clock: float) -> None:
    """Row 12 at its main shapes (:func:`ais_main_shapes`) at each group of
    lanes per chain its kernel is built for, per call and by device time per
    call, beside the bound; the ring's per-rung slope and intercept of
    device time at AIS_SLOPE_RUNGS rungs (the plan's group); then the AIS
    plan sweep. Launches made here are not counted."""
    import torch

    from torchebm_tpu_torch.ops._counts import work

    fa = ops.fused_ais
    shapes = ais_main_shapes(dev)
    for label, args, kw, shape in shapes:
        b_ms, b_by = bound_of(work("mixture_ais_run", args, kw, fa.mixture_ais_run(*args, **kw)),
                              clock)
        pick = fa.ais_launch_plan(*shape)[0]
        by_group = {}
        for group in fa.ais_groups(*shape[1:]):
            run = functools.partial(fa._run, *args, **kw, group=group)
            by_group[group] = (statistics.median(cuda_times(run, 2, 10)), device_ms(run))
        fastest = min(by_group, key=lambda grp: by_group[grp][1])
        print(f"timing: mixture_ais_run {label}, by lanes per chain G: " + "; ".join(
            f"G={grp} {ms:.4f} ms per call, device {dev_ms:.4f} ms"
            for grp, (ms, dev_ms) in by_group.items())
            + f"; fastest G={fastest}, the plan picks G={pick}; bound {b_ms:.5f} ms by {b_by} "
            f"({b_ms / by_group[pick][1]:.3f} of the bound's rate by device time at the pick) "
            f"| {card}", flush=True)
    label, (x0, mu0, s0, means, _, step), kw, _ = shapes[0]
    tables = {m: torch.linspace(0.0, 1.0, m + 1, device=dev) for m in AIS_SLOPE_RUNGS}
    slope, intercept, times = device_slope(
        lambda m: fa.mixture_ais_run(x0, mu0, s0, means, tables[m], step, **kw), AIS_SLOPE_RUNGS)
    print(f"timing: mixture_ais_run {label.split(' ')[0]} ring {x0.shape[0]} chains, device "
          f"time per call at {AIS_SLOPE_RUNGS} rungs: {times} ms; {slope:.4f} us per rung + "
          f"{intercept:.2f} us per call | {card}", flush=True)
    plan_sweep("ais", fa, dev, card, [])


def _ais_sweep_cases(fa, dev) -> list:
    """The AIS plan sweep's shapes: ``[(label, run, (n, d, K, gaussian))]``,
    ``run(group=G)`` one anneal at G lanes per chain from draws of the base
    N(0, AIS_BASE_VAR I), step 0.05: the ring at AIS_CHAINS chains over 200,
    50 and 1,000 rungs and with 5 transitions per rung, at 1,001 to 8,192
    and at 100,000 and 300,000 chains; rings of K components (K = 16 also at
    4,096 and 100,000 chains); random means of K components at d; the isotropic Gaussian
    (one component) and the full-covariance Gaussian at d, at AIS_CHAINS
    and (d = 2) at 4,096, twice AIS_CHAINS and AIS_GAUSS_CHAINS chains."""
    import torch

    g = torch.Generator(dev).manual_seed(58)
    s0 = AIS_BASE_VAR ** 0.5
    cases = []

    def add(label, n, means, kw, rungs=AIS_RUNGS, n_tr=1):
        d = means.shape[1]
        x0 = s0 * torch.randn((n, d), generator=g, device=dev)
        betas = torch.linspace(0.0, 1.0, rungs + 1, device=dev)
        cases.append((f"{label} d={d} {n}x{rungs} rungs"
                      + (f", {n_tr} transitions" if n_tr > 1 else ""),
                      functools.partial(fa._run, x0, torch.zeros(d, device=dev), s0, means, betas,
                                        0.05, n_transitions=n_tr, seed=21, **kw),
                      (n, d, means.shape[0], kw.get("precision") is not None)))

    def ring(k):
        r = _ring(k).to(dev)
        return r.means, dict(scale=float(r.scale), log_weights=r.log_weights)

    for rungs in (AIS_RUNGS, 50, 1000):
        add("ring K=8", AIS_CHAINS, *ring(8), rungs=rungs)
    add("ring K=8", AIS_CHAINS, *ring(8), n_tr=5)
    for n in (1001, 2048, 4096, 8192, 100_000, 300_000):
        add("ring K=8", n, *ring(8))
    for k in SWEEP_RING_K:
        if k != 8:
            add(f"ring K={k}", AIS_CHAINS, *ring(k))
    add("ring K=16", 4096, *ring(16))
    add("ring K=16", 100_000, *ring(16))
    for d, k in ((3, 2), (3, 8), (3, 16), (4, 8), (5, 2), (5, 8), (8, 2), (8, 8), (16, 2),
                 (16, 8)):
        add(f"mixture K={k}", AIS_CHAINS, 2.0 * torch.randn((k, d), generator=g, device=dev),
            dict(scale=0.8))
    for d, n in ((2, 4096), (2, AIS_CHAINS), (2, 2 * AIS_CHAINS), (2, AIS_GAUSS_CHAINS),
                 (4, AIS_CHAINS), (8, AIS_CHAINS), (16, AIS_CHAINS)):
        add("isotropic Gaussian", n, torch.zeros((1, d), device=dev),
            dict(scale=2.0 ** 0.5, log_norm_t=0.0))
    for d, n in ((2, 4096), (2, AIS_CHAINS), (2, 2 * AIS_CHAINS), (2, AIS_GAUSS_CHAINS),
                 (4, AIS_CHAINS), (8, AIS_CHAINS), (16, AIS_CHAINS), (32, AIS_CHAINS)):
        a = 0.1 * torch.randn((d, d), generator=g, device=dev)
        add("full-covariance Gaussian", n, torch.zeros((1, d), device=dev),
            dict(precision=(a @ a.T + torch.eye(d, device=dev)).contiguous(), log_norm_t=0.0))
    return cases


def phase_ess_shape(ops, dev, card: str) -> None:
    """``chip_smoke.py --ess-shape``: rows 7 and 9 at the ESS protocol's shape,
    rows 10-11 (thin 1) at their main shape (:func:`pt_main_shape`), row
    14 (:func:`sinkhorn_ab`) and row 13 (:func:`mlp_ab`) through the public
    wrappers (the plans' groups
    and clusters), per call and by device time per call. It runs against
    any revision of the package, so an earlier checkout can be timed beside
    this one on the same card:
    ``PYTHONPATH=<checkout> python3 -P chip_smoke.py --ess-shape``."""
    for module, name, cases in (
        (ops.fused_mala, "mixture_mala_chain_trajectory", mala_ess_shape_cases(dev)),
        (ops.fused_hmc, "mixture_hmc_chain_trajectory", hmc_ess_shape_cases(dev)),
    ):
        for label, eps, args, kw in cases:
            run = functools.partial(getattr(module, name), *args, **kw)
            ms = statistics.median(cuda_times(run, 2, 10))
            dev_ms = device_ms(run)
            print(f"ess-shape: {name} (package {ops.__file__}, corr-Gaussian d=2, "
                  f"{N_CHAINS}x{ESS_DRAWS} thin {ESS_THIN}, step {eps:.5f}, {label}): "
                  f"{ms:.4f} ms per call, device {dev_ms:.4f} ms | {card}", flush=True)
    args, kw = pt_main_shape(dev)
    for name, extra in (("pt_langevin_chain", {}), ("pt_langevin_chain_trajectory", dict(thin=1))):
        run = functools.partial(getattr(ops.fused_pt, name), *args, **kw, **extra)
        ms = statistics.median(cuda_times(run, 2, 10))
        dev_ms = device_ms(run)
        print(f"ess-shape: {name} (package {ops.__file__}, 8gauss {N_CHAINS} chains x "
              f"{len(PT_TEMPS)} replicas x {N_STEPS} steps, swap every {PT_SWAP_EVERY}"
              + (", thin 1" if extra else "") + f"): {ms:.4f} ms per call, device "
              f"{dev_ms:.4f} ms | {card}", flush=True)
    sinkhorn_ab(ops, dev, card)
    mlp_ab(ops, dev, card)


def mlp_ab(ops, dev, card: str) -> None:
    """Row 13 through the public wrapper, for ``--ess-shape``: at the CD
    path's 256 x 2 and at 4,096 x 2 on MLP(128, 128) (``extract_mlp_layers``'
    views of a random MLPEnergy), CD_K steps and an int seed (which every
    revision takes): the time per call (wrapper included), the device time
    per call, and the per-step slope and intercept of device time at
    MLP_SLOPE_STEPS steps."""
    import torch

    mlp = ops.fused_mlp_langevin
    layers = _mlp_layers(dev, (2, *CD_HIDDEN), 60)
    g = torch.Generator(dev).manual_seed(8)
    for n in (CD_BATCH, 4096):
        x = torch.randn((n, 2), generator=g, device=dev)
        run = functools.partial(mlp.mlp_langevin_chain, x, layers, CD_K, CD_STEP, 1.0, seed=24)
        ms = statistics.median(cuda_times(run, 2, 10))
        dev_ms = statistics.median(cuda_times(run, 2, 5, batch=10))
        slope, intercept, _ = device_slope(
            lambda k: mlp.mlp_langevin_chain(x, layers, k, CD_STEP, 1.0, seed=24),
            MLP_SLOPE_STEPS)
        print(f"ess-shape: mlp_langevin_chain (package {ops.__file__}, {n}x2, MLP{CD_HIDDEN}, "
              f"{CD_K} steps): {ms:.4f} ms per call, device {dev_ms:.4f} ms; {slope:.3f} us per "
              f"step + {intercept:.2f} us per call | {card}", flush=True)


def sinkhorn_ab(ops, dev, card: str) -> None:
    """Row 14 through the public wrapper, for ``--ess-shape``: at the flow
    path's (256, 256) and at (1,024, 1,024), the per-iteration slope and the
    intercept of device time at tol 0, and the time per call (wrapper
    included) and device time of FLOW_ITERS iterations; and the flow path's
    gated call (FLOW_TOL) at (256, 256)."""
    import torch

    sk = ops.fused_sinkhorn
    g = torch.Generator(dev).manual_seed(7)
    for shape in ((FLOW_BATCH, FLOW_BATCH), (1024, 1024)):
        cost = _pair_cost(g, dev, *shape)
        slope, intercept, times = device_slope(
            lambda k: sk.sinkhorn_log_fused(cost, FLOW_REG, k), SINKHORN_SLOPE_ITERS)
        ms = statistics.median(cuda_times(
            lambda: sk.sinkhorn_log_fused(cost, FLOW_REG, FLOW_ITERS), 2, 10))
        print(f"ess-shape: sinkhorn_log_fused (package {ops.__file__}, {shape[0]}x{shape[1]}, "
              f"reg {FLOW_REG}, tol 0): {slope:.3f} us per iteration, {intercept:.2f} us per "
              f"call besides; {FLOW_ITERS} iterations {ms:.4f} ms per call, device "
              f"{times[-1]:.4f} ms | {card}", flush=True)
        if shape == (FLOW_BATCH, FLOW_BATCH):
            run = functools.partial(sk.sinkhorn_log_fused, cost, FLOW_REG, FLOW_ITERS,
                                    tol=FLOW_TOL)
            iters = int(run(return_iters=True)[1])
            ms = statistics.median(cuda_times(run, 2, 10))
            dev_ms = statistics.median(cuda_times(run, 2, 5, batch=10))
            print(f"ess-shape: sinkhorn_log_fused (package {ops.__file__}, {shape[0]}x{shape[1]}, "
                  f"reg {FLOW_REG}, tol {FLOW_TOL:g}, the flow path's gated call): {iters} "
                  f"iterations, {ms:.4f} ms per call, device {dev_ms:.4f} ms | {card}",
                  flush=True)


def phase_group_timing(ops, dev, card: str) -> None:
    """Rows 6-9 at the main shape (the ring from N(0, I), 10,000 chains x
    1,000 steps or draws) at each group of lanes per chain their kernels are
    built for, per call and by device time per call, beside the bound; rows
    7 and 9 at the ESS protocol's shape (the correlated Gaussian: MALA at the
    pilot step, HMC at the tuned step with unit and adapted mass) at each
    group; then each plan's sweep; then rows 10-11 and row 12 at each group
    (:func:`pt_group_timing`, :func:`ais_group_timing`). Launches made here
    are not counted."""
    import torch

    from torchebm_tpu_torch.core import GaussianMixtureEnergy
    from torchebm_tpu_torch.ops._counts import work

    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    k8 = mix.means.shape[0]
    x2 = torch.randn((N_CHAINS, 2), generator=torch.Generator(dev).manual_seed(5), device=dev)
    ring_kw = dict(scale=float(mix.scale), log_weights=mix.log_weights)
    clock = max_sm_clock_mhz()
    for family, module, args, ess, per in (
        ("mala", ops.fused_mala, (x2, mix.means, N_STEPS, 0.05), mala_ess_shape_cases(dev),
         f"{N_STEPS} steps"),
        ("hmc", ops.fused_hmc, (x2, mix.means, N_STEPS, 0.3, HMC_LEAPFROG),
         hmc_ess_shape_cases(dev), f"{N_STEPS} draws x {HMC_LEAPFROG} leapfrog"),
    ):
        groups = getattr(module, f"{family}_groups")
        picked = getattr(module, f"{family}_launch_plan")(N_CHAINS, 2, k8, False)[0]
        for name, thin in ((f"mixture_{family}_chain", None),
                           (f"mixture_{family}_chain_trajectory", 1)):
            kw = dict(ring_kw, seed=21, **({} if thin is None else dict(thin=thin)))
            b_ms = bound_of(work(name, args, kw, getattr(module, name)(*args, **kw)), clock)[0]
            by_group = {}
            for group in groups(2, k8, False):
                run = functools.partial(module._run, *args, **run_kw(family, thin=thin, **ring_kw),
                                        group=group)
                by_group[group] = (statistics.median(cuda_times(run, 2, 10)), device_ms(run))
            fastest = min(by_group, key=lambda grp: by_group[grp][1])
            print(f"timing: {name} {N_CHAINS}x2x{per}, K={k8}, by lanes per chain G: "
                  + "; ".join(f"G={grp} {ms:.4f} ms per call, device {dev_ms:.4f} ms"
                              for grp, (ms, dev_ms) in by_group.items())
                  + f"; fastest G={fastest}, the plan picks G={picked}; bound {b_ms:.4f} ms "
                  f"| {card}", flush=True)
        name = f"mixture_{family}_chain_trajectory"
        for label, eps, eargs, kw in ess:
            b_ms, b_by = bound_of(work(name, eargs, kw, getattr(module, name)(*eargs, **kw)),
                                  clock)
            for group in groups(2, 1, True):
                run = functools.partial(module._run, *eargs, **run_kw(family, **kw),
                                        group=group)
                ms = statistics.median(cuda_times(run, 2, 10))
                dev_ms = device_ms(run)
                print(f"timing: {name} at the ESS protocol's shape (corr-Gaussian d=2, "
                      f"{N_CHAINS}x{ESS_DRAWS} thin {ESS_THIN}, step {eps:.5f}, {label}) "
                      f"G={group}: {ms:.4f} ms per call, device {dev_ms:.4f} ms; bound "
                      f"{b_ms:.5f} ms by {b_by} ({b_ms / dev_ms:.3f} of the bound's rate by "
                      f"device time) | {card}", flush=True)
        plan_sweep(family, module, dev, card, ess)
    pt_group_timing(ops, dev, card, clock)
    ais_group_timing(ops, dev, card, clock)


def pt_group_timing(ops, dev, card: str, clock: float) -> None:
    """Rows 10-11 (thin 1) at their main shape (:func:`pt_main_shape`) at
    each group of lanes per replica their kernel is built for, per call and
    by device time per call, beside the bound; the host's time per call of
    both public wrappers at the pick and of the trajectory's allocation;
    then the PT plan sweep. Launches made here are not counted."""
    import torch

    from torchebm_tpu_torch.ops._counts import work

    fp = ops.fused_pt
    args, kw = pt_main_shape(dev)
    ladder, means, n_steps, _, _, betas, swap_every = args
    n_rep, n, d = ladder.shape
    k = means.shape[0]
    target = dict(scale=kw["scale"], log_weights=kw["log_weights"])
    groups = fp.pt_groups(n_rep, d, k, False)
    picked = fp.pt_launch_plan(n, n_rep, d, k, False)[0]
    shape = (f"8gauss {n} chains x {n_rep} replicas x {n_steps} steps, swap every "
             f"{swap_every}")
    for name, thin in (("pt_langevin_chain", None), ("pt_langevin_chain_trajectory", 1)):
        extra = {} if thin is None else dict(thin=thin)
        b_ms, b_by = bound_of(work(name, args, dict(kw, **extra),
                                   getattr(fp, name)(*args, **kw, **extra)), clock)
        by_group = {}
        for group in groups:
            run = functools.partial(pt_run, fp, ladder, means, n_steps, betas, swap_every,
                                    thin=thin, group=group, **target)
            by_group[group] = (statistics.median(cuda_times(run, 2, 10)), device_ms(run))
        fastest = min(by_group, key=lambda grp: by_group[grp][1])
        print(f"timing: {name} {shape}" + (", thin 1" if thin else "") + ", by lanes per "
              f"replica G: " + "; ".join(
                  f"G={grp} {ms:.4f} ms per call, device {dev_ms:.4f} ms"
                  for grp, (ms, dev_ms) in by_group.items())
              + f"; fastest G={fastest}, the plan picks G={picked}; bound {b_ms:.4f} ms by "
              f"{b_by} ({b_ms / by_group[picked][1]:.3f} of the bound's rate by device time at "
              f"the pick) | {card}", flush=True)
    hosts = {name: host_ms(functools.partial(getattr(fp, name), *args, **kw, **extra))
             for name, extra in (("pt_langevin_chain", {}),
                                 ("pt_langevin_chain_trajectory", dict(thin=1)))}
    alloc = host_ms(lambda: torch.empty((n_steps, n, d), device=dev))
    print(f"timing: host ms per call to the return, {shape}, the plan's G={picked}: "
          + "; ".join(f"{name} {ms:.4f}" for name, ms in hosts.items())
          + f"; torch.empty of the ({n_steps}, {n}, {d}) trajectory {alloc:.4f} | {card}",
          flush=True)
    plan_sweep("pt", fp, dev, card, [])


def device_slope(run, iters):
    """``(us per iteration, us per call besides, [device ms per call])`` of
    ``run(n)`` at each ``n`` of ``iters`` (Sinkhorn iterations, chain
    steps): the least-squares line through device time per call (10 calls
    queued behind a spin, median of 5 readings)."""
    times = [round(statistics.median(cuda_times(lambda k=k: run(k), 2, 5, batch=10)), 5)
             for k in iters]
    mx, my = statistics.fmean(iters), statistics.fmean(times)
    slope = (sum((x - mx) * (y - my) for x, y in zip(iters, times))
             / sum((x - mx) ** 2 for x in iters))
    return slope * 1e3, (my - slope * mx) * 1e3, times


def sinkhorn_cluster_sweep(sk, dev, card: str) -> None:
    """Row 14 at every cluster size it takes: the per-iteration slope and
    the intercept at SINKHORN_SWEEP_SLOPES, then device time per call at
    SINKHORN_SWEEP_ITERS iterations over SINKHORN_SWEEP, the shapes the
    plan's rule (``launch_plan``) is read from, beside the plan's pick."""
    import torch

    g = torch.Generator(dev).manual_seed(99)
    for shape in SINKHORN_SWEEP_SLOPES:
        cost = _pair_cost(g, dev, *shape)
        cells = []
        for blocks in sk.BLOCK_SIZES:
            slope, intercept, _ = device_slope(
                lambda k: sk._run(cost, FLOW_REG, k, blocks=blocks), SINKHORN_SLOPE_ITERS)
            cells.append(f"{blocks}: {slope:.3f} us + {intercept:.2f} us")
        print(f"sinkhorn sweep: {shape[0]}x{shape[1]} per iteration + per call, by cluster size "
              f"(plan {sk.launch_plan(*shape).blocks}): {'; '.join(cells)} | {card}", flush=True)
    hits = 0
    for shape in SINKHORN_SWEEP:
        cost = _pair_cost(g, dev, *shape)
        times = {}
        for blocks in sk.BLOCK_SIZES:
            if blocks <= shape[0]:
                times[blocks] = statistics.median(cuda_times(
                    lambda: sk._run(cost, FLOW_REG, SINKHORN_SWEEP_ITERS, blocks=blocks),
                    1, 3, batch=5))
        pick, best = sk.launch_plan(*shape).blocks, min(times, key=times.get)
        hits += pick == best
        print(f"sinkhorn sweep: {shape[0]}x{shape[1]}, {SINKHORN_SWEEP_ITERS} iterations, device "
              f"ms per call by cluster size: "
              + ", ".join(f"{b}: {t:.4f}" for b, t in times.items())
              + f"; plan {pick}, fastest {best}"
              + ("" if pick == best else f" ({times[pick] / times[best] - 1:.1%} slower)")
              + f" | {card}", flush=True)
    print(f"sinkhorn sweep: the plan's pick is the fastest at {hits} of {len(SINKHORN_SWEEP)} "
          f"shapes | {card}")


def mlp_plan_sweep(mlp, dev, card: str) -> None:
    """Row 13's launch settings: device time per call (CD_K steps, a device
    seed) at every built (tile, warps) that fits, on the route the plan takes
    and, where the weights fit, streamed too at the pick's tile, at
    MLP_SWEEP, the shapes its rule (``launch_plan``) is read from, beside
    the plan's pick."""
    import torch

    g = torch.Generator(dev).manual_seed(98)
    seed = torch.tensor(25, device=dev)
    hits = 0
    for n, widths in MLP_SWEEP:
        layers = _mlp_layers(dev, widths, 70)
        x = torch.randn((n, widths[0]), generator=g, device=dev)
        pick = mlp.launch_plan(n, widths, dev)
        times = {}
        for setting in mlp.SETTINGS:
            plan = mlp.MlpPlan(*setting)
            if mlp.fits(widths, plan, dev) and (plan.resident or not pick.resident
                                                or plan.tile == pick.tile):
                times[plan] = device_ms(lambda: mlp._launch(
                    x, layers, list(widths), CD_K, CD_STEP, 1.0, seed, None, None, plan))
        best = min(times, key=times.get)
        hits += pick == best
        print(f"mlp sweep: {n}x{widths}, {CD_K} steps, device ms per call by (tile, warps, "
              f"resident): " + ", ".join(f"{tuple(p)}: {t:.4f}" for p, t in times.items())
              + f"; plan {tuple(pick)}, fastest {tuple(best)}"
              + ("" if pick == best else f" ({times[pick] / times[best] - 1:.1%} slower)")
              + f" | {card}", flush=True)
    print(f"mlp sweep: the plan's pick is the fastest at {hits} of {len(MLP_SWEEP)} shapes | "
          f"{card}")


def phase_adaln(ops, dev, card: str) -> dict:
    """Each adaLN kernel, forward and backward, at ADALN_SHAPE in each of
    ADALN_DTYPES and at ADALN_CHUNKED_SHAPE in bf16: device ms per call
    (``device_ms``; a chunked backward's second pass included), its bound
    (bytes over HBM_BYTES_PER_S, ``ops._counts.work``, which leaves out the
    chunks' partial sums), its plain version's time, and the eager
    operations it replaces (the block's composite: LayerNorm and modulate,
    or the gate's multiply and add; their autograd backward, the residual's
    add included); each kernel is checked against its plain version and
    must beat it. Returns the summary's readings at ADALN_SHAPE in bf16:
    ``{wrapper: {ms, plain_ms, library_ms (the eager operations), bound_ms,
    bound_by, max_abs_err}}``."""
    import torch
    import torch.nn.functional as F

    from torchebm_tpu_torch.ops import fused_adaln as fa
    from torchebm_tpu_torch.ops._counts import work

    clock = max_sm_clock_mhz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    readings = {}
    for shape, dtype_name in [*((ADALN_SHAPE, t) for t in ADALN_DTYPES),
                              (ADALN_CHUNKED_SHAPE, "bfloat16")]:
        b, n, d = shape
        dtype = getattr(torch, dtype_name)
        g = torch.Generator(dev).manual_seed(81)

        def r(*size, scale=1.0):
            return (scale * torch.randn(size, generator=g, device=dev)).to(dtype)

        x, y, dz, dres = r(b, n, d, scale=2.0), r(b, n, d), r(b, n, d), r(b, n, d)
        mod = r(b, 6 * d, scale=0.3)
        shift, scale, gate = mod[:, :d], mod[:, d:2 * d], mod[:, 2 * d:3 * d]
        _, mean, rstd = fa.adaln_modulate(x, shift, scale, 1e-6)

        def composite_backward(fn, inputs, grads):
            leaves = [t.detach().requires_grad_() for t in inputs]
            out = fn(*leaves)
            return lambda: torch.autograd.grad(out, leaves, grads, retain_graph=True)

        def eager_modulate(x, shift, scale):
            return (F.layer_norm(x, (d,), eps=1e-6) * (1 + scale[:, None, :])
                    + shift[:, None, :])

        def eager_modulate_backward():
            grad = composite_backward(eager_modulate, (x, shift, scale), dz)
            return lambda: (grad(), dz + dres)  # the residual's separate add

        cases = {
            "adaln_modulate": ((x, shift, scale, 1e-6), fa.adaln_modulate_plain,
                               lambda: eager_modulate(x, shift, scale)),
            "adaln_modulate_backward": ((dz, x, mean, rstd, scale, dres),
                                        fa.adaln_modulate_backward_plain,
                                        eager_modulate_backward()),
            "gated_residual": ((x, gate, y), fa.gated_residual_plain,
                               lambda: x + gate[:, None, :] * y),
            "gated_residual_backward": ((dz, gate, y), fa.gated_residual_backward_plain,
                                        composite_backward(
                                            lambda x, gate, y: x + gate[:, None, :] * y,
                                            (x, gate, y), dz)),
        }
        for name, (args, plain, eager) in cases.items():
            kernel = getattr(fa, name)
            got, want = kernel(*args), plain(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs = [float((a.float() - c.float()).norm() / c.float().norm())
                    for a, c in zip(got, want) if a is not None]
            abs_err = max(float((a.float() - c.float()).abs().max())
                          for a, c in zip(got, want) if a is not None)
            gate_err = 1e-5 if dtype == torch.float32 else 1e-2
            ms = device_ms(lambda: kernel(*args))
            plain_ms = device_ms(lambda: plain(*args))
            eager_ms = device_ms(eager)
            bound_ms, bound_by = bound_of(work(name, args, {}, kernel(*args)), clock)
            chunks = fa.launch_plan(b, n, d, x.element_size(), backward=True, sms=sms).chunks
            print(f"adaln: {name} {dtype_name} {shape} ({chunks} chunks a sample in the "
                  f"backward): kernel {ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by} at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), "
                  f"{bound_ms / ms:.3f} of the bound's rate; plain version {plain_ms:.4f} ms; "
                  f"the eager operations it replaces {eager_ms:.4f} ms; relative error "
                  f"against the plain version {max(errs):.2e} (gate {gate_err:g}) | {card}",
                  flush=True)
            if not max(errs) <= gate_err:
                raise AssertionError(f"{name} {dtype_name} {shape} differs from its plain "
                                     f"version: {errs}")
            if not ms < plain_ms:
                raise AssertionError(f"{name} {dtype_name} {shape} is not faster than its plain "
                                     f"version: {ms:.4f} >= {plain_ms:.4f} ms")
            if shape == ADALN_SHAPE and dtype == torch.bfloat16:
                readings[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=eager_ms,
                                      bound_ms=bound_ms, bound_by=bound_by, max_abs_err=abs_err)
        del x, y, dz, dres, mod, mean, rstd, cases
        _release()
    return readings


def phase_timing(ops, dev, card: str) -> dict:
    """Each kernel against its plain version (CUDA events), with its work
    (``ops._counts.work``); PT per ladder step, AIS per rung, the one-step op
    in GB/s beside ``torch.add(x, g, alpha=-eta)`` (the one PyTorch call that
    computes the op at noise scale 0 without clamp); and the sampler paths
    against their generic loops."""
    import torch

    from torchebm_tpu_torch.core import GaussianEnergy, GaussianMixtureEnergy
    from torchebm_tpu_torch.ops._counts import work
    from torchebm_tpu_torch.samplers import (
        HamiltonianMonteCarlo,
        LangevinDynamics,
        MetropolisAdjustedLangevin,
        ParallelTemperingLangevin,
        annealed_importance_sampling,
    )

    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    g = torch.Generator(dev).manual_seed(5)
    x2 = torch.randn((N_CHAINS, 2), generator=g, device=dev)
    xdw = 0.5 * torch.randn(DW_SHAPE, generator=g, device=dev)
    ladder = torch.randn((len(PT_TEMPS), N_CHAINS, 2), generator=g, device=dev)
    x_ais = AIS_BASE_VAR ** 0.5 * torch.randn((AIS_CHAINS, 2), generator=g, device=dev)
    big_x = torch.randn(STEP_ELEMS, generator=g, device=dev)
    big_g = torch.randn(STEP_ELEMS, generator=g, device=dev)
    mix_kw = dict(scale=float(mix.scale), log_weights=mix.log_weights, seed=21)
    mix_args, dw_args = (x2, mix.means, N_STEPS, 0.05), (xdw, N_STEPS, 0.01)
    hmc_args = (x2, mix.means, N_STEPS, 0.3, HMC_LEAPFROG)
    pt_args = (ladder, mix.means, N_STEPS, 0.05, 1.0, tuple(1.0 / t for t in PT_TEMPS),
               PT_SWAP_EVERY)
    ais_args = (x_ais, torch.zeros(2, device=dev), AIS_BASE_VAR ** 0.5, mix.means,
                torch.linspace(0.0, 1.0, AIS_RUNGS + 1, device=dev), 0.05)
    mlp_layers = _mlp_layers(dev, (2, *CD_HIDDEN), 60)
    x_cd = torch.randn((CD_BATCH, 2), generator=g, device=dev)
    seed_t = torch.tensor(24, device=dev)
    sk_cost = _pair_cost(g, dev, FLOW_BATCH, FLOW_BATCH)
    # name -> (args, kwargs, (updates per call, their unit), plain version's
    # (warm-up, repetitions)): the plain MALA, HMC, PT and AIS versions take
    # seconds per call, so one repetition
    chain_updates, fast, slow = (N_CHAINS * N_STEPS, "chain-updates"), (1, 3), (1, 1)
    last = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        print(f"phase: timing: {part} in {now - last[0]:.1f} s", flush=True)
        last[0] = now

    calls = {
        "mixture_langevin_chain": (mix_args, mix_kw, chain_updates, fast),
        "mixture_langevin_chain_trajectory": (mix_args, dict(mix_kw, thin=1), chain_updates,
                                              fast),
        "doublewell_langevin_chain": (dw_args, dict(seed=22),
                                      (xdw.numel() * N_STEPS, "element-updates"), fast),
        "doublewell_langevin_chain_trajectory": (dw_args, dict(seed=22, thin=10),
                                                 (xdw.numel() * N_STEPS, "element-updates"),
                                                 fast),
        "mixture_mala_chain": (mix_args, mix_kw, chain_updates, slow),
        "mixture_mala_chain_trajectory": (mix_args, dict(mix_kw, thin=1), chain_updates, slow),
        "mixture_hmc_chain": (hmc_args, mix_kw, (N_CHAINS * N_STEPS, "draws"), slow),
        "mixture_hmc_chain_trajectory": (hmc_args, dict(mix_kw, thin=1),
                                         (N_CHAINS * N_STEPS, "draws"), slow),
        "pt_langevin_chain": (pt_args, mix_kw, (ladder.numel() // 2 * N_STEPS,
                                                "replica-updates"), slow),
        "pt_langevin_chain_trajectory": (pt_args, dict(mix_kw, thin=1),
                                         (ladder.numel() // 2 * N_STEPS, "replica-updates"),
                                         slow),
        "mixture_ais_run": (ais_args, mix_kw, (AIS_CHAINS * AIS_RUNGS, "chain-rungs"), slow),
        # the function torch.add computes: noise scale 0, no clamp
        "fused_langevin_step": ((big_x, big_g, 0.05, 0.0), {}, (STEP_ELEMS, "elements"), fast),
        # the CD path's call: one batch of negatives, CD_K steps, the
        # sampler's device seed
        "mlp_langevin_chain": ((x_cd, mlp_layers, CD_K, CD_STEP, 1.0), dict(seed=seed_t),
                               (CD_BATCH * CD_K, "chain-steps"), fast),
        # the flow path's matrix at fixed work: FLOW_ITERS iterations, no gate
        "sinkhorn_log_fused": ((sk_cost, FLOW_REG, FLOW_ITERS), dict(tol=0.0),
                               (sk_cost.numel() * FLOW_ITERS, "element-iterations"), (1, 3)),
    }
    times = {}
    for name, (args, kw, (updates, unit), plain_reps) in calls.items():
        module = getattr(ops, KERNELS[name][0])
        kernel = getattr(module, name)
        plain = getattr(module, PLAIN_NAMES.get(name, name + "_plain"))
        reps = STEP_REPS if name == "fused_langevin_step" else (2, 10)
        ms = statistics.median(cuda_times(lambda: kernel(*args, **kw), *reps))
        plain_ms = statistics.median(cuda_times(lambda: plain(*args, **kw), *plain_reps))
        times[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                           work=work(name, args, kw, kernel(*args, **kw)))
        print(f"timing: {name}: kernel {ms:.4f} ms ({updates / ms * 1e3:.4e} {unit}/s), plain "
              f"{plain_ms:.3f} ms ({updates / plain_ms * 1e3:.4e} {unit}/s; warm-up "
              f"{plain_reps[0]}, repetitions {plain_reps[1]}) | {card}")

    lap("the chain kernels against their plain versions")
    # rows 4-5 at the main shape for each group of lanes per chain the
    # kernel is built for: per call (one call per reading, the wrapper's host
    # work inside, as the rows' "ms") and the device time per call
    # (device_ms); launches made here are not counted
    fl = ops.fused_langevin
    k8 = mix.means.shape[0]
    picked = fl.mixture_launch_plan(N_CHAINS, 2, k8, False)[0]
    for name, thin in (("mixture_langevin_chain", None), ("mixture_langevin_chain_trajectory", 1)):
        by_group = {}
        for group in fl.MIXTURE_GROUPS:
            run = functools.partial(fl._mixture_run, name, x2, mix.means, N_STEPS, 0.05, 1.0, thin,
                                    mix_kw["scale"], mix.log_weights, None, 21, None, None,
                                    group=group)
            by_group[group] = (statistics.median(cuda_times(run, 2, 10)),
                               device_ms(run))
        fastest = min(by_group, key=lambda grp: by_group[grp][1])
        print(f"timing: {name} {N_CHAINS}x2x{N_STEPS}, K={k8}, by lanes per chain G: " + "; ".join(
            f"G={grp} {ms:.4f} ms per call, device {dev_ms:.4f} ms"
            for grp, (ms, dev_ms) in by_group.items())
            + f"; fastest G={fastest}, the plan picks G={picked} | {card}")
    # the shapes behind the plan's rule: rings of other K, and more chains
    for kr, n in PLAN_SHAPES:
        ring = _ring(kr).to(dev)
        xr = torch.randn((n, 2), generator=g, device=dev)
        by_group = {group: device_ms(functools.partial(
            fl._mixture_run, "mixture_langevin_chain", xr, ring.means, N_STEPS, 0.05, 1.0, None,
            float(ring.scale), ring.log_weights, None, 21, None, None, group=group))
            for group in fl.MIXTURE_GROUPS}
        print(f"timing: mixture_langevin_chain {n}x2x{N_STEPS}, ring K={kr}, device by lanes per "
              f"chain G: " + "; ".join(f"G={grp} {ms:.4f} ms" for grp, ms in by_group.items())
              + f"; the plan picks G={fl.mixture_launch_plan(n, 2, kr, False)[0]} | {card}")

    phase_group_timing(ops, dev, card)
    dw_ab(ops, dev, card)

    for name in ("pt_langevin_chain", "pt_langevin_chain_trajectory"):
        print(f"timing: {name} {N_CHAINS} chains x {len(PT_TEMPS)} replicas: "
              f"{times[name]['ms'] / N_STEPS * 1e3:.3f} us per ladder step | {card}")
    print(f"timing: mixture_ais_run {AIS_CHAINS} chains: "
          f"{times['mixture_ais_run']['ms'] / AIS_RUNGS * 1e3:.3f} us per rung | {card}")
    lap("rows 4-5 by group, the plan shapes, the group timings and plan sweeps")
    # the step op and torch.add as device time per call (STEP_REPS: batches
    # queued behind a spin) and, below, per call with the host's launch work
    lib_times = cuda_times(lambda: torch.add(big_x, big_g, alpha=-0.05), *STEP_REPS)
    times["fused_langevin_step"]["library_ms"] = statistics.median(lib_times)
    small = DW_SHAPE[0] * DW_SHAPE[1]
    for label, fn, n_elems in (
        ("fused_langevin_step, noise scale 0",
         lambda: ops.fused_langevin_step(big_x, big_g, 0.05, 0.0), STEP_ELEMS),
        ("torch.add(x, g, alpha=-eta)", lambda: torch.add(big_x, big_g, alpha=-0.05),
         STEP_ELEMS),
        ("fused_langevin_step, Philox noise",
         lambda: ops.fused_langevin_step(big_x, big_g, 0.05, 1.0, seed=3), STEP_ELEMS),
        (f"fused_langevin_step {DW_SHAPE[0]}x{DW_SHAPE[1]}, Philox noise",
         lambda: ops.fused_langevin_step(big_x[:small], big_g[:small], 0.05, 1.0, seed=3),
         small),
    ):
        nbytes = 3 * 4 * n_elems
        ts = cuda_times(fn, *STEP_REPS)
        q1, med, q3 = statistics.quantiles(ts, n=4)
        host = statistics.median(cuda_times(fn, STEP_REPS[0], STEP_REPS[1]))
        print(f"timing: {label} {n_elems} elements: device {med:.4f} ms per call (quartiles "
              f"{q1:.4f}-{q3:.4f}, {STEP_REPS[1]} batches of {STEP_REPS[2]}), "
              f"{nbytes / med / 1e6:.1f} GB/s (bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
              f"at 3.35 TB/s); {host:.4f} ms with the host's launch work | {card}")

    lap("the step op")
    # the neural chain at the knee of the JAX batch study: 4,096 chains
    knee = (torch.randn((4096, 2), generator=g, device=dev), mlp_layers, CD_K, CD_STEP, 1.0)
    mlp = ops.fused_mlp_langevin
    k_ms = statistics.median(cuda_times(lambda: mlp.mlp_langevin_chain(*knee, seed=seed_t), 2,
                                        10))
    p_ms = statistics.median(cuda_times(lambda: mlp.mlp_langevin_chain_plain(*knee, seed=24),
                                        1, 3))
    b_ms, b_by = bound_of(work("mlp_langevin_chain", knee, dict(seed=seed_t),
                               mlp.mlp_langevin_chain(*knee, seed=seed_t)), max_sm_clock_mhz())
    print(f"timing: mlp_langevin_chain 4096x2, MLP{CD_HIDDEN}, {CD_K} steps: kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by} ({b_ms / k_ms:.3f} of the bound's "
          f"rate) | {card}")
    # device time per call without the wrapper's host work (batches of 10
    # queued behind a spin) at MLP_SLOPE_STEPS steps, at the CD path's shape
    # and at the knee: us per step (the slope) and per call besides (the
    # intercept); and the host's time per call with the sampler's device seed
    for label, x in ((f"{CD_BATCH}x2", x_cd), ("4096x2", knee[0])):
        slope, intercept, fixed = device_slope(
            lambda k: mlp.mlp_langevin_chain(x, mlp_layers, k, CD_STEP, 1.0, seed=seed_t),
            MLP_SLOPE_STEPS)
        host = host_ms(lambda: mlp.mlp_langevin_chain(x, mlp_layers, CD_K, CD_STEP, 1.0,
                                                      seed=seed_t))
        print(f"timing: mlp_langevin_chain {label}, MLP{CD_HIDDEN}, plan "
              f"{tuple(mlp.launch_plan(x.shape[0], (2, *CD_HIDDEN), dev))} (tile, warps, "
              f"resident): device ms per call at {MLP_SLOPE_STEPS} steps {fixed}: {slope:.3f} us "
              f"per step (slope), {intercept:.2f} us per call besides (intercept); host "
              f"{host:.4f} ms per call up to its return (device seed) | {card}")
    mlp_plan_sweep(mlp, dev, card)
    lap("the neural chain and its plan sweep")
    # the Sinkhorn kernel as the flow path calls it (gated at FLOW_TOL), with
    # the iterations it ran and its bound for that work; and what the loop
    # pays: no single PyTorch call runs the fixed point, 2 x FLOW_ITERS
    # logsumexp calls are its body
    sk = ops.fused_sinkhorn
    gated = dict(tol=FLOW_TOL)
    k_ms = statistics.median(cuda_times(
        lambda: sk.sinkhorn_log_fused(sk_cost, FLOW_REG, FLOW_ITERS, **gated), 2, 10))
    p_ms = statistics.median(cuda_times(
        lambda: sk.sinkhorn_log_plain(sk_cost, FLOW_REG, FLOW_ITERS, **gated), 1, 3))
    d_ms = statistics.median(cuda_times(
        lambda: sk.sinkhorn_log_fused(sk_cost, FLOW_REG, FLOW_ITERS, **gated), 2, 10, batch=10))
    result = sk.sinkhorn_log_fused(sk_cost, FLOW_REG, FLOW_ITERS, return_iters=True, **gated)
    b_ms, b_by = bound_of(work("sinkhorn_log_fused", (sk_cost, FLOW_REG, FLOW_ITERS), gated,
                               result), max_sm_clock_mhz())
    print(f"timing: sinkhorn_log_fused {FLOW_BATCH}x{FLOW_BATCH}, reg {FLOW_REG}, "
          f"tol {FLOW_TOL:g}: "
          f"{int(result[1])} iterations of {FLOW_ITERS}: kernel {k_ms:.4f} ms per call (device "
          f"{d_ms:.4f} ms), plain {p_ms:.3f} ms, bound {b_ms:.5f} ms by {b_by} | {card}")
    lse_ms = statistics.median(cuda_times(
        lambda: [torch.logsumexp(sk_cost, dim=i % 2) for i in range(2 * FLOW_ITERS)], 1, 5))
    slope, intercept, fixed = device_slope(
        lambda k: sk.sinkhorn_log_fused(sk_cost, FLOW_REG, k), SINKHORN_SLOPE_ITERS)
    print(f"timing: sinkhorn_log_fused {FLOW_BATCH}x{FLOW_BATCH} at tol 0, device ms per call at "
          f"{SINKHORN_SLOPE_ITERS} iterations {fixed}: {slope:.3f} us per iteration (slope), "
          f"{intercept:.2f} us per call besides (intercept); {FLOW_ITERS} iterations "
          f"{fixed[-1]:.4f} ms; {2 * FLOW_ITERS} torch.logsumexp calls over the same matrix "
          f"{lse_ms:.3f} ms | {card}")
    sinkhorn_cluster_sweep(sk, dev, card)
    lap("the Sinkhorn kernel and its cluster sweep")
    # the EqM train step (config 5): kernel, loop and identity pairing (the
    # floor without any coupling work): host clock over 50 steps after 10
    from torchebm_tpu_torch.couplings import IndependentCoupling
    from torchebm_tpu_torch.samplers import FlowSampler

    data = _flow_batch(dev)
    for path, coupling in (("Sinkhorn kernel", _config5_coupling("auto")),
                           ("Sinkhorn loop", _config5_coupling("off")),
                           ("IndependentCoupling", IndependentCoupling())):
        trainer, net, _ = _flow_trainer(dev, 15, coupling)
        state = trainer.init_state(net, torch.Generator(dev).manual_seed(16))
        for _ in range(10):
            trainer.train_step(state, data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            trainer.train_step(state, data)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 50
        print(f"timing: EqM train step config 5, {path}: {ms:.4f} ms per step (50 steps after 10 "
              f"warm-up) | {card}")
    flow = FlowSampler(model=net, integrator="euler", negate_velocity=True)
    gen_ms = statistics.median(cuda_times(
        lambda: flow.sample(g, dim=2, n_samples=GEN_SAMPLES, n_steps=GEN_STEPS), 1, 3))
    print(f"timing: FlowSampler euler generation {GEN_SAMPLES} samples x {GEN_STEPS} steps: "
          f"{gen_ms:.3f} ms ({GEN_SAMPLES / gen_ms * 1e3:.4e} samples/s) | {card}")
    # the CD train step (config 3), kernel against generic loop: host clock
    # over 50 steps after 10 warm-up steps
    for fused, path in (("auto", "kernel path"), ("off", "generic loop")):
        trainer, net, _ = _cd_trainer(dev, CD_STEP, CD_K, CD_LR, fused, seed=11)
        gg = torch.Generator(dev).manual_seed(12)
        batches = _cd_batches(dev, gg, 60, seed=11)
        state = trainer.init_state(net, gg)
        for b in batches[:10]:
            trainer.train_step(state, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[10:]:
            trainer.train_step(state, b)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 50
        print(f"timing: CD train step config 3 {path}: {ms:.4f} ms per step (50 steps after 10 "
              f"warm-up) | {card}")

    lap("the train steps")
    # the sampler paths, kernel against generic loop
    pt = ParallelTemperingLangevin(mix, temperatures=PT_TEMPS, step_size=0.05,
                                   swap_every=PT_SWAP_EVERY)
    base = GaussianEnergy.create(torch.zeros(2), AIS_BASE_VAR * torch.eye(2)).to(dev)
    lang = LangevinDynamics(mix, step_size=0.05)
    for label, sampler, kw in (
        ("Langevin sample()", lang, {}),
        ("Langevin sample() + diagnostics", lang, dict(return_diagnostics=True)),
        ("MALA sample()", MetropolisAdjustedLangevin(mix, step_size=0.05), {}),
        ("HMC sample()", HamiltonianMonteCarlo(mix, step_size=0.3,
                                               n_leapfrog_steps=HMC_LEAPFROG), {}),
        (f"PT sample() R={len(PT_TEMPS)}", pt, {}),
    ):
        for fused, path, reps in (("auto", "kernel path", 3), ("off", "generic loop", 1)):
            s = sampler.replace(fused=fused)
            ms = statistics.median(cuda_times(lambda: s.sample(g, x=x2, n_steps=N_STEPS, **kw),
                                              1, reps))
            print(f"timing: {label} {path} {N_CHAINS}x{N_STEPS}: {ms:.3f} ms "
                  f"({N_CHAINS * N_STEPS / ms * 1e3:.4e} chain-updates/s), repetitions "
                  f"{reps} | {card}")
    for fused, path, reps in (("auto", "kernel path", 3), ("off", "generic loop", 1)):
        ms = statistics.median(cuda_times(lambda: annealed_importance_sampling(
            g, mix, base=base, n_samples=AIS_CHAINS, n_rungs=AIS_RUNGS, step_size=0.05,
            fused=fused), 1, reps))
        print(f"timing: annealed_importance_sampling {path} {AIS_CHAINS}x{AIS_RUNGS}: "
              f"{ms:.3f} ms, repetitions {reps} | {card}")
    hmc = HamiltonianMonteCarlo(_corr_gaussian(dev), step_size=0.2,
                                n_leapfrog_steps=HMC_LEAPFROG)
    ms = statistics.median(cuda_times(
        lambda: hmc.warmup(g, dim=2, n_warmup=200, n_samples=N_CHAINS), 1, 1))
    print(f"timing: HMC warmup (generic loop, dual averaging) {N_CHAINS} chains x 200: "
          f"{ms:.3f} ms, one repetition | {card}")
    lap("the sampler paths")
    return times


def sync_sites(fn) -> list:
    """The host's synchronising CUDA calls during ``fn()``, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them (one warning
    each: a ``bool()``, ``float()``, ``int()``, ``.cpu()`` or ``.item()`` of a
    device tensor), each as the ``file:line`` the warning names."""
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return [f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message).lower()]


def count_syncs(fn) -> int:
    return len(sync_sites(fn))


def phase_syncs(ops, dev, card: str) -> None:
    """Host syncs per call of what the flow and CD slices run on the host's
    clock:
    the EqM train step through the Sinkhorn kernel (none expected: the
    coupling's draw and the kernel's gate stay on the device) and through the
    loop (at ``tol`` > 0 one per ``CHECK_EVERY`` iterations, where it reads
    its gate), the auction and the greedy
    assignment on the flow batch's cost matrix (one per round), a dopri5
    generation (one per attempted step), and the CD train step through the
    neural kernel and on the loop, with the neural sampler's call alone
    (none expected: its seed stays on the device)."""
    import torch

    from torchebm_tpu_torch.couplings import (
        SinkhornCoupling,
        auction_assignment,
        greedy_assignment,
    )
    from torchebm_tpu_torch.integrators import get_integrator
    from torchebm_tpu_torch.samplers import FlowSampler

    data = _flow_batch(dev)
    g = torch.Generator(dev).manual_seed(41)
    steps = {}
    for fused in ("auto", "off"):
        trainer, net, _ = _flow_trainer(dev, 19, _config5_coupling(fused))
        state = trainer.init_state(net, torch.Generator(dev).manual_seed(20))
        for _ in range(3):
            trainer.train_step(state, data)
        steps[fused] = count_syncs(lambda: trainer.train_step(state, data))
    cost = SinkhornCoupling().compute_cost(torch.randn((FLOW_BATCH, 2), generator=g, device=dev),
                                           data).contiguous()
    auction = count_syncs(lambda: auction_assignment(cost))
    greedy = count_syncs(lambda: greedy_assignment(cost))
    flow = FlowSampler(model=net, negate_velocity=True)
    x0 = torch.randn((GEN_SAMPLES, 2), generator=g, device=dev)
    drift = flow._get_drift({})
    with torch.no_grad():
        _, stats = get_integrator("dopri5").integrate(
            {"x": x0}, 1.0 / GEN_STEPS, GEN_STEPS, drift=drift, return_stats=True)
    dopri = count_syncs(lambda: flow.sample(g, x=x0, n_steps=GEN_STEPS))
    print(f"syncs: EqM train step config 5: {steps['auto']} through the Sinkhorn kernel, "
          f"{steps['off']} on the loop (one per {ops.fused_sinkhorn.CHECK_EVERY} iterations of "
          f"the fixed point); "
          f"auction_assignment {FLOW_BATCH}x{FLOW_BATCH}: {auction}; greedy_assignment: "
          f"{greedy}; dopri5 generation {GEN_SAMPLES}x{GEN_STEPS}: {dopri} "
          f"({int(stats.n_attempted)} attempted steps, {int(stats.n_accepted)} accepted) | {card}")
    if steps["auto"] != 0:
        raise AssertionError(f"the EqM train step through the kernel syncs {steps['auto']} times")

    # the CD train step (config 3) through the neural kernel and on the loop,
    # and the sampler's call alone: its seed goes to the kernel as a device
    # tensor, so the call does not sync
    from torchebm_tpu_torch.samplers import LangevinDynamics

    cd = {}
    for fused in ("auto", "off"):
        trainer, net, energy = _cd_trainer(dev, CD_STEP, CD_K, CD_LR, fused, seed=21)
        gg = torch.Generator(dev).manual_seed(22)
        batches = _cd_batches(dev, gg, 4, seed=21)
        state = trainer.init_state(net, gg)
        for b in batches[:3]:
            trainer.train_step(state, b)
        cd[fused] = sync_sites(lambda: trainer.train_step(state, batches[3]))
    sampler = LangevinDynamics(energy, step_size=CD_STEP, fused_neural="auto")
    x0 = torch.randn((CD_BATCH, 2), generator=g, device=dev)
    before = ops.launch_counts()["mlp_langevin_chain"]
    sample = sync_sites(lambda: sampler.sample(g, x=x0, n_steps=CD_K))
    print(f"syncs: CD train step config 3: {len(cd['auto'])} through the neural kernel "
          f"{cd['auto']}, {len(cd['off'])} on the loop {cd['off']}; "
          f"LangevinDynamics(fused_neural='auto').sample {CD_BATCH}x{CD_K} steps through the "
          f"kernel: {len(sample)} {sample} | {card}")
    if ops.launch_counts()["mlp_langevin_chain"] != before + 1:
        raise AssertionError("the sampler's call did not launch the neural chain kernel")
    if sample:
        raise AssertionError(f"the neural chain's sampler call syncs: {sample}")
    ais_syncs(ops, dev, card)
    dw_syncs(ops, dev, card)
    mcmc_syncs(dev, card)


def mcmc_syncs(dev, card: str) -> None:
    """Host syncs of one RMHMC draw on the radial metric (none expected: the
    metric's factor keeps its status on the device) and of one NUTS
    transition at the shootout's settings (at most one per doubling after
    the first: whether any tree still grows), each after a warm-up call."""
    import torch

    from torchebm_tpu_torch.core import GaussianEnergy
    from torchebm_tpu_torch.samplers import NoUTurnSampler, RiemannianManifoldHMC

    g = torch.Generator(dev).manual_seed(45)
    rm = RiemannianManifoldHMC(GaussianEnergy.standard(2).to(dev), metric_fn=_radial_metric,
                               step_size=0.15, n_leapfrog_steps=RMHMC_LEAPFROG)
    run = functools.partial(rm.sample, g, dim=2, n_samples=RMHMC_CHAINS, n_steps=1)
    run()
    rm_sites = sync_sites(run)
    nuts = NoUTurnSampler(_corr_gaussian(dev), step_size=NUTS_STEP, max_tree_depth=NUTS_DEPTH)
    x = torch.randn((NUTS_CHAINS, 2), generator=g, device=dev)
    run = functools.partial(nuts.sample, g, x=x, n_steps=1)
    run()
    nuts_sites = sync_sites(run)
    _, diag = nuts.sample(g, x=x, n_steps=1, return_diagnostics=True)
    print(f"syncs: RiemannianManifoldHMC radial metric, one draw of {RMHMC_CHAINS} chains x "
          f"{RMHMC_LEAPFROG} leapfrog: {len(rm_sites)} {rm_sites}; NoUTurnSampler one transition "
          f"of {NUTS_CHAINS} chains at step {NUTS_STEP}, max_tree_depth {NUTS_DEPTH}: "
          f"{len(nuts_sites)} {nuts_sites} (a like transition's mean tree depth "
          f"{float(diag['tree_depth'][-1]):.3f}) | {card}")
    if rm_sites:
        raise AssertionError(f"the RMHMC draw syncs: {rm_sites}")
    if len(nuts_sites) > NUTS_DEPTH:
        raise AssertionError(f"the NUTS transition syncs {len(nuts_sites)} times, more than "
                             f"max_tree_depth {NUTS_DEPTH}")


def dw_syncs(ops, dev, card: str) -> None:
    """Host syncs of the double-well ``sample()`` calls through the kernels,
    final state and trajectory, at 4,096 x 32 x 1,000, after a warm-up call
    (none expected: the seed goes to the kernel as a device tensor and the
    constant schedule as two floats)."""
    import torch

    from torchebm_tpu_torch.core import DoubleWellEnergy
    from torchebm_tpu_torch.samplers import LangevinDynamics

    dw = LangevinDynamics(DoubleWellEnergy(), step_size=0.01)
    g = torch.Generator(dev).manual_seed(44)
    sites = {}
    for name, kw in (("doublewell_langevin_chain", {}),
                     ("doublewell_langevin_chain_trajectory",
                      dict(thin=10, return_trajectory=True))):
        run = functools.partial(dw.sample, g, dim=DW_SHAPE[1], n_samples=DW_SHAPE[0],
                                n_steps=N_STEPS, **kw)
        run()
        before = ops.launch_counts()[name]
        sites[name] = sync_sites(run)
        if ops.launch_counts()[name] != before + 1:
            raise AssertionError(f"the double-well sample() call did not launch {name}")
    print(f"syncs: LangevinDynamics(DoubleWellEnergy()).sample {DW_SHAPE[0]}x{DW_SHAPE[1]}x"
          f"{N_STEPS} through the kernel, after a warm-up call: "
          + "; ".join(f"{name} {len(v)} {v}" for name, v in sites.items()) + f" | {card}")
    if any(sites.values()):
        raise AssertionError(f"the double-well sample() call syncs: {sites}")


def ais_syncs(ops, dev, card: str) -> None:
    """Host syncs of the AIS call through the kernel on each of the path's
    targets, after a warm-up call (none expected: the seed goes to the kernel
    as a device tensor, the gates and the base's Cholesky factor are read
    once per state of their buffers)."""
    import torch

    from torchebm_tpu_torch.core import GaussianEnergy
    from torchebm_tpu_torch.samplers import annealed_importance_sampling

    base = GaussianEnergy.create(torch.zeros(2), AIS_BASE_VAR * torch.eye(2)).to(dev)
    g = torch.Generator(dev).manual_seed(43)
    sites = {}
    for name, (target, n) in _ais_targets(dev).items():
        run = functools.partial(annealed_importance_sampling, g, target, base=base, n_samples=n,
                                n_rungs=AIS_RUNGS, step_size=0.05)
        run()
        before = ops.launch_counts()["mixture_ais_run"]
        sites[name] = sync_sites(run)
        if ops.launch_counts()["mixture_ais_run"] != before + 1:
            raise AssertionError(f"the AIS call on the {name} did not launch its kernel")
    print("syncs: annealed_importance_sampling through the kernel, after a warm-up call: "
          + "; ".join(f"{name} {len(v)} {v}" for name, v in sites.items()) + f" | {card}")
    if any(sites.values()):
        raise AssertionError(f"the AIS call syncs: {sites}")


def bound_of(work: dict, clock_mhz: float):
    """``(bound_ms, bound_by)``: the larger of the bytes over the memory rate
    and, per instruction class, the count over its rate at ``clock_mhz`` (the
    tensor cores' TF32 operations over TF32_OPS_PER_S)."""
    byte_ms = work["bytes"] / HBM_BYTES_PER_S * 1e3
    op_ms = max(v / (TF32_OPS_PER_S if k == "tf32" else
                     RATE_PER_SM_CLOCK[k] * N_SMS * clock_mhz * 1e6) * 1e3
                for k, v in work["ops"].items())
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def max_sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return float(out.strip().splitlines()[0])


def device_events(prof) -> list:
    """The profile's device events by name: its CUDA kernels and copies. A
    user annotation's span on the device (``Optimizer.step#AdamW.step``)
    covers kernels counted on their own, so it is left out."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profiled(fn):
    """One call of ``fn()`` under ``torch.profiler`` (host and CUDA
    activities), padded by PROFILE_PAD_S of host sleep before the call and
    after its ``synchronize()``; the finished profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    return prof


def device_busy_ms(fn) -> tuple:
    """Device time of one call of ``fn()``: the sum of the durations that
    ``torch.profiler`` records for its CUDA kernels and copies (not a user
    annotation's span), from the first of up to PROFILE_SESSIONS sessions
    that records any; (ms, sessions taken), (0.0, PROFILE_SESSIONS) when none
    does. The durations are read from the session's raw events: building
    its per-event tables (``key_averages``) took minutes for the million
    events of a ``tune_trajectory_length`` call, on an H100's host with
    torch 2.11."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    for n in range(1, PROFILE_SESSIONS + 1):
        events = profiled(fn).profiler.kineto_results.events()
        busy = sum(e.duration_ns() for e in events
                   if e.device_type() == cuda and not e.is_user_annotation()) / 1e6
        if busy > 0:
            return busy, n
    return 0.0, PROFILE_SESSIONS


def host_top_ops(fn, n: int = 6) -> str:
    """The ``n`` host operations of one call of ``fn()`` with the most self
    CPU time under ``torch.profiler`` (a synchronising call's time includes
    its wait for the device), as "name ms" pairs."""
    prof = profiled(fn)
    ops = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                 key=lambda e: -e.self_cpu_time_total)[:n]
    return ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.3f} ms" for e in ops)


def device_breakdown(fn, n: int = 5) -> str:
    """One call of ``fn()`` under ``torch.profiler``: its device time by
    class (matrix products, attention, the rest: elementwise, reductions,
    copies, the optimizer) and the ``n`` kernels with the most device time,
    as "name ms" pairs."""
    kernels = [e for e in device_events(profiled(fn)) if e.self_device_time_total > 0]
    classes = {"products": 0.0, "attention": 0.0, "rest": 0.0}
    for e in kernels:
        name = e.key.lower()
        key = ("attention" if any(k in name for k in ("attention", "fmha", "flash")) else
               "products" if any(k in name for k in ("gemm", "xmma", "cutlass", "nvjet")) else
               "rest")
        classes[key] += e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:n]
    return (", ".join(f"{k} {v:.3f} ms" for k, v in classes.items()) + "; top kernels: "
            + ", ".join(f"{e.key[:70]} {e.self_device_time_total / 1e3:.3f} ms" for e in top))


def phase_profile(dev, card: str) -> None:
    """Wall time (host clock around ``synchronize()``, median of 3 after one
    warm-up), device busy time (one more call under ``torch.profiler``) and
    the idle share 1 - busy / wall of the sampler paths and the diagnostics;
    for the Langevin kernel calls (the headline's and the double well's) and
    the AIS kernel path also the host operations with the most self CPU
    time."""
    import torch

    from torchebm_tpu_torch.core import DoubleWellEnergy, GaussianEnergy, GaussianMixtureEnergy
    from torchebm_tpu_torch.samplers import (
        HamiltonianMonteCarlo,
        LangevinDynamics,
        MetropolisAdjustedLangevin,
        ParallelTemperingLangevin,
        annealed_importance_sampling,
        summarize_chains,
    )

    mix = GaussianMixtureEnergy.eight_gaussians().to(dev)
    g = torch.Generator(dev).manual_seed(6)
    x2 = torch.randn((N_CHAINS, 2), generator=g, device=dev)
    lang = LangevinDynamics(mix, step_size=0.05)
    dw = LangevinDynamics(DoubleWellEnergy(), step_size=0.01)
    dw_label = f"{DW_SHAPE[0]}x{DW_SHAPE[1]}x{N_STEPS}"
    hmc = HamiltonianMonteCarlo(mix, step_size=0.3, n_leapfrog_steps=HMC_LEAPFROG)
    mala = MetropolisAdjustedLangevin(mix, step_size=0.05)
    corr, _, (x0, eps) = _hmc_warmup(dev, False)
    corr = corr.replace(step_size=eps)
    traj = corr.sample(g, x=x0, n_steps=ESS_DRAWS, thin=ESS_THIN, return_trajectory=True)
    n, loop_steps = N_CHAINS, 200
    pt = ParallelTemperingLangevin(mix, temperatures=PT_TEMPS, step_size=0.05,
                                   swap_every=PT_SWAP_EVERY)
    ais_kw = dict(base=GaussianEnergy.create(torch.zeros(2), AIS_BASE_VAR * torch.eye(2)).to(dev),
                  n_samples=AIS_CHAINS, n_rungs=AIS_RUNGS, step_size=0.05)
    cd_steps = {}
    for fused in ("auto", "off"):
        trainer, net, _ = _cd_trainer(dev, CD_STEP, CD_K, CD_LR, fused, seed=13)
        gg = torch.Generator(dev).manual_seed(14)
        batch = _cd_batches(dev, gg, 1, seed=13)[0]
        cd_steps[fused] = (trainer, trainer.init_state(net, gg), batch)
    from torchebm_tpu_torch.samplers import FlowSampler

    eqm_steps = {}
    for fused in ("auto", "off"):
        trainer, net, _ = _flow_trainer(dev, 17, _config5_coupling(fused))
        eqm_steps[fused] = (trainer, trainer.init_state(net, torch.Generator(dev).manual_seed(18)),
                            _flow_batch(dev))
    flow = FlowSampler(model=eqm_steps["auto"][1].model, integrator="euler", negate_velocity=True)
    # The kernel paths and the other short calls are profiled first, the
    # generic loops after them and the HMC warmup (about 190,000 profiler
    # events, 40,000 on the device) last: after a session that large, later
    # sessions of the process have dropped some of their device events (on
    # an H100 with torch 2.11). So this phase profiles every call but the
    # advanced HMC paths' four, and every call of the first group must
    # record device events in one of its PROFILE_SESSIONS padded sessions
    # (see PROFILE_PAD_S).
    first = {
        f"EqM train step config 5 Sinkhorn kernel (batch {FLOW_BATCH})":
            lambda: eqm_steps["auto"][0].train_step(*eqm_steps["auto"][1:]),
        f"EqM train step config 5 Sinkhorn loop (batch {FLOW_BATCH})":
            lambda: eqm_steps["off"][0].train_step(*eqm_steps["off"][1:]),
        f"FlowSampler euler generation {GEN_SAMPLES}x{GEN_STEPS}":
            lambda: flow.sample(g, dim=2, n_samples=GEN_SAMPLES, n_steps=GEN_STEPS),
        f"CD train step config 3 kernel path (batch {CD_BATCH}, CD-{CD_K})":
            lambda: cd_steps["auto"][0].train_step(*cd_steps["auto"][1:]),
        f"CD train step config 3 generic loop (batch {CD_BATCH}, CD-{CD_K})":
            lambda: cd_steps["off"][0].train_step(*cd_steps["off"][1:]),
        f"Langevin sample() kernel path {n}x{N_STEPS}":
            lambda: lang.sample(g, x=x2, n_steps=N_STEPS),
        f"Langevin sample() kernel path + diagnostics {n}x{N_STEPS}":
            lambda: lang.sample(g, x=x2, n_steps=N_STEPS, return_diagnostics=True),
        f"Langevin sample() kernel path, double well {dw_label}":
            lambda: dw.sample(g, dim=DW_SHAPE[1], n_samples=DW_SHAPE[0], n_steps=N_STEPS),
        f"Langevin sample() kernel path, double-well trajectory {dw_label} thin 10":
            lambda: dw.sample(g, dim=DW_SHAPE[1], n_samples=DW_SHAPE[0], n_steps=N_STEPS,
                              thin=10, return_trajectory=True),
        f"HMC sample() kernel path {n}x{N_STEPS}": lambda: hmc.sample(g, x=x2, n_steps=N_STEPS),
        f"HMC ESS trajectory kernel path {n}x{ESS_DRAWS} thin {ESS_THIN}":
            lambda: corr.sample(g, x=x0, n_steps=ESS_DRAWS, thin=ESS_THIN,
                                return_trajectory=True),
        f"MALA sample() kernel path {n}x{N_STEPS}":
            lambda: mala.sample(g, x=x2, n_steps=N_STEPS),
        f"PT sample() kernel path {n}x{N_STEPS}, R={len(PT_TEMPS)}":
            lambda: pt.sample(g, x=x2, n_steps=N_STEPS),
        f"AIS kernel path {AIS_CHAINS}x{AIS_RUNGS} rungs":
            lambda: annealed_importance_sampling(g, mix, **ais_kw),
        f"summarize_chains {tuple(traj.shape)}": lambda: summarize_chains(traj),
        f"summarize_chains(rank_normalized=True) {tuple(traj.shape)}":
            lambda: summarize_chains(traj, rank_normalized=True),
    }
    loops = {
        f"Langevin sample() generic loop {n}x{N_STEPS}":
            lambda: lang.replace(fused="off").sample(g, x=x2, n_steps=N_STEPS),
        f"HMC sample() generic loop {n}x{loop_steps}":
            lambda: hmc.replace(fused="off").sample(g, x=x2, n_steps=loop_steps),
        f"MALA sample() generic loop {n}x{loop_steps}":
            lambda: mala.replace(fused="off").sample(g, x=x2, n_steps=loop_steps),
        f"PT sample() generic loop {n}x{loop_steps}, R={len(PT_TEMPS)}":
            lambda: pt.replace(fused="off").sample(g, x=x2, n_steps=loop_steps),
        f"AIS generic loop {AIS_CHAINS}x{AIS_RUNGS} rungs":
            lambda: annealed_importance_sampling(g, mix, fused="off", **ais_kw),
        f"HMC warmup (generic loop) {n}x{loop_steps}":
            lambda: corr.warmup(g, dim=2, n_warmup=loop_steps, n_samples=n),
    }
    first.update(_dit_family_calls(dev))
    profile_calls(first, card, require_events=True)
    profile_calls(loops, card, require_events=False)
    first.clear()
    _release()


def profile_calls(calls: dict, card: str, require_events: bool) -> dict:
    """For each ``label: fn`` of ``calls``, the wall time (host clock around
    ``synchronize()``, median of 3 after one warm-up), the device busy time
    (one more call under ``torch.profiler``, see :func:`device_busy_ms`) and
    the idle share; fails if a call records no device events in any of its
    sessions and ``require_events``. Returns ``{label: (wall ms, busy ms)}``."""
    import torch

    readings = {}
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
        busy, sessions = device_busy_ms(fn)
        readings[label] = (wall, busy)
        if busy <= 0 and require_events:
            raise AssertionError(f"profile: {label}: {sessions} profiles recorded no device events")
        device = (f"device busy {busy:.3f} ms, idle share {1.0 - busy / wall:.3f}" if busy > 0
                  else f"device busy not measured ({sessions} profiles recorded no device events)")
        if 1 < sessions and busy > 0:
            device += f" (profile {sessions}: the earlier ones recorded no device events)"
        print(f"profile: {label}: wall {wall:.3f} ms, {device} | {card}")
        if label.startswith(("Langevin sample() kernel path", "AIS kernel path")):
            print(f"profile: {label}: host ops by self CPU time (profiled call): "
                  f"{host_top_ops(fn)} | {card}")
        if label.startswith("DiT-768x12 train step"):
            print(f"profile: {label}: device time by class (profiled call): "
                  f"{device_breakdown(fn)} | {card}")
    return readings


#: the DiT family's and score matching's paths, in the order they run
DIT_PATHS = (path_dit, path_dit_eqm, path_cfg, path_score)


def main() -> None:
    import torch

    started = time.perf_counter()
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
    if sys.argv[1:] == ["--ess-shape"]:
        phase_ess_shape(ops, dev, card)
        return
    if sys.argv[1:] == ["--ais-shape"]:
        ais_ab(ops, dev, card)
        return
    if sys.argv[1:] == ["--dw-shape"]:
        dw_ab(ops, dev, card)
        return
    if sys.argv[1:] == ["--offset-shape"]:
        offset_ab(ops, dev, card)
        return
    if sys.argv[1:] == ["--ais"]:
        check_instances(phase_build(_build))
        _check_ais_groups(ops, dev, {})
        ais_group_timing(ops, dev, card, max_sm_clock_mhz())
        ais_syncs(ops, dev, card)
        return

    last = [started]

    def done(phase: str) -> None:
        now = time.perf_counter()
        print(f"phase: {phase} done at {now - started:.1f} s ({now - last[0]:.1f} s)", flush=True)
        last[0] = now

    if sys.argv[1:] == ["--mcmc"]:
        check_instances(phase_build(_build))
        done("build")
        for path in MCMC_PATHS:
            path(ops, dev, card)
            done(path.__name__)
        mcmc_syncs(dev, card)
        done("syncs")
        return
    if sys.argv[1:] == ["--parallel"]:
        check_instances(phase_build(_build))
        done("build")
        path_parallel(ops, dev, card)
        done("path_parallel")
        return
    if sys.argv[1:] == ["--gaps"]:
        from torchebm_tpu_torch.parallel import make_mesh

        check_instances(phase_build(_build))
        done("build")
        for path in GAP_PATHS:
            path(ops, dev, card)
            done(path.__name__)
        with _world_of_one():
            _par_flow(ops, dev, make_mesh(("data",)), card)
        done("_par_flow")
        return
    if sys.argv[1:] == ["--dit"]:
        check_instances(phase_build(_build))
        done("build")
        phase_adaln(ops, dev, card)
        done("adaln")
        profile_calls(_dit_family_calls(dev), card, require_events=True)
        done("profile")
        for path in DIT_PATHS:
            path(ops, dev, card)
            done(path.__name__)
        return
    if sys.argv[1:] == ["--adaln"]:
        check_instances(phase_build(_build))
        done("build")
        phase_adaln(ops, dev, card)
        done("adaln")
        return

    check_instances(phase_build(_build))
    phase_sass(_build)
    done("build")
    errors: dict = {}
    phase_check(ops.fused_langevin, dev, errors)
    done("check")
    for check in (phase_check_metropolis, phase_check_groups, phase_check_tempering,
                  phase_check_mlp, phase_check_sinkhorn):
        check(ops, dev, errors)
        done(check.__name__.removeprefix("phase_"))
    phase_profile(dev, card)
    done("profile")
    launches = dict.fromkeys(ops.launch_counts(), 0)
    for path in (path_langevin, path_hmc, *MCMC_PATHS, path_mala, path_gradient_descent, path_pt,
                 path_ais, path_step, path_cd, path_flow, *DIT_PATHS, *GAP_PATHS, path_parallel):
        for name, n in path(ops, dev, card).items():
            launches[name] += n
        done(path.__name__)
    times = phase_timing(ops, dev, card)
    done("timing")
    adaln = phase_adaln(ops, dev, card)
    done("adaln")
    phase_syncs(ops, dev, card)
    done("syncs")

    clock = max_sm_clock_mhz()
    print(f"bound: {N_SMS} SMs at {clock:.0f} MHz (nvidia-smi clocks.max.sm), per-SM rates "
          f"per clock {RATE_PER_SM_CLOCK}, TF32 tensor cores {TF32_OPS_PER_S / 1e12:g} TFLOP/s, "
          f"memory {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    rows = []
    for name, (_, source, replaces) in KERNELS.items():
        t = times[name]
        bound_ms, bound_by = bound_of(t["work"], clock)
        ops_counts = {k: f"{v:.3e}" for k, v in t["work"]["ops"].items()}
        print(f"bound: {name}: {bound_ms:.4f} ms by {bound_by} (instructions {ops_counts}, "
              f"bytes {t['work']['bytes']:.3e}); kernel {t['ms']:.4f} ms, "
              f"{bound_ms / t['ms']:.3f} of the bound's rate | {card}")
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": errors[name],
                     "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": t["library_ms"]})
    for name, (source, replaces) in ADALN_KERNELS.items():
        t = adaln[name]
        print(f"bound: {name}: {t['bound_ms']:.4f} ms by {t['bound_by']} at {ADALN_SHAPE} "
              f"bfloat16; kernel {t['ms']:.4f} ms, {t['bound_ms'] / t['ms']:.3f} of the bound's "
              f"rate | {card}")
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": t["max_abs_err"],
                     "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    summary = {"kernels": rows}
    print(f"chip_smoke.py: {time.perf_counter() - started:.1f} s in all, the build included")
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
