"""One process of a spawned gloo world on the CPU, for
``tests/test_torch_parallel.py``: checks of the port's distributed layer
(``torchebm_tpu_torch.parallel`` and what consumes it), each against the
unsharded computation that every process also runs on its own.

    python tests/torch_dist_worker.py {data|hsdp} OUT_DIR

with torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``): the world comes up through
``init_distributed()``. ``data`` is a 2-process ``("data",)`` world,
``hsdp`` a 4-process ``("data", "fsdp") = (2, 2)`` one; each also runs
the samplers' and ``FlowSampler``'s checks on a ``("data",)`` mesh over all
its processes (2 and 4 shards), AIS and HMC once more on the ``(2, 2)`` mesh.
Each check's result (or its traceback) goes to ``OUT_DIR/rank<r>.json``. Imports no JAX; the
samplers' and ``FlowSampler``'s checks also run in one process, on the world
of one that ``tests/test_torch_parallel.py`` brings up.

Where CUDA is visible each process runs on card ``LOCAL_RANK`` over NCCL
(the kernels launch where the CPU runs their plain versions), as under
``torchrun --nproc_per_node 4 tests/torch_dist_worker.py hsdp OUT_DIR`` on a
machine with four cards; the CPU tests hide the cards and run on gloo.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import traceback

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torchebm_tpu_torch as tt  # noqa: E402
from torchebm_tpu_torch.parallel import (  # noqa: E402
    all_gather_cat,
    batch_sharding,
    broadcast_object,
    fsdp_shard_params,
    get_rank,
    get_world_size,
    init_distributed,
    is_distributed,
    local_shard_bounds,
    make_mesh,
    psum_mean,
    replicate,
    shard_batch,
    shard_replay_buffer,
    shuffle_sharded,
)
from torchebm_tpu_torch.parallel.mesh import is_dtensor, row_shard  # noqa: E402


#: this process's device: card LOCAL_RANK where CUDA is visible, else the CPU
DEV = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))) if torch.cuda.is_available()
       else torch.device("cpu"))


def G(seed: int) -> torch.Generator:
    return torch.Generator(DEV).manual_seed(seed)


def err(a, b) -> float:
    a = a.full_tensor() if is_dtensor(a) else a
    b = b.full_tensor() if is_dtensor(b) else b
    return float((a - b).abs().max())


def placements(t) -> str:
    return str(tuple(t.placements)) if is_dtensor(t) else "plain"


# ----------------------------------------------------------------- ("data",)


def check_shim(mesh) -> dict:
    from torchebm_tpu_torch.utils import prefetch_to_device

    x = torch.arange(16.0).reshape(8, 2)
    xs = shard_batch(x, mesh)
    rank = get_rank()
    pre = next(prefetch_to_device([x], device="cpu", sharding=(mesh, batch_sharding(mesh, 2))))
    return {
        "is_distributed": is_distributed(), "rank": rank, "world": get_world_size(),
        "placements": placements(xs), "local": xs.to_local().tolist(),
        "replicated": placements(replicate({"w": torch.ones(3, 3)}, mesh)["w"]),
        "gathered": all_gather_cat(torch.full((2,), float(rank))).tolist(),
        "gathered_stacked": list(all_gather_cat(torch.zeros(3), tiled=False).shape),
        "gathered_dtensor": bool(torch.equal(all_gather_cat(xs), x)),
        "psum_mean": float(psum_mean(torch.tensor(float(rank)))),
        "broadcast": broadcast_object({"from": rank}, src=1)["from"],
        "bounds": list(local_shard_bounds(8)),
        "prefetch": placements(pre), "prefetch_equal": bool(torch.equal(pre.full_tensor(), x)),
    }


def check_langevin(mesh) -> dict:
    """Sharded against unsharded: the mixture row's plain version (chain
    offsets), its trajectory, the generic loop and the neural row; and the
    shards of one seed draw apart."""
    energy = tt.GaussianMixtureEnergy.eight_gaussians()
    x0 = torch.randn(64, 2, generator=G(1))
    out = {}
    for fused in ("force", "off"):
        s = tt.LangevinDynamics(energy, step_size=0.05, fused=fused)
        plain = s.sample(G(2), x=x0, n_steps=30)
        sharded = s.sample(G(2), x=shard_batch(x0, mesh), n_steps=30)
        out[f"final_{fused}"] = err(sharded, plain)
        out[f"placements_{fused}"] = placements(sharded)
        traj = s.sample(G(3), x=shard_batch(x0, mesh), n_steps=30, thin=5, return_trajectory=True)
        out[f"trajectory_{fused}"] = err(traj, s.sample(G(3), x=x0, n_steps=30, thin=5,
                                                        return_trajectory=True))
        out[f"trajectory_shape_{fused}"] = list(traj.shape)
        zeros = s.sample(G(0), x=shard_batch(torch.zeros(64, 2), mesh), n_steps=5)
        out[f"local_sum_{fused}"] = float(zeros.to_local().sum())
        out[f"shared_sum_{fused}"] = float(s.sample(G(0), x=torch.zeros(32, 2), n_steps=5).sum())
    torch.manual_seed(0)
    e = tt.core.as_energy(tt.MLPEnergy(2, (16, 16)))
    s = tt.LangevinDynamics(e, step_size=0.01, fused_neural="force")
    out["neural"] = err(s.sample(G(4), x=shard_batch(x0, mesh), n_steps=10),
                        s.sample(G(4), x=x0, n_steps=10))
    return out


# ------------------------------------------------------------ the samplers


N_SHARDED = 16  # chains of the samplers' checks: 16, 8 or 4 per shard


def rel(a, b) -> float:
    """``max |a - b|`` over ``max(1, max |b|)``."""
    a = a.full_tensor() if is_dtensor(a) else torch.as_tensor(a)
    b = b.full_tensor() if is_dtensor(b) else torch.as_tensor(b)
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def _on_rows(x, mesh, dim):
    """``x`` split on ``dim`` over the mesh's first axis (replicated over
    the others), or replicated (``dim`` None)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    if dim is None:
        return replicate(x, mesh)
    return distribute_tensor(x, mesh, [Shard(dim)] + [Replicate()] * (mesh.ndim - 1))


def _corr():
    return tt.GaussianEnergy.create(torch.zeros(2), torch.tensor([[1.0, 0.8], [0.8, 1.0]]))


def _identity_metric(x):
    return torch.eye(x.shape[-1], dtype=x.dtype, device=x.device).expand(x.shape[0], -1, -1)


def _radial_metric(x):
    """G(x) = (1 + |x|^2) I: the generalised leapfrog's stages iterate."""
    return (1.0 + torch.sum(x * x, -1))[:, None, None] * _identity_metric(x)


def _sampler_case(name):
    """``(x0, row dim or None, fused modes, run)``: ``run(generator, x,
    fused)`` returns ``({output: tensor}, {statistic: tensor})`` of the
    sampler ``name`` on the batch ``x`` (plain or sharded)."""
    mix = tt.GaussianMixtureEnergy.eight_gaussians()
    g0 = G(60)
    x0 = torch.randn(N_SHARDED, 2, generator=g0)
    both = ("force", "off")

    def chain(make, n_steps=6):
        def run(g, x, fused):
            s = make(fused)
            outs = {"final": s.sample(g, x=x, n_steps=n_steps),
                    "trajectory": s.sample(g, x=x, n_steps=n_steps, thin=2,
                                           return_trajectory=True)}
            last, diag = s.sample(g, x=x, n_steps=4, return_diagnostics=True)
            outs["diagnosed"] = last
            return outs, diag
        return run

    if name == "mala":
        return x0, 0, both, chain(lambda f: tt.MetropolisAdjustedLangevin(
            mix, step_size=0.05, fused=f))
    if name == "hmc":
        return x0, 0, both, chain(lambda f: tt.HamiltonianMonteCarlo(
            mix, step_size=0.1, n_leapfrog_steps=3, fused=f))
    if name == "pt":
        return x0, 0, both, chain(lambda f: tt.ParallelTemperingLangevin(
            mix, temperatures=(1.0, 2.0, 4.0), step_size=0.05, swap_every=2, fused=f))
    if name == "gradient_descent":
        return x0, 0, both, chain(lambda f: tt.GradientDescentSampler(
            mix, step_size=0.05, fused=f))
    if name == "langevin_implicit":
        # no row takes another integrator: the loop, its Picard residual over
        # every shard (at tol 1e-2 one shard's residual alone stops elsewhere)
        return x0, 0, both, chain(lambda f: tt.LangevinDynamics(
            mix, step_size=0.05, fused=f, integrator=tt.get_integrator(
                "backward_euler", solver_check_every=1, solver_tol=1e-2)))
    if name == "doublewell_row":
        return torch.randn(N_SHARDED, 3, generator=g0), 0, both, chain(
            lambda f: tt.LangevinDynamics(tt.DoubleWellEnergy(), step_size=0.01, fused=f))
    if name == "nuts":
        return x0, 0, (None,), chain(lambda f: tt.NoUTurnSampler(
            _corr(), step_size=0.3, max_tree_depth=4), n_steps=3)
    if name == "rmhmc":
        return x0, 0, (None,), chain(lambda f: tt.RiemannianManifoldHMC(
            _corr(), metric_fn=_identity_metric, step_size=0.2, n_leapfrog_steps=3))
    if name == "rmhmc_picard":
        # a metric that depends on x, the Picard stop checked at every update
        # on the residual over every shard (at tol 1e-3 one shard's residual
        # alone stops elsewhere)
        return x0, 0, (None,), chain(lambda f: tt.RiemannianManifoldHMC(
            _corr(), metric_fn=_radial_metric, step_size=0.2, n_leapfrog_steps=3,
            integrator=tt.get_integrator("generalised_leapfrog", solver_check_every=1,
                                         solver_tol=1e-3)))
    if name == "pt_run_replicas":
        def run(g, x, fused):
            s = tt.ParallelTemperingLangevin(mix, temperatures=(1.0, 2.0, 4.0), step_size=0.05,
                                             swap_every=2, fused=fused)
            ladder, acc = s.run_replicas(g, x, 6)
            return {"ladder": ladder}, {"acceptance": acc}
        return torch.randn(3, N_SHARDED, 2, generator=g0), 1, both, run
    if name == "ais":
        base = tt.GaussianEnergy.create(torch.zeros(2), 9.0 * torch.eye(2))

        def run(g, betas, fused):
            r = tt.annealed_importance_sampling(g, mix, base=base, n_samples=N_SHARDED,
                                                step_size=0.05, betas=betas, fused=fused)
            return ({"samples": r.samples, "log_weights": r.log_weights},
                    {k: getattr(r, k) for k in ("log_z", "log_z_ratio", "ess",
                                                "acceptance_rate")})
        return torch.linspace(0.0, 1.0, 5), None, both, run
    raise KeyError(name)


SAMPLERS = ("ais", "doublewell_row", "gradient_descent", "hmc", "langevin_implicit", "mala",
            "nuts", "pt", "pt_run_replicas", "rmhmc", "rmhmc_picard")


def sampler_check(name: str, mesh) -> dict:
    """``{fused mode: result}`` of sampler ``name`` on a sharded batch
    against the unsharded call from the same seed: each output's largest
    difference and whether it kept the input's placements, each statistic's
    relative difference, and this process's rows of the first output (so that
    the test sees that the shards ran different rows)."""
    x0, dim, modes, run = _sampler_case(name)
    xs = _on_rows(x0, mesh, dim)
    out = {}
    for fused in modes:
        got, got_stats = run(G(61), xs, fused)
        want, want_stats = run(G(61), x0, fused)
        first = next(iter(got.values()))
        out[str(fused)] = {
            "outputs": {k: err(v, want[k]) for k, v in got.items()},
            "placements": {k: (not is_dtensor(v) and dim is None)
                           or placements(v) == placements(xs) for k, v in got.items()},
            "stats": {k: rel(v, want_stats[k]) for k, v in got_stats.items()},
            "stat_keys": sorted(got_stats) == sorted(want_stats),
            "local_sum": float(first.to_local().sum()) if is_dtensor(first) else None,
        }
    return out


def check_samplers(mesh) -> dict:
    """:func:`sampler_check` of every sampler, each failing on its own."""
    out = {}
    for name in SAMPLERS:
        try:
            out[name] = sampler_check(name, mesh)
        except Exception:  # recorded: that sampler's test fails with the traceback
            out[name] = {"error": traceback.format_exc()}
    return out


def warmup_check(name: str, mesh) -> dict:
    """HMC's or NUTS's warmup with a diagonal mass on a sharded batch
    against the unsharded one: the step size (a float, the same on every
    process), the mass and the warmed states."""
    s = (tt.HamiltonianMonteCarlo(_corr(), step_size=0.1, n_leapfrog_steps=3) if name == "hmc"
         else tt.NoUTurnSampler(_corr(), step_size=0.3, max_tree_depth=4))
    x0 = torch.randn(N_SHARDED, 2, generator=G(62))
    xs, eps, mass = s.warmup(G(63), x=shard_batch(x0, mesh), n_warmup=8, adapt_mass=True)
    x_ref, eps_ref, mass_ref = s.warmup(G(63), x=x0, n_warmup=8, adapt_mass=True)
    return {"eps": eps, "eps_rel": abs(eps - eps_ref) / eps_ref, "mass": mass.tolist(),
            "mass_rel": rel(mass, mass_ref), "x": err(xs, x_ref),
            "placements": placements(xs) == placements(shard_batch(x0, mesh))}


def ptcd_check(mesh) -> dict:
    """A ParallelTemperingCD loss on a sharded batch against the unsharded
    one: value, energies, negatives and the gradient (the mean of the
    processes' gradients, as FSDP2 and the trainer take it)."""
    from torchebm_tpu_torch.parallel import psum_mean

    torch.manual_seed(0)
    net = tt.MLPEnergy(2, (16, 16))
    e = tt.core.as_energy(net)
    loss = tt.ParallelTemperingCD(model=e, sampler=tt.ParallelTemperingLangevin(
        e, temperatures=(1.0, 2.0, 4.0), step_size=0.01, swap_every=2), k_steps=4)
    x = torch.randn(N_SHARDED, 2, generator=G(64))
    out = {}
    for label, batch in (("sharded", shard_batch(x, mesh)), ("unsharded", x)):
        net.zero_grad()
        value, (neg, _), energies = loss.loss_and_energies(None, batch, G(65))
        value.backward()
        grads = [p.grad.detach().clone() for p in net.parameters()]
        if label == "sharded":
            grads = [psum_mean(gr, "data", mesh=mesh) for gr in grads]
        out[label] = (value.detach(), neg, energies, grads)
    (v, n, e_, g), (v0, n0, e0, g0) = out["sharded"], out["unsharded"]
    return {"loss": rel(v, v0), "negatives": err(n, n0),
            "negatives_placements": placements(n) == placements(shard_batch(x, mesh)),
            "energies": {k: rel(e_[k], e0[k]) for k in e0},
            "grads": max(rel(a, b) for a, b in zip(g, g0))}


def check_sampler_extras(mesh) -> dict:
    """The warmups and the ParallelTemperingCD loss, each failing on its own."""
    out = {}
    for name, fn in (("hmc_warmup", functools.partial(warmup_check, "hmc")),
                     ("nuts_warmup", functools.partial(warmup_check, "nuts")),
                     ("ptcd", ptcd_check)):
        try:
            out[name] = fn(mesh)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out


FLOW_CASES = ("euler", "dopri5", "backward_euler", "sde", "log_prob", "log_prob_hutchinson",
              "reflow")


def _flow_field():
    """The exact velocity of the linear path from N(0, I) to N((2, 0), I / 4)
    plus a small random SiLU MLP: its SDE is stable at the default 250
    steps, and dopri5 rejects steps at tight tolerances."""
    torch.manual_seed(0)
    net = tt.MLPVelocityField(2, (16, 16))
    with torch.no_grad():
        net.layers[0].weight.mul_(4.0)
    m = torch.tensor([2.0, 0.0])

    def field(x, t):
        s = t[:, None]
        exact = m + (x - s * m) * (0.25 * s - (1 - s)) / (0.25 * s**2 + (1 - s) ** 2)
        return exact + 0.05 * net(x, t)

    return field


def flow_check(name: str, mesh) -> dict:
    """``FlowSampler`` case ``name`` on a batch sharded over the mesh's first
    axis against the unsharded call from the same seed: each output's
    largest difference (the log-densities' relative to max(1, |value|)) and
    whether it kept the input's placement, the
    diagnostics' relative differences, and for ``dopri5`` (tolerances tight
    enough to reject steps) the attempted and accepted counts of the
    integrator's controller with the rows pooled and without."""
    from torchebm_tpu_torch.samplers.base import _Rows

    net = _flow_field()
    x0 = torch.randn(N_SHARDED, 2, generator=G(70))
    xs = shard_batch(x0, mesh)
    out = {"stats": {}, "counts": {}}
    if name in ("log_prob", "log_prob_hutchinson"):
        s = tt.FlowSampler(model=net, integrator="euler")
        kw = dict(n_steps=6, hutchinson=name == "log_prob_hutchinson", n_probes=2)
        got, want = s.log_prob(xs, generator=G(71), **kw), s.log_prob(x0, generator=G(71), **kw)
        outs = {"log_prob": (got, want)}
    elif name == "reflow":
        c = tt.ReflowCoupling(model=tt.FlowSampler(model=net, mode="sde"))
        got, want = c(xs, generator=G(71)), c(x0, generator=G(71))
        outs = {"x1": (got.x1, want.x1), "x0": (got.x0, want.x0)}
    else:
        integ = {"euler": "euler", "sde": None,
                 "dopri5": tt.get_integrator("dopri5", atol=1e-7, rtol=1e-7),
                 "backward_euler": tt.get_integrator("backward_euler", solver_check_every=1,
                                                     solver_tol=1e-4)}[name]
        s = tt.FlowSampler(model=net, mode="sde" if name == "sde" else "ode", integrator=integ)
        adaptive = name == "dopri5"
        kw = dict(n_steps={"dopri5": 2, "sde": 250}.get(name, 6), thin=1 if adaptive else 2,
                  return_trajectory=not adaptive, return_diagnostics=True)
        (got, diag), (want, want_diag) = s.sample(G(71), x=xs, **kw), s.sample(G(71), x=x0, **kw)
        outs = {"samples": (got, want)}
        out["stats"] = {k: rel(v, want_diag[k]) for k, v in diag.items()}
        out["stat_keys"] = sorted(diag) == sorted(want_diag)
        if adaptive:
            drift = s._get_drift({})
            with torch.no_grad():
                for label, x, norm in (("sharded", xs.to_local(), _Rows(xs).rms_norm),
                                       ("unsharded", x0, None)):
                    _, st = s.integrator.integrate({"x": x}, 0.5, 2, drift=drift, norm=norm,
                                                   return_stats=True)
                    out["counts"][label] = [int(st.n_attempted), int(st.n_accepted)]
    # log-densities of order 5 to 10: their difference relative to max(1, |value|)
    out["outputs"] = {k: (rel if k == "log_prob" else err)(a, b) for k, (a, b) in outs.items()}
    out["placements"] = {k: placements(a) == placements(xs) for k, (a, _) in outs.items()}
    first = next(iter(outs.values()))[0]
    out["local_sum"] = float(first.to_local().sum())
    return out


def check_flow(mesh) -> dict:
    """:func:`flow_check` of every case, each failing on its own."""
    out = {}
    for name in FLOW_CASES:
        try:
            out[name] = flow_check(name, mesh)
        except Exception:  # recorded: that case's test fails with the traceback
            out[name] = {"error": traceback.format_exc()}
    return out


def check_mesh2d_samplers(mesh) -> dict:
    """AIS split over the four processes of the ``(2, 2)`` mesh, and HMC on
    a batch sharded over ``"data"`` and replicated over ``"fsdp"``, each
    failing on its own."""
    out = {}
    for name in ("ais", "hmc"):
        try:
            out[name] = sampler_check(name, mesh)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out


def check_diagnostics(mesh) -> dict:
    traj = torch.randn(16, 40, 2, generator=G(5)) + torch.linspace(0, 0.5, 16)[:, None, None]
    sharded = shard_batch(traj, mesh)
    out = {
        "r_hat": err(tt.potential_scale_reduction(sharded), tt.potential_scale_reduction(traj)),
        "ess": err(tt.effective_sample_size(sharded), tt.effective_sample_size(traj)),
        "tail_ess": err(tt.tail_effective_sample_size(sharded),
                        tt.tail_effective_sample_size(traj)),
    }
    got = tt.summarize_chains(sharded, rank_normalized=True)
    want = tt.summarize_chains(traj, rank_normalized=True)
    out["summary"] = {k: (err(got[k], want[k]) if isinstance(want[k], torch.Tensor)
                          else float(got[k] != want[k])) for k in want}
    out["r_hat_value"] = tt.potential_scale_reduction(traj).tolist()
    return out


def check_buffer(mesh) -> dict:
    """The global shuffle, and a PCD step on a sharded buffer."""
    from torchebm_tpu_torch.losses import ReplayBuffer

    buf = ReplayBuffer(samples=torch.arange(32.0)[:, None] * torch.ones(1, 2), ptr=5)
    sb = shard_replay_buffer(buf, mesh)
    shuffled = shuffle_sharded(G(3), sb)
    whole = shuffled.samples.full_tensor()
    out = {
        "placements": placements(sb.samples), "ptr": shuffled.ptr,
        "shuffled_placements": placements(shuffled.samples),
        "same_rows": sorted(whole[:, 0].tolist()) == sorted(buf.samples[:, 0].tolist()),
        "moved": float((whole - buf.samples).abs().max()),
        "equal_unsharded": err(whole, shuffle_sharded(G(3), buf).samples),
    }
    torch.manual_seed(0)
    net = tt.MLPEnergy(2, (16, 16))
    e = tt.core.as_energy(net)
    cd = tt.PersistentContrastiveDivergence(
        model=e, sampler=tt.LangevinDynamics(e, step_size=0.01, fused_neural="force"),
        k_steps=3, buffer_size=32, init_steps=0)
    trainer = tt.ContrastiveDivergenceTrainer(cd, learning_rate=1e-3)
    pcd_buf = shard_replay_buffer(cd.init_buffer(G(4), (2,)), mesh)
    before = pcd_buf.samples.to_local().clone()
    state = trainer.init_state(net, G(5), loss_state=pcd_buf)
    state, metrics = trainer.train_step(state, shard_batch(torch.randn(8, 2, generator=G(6)), mesh))
    after = state.loss_state.samples.to_local()
    out["pcd_written_rows"] = torch.nonzero((after != before).any(dim=1)).flatten().tolist()
    out["pcd_ptr"] = state.loss_state.ptr
    out["pcd_loss"] = float(metrics["loss"])
    out["pcd_buffer_placements"] = placements(state.loss_state.samples)
    out["pcd_param_sum"] = float(sum(p.detach().double().sum() for p in net.parameters()))
    return out


def check_sinkhorn(mesh) -> dict:
    x0 = torch.randn(32, 2, generator=G(7))
    x1 = torch.randn(32, 2, generator=G(8)) + 2.0
    c = tt.SinkhornCoupling(n_iters=30, fused="force")
    got = c(shard_batch(x0, mesh), shard_batch(x1, mesh), generator=G(9))
    want = c(x0, x1, generator=G(9))
    return {"x1": err(got.x1, want.x1), "x0": err(got.x0, want.x0),
            "placements": placements(got.x1)}


# ------------------------------------------------------- ("data", "fsdp")


def _cd_trainer(fused_neural: str, net):
    e = tt.core.as_energy(net)
    cd = tt.ContrastiveDivergence(
        model=e, sampler=tt.LangevinDynamics(e, step_size=0.01, fused_neural=fused_neural),
        k_steps=5)
    return tt.ContrastiveDivergenceTrainer(cd, learning_rate=1e-2, ema_decay=0.9)


def _mlp(seed: int = 0):
    torch.manual_seed(seed)
    return tt.MLPEnergy(2, (64, 64))


def _shard(net, mesh):
    return fsdp_shard_params(net, mesh, min_size=1024)


def check_fsdp_placements(mesh) -> dict:
    net = _shard(_mlp(), mesh)
    tree = fsdp_shard_params({"big": torch.randn(64, 32, generator=G(1)), "small": torch.ones(4),
                              "odd": torch.randn(33, 7, generator=G(2))}, mesh, min_size=64)
    return {"module": {n: placements(p) for n, p in net.named_parameters()},
            "tree": {k: placements(v) for k, v in tree.items()},
            "tree_equal": err(tree["big"], torch.randn(64, 32, generator=G(1)))}


def check_fsdp_local_batches(mesh) -> dict:
    """An FSDP2 model trained on plain (not DTensor) batches, a different
    quarter of one batch in each process: FSDP2 averages its own gradients
    over the mesh and the trainer the replicated parameters', so one step
    equals the unsharded step on the whole batch."""
    x = torch.randn(16, 2, generator=G(40))

    def loss_of(net):
        return lambda params, xb, generator, model_kwargs=None: torch.mean(torch.square(net(xb)))

    ref_net = _mlp()
    ref = tt.BaseTrainer(loss_of(ref_net), functools.partial(torch.optim.Adam, lr=1e-2))
    ref.train_step(ref.init_state(ref_net, G(41)), x)
    net = _shard(_mlp(), mesh)
    trainer = tt.BaseTrainer(loss_of(net), functools.partial(torch.optim.Adam, lr=1e-2))
    rank = get_rank()
    trainer.train_step(trainer.init_state(net, G(41)), x[4 * rank:4 * rank + 4])
    ref_params = dict(ref_net.named_parameters())
    return {name: err(p, ref_params[name]) for name, p in net.named_parameters()}


def check_hsdp_cd(mesh) -> dict:
    """The HSDP CD step against the replicated one, through the neural
    kernel's plain version and through the generic loop."""
    out = {}
    batches = [torch.randn(16, 2, generator=G(10 + i)) for i in range(2)]
    for mode in ("force", "off"):
        ref_net = _mlp()
        ref = _cd_trainer(mode, ref_net)
        ref_state = ref.init_state(ref_net, G(7))
        net = _shard(_mlp(), mesh)
        trainer = _cd_trainer(mode, net)
        state = trainer.init_state(net, G(7))
        before = {n: placements(p) for n, p in net.named_parameters()}
        losses = []
        for b in batches:
            ref_state, m_ref = ref.train_step(ref_state, b)
            state, m = trainer.train_step(state, shard_batch(b, mesh))
            losses.append(abs(float(m["loss"]) - float(m_ref["loss"])))
            for key in ("pos_energy", "neg_energy"):
                losses.append(abs(float(m[key]) - float(m_ref[key])))
        ref_params = dict(ref_net.named_parameters())
        out[mode] = {
            "loss": max(losses),
            "loss_value": float(m_ref["loss"]),
            "params": max(err(p, ref_params[n]) for n, p in net.named_parameters()),
            "ema": max(err(v, ref_state.ema_params[n]) for n, v in state.ema_params.items()),
            "placements_kept": before == {n: placements(p) for n, p in net.named_parameters()},
            "ema_placements": {n: placements(v) for n, v in state.ema_params.items()} == before,
            "sharded": sorted(n for n, pl in before.items() if "Shard" in pl),
        }
    return out


def _label_dit():
    from torch import nn

    from torchebm_tpu_torch.models import (
        ConditionalTransformer2D,
        LabelEmbedder,
        MLPTimestepEmbedder,
    )

    class LabelDiT(nn.Module):
        def __init__(self):
            super().__init__()
            self.t_embed = MLPTimestepEmbedder(32)
            self.y_embed = LabelEmbedder(10, 32, dropout_prob=0.1)
            self.dit = ConditionalTransformer2D(in_channels=1, out_channels=1, input_size=8,
                                                patch_size=4, embed_dim=32, depth=1,
                                                num_heads=4, cond_dim=32)

        def forward(self, x, t, *, y, drop):
            return self.dit(x, self.t_embed(t) + self.y_embed(y, force_drop_mask=drop))

    torch.manual_seed(3)
    return LabelDiT()


def _flow_matching_loss(net):
    """The JAX dryrun's CFG flow-matching loss (``__graft_entry__.py``):
    noise, times and label drops drawn for the whole batch and cut to the
    local rows of a sharded one; the local rows' mean."""

    def loss(params, x1, generator, model_kwargs=None):
        y = model_kwargs["y"]
        start, n = 0, x1.shape[0]
        if is_dtensor(x1):
            x1, start, n = row_shard(x1)
            y = y.to_local()
        rows = slice(start, start + x1.shape[0])
        x0 = torch.randn((n, *x1.shape[1:]), generator=generator)[rows]
        t = torch.rand((n,), generator=generator)[rows]
        drop = (torch.rand((n,), generator=generator) < 0.1)[rows]
        tt_ = t[:, None, None, None]
        xt, ut = (1 - tt_) * x0 + tt_ * x1, x1 - x0
        return torch.mean(torch.square(net(xt, t, y=y, drop=drop) - ut))

    return loss


def check_dit(mesh) -> dict:
    x1 = torch.randn(8, 1, 8, 8, generator=G(20))
    y = torch.randint(0, 10, (8,), generator=G(21))
    opt = functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=1e-4)
    ref_net = _label_dit()
    ref = tt.BaseTrainer(_flow_matching_loss(ref_net), opt)
    ref_state, m_ref = ref.train_step(ref.init_state(ref_net, G(22)), (x1, {"y": y}))
    net = fsdp_shard_params(_label_dit(), mesh, min_size=512)
    trainer = tt.BaseTrainer(_flow_matching_loss(net), opt)
    before = {n: placements(p) for n, p in net.named_parameters()}
    state, m = trainer.train_step(trainer.init_state(net, G(22)),
                                  (shard_batch(x1, mesh), {"y": shard_batch(y, mesh)}))
    ref_params = dict(ref_net.named_parameters())
    return {
        "loss": abs(float(psum_mean(m["loss"].detach(), "data", mesh=mesh)) - float(m_ref["loss"])),
        "finite": bool(torch.isfinite(m["loss"])),
        "params": max(err(p, ref_params[n]) for n, p in net.named_parameters()),
        "placements_kept": before == {n: placements(p) for n, p in net.named_parameters()},
        "sharded": sorted(n for n, pl in before.items() if "Shard" in pl),
    }


def check_dcp(mesh, ckpt: str) -> dict:
    """A sharded CD state saved by every process, restored onto a fresh
    sharded template bitwise and stepped again alike; restore_or_init."""
    net = _shard(_mlp(), mesh)
    trainer = _cd_trainer("force", net)
    state = trainer.init_state(net, G(30))
    state, _ = trainer.train_step(state, shard_batch(torch.randn(16, 2, generator=G(31)), mesh))
    trainer.save(state, ckpt)
    saved = {n: (p.full_tensor() if is_dtensor(p) else p).detach().clone()
             for n, p in net.named_parameters()}
    fresh = _shard(_mlp(seed=5), mesh)
    fresh_trainer = _cd_trainer("force", fresh)
    restored = fresh_trainer.restore(ckpt, fresh_trainer.init_state(fresh, G(99)))
    out = {
        "files": sorted(os.listdir(os.path.join(ckpt, "step_00000001"))),
        "params": max(err(p, saved[n]) for n, p in fresh.named_parameters()),
        "ema": max(err(v, state.ema_params[n]) for n, v in restored.ema_params.items()),
        "step": restored.step,
        "generator": bool(torch.equal(restored.generator.get_state(), state.generator.get_state())),
        "placements": {n: placements(p) for n, p in fresh.named_parameters()}
        == {n: placements(p) for n, p in net.named_parameters()},
        "adam_state": max(err(restored.optimizer.state[p][k], state.optimizer.state[q][k])
                          for p, q in zip(fresh.parameters(), net.parameters())
                          for k in ("step", "exp_avg", "exp_avg_sq")),
    }
    batch = shard_batch(torch.randn(16, 2, generator=G(32)), mesh)
    restored, m = fresh_trainer.train_step(restored, batch)
    state, m_orig = trainer.train_step(state, batch)
    out["resumed_step"] = restored.step
    out["resumed_loss"] = abs(float(m["loss"]) - float(m_orig["loss"]))
    out["resumed_params"] = max(err(p, q) for p, q in zip(fresh.parameters(), net.parameters()))
    other = _shard(_mlp(seed=6), mesh)
    again = _cd_trainer("force", other).restore_or_init(ckpt, other, G(0))
    out["restore_or_init_step"] = again.step
    out["restore_or_init_params"] = max(err(p, saved[n]) for n, p in other.named_parameters())
    return out


def main() -> None:
    kind, out_dir = sys.argv[1], sys.argv[2]
    rank, world = init_distributed()
    results = {"init": {"rank": rank, "world": world, "again": list(init_distributed()),
                        "backend": dist.get_backend(), "device": str(DEV)}}
    torch.set_default_device(DEV)  # the checks' tensors and models
    flat = make_mesh(("data",), devices=DEV.type)  # every process on the chains' axis
    if kind == "data":
        mesh = flat
        checks = (check_shim, check_langevin, check_diagnostics, check_buffer, check_sinkhorn)
    else:
        mesh = make_mesh(("data", "fsdp"), (2, 2), devices=DEV.type)
        checks = (check_fsdp_placements, check_fsdp_local_batches, check_hsdp_cd, check_dit,
                  functools.partial(check_dcp, ckpt=os.path.join(out_dir, "ckpt")),
                  check_mesh2d_samplers)
    runs = [(check, mesh) for check in checks] + [(check_samplers, flat),
                                                  (check_sampler_extras, flat),
                                                  (check_flow, flat)]
    results["mesh"] = {"shape": list(mesh.shape), "names": list(mesh.mesh_dim_names)}
    for check, on in runs:
        name = getattr(check, "__name__", None) or check.func.__name__
        try:
            results[name] = check(on)
        except Exception:  # recorded: the test of this check fails with the traceback
            results[name] = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
