"""The port's distributed layer (``torchebm_tpu_torch.parallel`` and what
consumes it) on the CPU: the counterpart of ``tests/parallel/test_mesh.py``,
``test_sharded_checkpoint.py`` and ``tests/distributed/test_multiprocess.py``.

- Single-process identities, and a world of one (what :func:`make_mesh`
  brings up by itself), in this process.
- Two spawned gloo worlds (``tests/torch_dist_worker.py``): a 2-process
  ``("data",)`` world and a 4-process ``("data", "fsdp") = (2, 2)`` one,
  brought up from torchrun's environment through ``init_distributed``. Each
  spawns once, both at the same time, within one 120 s deadline; every process
  runs the checks and compares with the unsharded computation it also runs.
  The tests below read their results, one per check.
- The FSDP sharding rule against the JAX package's ``fsdp_shard_params`` on
  its 8-device CPU mesh.

Tolerances: the sharded paths draw the same numbers in the same order; the
samplers, ``FlowSampler`` and couplings agree to 1e-6 (the CPU's products may
round by batch size; ``log_prob`` relative to max(1, |value|)), dopri5 with
its attempted and accepted steps equal, the checkpoints bitwise; the pooled
R̂ and ESS sum in another order (1e-5 relative); the HSDP CD step differs
from the replicated one by the order of the gradient's sum over shards,
which Adam (lr 1e-2) carries into the parameters: 1e-5 on the loss and 1e-4
on the parameters, as the JAX test allows.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torchebm_tpu_torch as tt
from torchebm_tpu_torch.parallel import (
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
    replicated_sharding,
    shard_batch,
)
from torchebm_tpu_torch.parallel.mesh import _shard_dim, is_dtensor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as worker  # noqa: E402  (imports no JAX)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_worker.py")
SPAWN_TIMEOUT = 120
WORLDS = {"data": 2, "hsdp": 4}
LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "TORCHEBM_DISTRIBUTED", "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds():
    """``{world: [per-rank results]}``: both worlds spawned at once; spawned
    again, once, only if a store's port was taken between the probe that
    found it free and the world's bind."""
    try:
        return _spawn_worlds()
    except RuntimeError as e:
        if "Address already in use" not in str(e):
            raise
        return _spawn_worlds()


def _spawn_worlds() -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for kind, size in WORLDS.items():
            out = os.path.join(tmp, kind)
            os.makedirs(out)
            port = _free_port()
            for rank in range(size):
                env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
                env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(size),
                           RANK=str(rank), LOCAL_RANK=str(rank), CUDA_VISIBLE_DEVICES="",
                           OMP_NUM_THREADS="1")
                procs[kind, rank] = subprocess.Popen(
                    [sys.executable, WORKER, kind, out], env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
        errors = []
        deadline = time.monotonic() + SPAWN_TIMEOUT
        try:
            for (kind, rank), p in procs.items():
                try:
                    log, _ = p.communicate(timeout=max(deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    errors.append(f"{kind} rank {rank} timed out after {SPAWN_TIMEOUT} s")
                    continue
                if p.returncode != 0:
                    errors.append(f"{kind} rank {rank} rc={p.returncode}\n{log[-4000:]}")
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if errors:
            raise RuntimeError("\n----\n".join(errors))
        results = {}
        for kind, size in WORLDS.items():
            results[kind] = []
            for rank in range(size):
                with open(os.path.join(tmp, kind, f"rank{rank}.json")) as f:
                    results[kind].append(json.load(f))
        return results


def _check(worlds, kind: str, name: str) -> list:
    """The per-rank results of one check, failing with a rank's traceback."""
    per_rank = [r[name] for r in worlds[kind]]
    for rank, r in enumerate(per_rank):
        assert "error" not in r, f"{kind} rank {rank}:\n{r.get('error')}"
    return per_rank


# ------------------------------------------------------------ no group


def test_shim_is_the_identity_without_a_group(monkeypatch):
    for var in LAUNCH_ENV:
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    assert (is_distributed(), get_rank(), get_world_size()) == (False, 0, 1)
    x = torch.arange(4.0)
    assert all_gather_cat(x) is x and psum_mean(x) is x
    obj = {"a": 1}
    assert broadcast_object(obj) is obj
    assert local_shard_bounds(8) == (0, 8)
    assert init_distributed() == (0, 1)
    assert not dist.is_initialized()


def test_init_distributed_leaves_a_one_task_cluster_single_process(monkeypatch):
    for var in LAUNCH_ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SLURM_JOB_ID", "7")
    monkeypatch.setenv("SLURM_PROCID", "0")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert init_distributed() == (0, 1)
    assert not dist.is_initialized()


@pytest.mark.parametrize("shape,numel,axis,min_size,want", [
    ((256, 128), 256 * 128, 2, 64, 0), ((7, 256), 7 * 256, 2, 64, 1),
    ((4,), 4, 2, 64, None), ((33, 7), 231, 2, 64, None), ((256, 128), 256 * 128, 2, 2**16, None),
    ((8, 8), 64, 1, 64, 0),
])
def test_shard_dim_rule(shape, numel, axis, min_size, want):
    assert _shard_dim(shape, numel, axis, min_size) == want


@pytest.mark.parametrize("shape", [(256, 128), (7, 256), (4,), (33, 7), (96, 64, 3), (12, 10)])
def test_fsdp_rule_matches_the_jax_package(shape):
    """The JAX package's ``fsdp_shard_params`` on its 8-device CPU mesh,
    ``("data", "fsdp") = (4, 2)``, splits the dimension the port's rule
    picks (min_size 64)."""
    import jax.numpy as jnp

    from torchebm_tpu.parallel import fsdp_shard_params as jax_fsdp
    from torchebm_tpu.parallel import make_mesh as jax_mesh

    spec = tuple(jax_fsdp({"w": jnp.zeros(shape)}, jax_mesh(("data", "fsdp"), (4, 2)),
                          min_size=64)["w"].sharding.spec)
    jax_dim = next((i for i, s in enumerate(spec) if s == "fsdp"), None)
    assert _shard_dim(shape, int(np.prod(shape)), 2, 64) == jax_dim


# ------------------------------------------------------------ world of one


@pytest.fixture(scope="module")
def mesh2d():
    """A ``("data", "fsdp") = (1, 1)`` CPU mesh over the world of one that
    :func:`make_mesh` brings up in this process; the group is torn down
    after the module."""
    created = not dist.is_initialized()
    mesh = make_mesh(("data", "fsdp"), (1, 1), devices="cpu")
    yield mesh
    if created and dist.is_initialized():
        dist.destroy_process_group()


def test_make_mesh_brings_up_a_world_of_one(mesh2d):
    assert dist.is_initialized() and not is_distributed()
    assert mesh2d.mesh_dim_names == ("data", "fsdp") and tuple(mesh2d.shape) == (1, 1)
    assert tuple(make_mesh(("data",), devices="cpu").shape) == (1,)
    with pytest.raises(ValueError):
        make_mesh(("data",), (3,), devices="cpu")
    with pytest.raises(ValueError):
        make_mesh(("data", "fsdp"), (1,), devices="cpu")


def test_batch_and_replicated_placements(mesh2d):
    from torch.distributed.tensor import Replicate, Shard

    assert batch_sharding(mesh2d, 2) == (Shard(0), Replicate())
    assert batch_sharding(mesh2d, 3, axis="fsdp") == (Replicate(), Shard(0))
    assert replicated_sharding(mesh2d) == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        batch_sharding(mesh2d, 2, axis="model")


def test_shard_batch_and_replicate_keep_values(mesh2d):
    x = torch.randn(8, 2, generator=torch.Generator().manual_seed(0))
    tree = shard_batch({"x": x, "pair": (x, 3)}, mesh2d)
    assert is_dtensor(tree["x"]) and tree["pair"][1] == 3
    assert torch.equal(tree["x"].full_tensor(), x)
    rep = replicate({"w": x}, mesh2d)["w"]
    assert tuple(rep.placements) == replicated_sharding(mesh2d)


def test_fsdp_shard_params_tree_placements(mesh2d):
    from torch.distributed.tensor import Replicate, Shard

    big = torch.randn(256, 128, generator=torch.Generator().manual_seed(0))
    out = fsdp_shard_params({"big": big, "small": torch.ones(4)}, mesh2d, min_size=64)
    assert tuple(out["big"].placements) == (Replicate(), Shard(0))
    assert tuple(out["small"].placements) == (Replicate(), Replicate())
    assert torch.equal(out["big"].full_tensor(), big)


def test_sharded_langevin_in_a_world_of_one(mesh2d):
    e = tt.GaussianMixtureEnergy.eight_gaussians()
    x0 = torch.randn(16, 2, generator=torch.Generator().manual_seed(1))
    for fused in ("force", "off"):
        s = tt.LangevinDynamics(e, step_size=0.05, fused=fused)
        want = s.sample(torch.Generator().manual_seed(2), x=x0, n_steps=10)
        got = s.sample(torch.Generator().manual_seed(2), x=shard_batch(x0, mesh2d), n_steps=10)
        assert tuple(got.placements) == batch_sharding(mesh2d, 2)
        torch.testing.assert_close(got.full_tensor(), want, rtol=0, atol=1e-6)
        got, diag = s.sample(torch.Generator().manual_seed(3), x=shard_batch(x0, mesh2d),
                             n_steps=6, thin=2, return_diagnostics=True)
        want, want_diag = s.sample(torch.Generator().manual_seed(3), x=x0, n_steps=6, thin=2,
                                   return_diagnostics=True)
        torch.testing.assert_close(got.full_tensor(), want, rtol=0, atol=1e-6)
        assert sorted(diag) == sorted(want_diag) == ["energy", "mean", "var"]
        for k, v in want_diag.items():
            torch.testing.assert_close(diag[k], v, rtol=1e-6, atol=1e-6)


def _assert_sampler(result, name):
    """One sampler's :func:`torch_dist_worker.sampler_check`: every output
    within 1e-6 of the unsharded call's, laid out as the input, every
    statistic within 1e-6 relative, in each fused mode."""
    assert "error" not in result, result.get("error")
    modes = ("None",) if name in ("nuts", "rmhmc", "rmhmc_picard") else ("force", "off")
    assert sorted(result) == sorted(modes)
    for fused, r in result.items():
        assert max(r["outputs"].values()) <= 1e-6, (fused, r["outputs"])
        assert all(r["placements"].values()), (fused, r["placements"])
        assert r["stat_keys"] and r["stats"], (fused, r["stats"])
        assert max(r["stats"].values()) <= 1e-6, (fused, r["stats"])


@pytest.fixture(scope="module")
def mesh1(mesh2d):
    """A ``("data",) = (1,)`` CPU mesh over the world of one of :func:`mesh2d`."""
    return make_mesh(("data",), devices="cpu")


@pytest.mark.parametrize("name", worker.SAMPLERS)
def test_sharded_sampler_equals_unsharded_in_a_world_of_one(mesh1, name):
    """Each sampler on a DTensor batch of one shard (AIS on a replicated
    schedule) gives the unsharded call's values and statistics, with
    ``fused="force"`` and ``"off"``: the kernels' plain versions at chain
    offset 0 and the loops' draws of the whole batch."""
    _assert_sampler(worker.sampler_check(name, mesh1), name)


@pytest.mark.parametrize("name", ["hmc", "nuts"])
def test_sharded_warmup_in_a_world_of_one(mesh1, name):
    r = worker.warmup_check(name, mesh1)
    assert r["eps_rel"] <= 1e-6 and r["mass_rel"] <= 1e-6 and r["x"] <= 1e-6 and r["placements"]


def test_parallel_tempering_cd_on_a_sharded_batch_in_a_world_of_one(mesh1):
    _assert_ptcd(worker.ptcd_check(mesh1))


def _assert_flow(r, name):
    """One :func:`torch_dist_worker.flow_check` case: every output within
    1e-6 of the unsharded call's (the log-densities relative to max(1,
    |value|): the CPU's products round by batch size, and six RK4 steps of a
    divergence carry it), laid out as the input, the diagnostics within 1e-6
    relative; dopri5's controller attempted and accepted as many
    steps with the rows pooled as without, and rejected some."""
    assert "error" not in r, r.get("error")
    assert max(r["outputs"].values()) <= 1e-6, r["outputs"]
    assert all(r["placements"].values()), r["placements"]
    if name in ("euler", "dopri5", "backward_euler", "sde"):
        assert r["stat_keys"] and r["stats"] and max(r["stats"].values()) <= 1e-6, r["stats"]
    if name == "dopri5":
        (att, acc), want = r["counts"]["sharded"], r["counts"]["unsharded"]
        assert [att, acc] == want and att > acc, r["counts"]


@pytest.mark.parametrize("name", worker.FLOW_CASES)
def test_sharded_flow_sampler_equals_unsharded_in_a_world_of_one(mesh1, name):
    """``FlowSampler`` on a DTensor batch of one shard: Euler, dopri5 (the
    controller's pooled error norm), the implicit Euler's pooled Picard
    residual, SDE generation (the whole batch's normals), ``log_prob`` exact
    and Hutchinson (the whole batch's probes) and ``ReflowCoupling``."""
    _assert_flow(worker.flow_check(name, mesh1), name)


def _assert_ptcd(r):
    assert r["loss"] <= 1e-6 and r["negatives"] <= 1e-6 and r["negatives_placements"]
    assert max(r["energies"].values()) <= 1e-6 and r["grads"] <= 1e-5


def test_a_sharded_checkpoint_needs_a_template(mesh2d, tmp_path):
    from torchebm_tpu_torch.utils.training import load_checkpoint, save_checkpoint

    w = fsdp_shard_params({"w": torch.randn(64, 64)}, mesh2d, min_size=64)["w"]
    save_checkpoint(str(tmp_path), 3, {"w": w}, extra={"n": 5})
    assert not os.path.exists(tmp_path / "step_00000003" / "state.pt")
    with pytest.raises(ValueError, match="template"):
        load_checkpoint(str(tmp_path))
    template = {"step": 0, "params": {"w": fsdp_shard_params({"w": torch.zeros(64, 64)}, mesh2d,
                                                             min_size=64)["w"]},
                "extra": {"n": 0}}
    got = load_checkpoint(str(tmp_path), template=template)
    assert got["step"] == 3 and got["extra"]["n"] == 5
    assert tuple(got["params"]["w"].placements) == tuple(w.placements)
    assert torch.equal(got["params"]["w"].full_tensor(), w.full_tensor())


# ------------------------------------------------------------ spawned worlds


@pytest.mark.parametrize("kind", sorted(WORLDS))
def test_init_distributed_from_torchrun_environment(worlds, kind):
    ranks = [r["init"] for r in worlds[kind]]
    assert sorted(r["rank"] for r in ranks) == list(range(WORLDS[kind]))
    for r in ranks:
        assert r["world"] == WORLDS[kind] and r["again"] == [r["rank"], r["world"]]
        assert r["backend"] == "gloo"


def test_shim_and_placements_on_two_processes(worlds):
    r0, r1 = _check(worlds, "data", "check_shim")
    for rank, r in enumerate((r0, r1)):
        assert r["is_distributed"] and (r["rank"], r["world"]) == (rank, 2)
        assert r["placements"] == "(Shard(dim=0),)" and r["replicated"] == "(Replicate(),)"
        assert r["local"] == np.arange(16.0).reshape(8, 2)[4 * rank:4 * rank + 4].tolist()
        assert r["gathered"] == [0.0, 0.0, 1.0, 1.0] and r["gathered_stacked"] == [2, 3]
        assert r["gathered_dtensor"] and r["psum_mean"] == 0.5 and r["broadcast"] == 1
        assert r["bounds"] == [4 * rank, 4 * rank + 4]
        assert r["prefetch"] == "(Shard(dim=0),)" and r["prefetch_equal"]


@pytest.mark.parametrize("fused", ["force", "off"])
def test_sharded_langevin_equals_unsharded(worlds, fused):
    """``sample(x=shard_batch(x0))`` equals ``sample(x=x0)``: the mixture
    row's plain version with chain offsets, or the generic loop's global draws."""
    for r in _check(worlds, "data", "check_langevin"):
        assert r[f"final_{fused}"] <= 1e-6 and r[f"trajectory_{fused}"] <= 1e-6
        assert r[f"placements_{fused}"] == "(Shard(dim=0),)"
        assert r[f"trajectory_shape_{fused}"] == [64, 6, 2]


def test_sharded_neural_row_equals_unsharded(worlds):
    for r in _check(worlds, "data", "check_langevin"):
        assert r["neural"] <= 1e-6


@pytest.mark.parametrize("fused", ["force", "off"])
def test_ranks_sharing_a_seed_draw_different_noise_when_sharded(worlds, fused):
    """From one generator seed and zero starts, the two shards' chains
    differ; unsharded calls with that seed agree on every rank."""
    r0, r1 = _check(worlds, "data", "check_langevin")
    assert r0[f"local_sum_{fused}"] != r1[f"local_sum_{fused}"]
    assert r0[f"shared_sum_{fused}"] == r1[f"shared_sum_{fused}"]


def test_pooled_diagnostics_over_sharded_chains(worlds):
    for r in _check(worlds, "data", "check_diagnostics"):
        assert r["r_hat"] <= 1e-5 * max(r["r_hat_value"])
        assert r["tail_ess"] == 0.0
        for key, e in r["summary"].items():
            assert e <= (1e-3 if key.startswith("ess") else 1e-5), key
        assert r["ess"] <= 1e-3  # ESS of several hundred: 1e-5 relative


def test_sharded_buffer_shuffle(worlds):
    for r in _check(worlds, "data", "check_buffer"):
        assert r["placements"] == r["shuffled_placements"] == "(Shard(dim=0),)"
        assert r["same_rows"] and r["moved"] > 0 and r["equal_unsharded"] == 0.0
        assert r["ptr"] == 5


def test_pcd_step_on_a_sharded_buffer(worlds):
    """The local ring takes the local batch's negatives (rows 0-3 of each
    16-row shard, the pointer at 4), and the replicated parameters agree."""
    per_rank = _check(worlds, "data", "check_buffer")
    for r in per_rank:
        assert r["pcd_written_rows"] == [0, 1, 2, 3] and r["pcd_ptr"] == 4
        assert np.isfinite(r["pcd_loss"]) and r["pcd_buffer_placements"] == "(Shard(dim=0),)"
    assert per_rank[0]["pcd_param_sum"] == per_rank[1]["pcd_param_sum"]
    assert per_rank[0]["pcd_loss"] == per_rank[1]["pcd_loss"]


def test_sinkhorn_coupling_on_a_sharded_batch(worlds):
    for r in _check(worlds, "data", "check_sinkhorn"):
        assert r["x1"] <= 1e-6 and r["x0"] == 0.0 and r["placements"] == "(Shard(dim=0),)"


def test_fsdp_placements_on_an_hsdp_mesh(worlds):
    for r in _check(worlds, "hsdp", "check_fsdp_placements"):
        assert r["module"]["layers.1.weight"] == "(Replicate(), Shard(dim=0))"
        assert all(v == "plain" for k, v in r["module"].items() if k != "layers.1.weight")
        assert r["tree"] == {"big": "(Replicate(), Shard(dim=0))",
                             "small": "(Replicate(), Replicate())",
                             "odd": "(Replicate(), Replicate())"}
        assert r["tree_equal"] == 0.0


def test_fsdp_on_local_batches_equals_the_whole_batch_step(worlds):
    """Each process a different quarter of the batch, as plain tensors: the
    sharded parameters (FSDP2's reduction) and the replicated ones (the
    trainer's mean over the mesh) step as the unsharded model on the whole
    batch does."""
    for r in _check(worlds, "hsdp", "check_fsdp_local_batches"):
        assert set(r) == {f"layers.{i}.{k}" for i in range(3) for k in ("weight", "bias")}
        assert max(r.values()) <= 1e-4, r


@pytest.mark.parametrize("fused_neural", ["force", "off"])
def test_hsdp_cd_step_equals_the_replicated_one(worlds, fused_neural):
    """Two CD train steps under HSDP against the replicated trainer on the
    whole batch: through the neural kernel's plain version (weights
    gathered, chain offsets) and through the generic loop (FSDP2 forwards
    per chain step); placements kept, the EMA on them too."""
    for r in _check(worlds, "hsdp", "check_hsdp_cd"):
        r = r[fused_neural]
        assert r["loss"] <= 1e-5 * max(1.0, abs(r["loss_value"]))
        assert r["params"] <= 1e-4 and r["ema"] <= 1e-4
        assert r["placements_kept"] and r["ema_placements"]
        assert r["sharded"] == ["layers.1.weight"]


def test_dit_cfg_flow_matching_step_under_hsdp(worlds):
    """The JAX dryrun's label-dropout flow-matching step of a small DiT:
    attention, modulation and patch-embed weights carry the fsdp axis, the
    step equals the unsharded one, and the placements stay."""
    for r in _check(worlds, "hsdp", "check_dit"):
        assert r["finite"] and r["placements_kept"]
        for name in ("dit.blocks.0.attn.qkv.weight", "dit.blocks.0.modulation.weight",
                     "dit.patch_embed.proj.weight"):
            assert name in r["sharded"]
        assert r["loss"] <= 1e-6 and r["params"] <= 1e-6


def test_dcp_resume_is_bitwise_and_steps_again(worlds):
    for r in _check(worlds, "hsdp", "check_dcp"):
        assert r["files"] == [".metadata"] + [f"__{i}_0.distcp" for i in range(4)]
        assert r["params"] == r["ema"] == r["adam_state"] == 0.0
        assert r["step"] == 1 and r["generator"] and r["placements"]
        assert r["resumed_step"] == 2
        assert r["resumed_loss"] == 0.0 and r["resumed_params"] == 0.0


def test_restore_or_init_resumes_a_sharded_run(worlds):
    for r in _check(worlds, "hsdp", "check_dcp"):
        assert r["restore_or_init_step"] == 1 and r["restore_or_init_params"] == 0.0


@pytest.mark.parametrize("kind", sorted(WORLDS))
@pytest.mark.parametrize("name", worker.SAMPLERS)
def test_sharded_sampler_equals_unsharded_across_processes(worlds, kind, name):
    """Each sampler on a batch sharded over every process of the world (2
    and 4 shards; AIS split into as many blocks) gives the unsharded call's
    values on every rank and its statistics on every rank; the shards ran
    different rows."""
    per_rank = [r[name] for r in _check(worlds, kind, "check_samplers")]
    for r in per_rank:
        _assert_sampler(r, name)
    for fused in per_rank[0]:
        sums = [r[fused]["local_sum"] for r in per_rank]
        if sums[0] is not None:
            assert len(set(sums)) == len(sums), (fused, sums)


@pytest.mark.parametrize("kind", sorted(WORLDS))
@pytest.mark.parametrize("name", ["hmc_warmup", "nuts_warmup"])
def test_sharded_warmup_gives_one_step_size_across_processes(worlds, kind, name):
    """Dual averaging fed the acceptance over every shard: every rank gets
    the same step size and mass, within 1e-6 of the unsharded warmup's, and
    its rows of the unsharded warmed states."""
    per_rank = [r[name] for r in _check(worlds, kind, "check_sampler_extras")]
    for r in per_rank:
        assert "error" not in r, r.get("error")
        assert r["eps_rel"] <= 1e-6 and r["mass_rel"] <= 1e-6 and r["x"] <= 1e-6
        assert r["placements"]
    assert len({r["eps"] for r in per_rank}) == 1
    assert all(r["mass"] == per_rank[0]["mass"] for r in per_rank)


@pytest.mark.parametrize("kind", sorted(WORLDS))
def test_parallel_tempering_cd_on_a_sharded_batch_across_processes(worlds, kind):
    for r in _check(worlds, kind, "check_sampler_extras"):
        assert "error" not in r["ptcd"], r["ptcd"].get("error")
        _assert_ptcd(r["ptcd"])


@pytest.mark.parametrize("kind", sorted(WORLDS))
@pytest.mark.parametrize("name", worker.FLOW_CASES)
def test_sharded_flow_sampler_equals_unsharded_across_processes(worlds, kind, name):
    """``FlowSampler`` (and ``ReflowCoupling``) on a batch sharded over 2 and
    4 processes gives the unsharded call's values on every rank, and dopri5
    its attempted and accepted steps; the shards ran different rows."""
    per_rank = [r[name] for r in _check(worlds, kind, "check_flow")]
    for r in per_rank:
        _assert_flow(r, name)
    sums = [r["local_sum"] for r in per_rank]
    assert len(set(sums)) == len(sums), sums


@pytest.mark.parametrize("name", ["ais", "hmc"])
def test_samplers_on_a_two_axis_mesh(worlds, name):
    """AIS split over the four processes of the ``(2, 2)`` mesh, HMC on a
    batch sharded over ``"data"`` and replicated over ``"fsdp"``."""
    for r in _check(worlds, "hsdp", "check_mesh2d_samplers"):
        _assert_sampler(r[name], name)
