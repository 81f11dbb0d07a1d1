"""The port's Sinkhorn kernel module against the JAX package's, on the CPU.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the Pallas kernel in interpret mode and against the JAX package's
loop (``sinkhorn_log(fused="off")``) on the same numpy cost matrices, at the
shapes of ``tests/ops/test_sinkhorn_parity.py``, rtol and atol 1e-5 as there.
The CUDA kernel is held against the plain version in
tests/test_torch_kernels_gpu.py.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torchebm_tpu.couplings.ot import sinkhorn_log as j_sinkhorn_log
from torchebm_tpu.couplings.ot import unbalanced_sinkhorn_log as j_unbalanced
from torchebm_tpu.ops.fused_sinkhorn import sinkhorn_log_fused as j_fused
from torchebm_tpu_torch import ops
from torchebm_tpu_torch.couplings import sinkhorn_log, unbalanced_sinkhorn_log
from torchebm_tpu_torch.ops import fused_sinkhorn as fs

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(8, 128), (256, 256), (17, 33), (5, 200)]


def _cost(seed, n, m):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((n, 2)).astype(np.float32)
    x1 = rng.standard_normal((m, 2)).astype(np.float32) + 1.0
    c = ((x0[:, None, :] - x1[None, :, :]) ** 2).sum(-1)
    return (c / c.max()).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret_and_xla_fixed_iters(shape):
    c = _cost(0, *shape)
    out = fs.sinkhorn_log_fused(torch.from_numpy(c), 0.05, 60).numpy()
    np.testing.assert_allclose(out, np.asarray(j_fused(jnp.asarray(c), 0.05, 60, interpret=True)),
                               **TOL)
    np.testing.assert_allclose(
        out, np.asarray(j_sinkhorn_log(jnp.asarray(c), reg=0.05, n_iters=60, fused="off")), **TOL)


def test_plain_matches_jax_damped():
    c = _cost(1, 64, 192)
    fi = 0.5 / (0.5 + 0.1)
    out = fs.sinkhorn_log_fused(torch.from_numpy(c), 0.1, 80, damping=fi).numpy()
    np.testing.assert_allclose(
        out, np.asarray(j_fused(jnp.asarray(c), 0.1, 80, damping=fi, interpret=True)), **TOL)
    ref = j_unbalanced(jnp.asarray(c), reg=0.1, reg_marginal=0.5, n_iters=80, fused="off")
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    via = unbalanced_sinkhorn_log(torch.from_numpy(c), 0.1, 0.5, 80, fused="force").numpy()
    np.testing.assert_array_equal(via, out)


@pytest.mark.parametrize("shape, reg, tol, cap", [((128, 128), 0.1, 1e-4, 500),
                                                  ((32, 128), 0.05, 1e-3, 40),
                                                  ((256, 256), 0.05, 1e-3, 50)])
def test_gate_matches_jax_and_converges(shape, reg, tol, cap):
    """Gated exits: the plain version stops in the iteration the Pallas kernel
    stops in (the plans agree to 1e-5, and one iteration fewer moves the plan
    by more than twice that), and the balanced plan's marginals are uniform
    to rtol 2e-3."""
    c = _cost(2, *shape)
    out, iters = fs.sinkhorn_log_fused(torch.from_numpy(c), reg, cap, tol=tol, return_iters=True)
    assert 1 <= int(iters) < cap and iters.dtype == torch.int32
    ref = np.asarray(j_fused(jnp.asarray(c), reg, cap, tol=tol, interpret=True))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    fixed = fs.sinkhorn_log_plain(torch.from_numpy(c), reg, int(iters))
    np.testing.assert_array_equal(out.numpy(), fixed.numpy())
    shorter = fs.sinkhorn_log_plain(torch.from_numpy(c), reg, int(iters) - 1)
    assert float((shorter - out).abs().max()) > 2 * TOL["atol"]
    plan = out.exp()
    n, m = shape
    np.testing.assert_allclose(plan.sum(1).numpy(), np.full(n, 1 / n), rtol=2e-3)
    np.testing.assert_allclose(plan.sum(0).numpy(), np.full(m, 1 / m), rtol=2e-3)


def test_tol_zero_runs_the_cap_and_the_first_iteration_always_runs():
    c = torch.from_numpy(_cost(3, 16, 24))
    _, iters = fs.sinkhorn_log_plain(c, 0.05, 7, return_iters=True)
    assert int(iters) == 7
    _, iters = fs.sinkhorn_log_plain(c, 0.05, 7, tol=1e9, return_iters=True)
    assert int(iters) == 1
    out, iters = fs.sinkhorn_log_plain(c, 0.05, 0, return_iters=True)
    assert int(iters) == 0
    np.testing.assert_allclose(out.numpy(), c.numpy() * (-1.0 / 0.05), rtol=1e-6)


def _loop_errors(c, reg, n_iters):
    """max|f_new - f| after each iteration of the loop, as it computes them."""
    C = torch.from_numpy(c)
    n, m = C.shape
    M = C * (-1.0 / reg)
    f, g, errs = torch.zeros(n), torch.zeros(m), []
    for _ in range(n_iters):
        f_new = -np.log(n) - torch.logsumexp(M + g[None, :], dim=1)
        g = -np.log(m) - torch.logsumexp(M + f_new[:, None], dim=0)
        errs.append(float(torch.max(torch.abs(f_new - f))))
        f = f_new
    return errs


@pytest.mark.parametrize("target", [fs.CHECK_EVERY - 1, fs.CHECK_EVERY, fs.CHECK_EVERY + 1])
def test_loop_reads_its_gate_every_k_iterations(target):
    """The loop keeps its gate on the device and reads it on the host every
    CHECK_EVERY iterations: a matrix that converges one iteration before, at
    and after such a read stops in the iteration the JAX loop stops in, with
    the plan of exactly that many iterations (bit for bit)."""
    c, reg = _cost(8, 48, 80), 0.05
    errs = _loop_errors(c, reg, target + 1)
    assert all(a > b for a, b in zip(errs, errs[1:]))
    tol = math.sqrt(errs[target - 1] * errs[target - 2])  # met first after iteration `target`
    out, iters = fs.sinkhorn_log_plain(torch.from_numpy(c), reg, 50, tol=tol, return_iters=True)
    assert int(iters) == target and iters.dtype == torch.int32
    np.testing.assert_array_equal(
        out.numpy(), fs.sinkhorn_log_plain(torch.from_numpy(c), reg, target).numpy())
    ref = j_sinkhorn_log(jnp.asarray(c), reg=reg, n_iters=50, tol=tol, fused="off")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(
        sinkhorn_log(torch.from_numpy(c), reg, 50, tol=tol, fused="off").numpy(), out.numpy())


def test_plain_takes_float64_and_any_size():
    c = _cost(4, 12, 20)
    out64 = fs.sinkhorn_log_plain(torch.from_numpy(c).double(), 0.05, 30)
    assert out64.dtype == torch.float64
    out32 = fs.sinkhorn_log_plain(torch.from_numpy(c), 0.05, 30)
    np.testing.assert_allclose(out32.numpy(), out64.numpy(), rtol=1e-4, atol=1e-4)


def test_argument_probes():
    c = torch.from_numpy(_cost(5, 8, 8))
    with pytest.raises(ValueError, match="2D"):
        fs.sinkhorn_log_fused(c[0], 0.05, 5)
    with pytest.raises(ValueError, match="non-empty"):
        fs.sinkhorn_log_fused(torch.zeros(0, 4), 0.05, 5)
    with pytest.raises(TypeError, match="float32"):
        fs.sinkhorn_log_fused(c.double(), 0.05, 5)
    with pytest.raises(ValueError, match="contiguous"):
        fs.sinkhorn_log_fused(c.T[:, :4], 0.05, 5)
    with pytest.raises(ValueError, match="reg"):
        fs.sinkhorn_log_fused(c, 0.0, 5)
    with pytest.raises(ValueError, match="n_iters"):
        fs.sinkhorn_log_fused(c, 0.05, -1)
    with pytest.raises(ValueError, match="tol"):
        fs.sinkhorn_log_fused(c, 0.05, 5, tol=-1.0)
    with pytest.raises(ValueError, match="damping"):
        fs.sinkhorn_log_fused(c, 0.05, 5, damping=1.5)
    with pytest.raises(ValueError, match="exceeds"):
        fs.sinkhorn_log_fused(torch.zeros(2048, 2048), 0.05, 1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fs.sinkhorn_log_fused(torch.zeros(4, 4, device="meta"), 0.05, 1)


#: (shape, the plan's cluster size, M resident, exchange in shared memory,
#: f in shared memory): the flow path's matrix, the largest square one,
#: one wide row and a tall matrix of three columns, the parity shapes,
#: ragged and unbalanced shapes, wide matrices whose exchange goes through
#: scratch, and one tall column whose f does
PLAN_CASES = [
    ((256, 256), 16, True, True, True), ((1024, 1024), 16, False, True, True),
    ((1, 70_000), 1, False, False, True), ((70_000, 3), 16, True, True, True),
    ((8, 128), 8, True, True, True), ((17, 33), 16, True, True, True),
    ((64, 192), 16, True, True, True), ((128, 128), 16, True, True, True),
    ((200, 333), 16, True, True, True), ((5000, 200), 16, False, True, True),
    ((128, 4096), 16, True, True, True), ((64, 16_384), 16, False, True, True),
    ((2, 524_288), 2, False, False, True), ((1, 1 << 20), 1, False, False, True),
    ((1 << 20, 1), 16, False, True, False),
]


def _check_plan(plan, n, m):
    """What every plan keeps to: a built cluster of at most one block per
    row; its shared memory, pairs included, within SMEM_BUDGET and equal to
    what it holds; a padded row stride that gives the column pass's lanes
    32 distinct banks; scratch for what lives outside shared memory."""
    band, own = -(-n // plan.blocks), -(-m // plan.blocks)
    assert plan.blocks in fs.BLOCK_SIZES and plan.blocks <= n
    assert plan.slices in (1, 2, 4, 8, 16, 32) and plan.slices <= band
    assert plan.smem_bytes <= fs.SMEM_BUDGET
    assert plan.smem_bytes == (4 * band * plan.f_smem
                               + (8 * plan.blocks * (own + 1) + 4 * m) * plan.pairs_smem
                               + 4 * band * plan.stride * plan.resident)
    assert plan.stride >= m and (plan.resident or plan.stride == m)
    if plan.stride != m:
        wc = 32 // plan.slices
        banks = {(cy * plan.stride + cx) % 32 for cy in range(plan.slices) for cx in range(wc)}
        assert len(banks) == 32
    assert plan.scratch_floats >= ((4 * plan.blocks * m + 2 * fs.MAX_BLOCKS + m)
                                   * (not plan.pairs_smem) + n * (not plan.f_smem))


@pytest.mark.parametrize("shape, blocks, resident, pairs_smem, f_smem", PLAN_CASES,
                         ids=[f"{s[0]}x{s[1]}" for s, *_ in PLAN_CASES])
def test_fit_rule_and_launch_plan(shape, blocks, resident, pairs_smem, f_smem):
    """The fit rule, the plan's pick at each shape, and ``blocks=``: every
    built size up to one block per row is planned (and kept to the same
    rules); a size not built, or more blocks than rows, raises."""
    assert fs.fits_fused_sinkhorn(1024, 1024) and fs.fits_fused_sinkhorn(1, 1 << 20)
    assert not fs.fits_fused_sinkhorn(4096, 4096) and not fs.fits_fused_sinkhorn(1025, 1024)
    assert not fs.fits_fused_sinkhorn(0, 5)
    assert ops.fits_fused_sinkhorn is fs.fits_fused_sinkhorn
    with pytest.raises(ValueError, match="exceeds"):
        fs.launch_plan(4096, 4096)
    n, m = shape
    plan = fs.launch_plan(n, m)
    assert (plan.blocks, plan.resident, plan.pairs_smem, plan.f_smem) == (
        blocks, resident, pairs_smem, f_smem)
    _check_plan(plan, n, m)
    for size in fs.BLOCK_SIZES:
        if size <= n:
            forced = fs.launch_plan(n, m, blocks=size)
            assert forced.blocks == size
            _check_plan(forced, n, m)
        else:
            with pytest.raises(ValueError, match="one block per row"):
                fs.launch_plan(n, m, blocks=size)
    for size in (0, 3, 32):
        with pytest.raises(ValueError, match="blocks must be one of"):
            fs.launch_plan(n, m, blocks=size)
    if shape == (256, 256):  # the flow path: 16 rows of 256 + 16 floats a block
        assert (plan.slices, plan.stride) == (2, 272)
        assert plan.smem_bytes == 4 * 16 + 8 * 16 * 17 + 4 * 256 + 4 * 16 * 272


@pytest.mark.parametrize("fused", ["auto", "off", "force"])
def test_dispatch_on_the_cpu(fused, monkeypatch):
    """On a CPU matrix ``"auto"`` and ``"off"`` take the loop and ``"force"``
    the kernel's wrapper (its plain version here); none launches a kernel, and
    all three return the same plan."""
    calls = []
    real = fs.sinkhorn_log_fused
    monkeypatch.setattr(fs, "sinkhorn_log_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    c = torch.from_numpy(_cost(6, 24, 40))
    counts = ops.launch_counts()
    out = sinkhorn_log(c, 0.05, 30, tol=1e-3, fused=fused)
    assert ops.launch_counts() == counts
    assert len(calls) == (1 if fused == "force" else 0)
    np.testing.assert_array_equal(out.numpy(), fs.sinkhorn_log_plain(c, 0.05, 30, 1e-3).numpy())


def test_dispatch_gate():
    from torchebm_tpu_torch.couplings.ot import _use_fused_sinkhorn

    small, big = torch.zeros(8, 8), torch.zeros(2048, 2048)
    assert not _use_fused_sinkhorn(small, "auto")  # a CPU matrix
    assert _use_fused_sinkhorn(small, "force") and _use_fused_sinkhorn(small.double(), "force")
    assert not _use_fused_sinkhorn(big, "force")  # beyond the fit rule: the loop
    assert not _use_fused_sinkhorn(small, "off")
    meta = torch.zeros(8, 8, device="meta")
    assert not _use_fused_sinkhorn(meta, "auto")
    with pytest.raises(ValueError, match="fused"):
        _use_fused_sinkhorn(small, "on")
    # a float64 matrix under "force" is computed in float32 and handed back as float64
    c = torch.from_numpy(_cost(7, 8, 8)).double()
    out = sinkhorn_log(c, 0.05, 10, fused="force")
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), fs.sinkhorn_log_plain(c.float(), 0.05, 10).numpy())
    # beyond the fit rule "force" falls through to the loop, decided before any launch
    out = sinkhorn_log(torch.zeros(1025, 1024), 0.05, 1, fused="force")
    assert out.shape == (1025, 1024)
