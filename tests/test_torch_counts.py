"""The kernels' instruction counts (``torchebm_tpu_torch.ops._counts``) stay
tied to the CUDA sources they were counted from, and cover every kernel."""

import hashlib

import pytest
import torch

from torchebm_tpu_torch import ops
from torchebm_tpu_torch.ops import _build, _counts

#: the kernels that draw Philox numbers
CHAIN_KERNELS = {
    "mixture_langevin_chain", "mixture_langevin_chain_trajectory", "doublewell_langevin_chain",
    "doublewell_langevin_chain_trajectory", "mixture_mala_chain", "mixture_mala_chain_trajectory",
    "mixture_hmc_chain", "mixture_hmc_chain_trajectory", "pt_langevin_chain",
    "pt_langevin_chain_trajectory", "mixture_ais_run", "fused_langevin_step", "mlp_langevin_chain",
}
SOURCES = sorted(p.name for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def test_every_source_has_counts():
    assert sorted(_counts.COUNTED_SOURCES) == SOURCES


@pytest.mark.parametrize("source", SOURCES)
def test_counts_were_checked_against_the_current_source(source):
    """A source edited after its counts were taken fails here: recount its
    kernels' instructions in ``_counts.work``, then record the new hash."""
    digest = hashlib.sha256((_build.CSRC / source).read_bytes()).hexdigest()[:16]
    assert _counts.COUNTED_SOURCES.get(source) == digest, (
        f"{source} changed since its instruction counts were checked")


def _calls():
    """``{wrapper name: (args, kwargs)}``: one small CPU call per kernel wrapper."""
    g = torch.Generator().manual_seed(0)
    x0, means = torch.randn(4, 2, generator=g), torch.randn(3, 2, generator=g)
    ladder = torch.randn(2, 4, 2, generator=g)
    stream, row = torch.randn(2, 5, 24, generator=g), torch.randn(2, 24, generator=g)
    mix = dict(scale=0.5, seed=1)
    return {
        "mixture_langevin_chain": ((x0, means, 5, 0.05), mix),
        "mixture_langevin_chain_trajectory": ((x0, means, 5, 0.05), dict(mix, thin=1)),
        "doublewell_langevin_chain": ((torch.randn(4, 3, generator=g), 5, 0.01), {}),
        "doublewell_langevin_chain_trajectory":
            ((torch.randn(4, 3, generator=g), 5, 0.01), dict(thin=1)),
        "mixture_mala_chain": ((x0, means, 5, 0.05), mix),
        "mixture_mala_chain_trajectory": ((x0, means, 5, 0.05), dict(mix, thin=1)),
        "mixture_hmc_chain": ((x0, means, 5, 0.05, 3), mix),
        "mixture_hmc_chain_trajectory": ((x0, means, 5, 0.05, 3), dict(mix, thin=1)),
        "pt_langevin_chain": ((ladder, means, 6, 0.05, 1.0, (1.0, 0.5), 2), mix),
        "pt_langevin_chain_trajectory":
            ((ladder, means, 6, 0.05, 1.0, (1.0, 0.5), 2), dict(mix, thin=1)),
        "mixture_ais_run":
            ((x0, torch.zeros(2), 3.0, means, torch.linspace(0.0, 1.0, 4), 0.05), mix),
        "fused_langevin_step": ((x0, torch.randn(4, 2, generator=g), 0.01, 1.0), {}),
        "mlp_langevin_chain": ((x0, [(torch.randn(2, 8, generator=g), torch.zeros(8)),
                                     (torch.randn(8, 1, generator=g), torch.zeros(1))], 5, 0.01),
                               dict(seed=1)),
        "sinkhorn_log_fused": ((torch.rand(6, 9, generator=g), 0.05, 7), dict(tol=0.0)),
        "adaln_modulate": ((stream, row, row), {}),
        "adaln_modulate_backward":
            ((stream, stream, torch.zeros(2, 5), torch.ones(2, 5), row), dict(dres=stream)),
        "gated_residual": ((stream, row, stream), {}),
        "gated_residual_backward": ((stream, row, stream), {}),
    }


@pytest.mark.parametrize("name", sorted(ops.launch_counts()))
def test_every_kernel_has_work_counts(name):
    calls = _calls()
    assert sorted(calls) == sorted(ops.launch_counts())
    args, kw = calls[name]
    result = getattr(ops, name)(*args, **kw)
    work = _counts.work(name, args, kw, result)
    assert set(work["ops"]) == {"fp32", "int32", "sfu", "tf32"}
    assert work["ops"]["fp32"] > 0 and work["bytes"] > 0
    # every chain kernel draws Philox numbers on these calls; Sinkhorn and the
    # adaLN kernels draw none
    assert (work["ops"]["int32"] > 0) == (name in CHAIN_KERNELS)


def test_work_scales_with_the_chain_length():
    args, kw = _calls()["mixture_langevin_chain"]
    once = _counts.work("mixture_langevin_chain", args, kw, ops.mixture_langevin_chain(*args, **kw))
    longer = (*args[:2], 2 * args[2], *args[3:])
    twice = _counts.work("mixture_langevin_chain", longer, kw,
                         ops.mixture_langevin_chain(*longer, **kw))
    assert twice["ops"] == {k: 2 * v for k, v in once["ops"].items()}
    with pytest.raises(KeyError):
        _counts.work("no_such_kernel", args, kw, None)


def test_sinkhorn_work_follows_the_iterations_run():
    """The work of a gated call is what its data needed: the kernel's own
    iteration count when the call returned it, the cap otherwise; the bytes
    are the cost matrix read and the plan written."""
    args, kw = _calls()["sinkhorn_log_fused"]
    capped = _counts.work("sinkhorn_log_fused", args, kw, ops.sinkhorn_log_fused(*args, **kw))
    assert capped["bytes"] == 2 * 4 * 6 * 9
    gated = dict(tol=1e9, return_iters=True)  # one iteration, then the gate
    result = ops.sinkhorn_log_fused(*args, **gated)
    assert int(result[1]) == 1
    once = _counts.work("sinkhorn_log_fused", args, gated, result)
    per_iter = {k: (capped["ops"][k] - once["ops"][k]) / 6 for k in once["ops"]}
    assert per_iter["fp32"] > 0 and per_iter["sfu"] == 2 * 6 * 9 + 2 * (6 + 9)
    assert once["bytes"] == capped["bytes"]


def test_neural_chain_counts_its_products_on_the_tensor_cores():
    """MLP(128, 128) at d = 2: the 128 x 128 layer's products forward and
    backward as three TF32 passes, the 2-input layer's on FP32 FMAs."""
    g = torch.Generator().manual_seed(0)
    layers = [(torch.randn(2, 128, generator=g), torch.zeros(128)),
              (torch.randn(128, 128, generator=g), torch.zeros(128)),
              (torch.randn(128, 1, generator=g), torch.zeros(1))]
    x0 = torch.randn(4, 2, generator=g)
    args = (x0, layers, 3, 0.01)
    work = _counts.work("mlp_langevin_chain", args, {}, ops.mlp_langevin_chain(*args, seed=1))
    per = 4 * 3
    assert work["ops"]["tf32"] == per * 2 * 3 * 2 * 128 * 128
    assert work["ops"]["fp32"] == per * (2 * 2 * 128 + 13 * 256 + 4 * 2 + 60)
    assert work["ops"]["sfu"] == per * (2 * 256 + 12)


def test_doublewell_counts_one_normal_per_element_step():
    """The double-well chain needs one normal per element-step: a quarter
    of a Philox block (21 INT32 instructions; the kernel draws one block
    per four steps and uses its four normals), half a Box-Muller pair, and
    7 FP32 operations for the gradient, the update and the clamp."""
    x0 = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    args = (x0, 5, 0.01)
    work = _counts.work("doublewell_langevin_chain", args, {},
                        ops.doublewell_langevin_chain(*args, seed=1))
    per = 4 * 3 * 5
    assert work["ops"] == {"int32": per * 21, "fp32": per * 22, "sfu": per * 3, "tf32": 0.0}


@pytest.mark.parametrize("k, gaussian", [(3, False), (1, False), (1, True)],
                         ids=["mixture", "one-component", "full-covariance"])
def test_ais_counts_the_base_in_closed_form(k, gaussian):
    """Per transition the AIS kernel's base is an isotropic Gaussian in
    closed form (3d + 2 FP32, no special function), and so is a
    one-component target (plus its log-weight); a mixture of K ≥ 2 and the
    full-covariance Gaussian keep their evaluators' counts."""
    g = torch.Generator().manual_seed(0)
    d, n, rungs = 2, 4, 3
    x0, means = torch.randn(n, d, generator=g), torch.randn(k, d, generator=g)
    kw = dict(precision=torch.eye(d)) if gaussian else dict(scale=0.5)
    args = (x0, torch.zeros(d), 3.0, means, torch.linspace(0.0, 1.0, rungs + 1), 0.05)
    work = _counts.work("mixture_ais_run", args, kw, ops.mixture_ais_run(*args, **kw, seed=1))
    target = ({"fp32": d * d + 3 * d + 2, "sfu": 0} if gaussian
              else {"fp32": 3 * d + 3, "sfu": 0} if k == 1
              else {"fp32": k * (3 * d + 8) + 2 * d + 6, "sfu": k + 2})
    per = n * rungs
    assert work["ops"]["sfu"] == per * (target["sfu"] + 12 + 1 + 2)
    assert work["ops"]["fp32"] == per * ((3 * d + 2) + target["fp32"] + 60 + 2 + 12 * d + 12) \
        + 4 * per
    assert work["ops"]["int32"] == per * 2 * 84
