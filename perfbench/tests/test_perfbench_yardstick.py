"""The yardstick against the program at tiny sizes on the CPU: the plain
references agree with the port, the frozen counts give the bounds they were
frozen at, the DiT FLOP formula agrees with ``torch.utils.flop_counter``, and
nothing the benchmark runs loads JAX or the JAX package."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import generate
from perfbench.counts import chains as chain_counts
from perfbench.counts import dit as dit_counts
from perfbench.reference import dit as ref_dit
from perfbench.reference import ring
from perfbench.systems import label_dit
from perfbench.tests.conftest import TINY_DIT

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
PEAKS = json.loads((BENCH / "peaks.json").read_text())["NVIDIA H100 80GB HBM3"]


def _tiny_dit(**kw):
    cfg = json.loads((BENCH / "configs" / "dit_b2_eqm.json").read_text())
    cfg.update(TINY_DIT, **kw)
    return cfg


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_dit_reference_matches_the_port_in_float32():
    cfg = _tiny_dit(dtype="float32")
    weights = generate.make_weights(ref_dit.param_layout(cfg), 7, "cpu")
    net = label_dit.build(cfg, weights, "cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((5, 2, 8, 8), generator=g)
    t = torch.rand((5,), generator=g)
    y = torch.randint(0, 10, (5,), generator=g)
    drop = torch.tensor([True, False, False, True, False])
    with torch.no_grad():
        got = net(x, t, y=y, drop=drop)
    assert _rel(got, ref_dit.forward(weights, cfg, x, t, y, drop)) < 1e-5


def test_eqm_train_reference_matches_the_port_in_float32():
    from perfbench.entries import eqm_train

    cfg = _tiny_dit(dtype="float32")
    traffic = json.loads((BENCH / "traffic" / "train_bf16.json").read_text())
    traffic.update(batch=6, pool=3, reference_block_rows=4, warmup_steps=0)
    cell = eqm_train.setup(cfg, traffic, 11, "cpu")
    got = cell.readings()
    cell.release()
    numbers = eqm_train.compare(got, cell.reference(got))
    assert numbers["loss_gap"] < 1e-5 and numbers["grad_norm_gap"] < 1e-4
    assert numbers["update_norm_gap"] < 1e-3 and numbers["ema_norm_gap"] < 1e-3


def test_cfg_euler_reference_matches_the_port_in_float32():
    from torchebm_tpu_torch.models import LabelClassifierFreeGuidance
    from torchebm_tpu_torch.samplers import FlowSampler

    cfg = _tiny_dit(dtype="float32")
    weights = generate.make_weights(ref_dit.param_layout(cfg), 3, "cpu")
    net = label_dit.build(cfg, weights, "cpu")
    guided = LabelClassifierFreeGuidance(base=net, null_label_id=10, cfg_scale=4.0,
                                         guide_channels=1)
    g = torch.Generator().manual_seed(1)
    x0 = torch.randn((4, 2, 8, 8), generator=g)
    y = torch.randint(0, 10, (4,), generator=g)
    got = FlowSampler(model=guided, integrator="euler").sample(g, x=x0, n_steps=5,
                                                               model_kwargs={"y": y})
    assert _rel(got, ref_dit.cfg_euler(weights, cfg, x0, y, 5, 4.0, 1)) < 1e-5


@pytest.mark.parametrize("sampler", ["langevin", "hmc"])
def test_ring_reference_matches_the_port(sampler):
    from torchebm_tpu_torch.samplers import HamiltonianMonteCarlo, LangevinDynamics

    from perfbench.systems import mixture_ring

    cfg = json.loads((BENCH / "configs" / "eight_gaussians_2d.json").read_text())
    energy = mixture_ring.build(cfg, "cpu")
    x0 = torch.randn((200, 2), generator=torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(2**31 + 9)
    state = g.get_state()
    means = ring.ring_means(cfg, "cpu")
    seed = ring.kernel_seed(state, "cpu")
    if sampler == "langevin":
        got = LangevinDynamics(energy, step_size=0.05, fused="force").sample(g, x=x0, n_steps=40)
        want = ring.langevin(x0, means, 0.4, 0.05, 40, seed)
    else:
        got = HamiltonianMonteCarlo(energy, step_size=0.3, n_leapfrog_steps=8,
                                    fused="force").sample(g, x=x0, n_steps=3)
        want = ring.hmc(x0, means, 0.4, 0.3, 8, 3, seed)
    assert float((got - want).abs().max()) < 1e-3


def test_frozen_chain_counts_give_the_bounds():
    lang = chain_counts.langevin(10_000, 2, 8, 1_000)
    hmc = chain_counts.hmc(10_000, 2, 8, 1_000, 8)
    assert chain_counts.bound_s(lang, PEAKS) * 1e3 == pytest.approx(0.05679, rel=1e-3)
    assert chain_counts.bound_s(hmc, PEAKS) * 1e3 == pytest.approx(0.3366, rel=1e-3)


def test_frozen_chain_counts_match_the_ports_counts():
    from torchebm_tpu_torch.ops import _counts

    x0, means = torch.zeros(100, 2), torch.zeros(8, 2)
    port = _counts.work("mixture_langevin_chain", (x0, means, 50), {}, x0)["ops"]
    assert {k: v for k, v in port.items() if v} == chain_counts.langevin(100, 2, 8, 50)["ops"]
    port = _counts.work("mixture_hmc_chain", (x0, means, 50, 0.3, 8), {}, (x0, x0[:, 0]))["ops"]
    mine = chain_counts.hmc(100, 2, 8, 50, 8)["ops"]
    assert {k: v for k, v in port.items() if v} == mine


def test_dit_flops_agree_with_flop_counter():
    """On the reference's forward, whose every product (attention's too) is a
    plain matmul that ``flop_counter`` counts; the port's attention on the
    CPU runs a kernel it does not count."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = _tiny_dit(dtype="float32")
    weights = {k: v.requires_grad_(True)
               for k, v in generate.make_weights(ref_dit.param_layout(cfg), 1, "cpu").items()}
    x, t, y = torch.randn(3, 2, 8, 8), torch.rand(3), torch.tensor([1, 2, 3])
    with torch.no_grad(), FlopCounterMode(display=False) as fwd:
        ref_dit.forward(weights, cfg, x, t, y)
    assert fwd.get_total_flops() == 3 * dit_counts.forward_flops(cfg)
    with FlopCounterMode(display=False) as both:
        ref_dit.forward(weights, cfg, x, t, y).square().mean().backward()
    assert both.get_total_flops() == pytest.approx(dit_counts.train_step_flops(cfg, 3), rel=0.03)


def test_dit_b2_counts():
    cfg = json.loads((BENCH / "configs" / "dit_b2_eqm.json").read_text())
    assert dit_counts.forward_flops(cfg) == pytest.approx(45.9e9, rel=0.01)
    assert dit_counts.train_step_flops(cfg, 256) == pytest.approx(35.3e12, rel=0.01)


def _top_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax_and_references_no_program():
    forbidden = {"jax", "jaxlib", "flax", "optax", "torchebm_tpu", "benchmarks"}
    for path in BENCH.rglob("*.py"):
        assert not _top_imports(path) & forbidden, path
    for path in (BENCH / "reference").rglob("*.py"):
        assert "torchebm_tpu_torch" not in _top_imports(path), path


def test_a_run_loads_no_jax(tiny_root):
    code = (
        "import sys, pathlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from perfbench import run\n"
        f"rc = run.main(['--workload', 'eight_gaussians_2d.langevin_10k', '--seed', '5', "
        f"'--seconds', '0.2'], root=pathlib.Path({str(tiny_root)!r}), require_cuda=False)\n"
        "assert rc == 0, rc\n"
        "assert not run.forbidden_modules(), run.forbidden_modules()\n"
        "assert 'torchebm_tpu_torch' in sys.modules\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert json.loads(done.stdout.strip().splitlines()[-1])["correct"] is True
