"""Time the CD train step of config 3 on the port, for one checkout.

Config 3 is MLPEnergy(2, (128, 128)), batch 256 of 8-Gaussians data, CD-10
Langevin negatives at step 0.01, Adam 1e-4, through
``ContrastiveDivergenceTrainer.train_step``. The step is host-bound, so its
time is read on the host clock around ``torch.cuda.synchronize()``: after
``--warmup`` steps, ``--blocks`` blocks of ``--steps`` steps each, and the
median block's ms per step is reported, with every block's.

``--root`` names the checkout whose ``torchebm_tpu_torch`` is imported (by
default the one holding this script), so that two versions can be compared
in one run on one card, for example a parent unpacked with ``git archive``
into a git-ignored directory:

    python3 scripts/time_cd_step.py --root build/parent --fused auto
    python3 scripts/time_cd_step.py --fused auto

Prints one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--fused", choices=("auto", "off"), default="auto")
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_cd_step.py needs a CUDA device")
    from torchebm_tpu_torch.core import as_energy
    from torchebm_tpu_torch.core.trainer import ContrastiveDivergenceTrainer
    from torchebm_tpu_torch.datasets import EightGaussiansDataset
    from torchebm_tpu_torch.losses import ContrastiveDivergence
    from torchebm_tpu_torch.models import MLPEnergy
    from torchebm_tpu_torch.samplers import LangevinDynamics

    import torchebm_tpu_torch

    if Path(torchebm_tpu_torch.__file__).resolve().parents[1] != root:
        sys.exit(f"imported torchebm_tpu_torch from {torchebm_tpu_torch.__file__}, not {root}")

    dev = torch.device("cuda")
    torch.manual_seed(args.seed)
    net = MLPEnergy(2, (128, 128)).to(dev)
    energy = as_energy(net)
    cd = ContrastiveDivergence(
        model=energy, sampler=LangevinDynamics(energy, step_size=0.01, fused_neural=args.fused),
        k_steps=10)
    trainer = ContrastiveDivergenceTrainer(cd, learning_rate=1e-4)
    g = torch.Generator(dev).manual_seed(args.seed + 1)
    n_steps = args.warmup + args.blocks * args.steps
    data = EightGaussiansDataset(n_samples=100 * 256, seed=args.seed, device=dev)
    batches = []
    while len(batches) < n_steps:
        batches.extend(data.batches(g, 256))
    state = trainer.init_state(net, g)
    for b in batches[:args.warmup]:
        state, _ = trainer.train_step(state, b)
    blocks = []
    for i in range(args.blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[args.warmup + i * args.steps: args.warmup + (i + 1) * args.steps]:
            state, _ = trainer.train_step(state, b)
        torch.cuda.synchronize()
        blocks.append((time.perf_counter() - t0) * 1e3 / args.steps)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"root": str(root), "fused_neural": args.fused,
                      "ms_per_step": statistics.median(blocks), "blocks_ms": blocks,
                      "card": card}))


if __name__ == "__main__":
    main()
