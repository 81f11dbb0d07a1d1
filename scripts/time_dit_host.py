"""Time the host-bound DiT paths of ``chip_smoke.py`` on one card, for one
checkout of the port.

At 64 tokens (1 x 32 x 32 images, patch 4) a DiT-768x12 at batch 256 is
bound by the host's launch work, so the host cost of each operation shows
end to end. For the port under ``--root`` (a checkout; the default is
this one) it reads, in bf16:

- ``train step``: ``chip_smoke.py``'s flow-matching train step (MSE onto a
  fresh normal target, AdamW), CUDA events around one call, the median of
  ``--steps`` after ``--warmup``;
- ``forward``: a forward under ``no_grad``, the same way;
- ``forward host``: the host time of that forward up to its return, before
  the card finishes it (``chip_smoke.host_ms``);
- ``cfg step``: ``path_cfg``'s class-conditional generation (LabelDiT-768x12,
  256 samples, 20 Euler steps, two forwards a step), host clock around one
  generation over its steps, the median of ``--gens`` after a warm-up one.

Where the checkout has the adaLN kernels (``ops/fused_adaln.py``) each
reading is taken twice, on the kernels (``kernels``) and on the plain
operations they replace (``composite``), in turns that reverse every other
round; a checkout without them reads ``composite`` alone. Prints a line a
reading and one JSON line with all of them. Needs a CUDA device:

    python3 scripts/time_dit_host.py [--root CHECKOUT]

Compare two checkouts in one call, in alternating processes (parent,
change, change, parent): only readings taken on one card, in one call, are
compared.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _chip_smoke():
    """This checkout's ``chip_smoke.py``: its helpers import the port only
    when called, so they run the port that ``sys.path`` finds first."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--gens", type=int, default=3)
    args = ap.parse_args()

    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_dit_host.py needs a CUDA device")
    import torchebm_tpu_torch
    from torchebm_tpu_torch.models.components import transformer

    cs = _chip_smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    label = args.label or str(Path(args.root).resolve())
    print(f"{card} | port {torchebm_tpu_torch.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    step, model, x, cond = cs._dit_train_step(dev, "bfloat16", seed=61)
    net = cs._label_dits(dev, 91)["bfloat16"]
    g = torch.Generator(dev).manual_seed(92)
    labels = torch.arange(cs.CFG_SAMPLES, device=dev) % cs.CFG_CLASSES
    guided = cs._cfg_sampler(net, cs.CFG_SCALE)

    def forward():
        with torch.no_grad():
            model(x, cond)

    def cfg_step_ms():
        cs._cfg_generate(guided, g, labels)
        times = []
        for _ in range(args.gens):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cs._cfg_generate(guided, g, labels)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / cs.CFG_STEPS)
        return statistics.median(times)

    plain_ops = getattr(transformer, "_plain_ops", None)
    variants = ["kernels", "composite"] if plain_ops is not None else ["composite"]
    readings = []
    for r in range(args.rounds):
        for variant in variants if r % 2 == 0 else variants[::-1]:
            if plain_ops is not None:
                transformer._plain_ops = plain_ops if variant == "kernels" else (lambda *ts: True)
            got = {
                "train step": statistics.median(cs.cuda_times(step, args.warmup, args.steps)),
                "forward": statistics.median(cs.cuda_times(forward, args.warmup, args.steps)),
                "forward host": cs.host_ms(forward, args.steps),
                "cfg step": cfg_step_ms(),
            }
            for what, ms in got.items():
                readings.append(dict(label=label, variant=variant, round=r, what=what, ms=ms))
            print(f"host-bound DiT: {label} {variant} round {r}: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in got.items()) + f" | {card}",
                  flush=True)
    if plain_ops is not None:
        transformer._plain_ops = plain_ops
    print(json.dumps({"card": card, "readings": readings}))


if __name__ == "__main__":
    main()
