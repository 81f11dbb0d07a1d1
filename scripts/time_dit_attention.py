"""Time the DiT-768x12 with its attention written four ways, on one card.

The model is ``chip_smoke.py``'s DiT (the JAX headline's,
``benchmarks/headline.py:547-606``): ``ConditionalTransformer2D`` at patch
4, width 768, 12 blocks of 12 heads, on 1 x 32 x 32 images at batch 256.
Its attention (64 tokens, head width 64) is swapped between readings:

- ``module``: the module's own choice (``transformer._attention``: SDPA's
  fused kernels through ``_FusedAttention`` when a gradient is taken, SDPA
  alone under ``no_grad``);
- ``sdpa``: ``F.scaled_dot_product_attention`` on its default backends
  (the fused flash or memory-efficient kernels), called directly;
- ``sdpa-math``: the same call pinned to its math backend;
- ``einsum``: the JAX package's form (``transformer.py:44-50``): the logits
  by einsum at scale hd^-0.5, the softmax in float32, cast back, einsum
  with v.

For float32 and bfloat16 compute it times the flow-matching train step
(MSE onto a fresh normal target, AdamW 1e-4) and a forward under
``no_grad``: CUDA events, the median of ``--steps`` calls after
``--warmup``, in ``--rounds`` rounds that visit the variants in turn,
reversing the order every other round, and the peak memory of each
reading (``max_memory_allocated``). Prints a line per reading, then one
JSON line with every reading. Needs a CUDA device:

    python3 scripts/time_dit_attention.py
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

DIT_KW = dict(in_channels=1, out_channels=1, input_size=32, patch_size=4, embed_dim=768,
              depth=12, num_heads=12, cond_dim=768)
BATCH = 256


def _attend_module(q, k, v):
    from torchebm_tpu_torch.models.components import transformer

    return transformer._attention(q, k, v)


def _attend_sdpa(q, k, v):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v)


def _attend_math(q, k, v):
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.MATH):
        return F.scaled_dot_product_attention(q, k, v)


def _attend_einsum(q, k, v):
    import torch

    logits = torch.einsum("bhnd,bhmd->bhnm", q, k) * q.shape[-1] ** -0.5
    weights = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bhmd->bhnd", weights, v)


VARIANTS = {"module": _attend_module, "sdpa": _attend_sdpa, "sdpa-math": _attend_math,
            "einsum": _attend_einsum}


def _forward_with(attend):
    """``MultiheadSelfAttention.forward`` with its attention on (B, H, N, hd)
    computed by ``attend``."""
    from torchebm_tpu_torch.models.nets import _linear

    def forward(self, x):
        b, n, d = x.shape
        qkv = _linear(self.qkv, x.to(self.dtype))
        qkv = qkv.reshape(b, n, 3, self.num_heads, d // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        y = attend(q, k, v)
        return _linear(self.out_proj, y.transpose(1, 2).reshape(b, n, d))

    return forward


def _median_ms(fn, warmup: int, steps: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=61)
    args = ap.parse_args()

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_dit_attention.py needs a CUDA device")
    from torchebm_tpu_torch.models import ConditionalTransformer2D
    from torchebm_tpu_torch.models.components import transformer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    readings = []
    for dtype_name in ("float32", "bfloat16"):
        torch.manual_seed(args.seed)
        with torch.device(dev):
            model = ConditionalTransformer2D(**DIT_KW, dtype=getattr(torch, dtype_name))
        g = torch.Generator(dev).manual_seed(args.seed)
        size = DIT_KW["input_size"]
        x = torch.randn((BATCH, DIT_KW["in_channels"], size, size), generator=g, device=dev)
        cond = torch.randn((BATCH, DIT_KW["cond_dim"]), generator=g, device=dev)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)

        def train_step():
            target = torch.randn(x.shape, generator=g, device=dev)
            loss = torch.mean(torch.square(model(x, cond) - target))
            loss.backward()
            opt.step()
            opt.zero_grad(set_to_none=True)

        def forward():
            with torch.no_grad():
                model(x, cond)

        names = list(VARIANTS)
        for r in range(args.rounds):
            for name in names if r % 2 == 0 else names[::-1]:
                transformer.MultiheadSelfAttention.forward = _forward_with(VARIANTS[name])
                for what, fn in (("train step", train_step), ("forward", forward)):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    ms = _median_ms(fn, args.warmup, args.steps)
                    peak = torch.cuda.max_memory_allocated() / 2**30
                    readings.append(dict(dtype=dtype_name, what=what, variant=name, round=r,
                                         ms=ms, peak_gib=peak))
                    print(f"attention: DiT-768x12 {dtype_name} {what}, batch {BATCH}, {name}, "
                          f"round {r}: {ms:.3f} ms (CUDA events, median of {args.steps} after "
                          f"{args.warmup}), peak {peak:.3f} GiB | {card}", flush=True)
        del model, opt, x, cond
        torch.cuda.empty_cache()
    for dtype_name in ("float32", "bfloat16"):
        for what in ("train step", "forward"):
            cells = []
            for name in VARIANTS:
                ms = [r["ms"] for r in readings
                      if (r["dtype"], r["what"], r["variant"]) == (dtype_name, what, name)]
                cells.append(f"{name} median {statistics.median(ms):.3f} ms "
                             f"(min {min(ms):.3f}, max {max(ms):.3f})")
            print(f"attention: DiT-768x12 {dtype_name} {what}, over {args.rounds} rounds: "
                  + "; ".join(cells) + f" | {card}")
    print(json.dumps({"card": card, "readings": readings}))


if __name__ == "__main__":
    main()
