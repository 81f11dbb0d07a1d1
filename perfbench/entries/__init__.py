"""Entries: one kind of call each, found by a traffic file's ``entry``.

An entry module has ``setup(config, traffic, seed, device)``, which builds
the system under test, warms it up and returns a cell with:

- ``units``: the work of one call (samples, transitions), and ``work``: what
  the metric readers need (FLOPs per call, a kernel and its least time);
- ``call(i)``: call ``i`` of the window, one user call;
- ``readings()``: what the program produced that the check compares, after
  the window; ``release()`` frees the program's state;
- ``reference(got, precision=None)``: the plain reference's readings of the
  inputs behind ``got``, the program's readings (``precision``: a control's
  lower precision);

and ``compare(got, want) -> {number: value}``, each number a gap that must
not pass its limit.
"""

import sys
import time

import torch


def stamp(label: str, since: float) -> float:
    """Print on standard error the seconds a set-up step took since
    ``since``; returns now."""
    now = time.perf_counter()
    print(f"step {label}: {now - since:.3f} s", file=sys.stderr, flush=True)
    return now


def free(device) -> None:
    """Return what the card's caching allocator holds of dropped tensors."""
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def sync(device) -> None:
    """Wait for ``device``'s work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """Keeps ``k`` of the window's calls, every call as likely as any other,
    chosen by a generator seeded from the run: :meth:`slot` decides, before a
    call, whether it is kept and in which of the ``k`` slots."""

    def __init__(self, k: int, seed: int):
        import random

        self.k, self.n, self.rng = int(k), 0, random.Random(seed)
        self.kept: dict = {}

    def slot(self):
        n, self.n = self.n, self.n + 1
        if n < self.k:
            return n
        j = self.rng.randrange(n + 1)
        return j if j < self.k else None
