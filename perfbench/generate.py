"""Inputs and weights from the seed: the one general traffic generator.

A traffic file's ``inputs`` maps each input's name to its distribution and
shape::

    "inputs": {"x": {"dist": "normal", "shape": ["batch", "in_channels", 32, 32]},
               "y": {"dist": "randint", "high": "num_classes", "shape": ["batch"]},
               "drop": {"dist": "bernoulli", "p": "label_dropout", "shape": ["batch"]}}

A size or parameter given as a string is read from the traffic file, then
from the configuration. :func:`make_pool` draws ``pool`` entries of every
input on the device, one call per input, from a generator seeded by the run's
seed, so the same seed gives the same inputs and every seed the same sizes.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

import torch

DISTS = ("normal", "randint", "bernoulli")


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of the run seeded by ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(subseed(seed, tag))


def lookup(value, traffic: dict, config: dict):
    """``value`` itself, or the traffic's or else the configuration's entry
    of that name."""
    if not isinstance(value, str):
        return value
    for table in (traffic, config):
        if value in table:
            return table[value]
    raise KeyError(f"no size or parameter named {value!r} in the traffic or the configuration")


def make_pool(traffic: dict, config: dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """``traffic["pool"]`` dicts of inputs, each holding every input of
    ``traffic["inputs"]`` at its shape."""
    n = int(traffic["pool"])
    g = generator(seed, "inputs", device)
    drawn = {}
    for name in sorted(traffic["inputs"]):
        spec = traffic["inputs"][name]
        shape = (n, *(int(lookup(s, traffic, config)) for s in spec["shape"]))
        dist = spec["dist"]
        if dist == "normal":
            drawn[name] = torch.randn(shape, generator=g, device=device)
        elif dist == "randint":
            drawn[name] = torch.randint(0, int(lookup(spec["high"], traffic, config)), shape,
                                        generator=g, device=device)
        elif dist == "bernoulli":
            p = float(lookup(spec["p"], traffic, config))
            drawn[name] = torch.rand(shape, generator=g, device=device) < p
        else:
            raise ValueError(f"input {name!r}: unknown dist {dist!r}; known: {DISTS}")
    return [{k: v[i] for k, v in drawn.items()} for i in range(n)]


def make_weights(layout: Sequence[Tuple[str, tuple, float]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """``{name: float32 tensor}``: normal draws times each leaf's standard
    deviation, for the ``(name, shape, std)`` entries of ``layout``; one draw
    on the device for all leaves, scaled in one multiply."""
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in layout]
    g = generator(seed, "weights", device)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    stds = torch.tensor([float(std) for *_, std in layout], device=device)
    flat.mul_(torch.repeat_interleave(stds, torch.tensor(sizes, device=device)))
    return {name: part.view(shape)
            for (name, shape, _), part in zip(layout, torch.split(flat, sizes))}
