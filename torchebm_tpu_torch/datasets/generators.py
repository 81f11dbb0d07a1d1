r"""Synthetic 2D datasets (counterpart of :mod:`torchebm_tpu.datasets.generators`).

Each distribution is a function ``make_<name>(generator, n_samples, **cfg)``
returning an ``(n, 2)`` float32 tensor on the generator's device, drawn from
that generator alone; :class:`BaseSyntheticDataset` wraps one with the
seeded-at-init / ``regenerate`` / ``get_data`` / indexing surface.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.module import default_device

Tensor = torch.Tensor

__all__ = [
    "make_gaussian_mixture",
    "make_8gaussians",
    "make_two_moons",
    "make_swiss_roll",
    "make_circle",
    "make_checkerboard",
    "make_pinwheel",
    "make_grid",
    "BaseSyntheticDataset",
    "GaussianMixtureDataset",
    "EightGaussiansDataset",
    "TwoMoonsDataset",
    "SwissRollDataset",
    "CircleDataset",
    "CheckerboardDataset",
    "PinwheelDataset",
    "GridDataset",
    "DATASET_REGISTRY",
]


def _normal(g: torch.Generator, *shape) -> Tensor:
    return torch.randn(shape, generator=g, device=g.device, dtype=torch.float32)


def _uniform(g: torch.Generator, *shape) -> Tensor:
    return torch.rand(shape, generator=g, device=g.device, dtype=torch.float32)


def _randint(g: torch.Generator, high: int, n: int) -> Tensor:
    return torch.randint(0, high, (n,), generator=g, device=g.device)


def _linspace(g: torch.Generator, start: float, end: float, n: int) -> Tensor:
    return torch.linspace(start, end, n, device=g.device, dtype=torch.float32)


def make_gaussian_mixture(g: torch.Generator, n_samples: int = 2000, n_components: int = 8,
                          std: float = 0.05, radius: float = 1.0) -> Tensor:
    """Ring of ``n_components`` Gaussians."""
    if n_components <= 0:
        raise ValueError("n_components must be positive")
    if std < 0:
        raise ValueError("std must be non-negative")
    thetas = _linspace(g, 0.0, 2 * math.pi, n_components + 1)[:-1]
    centers = radius * torch.stack([torch.cos(thetas), torch.sin(thetas)], dim=1)
    comp = _randint(g, n_components, n_samples)
    return centers[comp] + std * _normal(g, n_samples, 2)


_DIAG = 1.0 / math.sqrt(2)
#: the eight centres of the classic benchmark (the JAX package's ``_EIGHT_CENTERS``)
_EIGHT_CENTERS = (
    (1, 0), (-1, 0), (0, 1), (0, -1),
    (_DIAG, _DIAG), (_DIAG, -_DIAG), (-_DIAG, _DIAG), (-_DIAG, -_DIAG),
)


def make_8gaussians(g: torch.Generator, n_samples: int = 2000, std: float = 0.02,
                    scale: float = 2.0) -> Tensor:
    """The classic '8 Gaussians' mixture."""
    centers = scale * torch.tensor(_EIGHT_CENTERS, dtype=torch.float32, device=g.device)
    comp = _randint(g, 8, n_samples)
    return centers[comp] + std * _normal(g, n_samples, 2)


def make_two_moons(g: torch.Generator, n_samples: int = 2000, noise: float = 0.05) -> Tensor:
    """Two interleaving half-circles."""
    n_out = n_samples // 2
    n_in = n_samples - n_out
    outer = _linspace(g, 0.0, math.pi, n_out)
    inner = _linspace(g, 0.0, math.pi, n_in)
    data = torch.stack(
        [
            torch.cat([torch.cos(outer), 1 - torch.cos(inner)]),
            torch.cat([torch.sin(outer), 1 - torch.sin(inner) - 0.5]),
        ],
        dim=1,
    )
    return data + noise * _normal(g, *data.shape)


def make_swiss_roll(g: torch.Generator, n_samples: int = 2000, noise: float = 0.05,
                    arclength: float = 3.0) -> Tensor:
    """2D Swiss roll, centred and scaled."""
    t = arclength * math.pi * (1 + 2 * _uniform(g, n_samples))
    data = torch.stack([t * torch.cos(t), t * torch.sin(t)], dim=1)
    data = data + noise * _normal(g, *data.shape)
    std = torch.std(data, dim=0, correction=0)
    return (data - torch.mean(data, dim=0)) / (torch.mean(std) * 2.0)


def make_circle(g: torch.Generator, n_samples: int = 2000, noise: float = 0.05,
                radius: float = 1.0) -> Tensor:
    """Uniform circle with Gaussian noise."""
    angles = 2 * math.pi * _uniform(g, n_samples)
    data = radius * torch.stack([torch.cos(angles), torch.sin(angles)], dim=1)
    return data + noise * _normal(g, *data.shape)


def make_checkerboard(g: torch.Generator, n_samples: int = 2000, range_limit: float = 4.0,
                      noise: float = 0.01) -> Tensor:
    """Checkerboard pattern: ``max(1000, 4n)`` uniform candidates, the valid
    ones first in a stable order, ``n`` of them kept (reused modulo their
    count in the unlikely shortfall), as in the JAX package."""
    batch = max(1000, 4 * n_samples)
    xy = (_uniform(g, batch, 2) * 2 - 1) * range_limit
    keep = torch.remainder(torch.floor(xy[:, 0]) + torch.floor(xy[:, 1]), 2) != 0
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    n_valid = int(keep.sum())
    idx = order[torch.arange(n_samples, device=g.device) % max(n_valid, 1)]
    return xy[idx] + noise * _normal(g, n_samples, 2)


def make_pinwheel(g: torch.Generator, n_samples: int = 2000, n_classes: int = 5,
                  noise: float = 0.05, radial_scale: float = 2.0, angular_scale: float = 0.1,
                  spiral_scale: float = 5.0) -> Tensor:
    """Pinwheel with curved blades."""
    cls = _randint(g, n_classes, n_samples)
    t = torch.sqrt(_uniform(g, n_samples))
    radii = t * radial_scale
    base_angle = cls * (2 * math.pi / n_classes)
    thetas = base_angle + spiral_scale * t + angular_scale * _normal(g, n_samples)
    data = torch.stack([radii * torch.cos(thetas), radii * torch.sin(thetas)], dim=1)
    return data + noise * _normal(g, *data.shape)


def make_grid(g: torch.Generator, n_samples_per_dim: int = 10, range_limit: float = 1.0,
              noise: float = 0.01) -> Tensor:
    """Regular 2D grid plus noise; ``n_samples_per_dim²`` points, x varying
    fastest (``meshgrid`` in xy order)."""
    if n_samples_per_dim <= 0:
        raise ValueError("n_samples_per_dim must be positive")
    coords = _linspace(g, -range_limit, range_limit, n_samples_per_dim)
    yv, xv = torch.meshgrid(coords, coords, indexing="ij")
    data = torch.stack([xv.reshape(-1), yv.reshape(-1)], dim=1)
    return data + noise * _normal(g, *data.shape)


# ---------------------------------------------------------------------------
# Stateful dataset wrappers
# ---------------------------------------------------------------------------


class BaseSyntheticDataset:
    """Seeded-at-init dataset wrapper with ``regenerate``/``get_data``/indexing.

    The data are drawn from ``torch.Generator(device).manual_seed(seed)``
    and live on ``device``: by default the current CUDA device when there is
    one, else the CPU.
    """

    _make = None  # staticmethod set by subclasses
    _default_kwargs = {}

    def __init__(self, n_samples: int = 2000, seed: Optional[int] = None, *,
                 device: Optional[torch.device] = None, **kwargs):
        if n_samples <= 0:
            raise ValueError("n_samples must be positive")
        self.n_samples = int(n_samples)
        self.config = {**self._default_kwargs, **kwargs}
        self.seed = 0 if seed is None else int(seed)
        self.device = default_device() if device is None else torch.device(device)
        self.data = self._generate(self.seed)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(seed)

    def _generate(self, seed: int) -> Tensor:
        return type(self)._make(self._generator(seed), self.n_samples, **self.config)

    def regenerate(self, seed: Optional[int] = None) -> Tensor:
        """Redraw the dataset (optionally with a new seed); returns the new data."""
        self.seed = int(seed) if seed is not None else self.seed + 1
        self.data = self._generate(self.seed)
        return self.data

    def get_data(self) -> Tensor:
        return self.data

    def __len__(self) -> int:
        return self.data.shape[0]

    def __getitem__(self, idx):
        return self.data[idx]

    def batches(self, generator: torch.Generator, batch_size: int, *, drop_last: bool = True):
        """Yield shuffled minibatches (one epoch); the permutation comes from
        ``generator``, which must live on the data's device."""
        perm = torch.randperm(self.data.shape[0], generator=generator, device=self.device)
        n_full = self.data.shape[0] // batch_size
        for i in range(n_full):
            yield self.data[perm[i * batch_size: (i + 1) * batch_size]]
        if not drop_last and self.data.shape[0] % batch_size:
            yield self.data[perm[n_full * batch_size:]]


class GaussianMixtureDataset(BaseSyntheticDataset):
    _make = staticmethod(make_gaussian_mixture)
    _default_kwargs = dict(n_components=8, std=0.05, radius=1.0)


class EightGaussiansDataset(BaseSyntheticDataset):
    _make = staticmethod(make_8gaussians)
    _default_kwargs = dict(std=0.02, scale=2.0)


class TwoMoonsDataset(BaseSyntheticDataset):
    _make = staticmethod(make_two_moons)
    _default_kwargs = dict(noise=0.05)


class SwissRollDataset(BaseSyntheticDataset):
    _make = staticmethod(make_swiss_roll)
    _default_kwargs = dict(noise=0.05, arclength=3.0)


class CircleDataset(BaseSyntheticDataset):
    _make = staticmethod(make_circle)
    _default_kwargs = dict(noise=0.05, radius=1.0)


class CheckerboardDataset(BaseSyntheticDataset):
    _make = staticmethod(make_checkerboard)
    _default_kwargs = dict(range_limit=4.0, noise=0.01)


class PinwheelDataset(BaseSyntheticDataset):
    _make = staticmethod(make_pinwheel)
    _default_kwargs = dict(n_classes=5, noise=0.05, radial_scale=2.0,
                           angular_scale=0.1, spiral_scale=5.0)


class GridDataset(BaseSyntheticDataset):
    _default_kwargs = dict(range_limit=1.0, noise=0.01)

    def __init__(self, n_samples_per_dim: int = 10, seed: Optional[int] = None, *,
                 device: Optional[torch.device] = None, **kwargs):
        self.n_samples_per_dim = int(n_samples_per_dim)
        super().__init__(n_samples=n_samples_per_dim**2, seed=seed, device=device, **kwargs)

    def _generate(self, seed: int) -> Tensor:
        return make_grid(self._generator(seed), self.n_samples_per_dim, **self.config)


DATASET_REGISTRY = {
    "gaussian_mixture": GaussianMixtureDataset,
    "8gaussians": EightGaussiansDataset,
    "two_moons": TwoMoonsDataset,
    "swiss_roll": SwissRollDataset,
    "circle": CircleDataset,
    "checkerboard": CheckerboardDataset,
    "pinwheel": PinwheelDataset,
    "grid": GridDataset,
}
