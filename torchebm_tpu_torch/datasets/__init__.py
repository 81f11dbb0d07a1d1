"""Datasets (counterpart of ``torchebm_tpu.datasets``): the eight synthetic
2D generators and image loading."""

from .generators import (
    DATASET_REGISTRY,
    BaseSyntheticDataset,
    CheckerboardDataset,
    CircleDataset,
    EightGaussiansDataset,
    GaussianMixtureDataset,
    GridDataset,
    PinwheelDataset,
    SwissRollDataset,
    TwoMoonsDataset,
    make_8gaussians,
    make_checkerboard,
    make_circle,
    make_gaussian_mixture,
    make_grid,
    make_pinwheel,
    make_swiss_roll,
    make_two_moons,
)
from .images import load_mnist

__all__ = [
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
    "make_gaussian_mixture",
    "make_8gaussians",
    "make_two_moons",
    "make_swiss_roll",
    "make_circle",
    "make_checkerboard",
    "make_pinwheel",
    "make_grid",
    "load_mnist",
]
