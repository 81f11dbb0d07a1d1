"""The port's ``GaussianMixtureEnergy.eight_gaussians`` ring."""

from __future__ import annotations


def build(cfg: dict, device):
    from torchebm_tpu_torch.core import GaussianMixtureEnergy

    if cfg["dim"] != 2:
        raise ValueError("the ring lies in 2 dimensions")
    ring = GaussianMixtureEnergy.eight_gaussians(radius=cfg["radius"], scale=cfg["scale"])
    if ring.means.shape[0] != cfg["n_components"]:
        raise ValueError(f"the port's ring has {ring.means.shape[0]} components")
    return ring.to(device)
