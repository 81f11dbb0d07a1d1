"""Couplings: noise↔data pairing rules (independent, minibatch OT,
model-induced); counterpart of ``torchebm_tpu.couplings``."""

from .base import BaseCostCoupling, BaseCoupling, BaseModelCoupling, CouplingResult
from .ot import (
    ExactOTCoupling,
    GreedyCoupling,
    IndependentCoupling,
    ReflowCoupling,
    SinkhornCoupling,
    UnbalancedSinkhornCoupling,
    auction_assignment,
    greedy_assignment,
    sinkhorn_log,
    unbalanced_sinkhorn_log,
)
from .registry import COUPLING_REGISTRY, get_coupling, resolve_coupling

__all__ = [
    "CouplingResult",
    "BaseCoupling",
    "BaseCostCoupling",
    "BaseModelCoupling",
    "IndependentCoupling",
    "ExactOTCoupling",
    "SinkhornCoupling",
    "UnbalancedSinkhornCoupling",
    "GreedyCoupling",
    "ReflowCoupling",
    "COUPLING_REGISTRY",
    "get_coupling",
    "resolve_coupling",
    "sinkhorn_log",
    "unbalanced_sinkhorn_log",
    "auction_assignment",
    "greedy_assignment",
]
