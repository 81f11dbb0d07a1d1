"""Every public name of the JAX package resolves in the port, or is on the
explicit list of what is still to be ported.

The names are read from the JAX package's sources (its top-level
``_SUBMODULES`` and ``_LAZY_SYMBOLS``, and each subpackage's ``__all__``), so
the check needs no JAX import. ``NOT_YET`` shrinks as slices land; a name on
it that resolves fails the test, so the list cannot go stale.
"""

import ast
import importlib
from pathlib import Path

import pytest

import torchebm_tpu_torch

ROOT = Path(__file__).resolve().parents[1] / "torchebm_tpu"

#: what the port does not have yet: the distributed helpers (``parallel``)
NOT_YET = {
    "parallel",
    "make_mesh", "batch_sharding", "replicated_sharding", "shard_batch", "replicate",
    "fsdp_shard_params", "init_distributed", "local_shard_bounds", "is_distributed",
    "get_rank", "get_world_size", "all_gather_cat", "broadcast_object", "psum_mean",
    "shard_replay_buffer", "shuffle_sharded",
}

SUBPACKAGES = ("core", "integrators", "interpolants", "couplings", "samplers", "losses",
               "models", "models.components", "datasets", "ops", "utils", "parallel")


def _literal(path: Path, name: str):
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == name
                                                for t in node.targets):
            return ast.literal_eval(node.value)
    raise LookupError(f"{path} assigns no {name}")


def _jax_names():
    init = ROOT / "__init__.py"
    names = [("", n) for n in (*_literal(init, "_SUBMODULES"), *_literal(init, "_LAZY_SYMBOLS"))]
    for sub in SUBPACKAGES:
        path = ROOT.joinpath(*sub.split("."), "__init__.py")
        names += [(sub, n) for n in _literal(path, "__all__")]
    return names


def _resolves(sub: str, name: str) -> bool:
    try:
        module = importlib.import_module(f"torchebm_tpu_torch.{sub}" if sub else
                                         "torchebm_tpu_torch")
    except ModuleNotFoundError:
        return False
    return hasattr(module, name)


@pytest.mark.parametrize("sub", ["", *SUBPACKAGES], ids=lambda s: s or "top")
def test_every_jax_name_resolves_or_is_listed(sub):
    names = [n for s, n in _jax_names() if s == sub]
    assert names
    missing = sorted(n for n in names if n not in NOT_YET and not _resolves(sub, n))
    assert not missing, f"not in the port's {sub or 'top level'}: {missing}"
    stale = sorted(n for n in names if n in NOT_YET and _resolves(sub, n))
    assert not stale, f"ported, so take them off NOT_YET: {stale}"


def test_not_yet_holds_only_listed_jax_names():
    assert NOT_YET <= {n for _, n in _jax_names()}


def test_this_slice_resolves_at_models_or_losses_and_the_top_level():
    for sub, names in (
        ("models", ("ConditionalTransformer2D", "AdaLNZeroBlock", "AdaLNZeroPatchHead",
                    "ConvPatchEmbed2d", "FeedForward", "MultiheadSelfAttention", "modulate",
                    "patchify2d", "unpatchify2d", "build_2d_sincos_pos_embed", "LabelEmbedder",
                    "LabelClassifierFreeGuidance", "InteractionModel")),
        ("losses", ("ScoreMatching", "DenoisingScoreMatching", "SlicedScoreMatching",
                    "BaseScoreMatching")),
        ("interpolants", ("expand_t_like_x",)),
    ):
        module = importlib.import_module(f"torchebm_tpu_torch.{sub}")
        for name in names:
            assert getattr(torchebm_tpu_torch, name) is getattr(module, name), name
            assert name in torchebm_tpu_torch.__all__


def test_the_advanced_hmc_slice_resolves_at_its_subpackages_and_the_top_level():
    for sub, names in (
        ("samplers", ("RiemannianManifoldHMC", "NoUTurnSampler", "TrajectoryTuning",
                      "tune_trajectory_length")),
        ("integrators", ("GeneralisedLeapfrogIntegrator",)),
    ):
        module = importlib.import_module(f"torchebm_tpu_torch.{sub}")
        for name in names:
            assert getattr(torchebm_tpu_torch, name) is getattr(module, name), name
            assert name in torchebm_tpu_torch.__all__ and name in module.__all__
