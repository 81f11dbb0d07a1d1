"""The port's DiT family against the JAX package's flax modules on converted,
perturbed weights.

A fresh adaLN-Zero model outputs exactly zero, so every parity test first
moves every leaf of the flax tree by N(0, 0.02²) from a numpy seed, converts
the tree and then compares forward values (float32, rtol 1e-5 / atol 1e-5:
the same matmuls summed in another order) and parameter gradients (rtol 1e-4
/ atol 1e-5). Also here: patchify, the sin-cos table, the label embedder,
classifier-free guidance, the interaction energy, bf16 compute and
``FlowSampler.log_prob`` on a DiT field.
"""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import torchebm_tpu.models as jm
from torchebm_tpu.models.components import AdaLNZeroPatchHead as JHead
from torchebm_tpu.models.components import FeedForward as JFeedForward
from torchebm_tpu.models.components import MultiheadSelfAttention as JAttention
from torchebm_tpu.models.components import AdaLNZeroBlock as JBlock
from torchebm_tpu_torch.core import GaussianEnergy, TemperatureScheduler
from torchebm_tpu_torch.models import (
    AdaLNZeroBlock,
    AdaLNZeroPatchHead,
    ConditionalTransformer2D,
    EqMEnergy,
    FeedForward,
    InteractionModel,
    LabelClassifierFreeGuidance,
    LabelEmbedder,
    MLPTimestepEmbedder,
    MultiheadSelfAttention,
    build_2d_sincos_pos_embed,
    patchify2d,
    unpatchify2d,
)
from torchebm_tpu_torch.models.components import transformer
from torchebm_tpu_torch.samplers import FlowSampler, LangevinDynamics
from torchebm_tpu_torch.samplers.flow import WrappedField
from torchebm_tpu_torch.utils import conditional_transformer_2d_from_flax, label_embedder_from_flax
from torchebm_tpu_torch.utils.convert import (
    _load_attention,
    _load_block,
    _load_feedforward,
    _load_head,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _perturbed(params, seed):
    """The flax tree with every leaf moved by N(0, 0.02²), as numpy float32."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(np.shape(a))).astype(np.float32),
        params)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_patchify_matches_jax_and_round_trips():
    x = _normal(0, 2, 3, 8, 8)
    tokens = patchify2d(torch.from_numpy(x), 2)
    assert tokens.shape == (2, 16, 12)
    # (ph, pw, C) feature order, bit for bit: a pure permutation
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jm.patchify2d(jnp.asarray(x), 2)))
    back = unpatchify2d(tokens, 2, out_channels=3)
    np.testing.assert_array_equal(back.numpy(), x)
    t = _normal(1, 2, 16, 12)
    np.testing.assert_array_equal(unpatchify2d(torch.from_numpy(t), 2, out_channels=3).numpy(),
                                  np.asarray(jm.unpatchify2d(jnp.asarray(t), 2, out_channels=3)))
    with pytest.raises(ValueError):
        patchify2d(torch.from_numpy(x), 3)
    with pytest.raises(ValueError):
        unpatchify2d(tokens, 2, out_channels=5)
    with pytest.raises(ValueError, match="perfect square"):
        unpatchify2d(tokens[:, :15], 2, out_channels=3)


@pytest.mark.parametrize("embed_dim, grid", [(16, 4), (32, 3), (64, 8)])
def test_sincos_table_matches_jax(embed_dim, grid):
    got = build_2d_sincos_pos_embed(embed_dim, grid)
    assert got.shape == (grid * grid, embed_dim) and got.dtype == torch.float32
    want = np.asarray(jm.build_2d_sincos_pos_embed(embed_dim, grid))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the first half embeds the column coordinate (the JAX package's "emb_h")
    np.testing.assert_allclose(got[1, : embed_dim // 4].numpy(),
                               np.sin(1.0 / 10000 ** (np.arange(embed_dim // 4) / (embed_dim / 4))),
                               rtol=1e-6, atol=1e-6)
    assert float(torch.min(torch.linalg.norm(got[0] - got[1:], dim=-1))) > 1e-3
    with pytest.raises(ValueError):
        build_2d_sincos_pos_embed(15, 4)


def test_attention_and_feedforward_match_jax():
    x = _normal(2, 3, 16, 32)
    jattn = JAttention(embed_dim=32, num_heads=4)
    params = _perturbed(jax.jit(jattn.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 0)
    attn = MultiheadSelfAttention(32, 4)
    _load_attention(attn, params["params"])
    _close(attn(torch.from_numpy(x)), jax.jit(jattn.apply)(params, jnp.asarray(x)))
    with pytest.raises(ValueError, match="divisible"):
        MultiheadSelfAttention(30, 4)

    jff = JFeedForward(embed_dim=32, mlp_ratio=2.0)
    params = _perturbed(jax.jit(jff.init)(jax.random.PRNGKey(1), jnp.asarray(x)), 1)
    ff = FeedForward(32, 2.0)
    _load_feedforward(ff, params["params"])
    _close(ff(torch.from_numpy(x)), jax.jit(jff.apply)(params, jnp.asarray(x)))


def _attention_derivative(attend, mode):
    """One derivative of ``attend`` with q = x, k = 2x, v = sin x (one input
    on another's path), taken the way ``mode`` names."""
    x = torch.from_numpy(_normal(4, 2, 3, 16, 8))
    ones = torch.ones_like(x)

    def f(z):
        return attend(z, 2 * z, torch.sin(z))

    def loss(z):
        return torch.sum(torch.square(f(z)))

    if mode == "no_grad":
        with torch.no_grad():
            return f(x)
    if mode == "forward_ad":
        with fwAD.dual_level():
            return fwAD.unpack_dual(f(fwAD.make_dual(x, ones))).tangent
    if mode == "torch.func.jvp":
        return torch.func.jvp(f, (x,), (ones,))[1]
    if mode == "vmap jacrev grad":
        return torch.func.vmap(torch.func.jacrev(torch.func.grad(lambda z: loss(z[None]))))(
            x[:, :1, :4])
    xx = x.requires_grad_()
    if mode == "gradient":
        return torch.autograd.grad(loss(xx), xx)[0]
    if mode == "backward twice":
        y = loss(xx)
        first = torch.autograd.grad(y, xx, retain_graph=True)[0]
        return torch.stack([first, torch.autograd.grad(y, xx)[0]])
    (g,) = torch.autograd.grad(loss(xx), xx, create_graph=True)  # create_graph
    return torch.autograd.grad(torch.sum(torch.square(g)), xx)[0]


@pytest.mark.parametrize("mode", ["no_grad", "gradient", "backward twice", "create_graph",
                                  "forward_ad", "torch.func.jvp", "vmap jacrev grad"])
def test_attention_has_every_derivative_of_the_einsum_form(mode):
    """The attention picks SDPA's fused kernels or the JAX package's einsum
    form by itself; every way of differentiating it equals the einsum form's,
    which the fused backends alone cannot give (no forward-mode, no
    second-order derivative)."""
    got = _attention_derivative(transformer._attention, mode)
    want = _attention_derivative(transformer._einsum_attention, mode)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **GRAD_TOL)


def test_attention_trains_through_the_fused_kernels():
    """A first-order train step goes through ``_FusedAttention`` and equals
    plain SDPA's gradients; with no gradient to take, SDPA runs alone."""
    q, k, v = (torch.from_numpy(_normal(5 + i, 2, 3, 16, 8)).requires_grad_() for i in range(3))
    out = transformer._attention(q, k, v)
    assert type(out.grad_fn).__name__ == "_FusedAttentionBackward"
    ref = F.scaled_dot_product_attention(q, k, v)
    _close(out, ref.detach().numpy())
    got = torch.autograd.grad(torch.sum(out * torch.cos(out)), (q, k, v))
    want = torch.autograd.grad(torch.sum(ref * torch.cos(ref)), (q, k, v))
    for a, b in zip(got, want):
        _close(a, b.numpy(), GRAD_TOL)
    with torch.no_grad():
        assert transformer._attention(q, k, v).grad_fn is None


class _FlatEnergy(torch.nn.Module):
    """A DiT's explicit EqM energy on flattened 1 x 4 x 4 images."""

    def __init__(self, dit):
        super().__init__()
        self.energy_of_images = EqMEnergy(dit, "dot")

    def energy(self, x):
        return self.energy_of_images.energy(x.reshape(-1, 1, 4, 4))

    forward = energy


@pytest.mark.parametrize("loss_name", ["exact", "approx", "denoising", "sliced"])
def test_score_matching_trains_a_dit_energy_through_attention(loss_name, monkeypatch):
    """Score matching differentiates the model twice (``create_graph``,
    ``torch.func``); on a DiT energy the loss and its parameter gradients
    equal those with the einsum form forced everywhere. For approx SM the
    quadratic term ½ E‖∇E‖² is compared: its trace term is a difference
    quotient at ε = 1e-5 that cancels in float32, so rounding differences of
    1e-7 in the score reach it as 1e-2 (``test_torch_score_matching.py``
    bounds it against JAX); the whole loss still trains here."""
    from torchebm_tpu_torch.losses import (
        DenoisingScoreMatching,
        ScoreMatching,
        SlicedScoreMatching,
    )

    torch.manual_seed(0)
    dit = ConditionalTransformer2D(in_channels=1, out_channels=1, input_size=4, patch_size=2,
                                   embed_dim=16, depth=1, num_heads=2)
    with torch.no_grad():
        for p in dit.parameters():
            p.add_(0.1 * torch.randn_like(p))
    energy = _FlatEnergy(dit)
    loss = {"exact": ScoreMatching(model=energy),
            "approx": ScoreMatching(model=energy, hessian_method="approx"),
            "denoising": DenoisingScoreMatching(model=energy, noise_scale=0.1),
            "sliced": SlicedScoreMatching(model=energy, n_projections=2)}[loss_name]
    x = torch.from_numpy(_normal(6, 2, 16))
    runs = []
    for attend in (transformer._attention, transformer._einsum_attention):
        monkeypatch.setattr(transformer, "_attention", attend)
        dit.zero_grad()
        value = loss(None, x, torch.Generator().manual_seed(0))
        if loss_name == "approx":
            value.backward()
            assert torch.isfinite(value) and dit.head.proj.weight.grad is not None
            dit.zero_grad()
            value = 0.5 * torch.mean(torch.sum(torch.square(loss.compute_score(energy, x, None)),
                                               dim=-1))
        value.backward()
        runs.append((value.detach(), [p.grad.clone() for p in dit.parameters()]))
    (got, got_grads), (want, want_grads) = runs
    assert torch.isfinite(got)
    _close(got, want.numpy())
    for a, b in zip(got_grads, want_grads):
        _close(a, b.numpy(), GRAD_TOL)


@pytest.mark.parametrize("cond_dim", [None, 24])
def test_block_and_head_match_jax(cond_dim):
    x = _normal(3, 2, 16, 32)
    c = _normal(4, 2, cond_dim or 32)
    jblock = JBlock(embed_dim=32, num_heads=2, cond_dim=cond_dim)
    params = _perturbed(jax.jit(jblock.init)(jax.random.PRNGKey(2), jnp.asarray(x),
                                             jnp.asarray(c)), 2)
    block = AdaLNZeroBlock(32, 2, cond_dim=cond_dim)
    _load_block(block, params["params"])
    _close(block(torch.from_numpy(x), torch.from_numpy(c)),
           jax.jit(jblock.apply)(params, jnp.asarray(x), jnp.asarray(c)))

    jhead = JHead(embed_dim=32, patch_size=2, out_channels=3, cond_dim=cond_dim)
    params = _perturbed(jax.jit(jhead.init)(jax.random.PRNGKey(3), jnp.asarray(x),
                                            jnp.asarray(c)), 3)
    head = AdaLNZeroPatchHead(32, 2, 3, cond_dim=cond_dim)
    _load_head(head, params["params"])
    out = head(torch.from_numpy(x), torch.from_numpy(c))
    assert out.shape == (2, 3, 8, 8)
    _close(out, jax.jit(jhead.apply)(params, jnp.asarray(x), jnp.asarray(c)))


#: (in_channels, out_channels, input_size, patch_size, embed_dim, depth, heads, cond_dim)
DIT_CASES = [
    (3, 3, 8, 2, 32, 2, 4, 32),
    (1, 2, 16, 4, 64, 2, 2, None),
    (3, 1, 12, 4, 48, 2, 4, 20),
]


def _dit(case, seed, dtype=jnp.float32):
    c_in, c_out, size, patch, embed, depth, heads, cond_dim = case
    jdit = jm.ConditionalTransformer2D(
        in_channels=c_in, out_channels=c_out, input_size=size, patch_size=patch,
        embed_dim=embed, depth=depth, num_heads=heads, cond_dim=cond_dim, dtype=dtype)
    x = _normal(seed, 4, c_in, size, size)
    c = _normal(seed + 1, 4, cond_dim or embed)
    params = _perturbed(jax.jit(jdit.init)(jax.random.PRNGKey(seed), jnp.asarray(x),
                                           jnp.asarray(c)), seed)
    return jdit, params, x, c


def _convert(case, params, dtype=torch.float32):
    _, _, size, patch, _, _, heads, _ = case
    return conditional_transformer_2d_from_flax(params, num_heads=heads, input_size=size,
                                                patch_size=patch, dtype=dtype, device="cpu")


@pytest.mark.parametrize("case", DIT_CASES, ids=lambda c: "x".join(map(str, c[:5])))
def test_dit_forward_and_parameter_gradients_match_jax(case):
    jdit, params, x, c = _dit(case, 10)
    dit = _convert(case, params)
    assert len(dit.blocks) == case[5] and dit.cond_dim == (case[7] or case[4])
    want = jax.jit(jdit.apply)(params, jnp.asarray(x), jnp.asarray(c))
    _close(dit(torch.from_numpy(x), torch.from_numpy(c)), want)

    target = _normal(11, *want.shape)
    jgrads = jax.jit(jax.grad(lambda p: jnp.mean(jnp.square(
        jdit.apply(p, jnp.asarray(x), jnp.asarray(c)) - target))))(params)
    loss = torch.mean(torch.square(dit(torch.from_numpy(x), torch.from_numpy(c))
                                   - torch.from_numpy(target)))
    loss.backward()
    got = _grads_by_flax_name(dit)
    want = {k: np.asarray(v) for k, v in _flat(jgrads["params"]).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _grads_by_flax_name(dit) -> dict:
    """The port's parameter gradients under the flax tree's names and
    layouts (a Dense kernel is the transposed weight)."""
    dense = {"ConvPatchEmbed2d_0/proj": dit.patch_embed.proj,
             "head/modulation": dit.head.modulation, "head/proj": dit.head.proj}
    for i, b in enumerate(dit.blocks):
        dense.update({f"block_{i}/modulation": b.modulation,
                      f"block_{i}/MultiheadSelfAttention_0/qkv": b.attn.qkv,
                      f"block_{i}/MultiheadSelfAttention_0/out_proj": b.attn.out_proj,
                      f"block_{i}/FeedForward_0/Dense_0": b.mlp.layers[0],
                      f"block_{i}/FeedForward_0/Dense_1": b.mlp.layers[1]})
    out = {}
    for name, layer in dense.items():
        out[f"{name}/kernel"] = layer.weight.grad.numpy().T
        out[f"{name}/bias"] = layer.bias.grad.numpy()
    return out


def test_dit_zero_init_routes_and_scalar_time_lift():
    torch.manual_seed(0)
    dit = ConditionalTransformer2D(in_channels=1, out_channels=2, input_size=16, patch_size=4,
                                   embed_dim=64, depth=2, num_heads=4, cond_dim=64)
    x = torch.randn(3, 1, 16, 16)
    cond = torch.randn(3, 64)
    out = dit(x, cond)
    assert out.shape == (3, 2, 16, 16)
    # adaLN-Zero: the fresh model outputs exactly zero
    assert float(out.abs().max()) == 0.0
    assert "pos_embed" not in dit.state_dict()
    with pytest.raises(ValueError, match="conditioning"):
        dit(x)
    with pytest.raises(ValueError, match="divisible"):
        ConditionalTransformer2D(input_size=10, patch_size=4)

    case = (1, 1, 8, 4, 32, 2, 2, 16)
    jdit, params, x, _ = _dit(case, 20)
    t = np.array([0.1, 0.9, 0.5, 0.0], np.float32)
    dit = _convert(case, params)
    want = jax.jit(lambda p, xx, tt: jdit.apply(p, xx, t=tt))(params, jnp.asarray(x),
                                                              jnp.asarray(t))
    _close(dit(torch.from_numpy(x), t=torch.from_numpy(t)), want)
    # positional, cond= and t= agree
    _close(dit(torch.from_numpy(x), torch.from_numpy(t)), want)
    _close(dit(torch.from_numpy(x), cond=torch.from_numpy(t)), want)


def test_dit_bf16_keeps_float32_parameters_and_returns_float32():
    case = DIT_CASES[0]
    jdit, params, x, c = _dit(case, 30)
    f32 = _convert(case, params)
    bf16 = _convert(case, params, dtype=torch.bfloat16)
    out = bf16(torch.from_numpy(x), torch.from_numpy(c))
    assert out.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    ref = f32(torch.from_numpy(x), torch.from_numpy(c)).detach()
    # bf16 keeps 8 bits of mantissa (unit roundoff 2^-9 ≈ 2e-3); two blocks
    # of rounded activations stay within a few per cent of the f32 output
    rel = float((out.detach() - ref).abs().max() / ref.abs().max())
    assert 0 < rel < 3e-2, rel
    jout = jax.jit(jm.ConditionalTransformer2D(
        in_channels=3, out_channels=3, input_size=8, patch_size=2, embed_dim=32, depth=2,
        num_heads=4, cond_dim=32, dtype=jnp.bfloat16).apply)(params, jnp.asarray(x), jnp.asarray(c))
    assert float(np.abs(np.asarray(jout) - out.detach().numpy()).max() / ref.abs().max()) < 3e-2


def test_timestep_embedder_dtype():
    t = torch.tensor([0.0, 0.5, 1.0, 2.0])
    torch.manual_seed(1)
    f32 = MLPTimestepEmbedder(16)
    bf16 = MLPTimestepEmbedder(16, dtype=torch.bfloat16)
    bf16.load_state_dict(f32.state_dict())
    out = bf16(t)
    assert out.dtype == torch.bfloat16 and bf16.layers[0].weight.dtype == torch.float32
    ref = f32(t).detach()
    assert float((out.float() - ref).abs().max()) < 2e-2 * float(ref.abs().max())


def test_label_embedder_drops_and_matches_flax():
    torch.manual_seed(0)
    emb = LabelEmbedder(num_classes=10, out_dim=8, dropout_prob=0.5)
    labels = torch.arange(8)
    assert emb.null_label_id == 10 and emb.embed.weight.shape == (11, 8)
    assert LabelEmbedder(num_classes=10, out_dim=8).null_label_id is None
    dropped = emb(labels, force_drop_mask=torch.ones(8, dtype=torch.bool))
    assert float((dropped - emb.embed.weight[10]).abs().max()) == 0.0
    clean = emb(labels)
    assert float(torch.min(torch.linalg.norm(clean[0] - clean[1:], dim=-1))) > 1e-4
    # training-time drops come from the generator, at the rate asked
    g = torch.Generator().manual_seed(0)
    many = torch.zeros(4000, dtype=torch.long)
    drops = (emb(many, train=True, generator=g) == emb.embed.weight[10]).all(-1).float().mean()
    assert abs(float(drops) - 0.5) < 0.05
    with pytest.raises(ValueError, match="generator"):
        emb(labels, train=True)
    # no dropout: no null row, and the mask is ignored as in JAX
    plain = LabelEmbedder(num_classes=10, out_dim=8)
    assert plain.embed.weight.shape == (10, 8)
    assert torch.equal(plain(labels, force_drop_mask=torch.ones(8)), plain(labels))

    jemb = jm.LabelEmbedder(num_classes=10, out_dim=8, dropout_prob=0.1)
    jl = jnp.arange(8, dtype=jnp.int32)
    params = _perturbed(jemb.init({"params": jax.random.PRNGKey(0),
                                   "label_dropout": jax.random.PRNGKey(1)}, jl), 0)
    port = label_embedder_from_flax(params, 0.1, device="cpu")
    mask = np.array([1, 0, 0, 1, 0, 0, 0, 1], bool)
    _close(port(labels), jemb.apply(params, jl))
    _close(port(labels, force_drop_mask=torch.from_numpy(mask)),
           jemb.apply(params, jl, force_drop_mask=jnp.asarray(mask)))


def test_label_embedder_init_follows_flax_defaults():
    torch.manual_seed(0)
    w = LabelEmbedder(num_classes=1000, out_dim=256, dropout_prob=0.1).embed.weight.detach()
    # flax's nn.Embed default: a normal of variance 1 / out_dim, untruncated
    assert abs(float(w.mean())) < 2e-3
    assert abs(float(w.std()) - 256 ** -0.5) < 2e-3
    assert float(w.abs().max()) > 3.5 * 256 ** -0.5


class _Base:
    def __call__(self, x, t, y=None):
        return x * (1.0 + y.to(x.dtype)[:, None, None, None])


def test_cfg_math_and_short_cut():
    cfg = LabelClassifierFreeGuidance(base=_Base(), null_label_id=0, cfg_scale=3.0,
                                      guide_channels=1)
    x = torch.ones(2, 2, 2, 2)
    y = torch.tensor([1, 2])
    out = cfg(x, torch.zeros(2), y=y)
    # the guided channel: uncond + scale·(cond − uncond) = 1 + 3y
    np.testing.assert_allclose(out[:, 0, 0, 0].numpy(), 1 + 3 * y.float().numpy())
    # the other channel keeps the unconditional value
    np.testing.assert_allclose(out[:, 1, 0, 0].numpy(), np.ones(2))
    cfg1 = LabelClassifierFreeGuidance(base=_Base(), null_label_id=0, cfg_scale=1.0)
    np.testing.assert_allclose(cfg1(x, torch.zeros(2), y=y)[:, 0, 0, 0].numpy(),
                               1 + y.float().numpy())
    # every channel guided
    both = LabelClassifierFreeGuidance(base=_Base(), null_label_id=0, cfg_scale=3.0)
    np.testing.assert_allclose(both(x, torch.zeros(2), y=y)[:, 1, 0, 0].numpy(),
                               1 + 3 * y.float().numpy())

    jcfg = jm.LabelClassifierFreeGuidance(
        base=lambda xx, t, *, y: xx * (1.0 + y.astype(xx.dtype)[:, None, None, None]) + t[0],
        null_label_id=7, cfg_scale=2.5, guide_channels=2)
    xs = _normal(40, 3, 3, 2, 2)
    ys = np.array([1, 4, 2])
    want = jcfg(jnp.asarray(xs), jnp.full((3,), 0.25), y=jnp.asarray(ys))
    tcfg = LabelClassifierFreeGuidance(
        base=lambda xx, t, *, y: xx * (1.0 + y.to(xx.dtype)[:, None, None, None]) + t[0],
        null_label_id=7, cfg_scale=2.5, guide_channels=2)
    _close(tcfg(torch.from_numpy(xs), torch.full((3,), 0.25), y=torch.from_numpy(ys)), want)


def test_cfg_bare_callable_is_wrapped_and_generates_through_flow_sampler():
    def field(x, t, *, y):
        return torch.stack([y.to(x.dtype), torch.zeros_like(y, dtype=x.dtype)], -1) - x

    cfg = LabelClassifierFreeGuidance(base=field, null_label_id=0, cfg_scale=2.0,
                                      guide_channels=2)
    assert isinstance(cfg.base, WrappedField)
    y = torch.tensor([3, 3, 5, 5])
    gen = FlowSampler(model=cfg, integrator="euler").sample(
        torch.Generator().manual_seed(0), dim=2, n_samples=4, n_steps=50,
        model_kwargs={"y": y})
    # the guided field is 2y − x; the unit-time ODE from noise lands near 2y(1 − 1/e)
    c = 1.0 - float(np.exp(-1.0))
    np.testing.assert_allclose(gen[:2, 0].numpy(), 6.0 * c, atol=0.8)
    np.testing.assert_allclose(gen[2:, 0].numpy(), 10.0 * c, atol=0.8)
    wrapped = WrappedField(fn=lambda p, x, t, **kw: -x, params=1.0)
    assert LabelClassifierFreeGuidance(base=wrapped).base is wrapped
    dit = ConditionalTransformer2D(input_size=8, embed_dim=32, depth=1, num_heads=2)
    held = LabelClassifierFreeGuidance(base=dit)
    assert held.base is dit and len(list(held.parameters())) == len(list(dit.parameters()))


def test_interaction_model_matches_jax_and_brute_force():
    from torchebm_tpu.core import GaussianEnergy as JGaussian

    x = _normal(50, 8, 2)
    base = GaussianEnergy.standard(2)
    inter = InteractionModel(model=base, sigma_w=2.0, strength=1.0)
    jinter = jm.InteractionModel(model=JGaussian.standard(2), sigma_w=2.0, strength=1.0)
    got = inter(torch.from_numpy(x))
    _close(got, jax.jit(jinter.energy)(jnp.asarray(x)))
    pair = np.sum((x[:, None] - x[None]) ** 2, axis=-1).sum(axis=1)
    np.testing.assert_allclose(got.numpy(), base(torch.from_numpy(x)).numpy() - 0.5 / 4.0 * pair,
                               rtol=1e-4)
    _close(inter.gradient(torch.from_numpy(x)), jax.jit(jinter.gradient)(jnp.asarray(x)))
    assert InteractionModel.wants_step
    with pytest.raises(ValueError):
        InteractionModel(model=base, sigma_w=-1.0)


def test_interaction_model_repulses_and_schedules():
    base = GaussianEnergy.standard(2)
    g = torch.Generator().manual_seed(0)
    x0 = 0.1 * torch.randn(64, 2, generator=g)
    inter = InteractionModel(model=base, sigma_w=4.0, strength=0.15)
    plain = LangevinDynamics(base, step_size=0.01, fused="off").sample(
        torch.Generator().manual_seed(1), x=x0, n_steps=200)
    repulsive = LangevinDynamics(inter, step_size=0.01).sample(
        torch.Generator().manual_seed(1), x=x0, n_steps=200)
    assert float(repulsive.var()) > 1.5 * float(plain.var())

    sched = TemperatureScheduler(0.15, 0.8, n_steps=100, sqrt=False)
    inter = InteractionModel(model=base, sigma_w=4.0, strength=sched)
    out = LangevinDynamics(inter, step_size=0.01).sample(g, x=0.1 * torch.randn(16, 2,
                                                                               generator=g),
                                                         n_steps=100)
    assert bool(torch.isfinite(out).all())
    x = torch.randn(4, 2, generator=g)
    # the strength at step 0 is zero: the energy is the base energy
    _close(inter.energy(x, step=0), base(x).numpy())


def test_log_prob_of_a_dit_field_is_per_row():
    """The exact divergence probes all rows with one unit vector; the DiT's
    rows do not interact, so the batch's log-likelihoods equal those of each
    row alone (forward mode runs through the attention's einsum form)."""
    torch.manual_seed(0)
    dit = ConditionalTransformer2D(in_channels=1, out_channels=1, input_size=4, patch_size=2,
                                   embed_dim=16, depth=1, num_heads=2)
    with torch.no_grad():
        for p in dit.parameters():
            p.add_(0.1 * torch.randn_like(p))
    flow = FlowSampler(model=dit)
    x = torch.randn(3, 1, 4, 4, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        batch = flow.log_prob(x, n_steps=1, hutchinson=False)
        rows = torch.cat([flow.log_prob(x[i:i + 1], n_steps=1, hutchinson=False)
                          for i in range(3)])
    assert bool(torch.isfinite(batch).all())
    np.testing.assert_allclose(batch.numpy(), rows.numpy(), rtol=1e-5, atol=1e-5)


def test_dit_explicit_energy_eqm_trains_through_attention():
    """EqM's explicit energies differentiate the field twice
    (``create_graph``); the attention's backward is then differentiable."""
    from torchebm_tpu_torch.losses import EquilibriumMatchingLoss
    from torchebm_tpu_torch.models import EqMEnergy

    torch.manual_seed(0)
    dit = ConditionalTransformer2D(in_channels=1, out_channels=1, input_size=4, patch_size=2,
                                   embed_dim=16, depth=1, num_heads=2)
    x = torch.randn(3, 1, 4, 4)
    for energy_type in ("dot", "l2"):
        dit.zero_grad()
        loss = EquilibriumMatchingLoss(model=dit, energy_type=energy_type)(
            None, x, torch.Generator().manual_seed(0))
        loss.backward()
        assert torch.isfinite(loss) and dit.head.proj.weight.grad is not None
    assert EqMEnergy(dit, "dot").gradient(x).shape == x.shape

