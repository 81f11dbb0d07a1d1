"""The port's networks against the JAX package's flax modules on converted weights.

``MLPEnergy`` and ``ConvEnergy2D`` are built by ``utils.convert`` from the flax
parameter trees, then their energies and ``∇ₓE`` are compared with flax's on
the same numpy inputs (float32, rtol 1e-5 / atol 1e-5: one matmul or conv
stack summed in another order). The conv case pins XLA's ``SAME`` padding
(28 → 14 → 7 → 4, the odd pixel after) and the NHWC flatten order before the
dense layer. Also here: the port imports neither JAX nor the JAX package.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchebm_tpu.models import ConvEnergy2D as JaxConv
from torchebm_tpu.models import MLPEnergy as JaxMLP
from torchebm_tpu_torch.models import ConvEnergy2D, MLPEnergy
from torchebm_tpu_torch.utils import conv_energy_from_flax, mlp_energy_from_flax

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]


def _jax_energy_and_grad(module, params, x):
    e = module.apply(params, jnp.asarray(x))
    g = jax.grad(lambda xx: jnp.sum(module.apply(params, xx)))(jnp.asarray(x))
    return np.asarray(e), np.asarray(g)


def _torch_energy_and_grad(net, x):
    xt = torch.tensor(x, requires_grad=True)
    e = net(xt)
    (g,) = torch.autograd.grad(e.sum(), xt)
    return e.detach().numpy(), g.numpy()


@pytest.mark.parametrize("hidden, d", [((128, 128), 2), ((32, 16, 8), 5), ((7,), 3)])
def test_mlp_energy_matches_flax(hidden, d):
    net = JaxMLP(hidden_dims=hidden)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, d)))
    x = np.random.default_rng(0).standard_normal((33, d)).astype(np.float32)
    port = mlp_energy_from_flax(params)
    assert port.hidden_dims == hidden and port.input_dim == d
    for want, got in zip(_jax_energy_and_grad(net, params, x), _torch_energy_and_grad(port, x)):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("size, channels", [((28, 28), (8, 16, 16)), ((9, 12), (4, 6))])
@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_conv_energy_matches_flax(size, channels, data_format):
    net = JaxConv(channels=channels, dense_dim=32, data_format=data_format)
    h, w = size
    shape = (5, 1, h, w) if data_format == "NCHW" else (5, h, w, 1)
    params = net.init(jax.random.PRNGKey(1), jnp.zeros(shape))
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    port = conv_energy_from_flax(params, image_size=size, data_format=data_format)
    for want, got in zip(_jax_energy_and_grad(net, params, x), _torch_energy_and_grad(port, x)):
        np.testing.assert_allclose(got, want, **TOL)


def test_same_padding_and_flatten_order_are_pinned():
    """Symmetric padding would move every output, as would an NCHW flatten
    (then the converted dense rows sit in the wrong order)."""
    net = JaxConv(channels=(4, 4, 4), dense_dim=8)
    params = net.init(jax.random.PRNGKey(2), jnp.zeros((1, 1, 28, 28)))
    x = np.random.default_rng(2).standard_normal((3, 1, 28, 28)).astype(np.float32)
    want = np.asarray(net.apply(params, jnp.asarray(x)))
    port = conv_energy_from_flax(params)
    # 28 -> 14 and 14 -> 7 pad the odd pixel after, 7 -> 4 one on each side
    assert port.pads == [(0, 1, 0, 1), (0, 1, 0, 1), (1, 1, 1, 1)]
    np.testing.assert_allclose(port(torch.tensor(x)).detach().numpy(), want, **TOL)
    port.pads = [(1, 1, 1, 1)] * 3  # nn.Conv2d(padding=1)
    assert not np.allclose(port(torch.tensor(x)).detach().numpy(), want, atol=1e-3)
    port = conv_energy_from_flax(params)
    h = torch.tensor(x)
    for pad, conv in zip(port.pads, port.convs):
        h = torch.nn.functional.silu(conv(torch.nn.functional.pad(h, pad)))
    nchw = port.head(torch.nn.functional.silu(port.dense(h.reshape(3, -1)))).squeeze(-1)
    assert not np.allclose(nchw.detach().numpy(), want, atol=1e-3)


def test_init_follows_flax_defaults():
    torch.manual_seed(0)
    net = MLPEnergy(64, (256,))
    w = net.layers[0].weight.detach()
    assert torch.all(net.layers[0].bias == 0)
    # LeCun normal truncated at two standard deviations: variance 1/fan-in
    assert abs(float(w.std()) - 64 ** -0.5) < 0.01
    assert float(w.abs().max()) <= 2 * 64 ** -0.5 / 0.8796 + 1e-6
    conv = ConvEnergy2D()
    assert conv(torch.zeros(2, 1, 28, 28)).shape == (2,)
    assert conv.dense.in_features == 4 * 4 * 64


def test_bf16_compute_keeps_float32_parameters():
    net = MLPEnergy(2, (16,), dtype=torch.bfloat16)
    out = net(torch.randn(4, 2))
    assert out.dtype == torch.float32 and net.layers[0].weight.dtype == torch.float32
    with pytest.raises(ValueError, match="data_format"):
        ConvEnergy2D(data_format="CHWN")


@pytest.mark.parametrize("hidden, d, embed", [((128, 128, 128), 2, 32), ((16,), 5, 9)])
def test_mlp_velocity_field_matches_flax(hidden, d, embed):
    from torchebm_tpu.models import MLPVelocityField as JField
    from torchebm_tpu_torch.models import MLPVelocityField
    from torchebm_tpu_torch.utils import mlp_velocity_field_from_flax

    net = JField(hidden_dims=hidden, time_embed_dim=embed)
    params = net.init(jax.random.PRNGKey(4), jnp.zeros((1, d)), jnp.zeros((1,)))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((21, d)).astype(np.float32)
    t = rng.uniform(0, 1, 21).astype(np.float32)
    field = mlp_velocity_field_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                         time_embed_dim=embed)
    assert isinstance(field, MLPVelocityField) and field.hidden_dims == tuple(hidden)
    got = field(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == (21, d)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(net.apply(params, jnp.asarray(x), jnp.asarray(t))),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="MLPVelocityField tree"):
        mlp_velocity_field_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                     time_embed_dim=embed + 1)


@pytest.mark.parametrize("dim", [32, 9, 256])
def test_timestep_embedder_matches_flax(dim):
    from torchebm_tpu.models import MLPTimestepEmbedder as JEmbedder
    from torchebm_tpu_torch.models import MLPTimestepEmbedder

    t = np.random.default_rng(5).uniform(0, 1000, 13).astype(np.float32)
    want = JEmbedder.sinusoidal_embedding(jnp.asarray(t), dim)
    got = MLPTimestepEmbedder.sinusoidal_embedding(torch.from_numpy(t), dim)
    # cosines first, then sines, max_period 10,000; float32 sin and cos of
    # arguments up to 1,000 differ by their range reduction
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=2e-4)
    assert float(got[0, 0]) == pytest.approx(np.cos(t[0]), abs=2e-4)
    if dim % 2:
        assert float(got[:, -1].abs().max()) == 0.0
    emb = JEmbedder(out_dim=24, frequency_embedding_size=dim)
    params = emb.init(jax.random.PRNGKey(6), jnp.asarray(t))
    mine = MLPTimestepEmbedder(24, frequency_embedding_size=dim)
    from torchebm_tpu_torch.utils.convert import _flax_layers, _load_linear

    for layer, (kernel, bias) in zip(mine.layers,
                                     _flax_layers(jax.tree_util.tree_map(np.asarray, params),
                                                  "Dense")):
        _load_linear(layer, kernel, bias)
    np.testing.assert_allclose(mine(torch.from_numpy(t)).detach().numpy(),
                               np.asarray(emb.apply(params, jnp.asarray(t))),
                               rtol=1e-4, atol=2e-4)


def _imported_modules(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_the_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "torchebm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 55
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax", "torchebm_tpu"), (
                f"{path.relative_to(ROOT)} imports {name}")
