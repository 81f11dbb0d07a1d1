"""Parity of the port's neural (SiLU-MLP) Langevin chain with the JAX package.

On the CPU the wrapper runs its plain PyTorch version; it is held against the
JAX Pallas kernel's injected-noise path in interpret mode, on the same numpy
inputs and the same flax ``MLPEnergy`` weights, at the shapes of
tests/ops/test_mlp_chain_parity.py, to atol 2e-5 (float32: the same
tolerance as that file, where the kernel is held to a plain ``jax.grad``
chain). The Philox path is held to its twin, the dispatch of
``LangevinDynamics(fused_neural=...)`` to the generic loop. The CUDA kernel
is held against the plain version in tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchebm_tpu.models import MLPEnergy as JaxMLPEnergy
from torchebm_tpu.ops import fused_mlp_langevin as jmlp
from torchebm_tpu_torch import core as tcore
from torchebm_tpu_torch import ops as tops
from torchebm_tpu_torch import samplers as ts
from torchebm_tpu_torch.models import ConvEnergy2D, MLPEnergy
from torchebm_tpu_torch.ops import fused_langevin as tfl
from torchebm_tpu_torch.ops import fused_mlp_langevin as tmlp
from torchebm_tpu_torch.utils import mlp_energy_from_flax

torch.set_num_threads(1)

ATOL = 2e-5


def _flax_case(hidden, d, n, n_steps, seed=0):
    """Flax params, the JAX layers, and numpy ``x0`` and ``noise``."""
    params = JaxMLPEnergy(hidden_dims=hidden).init(jax.random.PRNGKey(seed), jnp.zeros((1, d)))
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((n, d)).astype(np.float32)
    noise = rng.standard_normal((n_steps, n, d)).astype(np.float32)
    return params, jmlp.extract_mlp_layers(params), x0, noise


def _torch_layers(layers):
    return [(torch.tensor(np.asarray(w)), torch.tensor(np.asarray(b))) for w, b in layers]


@pytest.mark.parametrize("hidden,d,n", [((32,), 2, 21), ((64, 64), 2, 37), ((32, 16), 5, 12)])
def test_plain_matches_jax_interpret(hidden, d, n):
    n_steps, h, ns = 9, 0.01, 0.8
    _, layers, x0, noise = _flax_case(hidden, d, n, n_steps)
    want = jmlp.mlp_langevin_chain(jnp.asarray(x0), layers, n_steps, h, ns,
                                   noise=jnp.asarray(noise), interpret=True)
    got = tops.mlp_langevin_chain(torch.tensor(x0), _torch_layers(layers), n_steps, h, ns,
                                  noise=torch.tensor(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_clamp_matches_jax_interpret():
    n_steps, h, ns, clamp = 7, 0.05, 1.0, (-0.5, 0.5)
    _, layers, x0, noise = _flax_case((32,), 2, 16, n_steps, seed=1)
    want = jmlp.mlp_langevin_chain(jnp.asarray(x0), layers, n_steps, h, ns, clamp=clamp,
                                   noise=jnp.asarray(noise), interpret=True)
    got = tops.mlp_langevin_chain(torch.tensor(x0), _torch_layers(layers), n_steps, h, ns,
                                  clamp=clamp, noise=torch.tensor(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert float(got.abs().max()) <= 0.5


def test_gradient_is_autograd_of_the_energy():
    """The hand-written backward pass equals autograd of the converted module."""
    params, layers, x0, _ = _flax_case((64, 32), 3, 50, 1)
    net = mlp_energy_from_flax(params)
    x = torch.tensor(x0, requires_grad=True)
    (want,) = torch.autograd.grad(net(x).sum(), x)
    got = tmlp._mlp_grad(torch.tensor(x0), tmlp.extract_mlp_layers(net))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_philox_path_is_the_twin_stream():
    """Without ``noise`` the chain draws the Philox normals of chain c at
    step t, the stream ``philox_normals`` reproduces: injecting those normals
    gives the same chain bit for bit."""
    _, layers, x0, _ = _flax_case((16,), 3, 10, 4, seed=2)
    tl, x = _torch_layers(layers), torch.tensor(x0)
    seed = 2**40 + 5
    noise = torch.stack([tfl.philox_normals(torch.arange(10), t, 3, seed) for t in range(4)])
    drawn = tops.mlp_langevin_chain(x, tl, 4, 0.02, 0.7, seed=seed)
    injected = tops.mlp_langevin_chain(x, tl, 4, 0.02, 0.7, noise=noise)
    assert torch.equal(drawn, injected)
    assert not torch.equal(drawn, tops.mlp_langevin_chain(x, tl, 4, 0.02, 0.7, seed=seed + 1))


def test_chain_offset_reproduces_the_whole_launch():
    """Chains ``[a, b)`` at ``chain_offset=a`` equal rows ``[a, b)`` of the
    launch over every chain, in the wrapper (its plain path here) and the
    plain version; offset 0 is the call without it; injected noise ignores
    it; a negative offset raises. Tolerance 1e-6: the CPU's products round
    by batch size (a wrong stream would differ by O(1))."""
    _, layers, x0, noise = _flax_case((16, 8), 3, 29, 6, seed=4)
    tl, x = _torch_layers(layers), torch.tensor(x0)
    seed = 2**33 + 11
    whole = tops.mlp_langevin_chain(x, tl, 6, 0.02, 0.8, seed=seed)
    for a, b in ((0, 8), (8, 17), (17, 29)):
        for fn in (tops.mlp_langevin_chain, tmlp.mlp_langevin_chain_plain):
            torch.testing.assert_close(fn(x[a:b], tl, 6, 0.02, 0.8, seed=seed, chain_offset=a),
                                       whole[a:b], rtol=0, atol=1e-6)
    assert torch.equal(tops.mlp_langevin_chain(x, tl, 6, 0.02, 0.8, seed=seed, chain_offset=0),
                       whole)
    inj = torch.tensor(noise)[:, 8:].contiguous()
    assert torch.equal(tops.mlp_langevin_chain(x[8:], tl, 6, 0.02, 0.8, noise=inj, chain_offset=8),
                       tops.mlp_langevin_chain(x[8:], tl, 6, 0.02, 0.8, noise=inj))
    with pytest.raises(ValueError, match="chain_offset"):
        tops.mlp_langevin_chain(x, tl, 6, 0.02, 0.8, chain_offset=-3)


def test_extract_reads_the_module_and_rejects_other_structures():
    net = MLPEnergy(3, (8, 4))
    layers = tmlp.extract_mlp_layers(net)
    assert [tuple(w.shape) for w, _ in layers] == [(3, 8), (8, 4), (4, 1)]
    assert all(not w.requires_grad for w, _ in layers)
    assert tmlp.extract_mlp_layers(ConvEnergy2D(1, (8, 8), channels=(4,), dense_dim=8)) is None
    assert tmlp.extract_mlp_layers(torch.nn.Sequential(torch.nn.Linear(2, 1))) is None

    class NoBias(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layers = torch.nn.ModuleList([torch.nn.Linear(2, 4, bias=False),
                                               torch.nn.Linear(4, 1)])

    assert tmlp.extract_mlp_layers(NoBias()) is None

    class TwoOutputs(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layers = torch.nn.ModuleList([torch.nn.Linear(2, 4), torch.nn.Linear(4, 2)])

    assert tmlp.extract_mlp_layers(TwoOutputs()) is None
    # the JAX helper rejects the same structures in its own tree form
    assert jmlp.extract_mlp_layers({"params": {"Dense_0": {"kernel": jnp.zeros((2, 4)),
                                                           "bias": jnp.zeros(4)}}}) is None


@pytest.mark.parametrize("widths, ok", [
    ((2, 128, 128), True), ((32, 64, 64, 64), True), ((2, 512, 512), True),
    ((2, 1024), False), ((513, 8), False), ((2,), False), ((2,) + (8,) * 9, False),
    ((2,) + (512,) * 8, True), ((512,) + (512,) * 8, False),
])
def test_width_and_depth_probes(widths, ok):
    """Widths up to the JAX cap of 512 and up to eight hidden layers, when a
    tile of 8 chains fits in shared memory (eight 512-wide layers do at d = 2,
    not at d = 512); (512, 512) streams its weights."""
    assert tmlp.supports(widths) is ok
    if ok:
        assert tmlp.launch_plan(4096, widths) is not None


#: (chains, widths, the plan on an H100): the CD path's 256 x 2, the smallest
#: tile whose grid the card holds at once (one block of MLP(128, 128) per SM
#: at any tile), the largest where none does, and (512, 512) streaming its
#: weights
PLAN_CASES = [
    (256, (2, 128, 128), (8, 8, True)),
    (1000, (2, 128, 128), (8, 8, True)),
    (2048, (2, 128, 128), (16, 8, True)),
    (4096, (2, 128, 128), (32, 8, True)),
    (8192, (2, 128, 128), (32, 8, True)),
    (100_000, (2, 128, 128), (32, 8, True)),
    (1000, (32, 64, 64, 64), (8, 8, True)),
    (512, (2, 512, 512), (8, 8, False)),
    (8190, (2, 512, 512), (16, 8, False)),
    # eight 512-wide layers: only 4 warps' chunks leave room at tile 8
    (4096, (2,) + (512,) * 8, (8, 4, False)),
]


def test_launch_plan_keeps_weights_resident_and_fills_the_card():
    """Planned for an H100 (a CPU state): 132 SMs, 227 KB per block.
    MLP(128, 128) keeps its weights in shared memory at every tile; at 4,096
    chains tiles of 32 fill 128 of the 132 SMs in one wave, where tiles of 16
    would take two."""
    assert tmlp._card_limits(torch.device("cpu")) == tmlp._H100_LIMITS == (232_448, 132)
    for n in (256, 4096, 100_000):
        assert tmlp.launch_plan(n, (2, 128, 128)).resident
    assert tmlp.launch_plan(4096, (2, 128, 128)).tile == 32
    assert -(-4096 // 32) <= 132 < -(-4096 // 16)


@pytest.mark.parametrize("n, widths, plan", PLAN_CASES)
def test_launch_plan_picks_tile_warps_and_route(n, widths, plan):
    got = tmlp.launch_plan(n, widths)
    assert got == plan and (got.tile, got.warps, got.resident) == plan
    assert 4 * tmlp._smem_layout(widths, *got).end <= 232_448


@pytest.mark.parametrize("widths, setting, ok", [
    ((2, 128, 128), (32, 8, True), True), ((2, 128, 128), (8, 8, True), True),
    # (512, 512) streamed at tile 32: its activations alone pass 227 KB
    ((2, 512, 512), (32, 8, False), False), ((2, 512, 512), (16, 8, False), True),
    # (256, 256) resident: 512 KB of weights
    ((2, 256, 256), (8, 8, True), False),
    # eight 512-wide layers at tile 8: 8 warps' chunks do not fit, 4 warps' do
    ((2,) + (512,) * 8, (8, 8, False), False), ((2,) + (512,) * 8, (8, 4, False), True),
])
def test_fits_reads_the_shared_memory_plan(widths, setting, ok):
    assert tmlp.fits(widths, setting) is ok
    assert (4 * tmlp._smem_layout(widths, *setting).end <= 232_448) is ok


def test_settings_are_what_the_plan_picks_from():
    """8 warps at every tile and route; 4 warps only streamed."""
    assert len(set(tmlp.SETTINGS)) == len(tmlp.SETTINGS) == 9
    assert {(w, r) for _, w, r in tmlp.SETTINGS} == {(8, True), (8, False), (4, False)}
    for n, widths, plan in PLAN_CASES:
        assert tuple(tmlp.launch_plan(n, widths)) in tmlp.SETTINGS


@pytest.mark.parametrize("widths, tile, warps, resident", [
    ((2, 128, 128), 8, 8, True), ((2, 128, 128), 32, 4, True), ((32, 64, 64, 64), 16, 8, True),
    ((2, 512, 512), 16, 8, False), ((10, 40, 24), 8, 4, True), ((3, 5, 7, 3), 32, 8, False),
    ((9, 300), 8, 8, False), ((2, 128, 128), 16, 4, False), ((32, 64, 64, 64), 32, 8, True),
])
def test_smem_layout_places_each_region_after_the_last(widths, tile, warps, resident):
    """The plan handed to the kernel: each staged weight (FMA layers as (H_p,
    in); resident tensor-core layers as (H_p, in rounded up to 32) TF32 (hi,
    lo) pairs; streamed ones not at all), the biases and w_out padded to 16
    units, the state and gradient, the state as pairs for a tensor-core
    first layer, every hidden layer's silu' but the last's, the operand
    buffers of pairs, the normals drawn ahead and the streamed chunks, each
    region 16-byte aligned."""
    lay = tmlp._smem_layout(widths, tile, warps, resident)
    d, hidden = widths[0], widths[1:]
    hp = [-(-h // 16) * 16 for h in hidden]
    off = 0
    for din, p, w in zip(widths[:-1], hp, lay.w):
        if din >= tmlp._MMA_MIN_K and not resident:
            assert w == -1
            continue
        assert w == off
        off += -(-(p * (din if din < tmlp._MMA_MIN_K else 2 * -(-din // 32) * 32)) // 4) * 4
    assert lay.b == tuple(off + sum(hp[:i]) for i in range(len(hp)))
    assert lay.out == off + sum(hp)
    assert lay.x == lay.out + hp[-1]
    assert lay.xp == -(-d // 16) * 16 + 4 and lay.ap == max(hp) + 4
    assert lay.g - lay.x == tile * lay.xp
    split_x = 2 * tile * lay.xp if d >= tmlp._MMA_MIN_K else 0
    assert lay.xo == (lay.g + tile * lay.xp if split_x else -1)
    assert lay.act - lay.g == tile * lay.xp + split_x
    assert lay.op - lay.act == tile * lay.ap * (len(hidden) - 1)
    assert lay.z - lay.op == 2 * tile * lay.ap * min(len(hidden), 2)
    quads = -(-d // 4)
    assert lay.z_steps == max(1, 32 * warps // (tile * quads))
    assert lay.stage - lay.z == 4 * lay.z_steps * tile * quads
    assert lay.end - lay.stage == (0 if resident else 2 * warps * 16 * 32)
    regions = [w for w in lay.w if w >= 0] + list(lay.b) + [lay.out, lay.x, lay.g, lay.act,
                                                             lay.op, lay.z, lay.stage, lay.end]
    assert regions == sorted(regions) and all(r % 4 == 0 for r in regions)
    # the pitches keep the B-fragment loads conflict-free: 4 times an odd number
    assert (lay.xp // 4) % 2 == 1 and (lay.ap // 4) % 2 == 1
    assert lay.as_ints() == (lay.out, lay.x, lay.g, lay.xo, lay.act, lay.op, lay.z, lay.stage,
                             lay.end, lay.xp, lay.ap, lay.z_steps, *lay.w, *lay.b)


def test_extract_gives_views_of_the_module_weights():
    """The main path copies no weight: ``extract_mlp_layers`` hands out
    views, and the wrapper's ``w.T.contiguous()`` is ``nn.Linear.weight``
    itself."""
    net = MLPEnergy(2, (128, 128))
    layers = tmlp.extract_mlp_layers(net)
    for (w, b), lin in zip(layers, net.layers):
        assert w.data_ptr() == lin.weight.data_ptr() and b.data_ptr() == lin.bias.data_ptr()
        assert w.T.contiguous().data_ptr() == lin.weight.data_ptr()


@pytest.mark.parametrize("hidden, d", [((16,), 2), ((32, 16), 3), ((8, 8, 8), 10)])
def test_plain_takes_both_weight_layouts(hidden, d):
    """The JAX layout's ``(in, out)`` arrays and ``extract_mlp_layers``' views
    of the converted module give the same chain."""
    params, layers, x0, noise = _flax_case(hidden, d, 12, 5, seed=3)
    views = tmlp.extract_mlp_layers(mlp_energy_from_flax(params))
    arrays = _torch_layers(layers)
    assert not arrays[0][0].T.is_contiguous() and views[0][0].T.is_contiguous()
    kw = dict(noise=torch.tensor(noise))
    got = tops.mlp_langevin_chain(torch.tensor(x0), views, 5, 0.02, 0.9, **kw)
    want = tops.mlp_langevin_chain(torch.tensor(x0), arrays, 5, 0.02, 0.9, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    seeded = [tops.mlp_langevin_chain(torch.tensor(x0), ls, 5, 0.02, 0.9, seed=11)
              for ls in (views, arrays)]
    torch.testing.assert_close(seeded[0], seeded[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 12345, 2**40 + 5])
def test_seed_as_int_or_tensor_gives_one_stream(seed):
    """A 0-d int64 tensor seed (the sampler's draw, read by the kernel on the
    device) keys the same Philox stream as the int."""
    _, layers, x0, _ = _flax_case((16,), 2, 9, 3, seed=4)
    tl, x = _torch_layers(layers), torch.tensor(x0)
    as_int = tops.mlp_langevin_chain(x, tl, 3, 0.02, 1.0, seed=seed)
    as_tensor = tops.mlp_langevin_chain(x, tl, 3, 0.02, 1.0, seed=torch.tensor(seed))
    assert torch.equal(as_int, as_tensor)
    plain = tmlp.mlp_langevin_chain_plain(x, tl, 3, 0.02, 1.0, seed=torch.tensor(seed))
    assert torch.equal(as_int, plain)


def test_seed_tensor_checks():
    x = torch.zeros(4, 2)
    layers = [(torch.zeros(2, 8), torch.zeros(8)), (torch.zeros(8, 1), torch.zeros(1))]
    for bad in (torch.tensor(3, dtype=torch.int32), torch.tensor([3]), torch.tensor(-1)):
        with pytest.raises(ValueError, match="seed"):
            tops.mlp_langevin_chain(x, layers, 3, 0.01, seed=bad)


def test_sampler_draws_the_kernel_seed_as_a_tensor(monkeypatch):
    """The neural branch hands the kernel the generator's draw as a tensor,
    the same draw ``_kernel_seed`` reads on the host."""
    from torchebm_tpu_torch.samplers import base as sbase

    energy = _energy()
    seeds = []
    real = tmlp.mlp_langevin_chain

    def spy(*args, **kwargs):
        seeds.append(kwargs["seed"])
        return real(*args, **kwargs)

    monkeypatch.setattr(tmlp, "mlp_langevin_chain", spy)
    x0 = torch.randn(16, 2, generator=torch.Generator().manual_seed(1))
    ts.LangevinDynamics(energy, step_size=0.01, fused_neural="force").sample(
        torch.Generator().manual_seed(5), x=x0, n_steps=3)
    (seed,) = seeds
    assert isinstance(seed, torch.Tensor) and seed.dtype == torch.int64 and seed.ndim == 0
    assert int(seed) == sbase._kernel_seed(torch.Generator().manual_seed(5))


def test_wrapper_argument_checks():
    x = torch.zeros(4, 2)
    layers = [(torch.zeros(2, 8), torch.zeros(8)), (torch.zeros(8, 1), torch.zeros(1))]
    with pytest.raises(ValueError, match="width"):
        tops.mlp_langevin_chain(x, [(torch.zeros(2, 1024), torch.zeros(1024)),
                                    (torch.zeros(1024, 1), torch.zeros(1))], 3, 0.01)
    with pytest.raises(ValueError, match="shape mismatch"):
        tops.mlp_langevin_chain(torch.zeros(4, 3), layers, 3, 0.01)
    with pytest.raises(ValueError, match="hidden layer"):
        tops.mlp_langevin_chain(x, layers[1:], 3, 0.01)
    with pytest.raises(ValueError, match="float32"):
        tops.mlp_langevin_chain(x, [(w.double(), b) for w, b in layers], 3, 0.01)
    with pytest.raises(TypeError, match="float32"):
        tops.mlp_langevin_chain(x.double(), layers, 3, 0.01)
    with pytest.raises(ValueError, match="noise"):
        tops.mlp_langevin_chain(x, layers, 3, 0.01, noise=torch.zeros(2, 4, 2))
    before = tops.mlp_langevin_chain.launches
    tops.mlp_langevin_chain(x, layers, 3, 0.01)
    assert tops.mlp_langevin_chain.launches == before  # the plain path counts nothing


# --------------------------------------------------------------------------
# dispatch through LangevinDynamics(fused_neural=...)
# --------------------------------------------------------------------------


def _energy(hidden=(16, 16), d=2):
    torch.manual_seed(0)
    return tcore.as_energy(MLPEnergy(d, hidden))


def test_as_energy_tags_only_the_library_mlp():
    assert _energy().arch == "silu_mlp"

    class MLPEnergyLookalike(MLPEnergy):
        pass

    assert tcore.as_energy(MLPEnergyLookalike(2, (8,))).arch is None
    assert tcore.as_energy(lambda x: x.sum(-1)).arch is None


def test_force_reaches_the_plain_kernel_and_off_the_loop(monkeypatch):
    energy = _energy()
    calls = []
    real = tmlp.mlp_langevin_chain

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tmlp, "mlp_langevin_chain", spy)
    x0 = torch.randn(64, 2, generator=torch.Generator().manual_seed(1))
    forced = ts.LangevinDynamics(energy, step_size=0.01, fused_neural="force")
    out = forced.sample(torch.Generator().manual_seed(2), x=x0, n_steps=5)
    assert calls == [(64, 2)] and out.shape == (64, 2)
    for mode in ("off", "auto"):  # "auto" needs a CUDA state
        ts.LangevinDynamics(energy, step_size=0.01, fused_neural=mode).sample(
            torch.Generator().manual_seed(2), x=x0, n_steps=5)
    assert len(calls) == 1
    # a call the gate refuses takes the loop
    forced.sample(torch.Generator().manual_seed(2), x=x0, n_steps=5, return_trajectory=True)
    forced.replace(clamp=(-1.0, 1.0)).sample(torch.Generator().manual_seed(2), x=x0, n_steps=5)
    assert len(calls) == 2


def test_kernel_path_matches_the_loop_at_zero_noise():
    """At noise 0 both paths run the same deterministic chain."""
    energy = _energy((32, 16), d=3)
    x0 = torch.randn(40, 3, generator=torch.Generator().manual_seed(3))
    kw = dict(step_size=0.05, noise_scale=0.0)
    kernel = ts.LangevinDynamics(energy, fused_neural="force", **kw).sample(
        torch.Generator().manual_seed(4), x=x0, n_steps=20)
    loop = ts.LangevinDynamics(energy, **kw).sample(
        torch.Generator().manual_seed(4), x=x0, n_steps=20)
    torch.testing.assert_close(kernel, loop, rtol=0, atol=1e-5)


@pytest.mark.parametrize("hidden, d, n_launch", [((16,), 2, 1), ((1024,), 2, 0),
                                                  ((8,) * 9, 2, 0), ((16,), 3, 0)])
def test_unsupported_shapes_fall_through_to_the_loop(monkeypatch, hidden, d, n_launch):
    """Widths above the cap, more than eight hidden layers, or a state whose
    width is not the net's input take the loop, decided before any launch."""
    energy = _energy(hidden, d=2)
    calls = []
    monkeypatch.setattr(tmlp, "mlp_langevin_chain", lambda *a, **k: calls.append(1) or a[0])
    sampler = ts.LangevinDynamics(energy, step_size=0.01, fused_neural="force")
    x0 = torch.randn(8, d)
    if d == 2:
        sampler.sample(torch.Generator().manual_seed(0), x=x0, n_steps=2)
    else:
        with pytest.raises(RuntimeError):  # the loop evaluates the net on a wrong width
            sampler.sample(torch.Generator().manual_seed(0), x=x0, n_steps=2)
    assert len(calls) == n_launch


def test_fused_neural_is_validated():
    with pytest.raises(ValueError, match="fused_neural"):
        ts.LangevinDynamics(_energy(), fused_neural="always")
    assert ts.LangevinDynamics(_energy()).fused_neural == "off"
