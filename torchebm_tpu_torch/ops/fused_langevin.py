r"""Whole-chain Langevin kernels: wrappers, plain PyTorch versions, launch counts.

PyTorch counterpart of :mod:`torchebm_tpu.ops.fused_langevin`. Each wrapper
runs an entire n-step chain

.. math::
    x_{t+1} = \mathrm{clip}\big(x_t - \eta_t \nabla E(x_t)
    + \text{noise\_scale}_t \sqrt{2\eta_t}\,\varepsilon_t\big)

in one launch of a hand-written CUDA kernel (``csrc/fused_langevin.cu``, built
by :mod:`._build`) when ``x0`` lies on a CUDA device, and in its plain PyTorch
version when ``x0`` lies on the CPU; any other device raises. The plain
versions are the CPU path and the oracle the kernels are checked against on
the card.

- :func:`mixture_langevin_chain` / :func:`mixture_langevin_chain_trajectory`:
  d-dim isotropic Gaussian mixture (``means``, ``scale``, ``log_weights``),
  or a full-covariance Gaussian with ``precision=`` (one ``(1, d)`` mean row,
  d ≤ 32).
- :func:`doublewell_langevin_chain` / :func:`doublewell_langevin_chain_trajectory`:
  elementwise :math:`\nabla E = 4h\,x(x^2-b^2)` over a state of any shape.
- :func:`fused_langevin_step`: one model-agnostic step from a given gradient,
  over a state of any shape (``csrc/fused_step.cu``).

``step_size`` and ``noise_scale`` are each a float or a ``(n_steps,)``
per-step schedule. ``noise`` (``(n_steps, *x0.shape)``) injects the normals;
without it they come from the Philox4x32-10 stream keyed by ``seed``, which
:func:`philox4x32_10` reproduces bit for bit in plain PyTorch
(:func:`philox_normals`; :func:`philox_uniforms` draws the Metropolis
uniforms of the MALA and HMC kernels from the same stream, and
:func:`doublewell_normals` the double-well chains' normals, one block per
four steps of an element). Every chain wrapper takes ``chain_offset``, the
index in the whole batch of its first chain (of its first element for the
double well), so that a launch over one shard of a batch sharded on its
rows draws that shard's rows of the whole batch's streams. The
``*_trajectory`` variants also return every ``thin``-th state as an
``(n_steps // thin, *x0.shape)`` tensor; the trailing ``n_steps % thin``
steps still run and land in ``final``.

Every wrapper carries an integer ``launches`` attribute, raised by one each
time it launches its kernel (never on the plain path); ``ops.launch_counts``
reads them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from ..utils.profiling import count
from . import _build
from ._build import ptr as _ptr

Tensor = torch.Tensor
Schedule = Union[float, Tensor]

__all__ = [
    "doublewell_langevin_chain",
    "doublewell_langevin_chain_trajectory",
    "mixture_langevin_chain",
    "mixture_langevin_chain_trajectory",
    "mixture_launch_plan",
    "fused_langevin_step",
    "fused_langevin_step_plain",
    "doublewell_langevin_chain_plain",
    "doublewell_langevin_chain_trajectory_plain",
    "doublewell_normals",
    "mixture_langevin_chain_plain",
    "mixture_langevin_chain_trajectory_plain",
    "philox4x32_10",
    "philox_normals",
    "philox_uniforms",
]

#: the JAX package's caps (unrolled K x d components, d^2 precision terms);
#: the sampler falls back to the loop beyond them.
MAX_DIM = 64
MAX_COMPONENTS_X_DIM = 1024
MAX_PRECISION_DIM = 32

#: the mixture chain kernel's block size (``kMixThreads`` in csrc/fused_langevin.cu)
MIXTURE_THREADS = 128
#: lanes per chain the mixture chain kernel is built for
MIXTURE_GROUPS = (1, 2, 4, 8)
#: threads an H100 holds resident at once (132 SMs x 2,048): the plan halves
#: the group while a launch would hold more
MIXTURE_RESIDENT_THREADS = 132 * 2048
#: the largest d a group holds in every lane (``kMaxGroupDim``): above it, one lane
MIXTURE_GROUP_MAX_DIM = 16
#: lanes per chain of the MALA, HMC, ladder and AIS chain kernels at
#: d <= MIXTURE_GROUP_MAX_DIM (``TEBM_DISPATCH_GROUPS``, csrc/tebm_common.cuh)
DISPATCH_GROUPS = (1, 2, 4, 8)


def dispatch_groups(d: int, k: int, gaussian: bool, *,
                    split_one_component: bool = False) -> Tuple[int, ...]:
    """The groups of lanes per chain that ``TEBM_DISPATCH_GROUPS``
    (csrc/tebm_common.cuh) launches a chain kernel at, on a target of ``k``
    components (or the full-covariance Gaussian) in ``d`` dimensions:
    :data:`DISPATCH_GROUPS` up to :data:`MIXTURE_GROUP_MAX_DIM`, one lane
    above it. A one-component mixture takes one lane too, unless
    ``split_one_component``: its lanes then share only the randomness drawn
    ahead. The MALA, HMC, ladder and AIS kernels' groups all derive from
    this rule."""
    if d > MIXTURE_GROUP_MAX_DIM or (k < 2 and not gaussian and not split_one_component):
        return (1,)
    return DISPATCH_GROUPS

_P, _I, _F, _U, _LL = _build.PTR, _build.INT, _build.FLOAT, _build.U32, _build.I64
#: C entry point (``tebm_<name>``) -> its argument types before the stream
_SIGNATURES = {
    "mixture_langevin_chain": (_P,) * 6 + (_I,) * 5 + (_F, _I, _F, _F, _U, _U, _LL) + (_I,) * 3,
    "mixture_langevin_chain_trajectory":
        (_P,) * 7 + (_I,) * 6 + (_F, _I, _F, _F, _U, _U, _LL) + (_I,) * 3,
    "doublewell_langevin_chain": (_P,) * 5 + (_LL, _I, _F, _F, _F, _F, _I, _F, _F, _U, _U, _LL),
    "doublewell_langevin_chain_trajectory":
        (_P,) * 6 + (_LL, _I, _I, _F, _F, _F, _F, _I, _F, _F, _U, _U, _LL),
    "fused_langevin_step": (_P,) * 4 + (_LL, _F, _F, _I, _F, _F, _U, _U),
}


def _launch(name: str, device, *args) -> None:
    _build.launch(name, _SIGNATURES[name], device, *args)


_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
# float32(2π), the constant the kernel multiplies by
_TWO_PI_F32 = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))


# ---------------------------------------------------------------------------
# Philox4x32-10 twin (int64 arithmetic masked to 32 bits)
# ---------------------------------------------------------------------------


def _mulhilo32(a: int, b):
    """``(hi, lo)`` 32-bit words of the 64-bit product of the constant ``a``
    and ``b`` (values < 2^32), split in 16-bit halves so int64 never overflows."""
    p_lo = b * (a & 0xFFFF)
    p_hi = b * (a >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors or ints holding
    32-bit words: counter ``(c0, c1, c2, c3)``, key ``(k0, k1)``. Returns the
    four output words; the CUDA kernels' generator is the same function."""
    k0 &= _MASK32
    k1 &= _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo32(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _box_muller(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    u1 = (a >> 8).to(torch.float32) * 2.0**-24 + 2.0**-25  # (0, 1]
    u2 = (b >> 8).to(torch.float32) * 2.0**-24  # [0, 1)
    r = torch.sqrt(-2.0 * torch.log(u1))
    t = _TWO_PI_F32 * u2
    return r * torch.cos(t), r * torch.sin(t)


def philox_normals(index: Tensor, step: int, n_coords: int, seed: int) -> Tensor:
    """Standard normals ``(*index.shape, n_coords)`` for chain (or element)
    ``index`` at ``step``: coordinates ``4j..4j+3`` come from counter
    ``(index lo, step, j, index hi)`` through two Box–Muller transforms."""
    index = index.to(torch.int64)
    zs = []
    for j in range((n_coords + 3) // 4):
        o = philox4x32_10(index & _MASK32, step, j, index >> 32, seed, seed >> 32)
        zs.extend(_box_muller(o[0], o[1]) + _box_muller(o[2], o[3]))
    return torch.stack(zs[:n_coords], dim=-1)


#: the Philox block index of the Metropolis uniforms; normals use blocks
#: 0..ceil(d/4)-1, so the two streams never share a counter.
UNIFORM_BLOCK = _MASK32


def philox_uniforms(index: Tensor, step: int, seed: int) -> Tensor:
    """Uniforms in [0, 1) of ``index.shape`` for chain ``index`` at ``step``:
    the top 24 bits of the first word of counter ``(index lo, step,
    0xFFFFFFFF, index hi)`` times 2^-24, as the kernels draw them."""
    index = index.to(torch.int64)
    o = philox4x32_10(index & _MASK32, step, UNIFORM_BLOCK, index >> 32, seed, seed >> 32)
    return (o[0] >> 8).to(torch.float32) * 2.0**-24


# ---------------------------------------------------------------------------
# shared argument handling
# ---------------------------------------------------------------------------


def _constant_schedule(step_size: Schedule,
                       noise_scale: Schedule) -> Optional[Tuple[float, float]]:
    """``(η, noise_scale·√(2η))`` for a pair of Python numbers, the
    coefficient computed in double precision (as the JAX kernels bake it);
    None for a per-step schedule."""
    if isinstance(step_size, (int, float)) and isinstance(noise_scale, (int, float)):
        return float(step_size), float(noise_scale) * math.sqrt(2.0 * float(step_size))
    return None


def _schedule_table(step_size: Schedule, noise_scale: Schedule, n_steps: int,
                    device) -> Tensor:
    """The ``(2, n_steps)`` float32 table ``[η_t, noise_scale_t·√(2η_t)]``.
    A pair of Python numbers gives a constant table
    (:func:`_constant_schedule`); a ``(n_steps,)`` schedule on either side
    gives the per-step table, scalars broadcast. Each copy of host numbers
    to ``device`` is counted in ``host_reads``: on a card it waits for the
    stream."""
    const = _constant_schedule(step_size, noise_scale)
    if const is not None:
        count("host_reads")
        col = torch.tensor([[const[0]], [const[1]]], dtype=torch.float32, device=device)
        return col.expand(2, n_steps).contiguous()
    for name, p in (("step_size", step_size), ("noise_scale", noise_scale)):
        shape = tuple(torch.as_tensor(p).shape)
        if shape not in ((), (n_steps,)):
            raise ValueError(
                f"{name} must be a scalar or a ({n_steps},) per-step schedule, got shape {shape}"
            )
        if not (isinstance(p, Tensor) and p.device == torch.device(device)):
            count("host_reads")
    h = torch.as_tensor(step_size, dtype=torch.float32, device=device).broadcast_to((n_steps,))
    ns = torch.as_tensor(noise_scale, dtype=torch.float32, device=device).broadcast_to((n_steps,))
    return torch.stack([h, ns * torch.sqrt(2.0 * h)])


def _check_tensor(name: str, t: Tensor, device: torch.device, shape=None) -> None:
    if not isinstance(t, Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device} (the device of x0)")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(x0: Tensor, n_steps: int, noise: Optional[Tensor]) -> None:
    _check_tensor("x0", x0, x0.device)
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x0 is on {x0.device}: only CPU (plain) and CUDA (kernel) run")
    if x0.numel() < 1:
        raise ValueError("x0 must hold at least one element")
    if int(n_steps) < 1:
        raise ValueError("n_steps must be >= 1")
    if noise is not None:
        _check_tensor("noise", noise, x0.device, (int(n_steps), *x0.shape))


def _check_metropolis(x0: Tensor, n_steps: int, noise: Optional[Tensor],
                      uniforms: Optional[Tensor]) -> None:
    """The checks of the Metropolis chains (MALA, HMC): ``noise`` and
    ``uniforms`` injected together or not at all, with their shapes."""
    if (noise is None) != (uniforms is None):
        raise ValueError("noise and uniforms must be supplied together")
    _check_common(x0, n_steps, noise)
    if uniforms is not None:
        _check_tensor("uniforms", uniforms, x0.device, (int(n_steps), x0.shape[0]))


def _check_thin(n_steps: int, thin: int) -> int:
    if thin < 1:
        raise ValueError("thin must be >= 1")
    n_kept = int(n_steps) // int(thin)
    if n_kept < 1:
        raise ValueError("n_steps // thin must be >= 1 for trajectory output")
    return n_kept


def _clamp_args(clamp) -> Tuple[int, float, float]:
    if clamp is None:
        return 0, 0.0, 0.0
    return 1, float(clamp[0]), float(clamp[1])


def _seed_words(seed: int) -> Tuple[int, int]:
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be in [0, 2^64), got {seed}")
    return seed & _MASK32, seed >> 32


def _seed_arg(seed, device) -> Tuple[Optional[Tensor], int, int]:
    """``(device seed tensor or None, seed lo, seed hi)``. A seed is a Python
    int in ``[0, 2^64)``, or a non-negative 0-d int64 tensor on the CPU or on
    the state's device; a kernel that takes a seed pointer reads a device
    tensor's two words where it lies (no host sync), a plain version takes
    ``int(seed)``: the same Philox stream either way."""
    if isinstance(seed, Tensor):
        on_card = seed.device.type == "cuda"
        if (seed.dtype != torch.int64 or seed.ndim != 0
                or seed.device != (device if on_card else torch.device("cpu"))):
            raise ValueError(f"a tensor seed must be a 0-d int64 tensor on the CPU or on "
                             f"{device}, got {seed.dtype} of shape {tuple(seed.shape)} on "
                             f"{seed.device}")
        if on_card:
            return seed, 0, 0
        seed = int(seed)
    return None, *_seed_words(seed)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _mixture_grad_logp(x: Tensor, means: Tensor, log_weights: Tensor,
                       inv_var: float) -> Tuple[Tensor, Tensor]:
    """Energy gradient and unnormalised log-density ``log Σ_k exp(logit_k)``
    of an isotropic mixture (the kernels' evaluator)."""
    diff = x[:, None, :] - means[None, :, :]
    logits = log_weights - 0.5 * inv_var * torch.sum(diff * diff, dim=-1)
    m = torch.amax(logits, dim=-1, keepdim=True)
    w = torch.exp(logits - m)
    den = torch.sum(w, dim=-1, keepdim=True)
    inv_den = 1.0 / den
    return (x - (w @ means) * inv_den) * inv_var, (m + torch.log(den))[:, 0]


def _gaussian_grad_logp(x: Tensor, mean: Tensor, precision: Tensor) -> Tuple[Tensor, Tensor]:
    """Energy gradient ``P (x − μ)`` and log-density ``−½ (x − μ)·∇E``."""
    diff = x - mean
    grad = diff @ precision.T
    return grad, -0.5 * torch.sum(diff * grad, dim=-1)


def _run_plain(x0: Tensor, grad_fn, sched: Tensor, n_coords: int, clamp, seed: int,
               noise: Optional[Tensor], thin: Optional[int], normals=None,
               chain_offset: int = 0):
    """Plain version of every chain kernel: the same update, schedule table and
    Philox stream (one counter per row of ``x0`` viewed as ``(-1, n_coords)``,
    numbered from ``chain_offset``, and step), or the normals ``normals(t)``
    gives for step ``t``."""
    n_steps = sched.shape[1]
    x = x0
    if normals is None:
        index = torch.arange(x0.numel() // n_coords, device=x0.device) + chain_offset

        def normals(t):
            return philox_normals(index, t, n_coords, seed).reshape(x0.shape)

    kept = []
    for t in range(n_steps):
        eps = noise[t] if noise is not None else normals(t)
        x = x - sched[0, t] * grad_fn(x) + sched[1, t] * eps
        if clamp is not None:
            x = torch.clamp(x, clamp[0], clamp[1])
        if thin is not None and (t + 1) % thin == 0:
            kept.append(x)
    return (torch.stack(kept) if thin is not None else None), x


# ---------------------------------------------------------------------------
# mixture / full-covariance Gaussian chain
# ---------------------------------------------------------------------------


def _target(x0, means, scale, log_weights, precision):
    """Validate a mixture (or, with ``precision``, full-covariance Gaussian)
    target for the ``(n_chains, d)`` state ``x0``; return
    ``(grad_logp, params_a, params_b, gaussian, inv_var)``, ``grad_logp(x)``
    giving the energy gradient and the unnormalised log-density."""
    if x0.ndim != 2:
        raise ValueError(f"x0 must have shape (n_chains, d), got {tuple(x0.shape)}")
    n, d = x0.shape
    _check_tensor("means", means, x0.device)
    if means.ndim != 2 or means.shape[1] != d:
        raise ValueError(f"means must have shape (K, {d}), got {tuple(means.shape)}")
    k = means.shape[0]
    if d > MAX_DIM or k * d > MAX_COMPONENTS_X_DIM:
        raise ValueError(
            f"the mixture chain holds K*d={k * d}, d={d}; supported sizes are "
            f"d <= {MAX_DIM} and K*d <= {MAX_COMPONENTS_X_DIM}"
        )
    inv_var = 1.0 / float(scale) ** 2
    if precision is not None:
        if k != 1:
            raise ValueError("precision= requires a single (1, d) means row (a Gaussian target)")
        if d > MAX_PRECISION_DIM:
            raise ValueError(
                f"the full-covariance chain holds d^2 precision terms; d={d} > {MAX_PRECISION_DIM}"
            )
        _check_tensor("precision", precision, x0.device, (d, d))
        mean = means[0]
        return (lambda x: _gaussian_grad_logp(x, mean, precision)), precision, mean, 1, inv_var
    if log_weights is None:
        log_weights = torch.full((k,), -math.log(k), dtype=torch.float32, device=x0.device)
    _check_tensor("log_weights", log_weights, x0.device, (k,))
    return (
        lambda x: _mixture_grad_logp(x, means, log_weights, inv_var),
        means, log_weights, 0, inv_var,
    )


def _mixture_args(x0, means, n_steps, step_size, noise_scale, scale, log_weights,
                  precision, noise):
    """Validate, then return ``(grad_fn, params_a, params_b, gaussian, sched, inv_var)``."""
    _check_common(x0, n_steps, noise)
    grad_logp, pa, pb, gaussian, inv_var = _target(x0, means, scale, log_weights, precision)
    sched = _schedule_table(step_size, noise_scale, int(n_steps), x0.device)
    return (lambda x: grad_logp(x)[0]), pa, pb, gaussian, sched, inv_var


def _chain_offset(chain_offset: int, n: int, bits: int = 63) -> int:
    """``chain_offset`` checked: the Philox index of a launch's last chain
    must fit the kernel's index, 63 bits (the counter's 64), or 31 where a
    kernel numbers the whole batch's chains as it numbers its own (an
    ``int``: no launch holds more chains)."""
    chain_offset = int(chain_offset)
    if not 0 <= chain_offset <= (1 << bits) - 1 - n:
        raise ValueError(f"chain_offset must be in [0, 2^{bits} - n_chains), got {chain_offset}")
    return chain_offset


def mixture_langevin_chain_plain(x0, means, n_steps, step_size, noise_scale=1.0, *, scale=1.0,
                                 log_weights=None, precision=None, seed=0, clamp=None,
                                 noise=None, chain_offset=0) -> Tensor:
    """Plain PyTorch version of :func:`mixture_langevin_chain`, on ``x0``'s
    device: the same update, schedule table and Philox stream."""
    grad_fn, *_, sched, _ = _mixture_args(
        x0, means, n_steps, step_size, noise_scale, scale, log_weights, precision, noise
    )
    _seed_words(seed)
    return _run_plain(x0, grad_fn, sched, x0.shape[1], clamp, seed, noise, None,
                      chain_offset=_chain_offset(chain_offset, x0.shape[0]))[1]


def mixture_langevin_chain_trajectory_plain(x0, means, n_steps, step_size, noise_scale=1.0, *,
                                            thin=1, scale=1.0, log_weights=None,
                                            precision=None, seed=0, clamp=None,
                                            noise=None, chain_offset=0) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`mixture_langevin_chain_trajectory`."""
    _check_thin(n_steps, thin)
    grad_fn, *_, sched, _ = _mixture_args(
        x0, means, n_steps, step_size, noise_scale, scale, log_weights, precision, noise
    )
    _seed_words(seed)
    return _run_plain(x0, grad_fn, sched, x0.shape[1], clamp, seed, noise, int(thin),
                      chain_offset=_chain_offset(chain_offset, x0.shape[0]))


def mixture_launch_plan(n: int, d: int, k: int, gaussian: bool,
                        group: Optional[int] = None) -> Tuple[int, int, int]:
    """``(group, threads, blocks)`` of one mixture chain launch over ``n``
    chains in ``d`` dimensions with ``k`` components: ``group`` lanes of one
    warp hold a chain, ``threads`` per block, ``blocks`` in the grid.

    The rule follows the card's timings of the kernel (``chip_smoke.py``,
    H100): up to 16 components, the smallest power of two that covers them,
    at most 4 lanes (the ring, K = 8, two components per lane); above 16, 8
    lanes. The group is then halved while ``n * group`` exceeds the threads
    the card holds at once (:data:`MIXTURE_RESIDENT_THREADS`), where more
    lanes only add work. It is 1 where the kernel keeps one lane per chain:
    the full-covariance Gaussian, one component, and
    ``d > MIXTURE_GROUP_MAX_DIM``. ``group=`` overrides the choice with a
    group the kernel is built for (timings compare them)."""
    single = gaussian or k < 2 or d > MIXTURE_GROUP_MAX_DIM
    if group is None:
        group = 1 if single else (min(1 << (k - 1).bit_length(), 4) if k <= 16 else 8)
        while group > 1 and n * group > MIXTURE_RESIDENT_THREADS:
            group //= 2
    elif group not in MIXTURE_GROUPS or (single and group != 1):
        raise ValueError(f"no mixture chain kernel at group {group} for d={d}, K={k}, "
                         f"gaussian={bool(gaussian)}")
    threads = MIXTURE_THREADS
    return group, threads, -(-n * group // threads)


def _mixture_run(name, x0, means, n_steps, step_size, noise_scale, thin, scale, log_weights,
                 precision, seed, clamp, noise, group=None, chain_offset=0):
    """The body of both mixture wrappers (``thin=None``: final state only):
    ``(traj, final, launched)``. A CPU ``x0`` runs the plain version; a CUDA
    ``x0`` launches kernel ``name`` with :func:`mixture_launch_plan`, whose
    group ``group`` overrides."""
    grad_fn, pa, pb, gaussian, sched, inv_var = _mixture_args(
        x0, means, n_steps, step_size, noise_scale, scale, log_weights, precision, noise
    )
    seed_lo, seed_hi = _seed_words(seed)
    chain_offset = _chain_offset(chain_offset, x0.shape[0])
    if x0.device.type == "cpu":
        return (*_run_plain(x0, grad_fn, sched, x0.shape[1], clamp, seed, noise, thin,
                            chain_offset=chain_offset), False)
    n, d = x0.shape
    k = means.shape[0]
    plan = mixture_launch_plan(n, d, k, bool(gaussian), group)
    out = torch.empty_like(x0)
    traj = None if thin is None else torch.empty(
        (int(n_steps) // thin, n, d), dtype=torch.float32, device=x0.device)
    use_clamp, lo, hi = _clamp_args(clamp)
    head = (_ptr(x0), _ptr(out)) + (() if thin is None else (_ptr(traj),))
    tail = () if thin is None else (thin,)
    _launch(
        name, x0.device,
        *head, _ptr(pa), _ptr(pb), _ptr(sched), _ptr(noise),
        n, d, k, gaussian, int(n_steps), *tail, inv_var,
        use_clamp, lo, hi, seed_lo, seed_hi, chain_offset, *plan,
    )
    return traj, out, True


@_build.counted
def mixture_langevin_chain(
    x0: Tensor,
    means: Tensor,
    n_steps: int,
    step_size: Schedule,
    noise_scale: Schedule = 1.0,
    *,
    scale: float = 1.0,
    log_weights: Optional[Tensor] = None,
    precision: Optional[Tensor] = None,
    seed: int = 0,
    clamp: Optional[Tuple[float, float]] = None,
    noise: Optional[Tensor] = None,
    chain_offset: int = 0,
) -> Tensor:
    """Full n-step Langevin chain on a d-dim isotropic Gaussian mixture (or,
    with ``precision``, a full-covariance Gaussian) in one kernel.

    ``x0``: ``(n_chains, d)``; ``means``: ``(K, d)``. Returns the final state.
    ``chain_offset`` numbers the chains' Philox streams from it: a launch over
    chains ``[a, b)`` of a batch with ``chain_offset=a`` draws what rows
    ``[a, b)`` of the launch over the whole batch draw (a sharded batch's
    shard; a Python int, so it costs no host sync). Injected ``noise`` ignores it.
    """
    _, out, launched = _mixture_run(
        "mixture_langevin_chain", x0, means, n_steps, step_size, noise_scale, None, scale,
        log_weights, precision, seed, clamp, noise, chain_offset=chain_offset,
    )
    mixture_langevin_chain.launches += launched
    return out


@_build.counted
def mixture_langevin_chain_trajectory(
    x0: Tensor,
    means: Tensor,
    n_steps: int,
    step_size: Schedule,
    noise_scale: Schedule = 1.0,
    *,
    thin: int = 1,
    scale: float = 1.0,
    log_weights: Optional[Tensor] = None,
    precision: Optional[Tensor] = None,
    seed: int = 0,
    clamp: Optional[Tuple[float, float]] = None,
    noise: Optional[Tensor] = None,
    chain_offset: int = 0,
) -> Tuple[Tensor, Tensor]:
    """:func:`mixture_langevin_chain` recording every ``thin``-th state.

    Returns ``(traj, final)``: ``traj`` ``(n_steps // thin, n_chains, d)``
    holds the states after steps ``thin, 2·thin, …``; ``final`` the state
    after all ``n_steps`` steps.
    """
    _check_thin(n_steps, thin)
    traj, out, launched = _mixture_run(
        "mixture_langevin_chain_trajectory", x0, means, n_steps, step_size, noise_scale,
        int(thin), scale, log_weights, precision, seed, clamp, noise, chain_offset=chain_offset,
    )
    mixture_langevin_chain_trajectory.launches += launched
    return traj, out


# ---------------------------------------------------------------------------
# double-well chain
# ---------------------------------------------------------------------------


def doublewell_normals(index: Tensor, n_steps: int, seed: int):
    """The double-well chains' normals for elements ``index``, step by step:
    steps ``4m … 4m+3`` take the four normals, in order, of the Philox block
    at counter ``(index lo, m, 0, index hi)`` (its two Box–Muller pairs), so
    one block feeds four steps of an element and every normal is used once.
    Yields ``n_steps`` tensors of ``index.shape``, as the kernels draw them."""
    for m in range(-(-int(n_steps) // 4)):
        quad = philox_normals(index, m, 4, seed)
        for q in range(min(4, int(n_steps) - 4 * m)):
            yield quad[..., q]


def _doublewell_args(x0, n_steps, barrier_height, b, seed, noise):
    """Validate; return ``(coef, b², (device seed or None, seed lo, seed hi))``."""
    _check_common(x0, n_steps, noise)
    return 4.0 * float(barrier_height), float(b) * float(b), _seed_arg(seed, x0.device)


def _doublewell_plain(x0, n_steps, step_size, noise_scale, thin, barrier_height, b, seed, clamp,
                      noise, chain_offset=0):
    """Plain version of both double-well kernels (``thin=None``: final state
    only) on ``x0``'s device: ``(traj, final)`` from the same update and
    schedule and the stream of :func:`doublewell_normals`, the elements
    numbered from ``chain_offset``."""
    coef, b2, _ = _doublewell_args(x0, n_steps, barrier_height, b, seed, noise)
    seed = int(seed)
    sched = _schedule_table(step_size, noise_scale, int(n_steps), x0.device)
    index = torch.arange(x0.numel(), device=x0.device) + _chain_offset(chain_offset, x0.numel())
    stream = doublewell_normals(index, n_steps, seed)
    return _run_plain(x0, lambda x: coef * x * (x * x - b2), sched, 1, clamp, seed, noise, thin,
                      normals=lambda t: next(stream).reshape(x0.shape))


def _doublewell_run(name, x0, n_steps, step_size, noise_scale, thin, barrier_height, b, seed,
                    clamp, noise, chain_offset=0):
    """The body of both double-well wrappers (``thin=None``: final state
    only): ``(traj, final, launched)``. A CPU ``x0`` runs the plain version; a
    CUDA ``x0`` launches kernel ``name`` with a constant schedule as two
    floats (no table) and a device seed read where it lies."""
    if x0.device.type == "cpu":
        return (*_doublewell_plain(x0, n_steps, step_size, noise_scale, thin, barrier_height, b,
                                   seed, clamp, noise, chain_offset), False)
    coef, b2, (seed_t, seed_lo, seed_hi) = _doublewell_args(
        x0, n_steps, barrier_height, b, seed, noise)
    const = _constant_schedule(step_size, noise_scale)
    sched = None if const else _schedule_table(step_size, noise_scale, int(n_steps), x0.device)
    eta, nc = const or (0.0, 0.0)
    out = torch.empty_like(x0)
    traj = None if thin is None else torch.empty(
        (int(n_steps) // thin, *x0.shape), dtype=torch.float32, device=x0.device)
    use_clamp, lo, hi = _clamp_args(clamp)
    head = (_ptr(x0), _ptr(out)) + (() if thin is None else (_ptr(traj),))
    tail = () if thin is None else (thin,)
    _launch(
        name, x0.device,
        *head, _ptr(sched), _ptr(noise), _ptr(seed_t), x0.numel(), int(n_steps), *tail,
        coef, b2, eta, nc, use_clamp, lo, hi, seed_lo, seed_hi,
        _chain_offset(chain_offset, x0.numel()),
    )
    return traj, out, True


def doublewell_langevin_chain_plain(x0, n_steps, step_size, noise_scale=1.0, *,
                                    barrier_height=2.0, b=1.0, seed=0, clamp=None,
                                    noise=None, chain_offset=0) -> Tensor:
    """Plain PyTorch version of :func:`doublewell_langevin_chain`, on ``x0``'s device."""
    return _doublewell_plain(x0, n_steps, step_size, noise_scale, None, barrier_height, b, seed,
                             clamp, noise, chain_offset)[1]


def doublewell_langevin_chain_trajectory_plain(x0, n_steps, step_size, noise_scale=1.0, *,
                                               thin=1, barrier_height=2.0, b=1.0, seed=0,
                                               clamp=None, noise=None,
                                               chain_offset=0) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`doublewell_langevin_chain_trajectory`."""
    _check_thin(n_steps, thin)
    return _doublewell_plain(x0, n_steps, step_size, noise_scale, int(thin), barrier_height, b,
                             seed, clamp, noise, chain_offset)


@_build.counted
def doublewell_langevin_chain(
    x0: Tensor,
    n_steps: int,
    step_size: Schedule,
    noise_scale: Schedule = 1.0,
    *,
    barrier_height: float = 2.0,
    b: float = 1.0,
    seed: Union[int, Tensor] = 0,
    clamp: Optional[Tuple[float, float]] = None,
    noise: Optional[Tensor] = None,
    chain_offset: int = 0,
) -> Tensor:
    """Full n-step Langevin chain on the double-well energy in one kernel;
    the state may have any shape and is stepped element by element.
    ``seed``: a Python int, or a 0-d int64 tensor on the CPU or on ``x0``'s
    device (read there by the kernel, with no host sync). ``chain_offset``
    numbers the elements' Philox streams from it: a launch over rows
    ``[a, b)`` of a state with ``e`` elements per row, at ``chain_offset =
    a·e``, draws what those rows draw in the launch over the whole state (a
    row shard); injected ``noise`` ignores it."""
    _, out, launched = _doublewell_run(
        "doublewell_langevin_chain", x0, n_steps, step_size, noise_scale, None, barrier_height,
        b, seed, clamp, noise, chain_offset,
    )
    doublewell_langevin_chain.launches += launched
    return out


@_build.counted
def doublewell_langevin_chain_trajectory(
    x0: Tensor,
    n_steps: int,
    step_size: Schedule,
    noise_scale: Schedule = 1.0,
    *,
    thin: int = 1,
    barrier_height: float = 2.0,
    b: float = 1.0,
    seed: Union[int, Tensor] = 0,
    clamp: Optional[Tuple[float, float]] = None,
    noise: Optional[Tensor] = None,
    chain_offset: int = 0,
) -> Tuple[Tensor, Tensor]:
    """:func:`doublewell_langevin_chain` recording every ``thin``-th state:
    returns ``(traj, final)`` with ``traj`` ``(n_steps // thin, *x0.shape)``."""
    _check_thin(n_steps, thin)
    traj, out, launched = _doublewell_run(
        "doublewell_langevin_chain_trajectory", x0, n_steps, step_size, noise_scale, int(thin),
        barrier_height, b, seed, clamp, noise, chain_offset,
    )
    doublewell_langevin_chain_trajectory.launches += launched
    return traj, out


# ---------------------------------------------------------------------------
# one fused step (model-agnostic)
# ---------------------------------------------------------------------------


def _step_args(x, grad, step_size, noise_scale, seed, noise):
    _check_tensor("x", x, x.device)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x is on {x.device}: only CPU (plain) and CUDA (kernel) run")
    if x.numel() < 1:
        raise ValueError("x must hold at least one element")
    _check_tensor("grad", grad, x.device, x.shape)
    if noise is not None:
        _check_tensor("noise", noise, x.device, x.shape)
    _seed_words(seed)
    return float(step_size), float(noise_scale) * math.sqrt(2.0 * float(step_size))


def _step_plain(x, grad, eta, coef, seed, clamp, noise):
    if noise is None:
        n = x.numel()
        quads = torch.arange((n + 3) // 4, device=x.device)
        noise = philox_normals(quads, 0, 4, seed).reshape(-1)[:n].reshape(x.shape)
    out = x - eta * grad + coef * noise
    return out if clamp is None else torch.clamp(out, clamp[0], clamp[1])


def fused_langevin_step_plain(x, grad, step_size, noise_scale=1.0, *, seed=0, clamp=None,
                              noise=None) -> Tensor:
    """Plain PyTorch version of :func:`fused_langevin_step`, on ``x``'s device."""
    eta, coef = _step_args(x, grad, step_size, noise_scale, seed, noise)
    return _step_plain(x, grad, eta, coef, seed, clamp, noise)


@_build.counted
def fused_langevin_step(
    x: Tensor,
    grad: Tensor,
    step_size: float,
    noise_scale: float = 1.0,
    *,
    seed: int = 0,
    clamp: Optional[Tuple[float, float]] = None,
    noise: Optional[Tensor] = None,
) -> Tensor:
    r"""One fused Langevin update ``x − η·g + noise_scale·√(2η)·ε``, clamped
    to ``clamp`` if given, over a state of any shape.

    ``noise`` (``x``'s shape) injects ε; without it elements ``4q..4q+3``
    take the four normals of Philox counter ``(q, 0, 0)``.
    """
    eta, coef = _step_args(x, grad, step_size, noise_scale, seed, noise)
    if x.device.type == "cpu":
        return _step_plain(x, grad, eta, coef, seed, clamp, noise)
    out = torch.empty_like(x)
    seed_lo, seed_hi = _seed_words(seed)
    use_clamp, lo, hi = _clamp_args(clamp)
    _launch("fused_langevin_step", x.device, _ptr(x), _ptr(grad), _ptr(noise), _ptr(out),
            x.numel(), eta, coef, use_clamp, lo, hi, seed_lo, seed_hi)
    fused_langevin_step.launches += 1
    return out
