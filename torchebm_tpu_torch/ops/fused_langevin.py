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

``step_size`` and ``noise_scale`` are each a float or a ``(n_steps,)``
per-step schedule. ``noise`` (``(n_steps, *x0.shape)``) injects the normals;
without it they come from the Philox4x32-10 stream keyed by ``seed``, which
:func:`philox4x32_10` reproduces bit for bit in plain PyTorch. The
``*_trajectory`` variants also return every ``thin``-th state as an
``(n_steps // thin, *x0.shape)`` tensor; the trailing ``n_steps % thin``
steps still run and land in ``final``.

Every wrapper carries an integer ``launches`` attribute, raised by one each
time it launches its kernel (never on the plain path).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple, Union

import torch

from . import _build

Tensor = torch.Tensor
Schedule = Union[float, Tensor]

__all__ = [
    "doublewell_langevin_chain",
    "doublewell_langevin_chain_trajectory",
    "mixture_langevin_chain",
    "mixture_langevin_chain_trajectory",
    "doublewell_langevin_chain_plain",
    "doublewell_langevin_chain_trajectory_plain",
    "mixture_langevin_chain_plain",
    "mixture_langevin_chain_trajectory_plain",
    "philox4x32_10",
    "philox_normals",
    "launch_counts",
    "reset_launch_counts",
]

#: the JAX package's caps (unrolled K x d components, d^2 precision terms);
#: the sampler falls back to the loop beyond them.
MAX_DIM = 64
MAX_COMPONENTS_X_DIM = 1024
MAX_PRECISION_DIM = 32

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


# ---------------------------------------------------------------------------
# shared argument handling
# ---------------------------------------------------------------------------


def _schedule_table(step_size: Schedule, noise_scale: Schedule, n_steps: int,
                    device) -> Tensor:
    """The ``(2, n_steps)`` float32 table ``[η_t, noise_scale_t·√(2η_t)]``.
    A pair of Python numbers gives a constant table (the coefficient computed
    in double precision, as the JAX kernels bake it); a ``(n_steps,)``
    schedule on either side gives the per-step table, scalars broadcast."""
    if isinstance(step_size, (int, float)) and isinstance(noise_scale, (int, float)):
        coef = float(noise_scale) * math.sqrt(2.0 * float(step_size))
        col = torch.tensor([[float(step_size)], [coef]], dtype=torch.float32, device=device)
        return col.expand(2, n_steps).contiguous()
    for name, p in (("step_size", step_size), ("noise_scale", noise_scale)):
        shape = tuple(torch.as_tensor(p).shape)
        if shape not in ((), (n_steps,)):
            raise ValueError(
                f"{name} must be a scalar or a ({n_steps},) per-step schedule, got shape {shape}"
            )
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


@functools.cache
def _kernels() -> ctypes.CDLL:
    """The built library with every entry point's C signature declared."""
    lib = _build.load_library()
    p, i, f, u, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32,
                      ctypes.c_longlong)
    sigs = {
        "tebm_mixture_langevin_chain":
            [p, p, p, p, p, p, i, i, i, i, i, f, i, f, f, u, u, p],
        "tebm_mixture_langevin_chain_trajectory":
            [p, p, p, p, p, p, p, i, i, i, i, i, i, f, i, f, f, u, u, p],
        "tebm_doublewell_langevin_chain":
            [p, p, p, p, ll, i, f, f, i, f, f, u, u, p],
        "tebm_doublewell_langevin_chain_trajectory":
            [p, p, p, p, p, ll, i, i, f, f, i, f, f, u, u, p],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tebm_error_string.argtypes = [ctypes.c_int]
    lib.tebm_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, device: torch.device, *args) -> None:
    """Call C entry ``tebm_<name>`` on ``device``'s current stream; raise on
    a non-zero ``cudaGetLastError``."""
    lib = _kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"tebm_{name}")(*args, stream)
    if rc != 0:
        msg = lib.tebm_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {rc} ({msg})")


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _mixture_grad(x: Tensor, means: Tensor, log_weights: Tensor, inv_var: float) -> Tensor:
    diff = x[:, None, :] - means[None, :, :]
    logits = log_weights - 0.5 * inv_var * torch.sum(diff * diff, dim=-1)
    w = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    inv_den = 1.0 / torch.sum(w, dim=-1, keepdim=True)
    return (x - (w @ means) * inv_den) * inv_var


def _run_plain(x0: Tensor, grad_fn, sched: Tensor, n_coords: int, clamp, seed: int,
               noise: Optional[Tensor], thin: Optional[int]):
    """Plain version of every chain kernel: the same update, schedule table and
    Philox stream (one counter per row of ``x0`` viewed as ``(-1, n_coords)``)."""
    n_steps = sched.shape[1]
    x = x0
    index = torch.arange(x0.numel() // n_coords, device=x0.device)
    kept = []
    for t in range(n_steps):
        eps = noise[t] if noise is not None else (
            philox_normals(index, t, n_coords, seed).reshape(x0.shape)
        )
        x = x - sched[0, t] * grad_fn(x) + sched[1, t] * eps
        if clamp is not None:
            x = torch.clamp(x, clamp[0], clamp[1])
        if thin is not None and (t + 1) % thin == 0:
            kept.append(x)
    return (torch.stack(kept) if thin is not None else None), x


# ---------------------------------------------------------------------------
# mixture / full-covariance Gaussian chain
# ---------------------------------------------------------------------------


def _mixture_args(x0, means, n_steps, step_size, noise_scale, scale, log_weights,
                  precision, noise):
    """Validate, then return ``(grad_fn, params_a, params_b, gaussian, sched, inv_var)``."""
    _check_common(x0, n_steps, noise)
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
    sched = _schedule_table(step_size, noise_scale, int(n_steps), x0.device)
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
        return (lambda x: (x - mean) @ precision.T), precision, mean, 1, sched, inv_var
    if log_weights is None:
        log_weights = torch.full((k,), -math.log(k), dtype=torch.float32, device=x0.device)
    _check_tensor("log_weights", log_weights, x0.device, (k,))
    return (
        lambda x: _mixture_grad(x, means, log_weights, inv_var),
        means, log_weights, 0, sched, inv_var,
    )


def mixture_langevin_chain_plain(x0, means, n_steps, step_size, noise_scale=1.0, *, scale=1.0,
                                 log_weights=None, precision=None, seed=0, clamp=None,
                                 noise=None) -> Tensor:
    """Plain PyTorch version of :func:`mixture_langevin_chain`, on ``x0``'s
    device: the same update, schedule table and Philox stream."""
    grad_fn, *_, sched, _ = _mixture_args(
        x0, means, n_steps, step_size, noise_scale, scale, log_weights, precision, noise
    )
    _seed_words(seed)
    return _run_plain(x0, grad_fn, sched, x0.shape[1], clamp, seed, noise, None)[1]


def mixture_langevin_chain_trajectory_plain(x0, means, n_steps, step_size, noise_scale=1.0, *,
                                            thin=1, scale=1.0, log_weights=None,
                                            precision=None, seed=0, clamp=None,
                                            noise=None) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`mixture_langevin_chain_trajectory`."""
    _check_thin(n_steps, thin)
    grad_fn, *_, sched, _ = _mixture_args(
        x0, means, n_steps, step_size, noise_scale, scale, log_weights, precision, noise
    )
    _seed_words(seed)
    return _run_plain(x0, grad_fn, sched, x0.shape[1], clamp, seed, noise, int(thin))


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
) -> Tensor:
    """Full n-step Langevin chain on a d-dim isotropic Gaussian mixture (or,
    with ``precision``, a full-covariance Gaussian) in one kernel.

    ``x0``: ``(n_chains, d)``; ``means``: ``(K, d)``. Returns the final state.
    """
    grad_fn, pa, pb, gaussian, sched, inv_var = _mixture_args(
        x0, means, n_steps, step_size, noise_scale, scale, log_weights, precision, noise
    )
    seed_lo, seed_hi = _seed_words(seed)
    if x0.device.type == "cpu":
        return _run_plain(x0, grad_fn, sched, x0.shape[1], clamp, seed, noise, None)[1]
    n, d = x0.shape
    out = torch.empty_like(x0)
    use_clamp, lo, hi = _clamp_args(clamp)
    _launch(
        "mixture_langevin_chain", x0.device,
        _ptr(x0), _ptr(out), _ptr(pa), _ptr(pb), _ptr(sched), _ptr(noise),
        n, d, means.shape[0], gaussian, int(n_steps), inv_var,
        use_clamp, lo, hi, seed_lo, seed_hi,
    )
    mixture_langevin_chain.launches += 1
    return out


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
) -> Tuple[Tensor, Tensor]:
    """:func:`mixture_langevin_chain` recording every ``thin``-th state.

    Returns ``(traj, final)``: ``traj`` ``(n_steps // thin, n_chains, d)``
    holds the states after steps ``thin, 2·thin, …``; ``final`` the state
    after all ``n_steps`` steps.
    """
    n_kept = _check_thin(n_steps, thin)
    grad_fn, pa, pb, gaussian, sched, inv_var = _mixture_args(
        x0, means, n_steps, step_size, noise_scale, scale, log_weights, precision, noise
    )
    seed_lo, seed_hi = _seed_words(seed)
    if x0.device.type == "cpu":
        return _run_plain(x0, grad_fn, sched, x0.shape[1], clamp, seed, noise, int(thin))
    n, d = x0.shape
    out = torch.empty_like(x0)
    traj = torch.empty((n_kept, n, d), dtype=torch.float32, device=x0.device)
    use_clamp, lo, hi = _clamp_args(clamp)
    _launch(
        "mixture_langevin_chain_trajectory", x0.device,
        _ptr(x0), _ptr(out), _ptr(traj), _ptr(pa), _ptr(pb), _ptr(sched), _ptr(noise),
        n, d, means.shape[0], gaussian, int(n_steps), int(thin), inv_var,
        use_clamp, lo, hi, seed_lo, seed_hi,
    )
    mixture_langevin_chain_trajectory.launches += 1
    return traj, out


# ---------------------------------------------------------------------------
# double-well chain
# ---------------------------------------------------------------------------


def _doublewell_args(x0, n_steps, step_size, noise_scale, barrier_height, b, noise):
    _check_common(x0, n_steps, noise)
    coef, b2 = 4.0 * float(barrier_height), float(b) * float(b)
    sched = _schedule_table(step_size, noise_scale, int(n_steps), x0.device)
    return (lambda x: coef * x * (x * x - b2)), coef, b2, sched


def doublewell_langevin_chain_plain(x0, n_steps, step_size, noise_scale=1.0, *,
                                    barrier_height=2.0, b=1.0, seed=0, clamp=None,
                                    noise=None) -> Tensor:
    """Plain PyTorch version of :func:`doublewell_langevin_chain`, on ``x0``'s device."""
    grad_fn, _, _, sched = _doublewell_args(
        x0, n_steps, step_size, noise_scale, barrier_height, b, noise
    )
    _seed_words(seed)
    return _run_plain(x0, grad_fn, sched, 1, clamp, seed, noise, None)[1]


def doublewell_langevin_chain_trajectory_plain(x0, n_steps, step_size, noise_scale=1.0, *,
                                               thin=1, barrier_height=2.0, b=1.0, seed=0,
                                               clamp=None, noise=None) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`doublewell_langevin_chain_trajectory`."""
    _check_thin(n_steps, thin)
    grad_fn, _, _, sched = _doublewell_args(
        x0, n_steps, step_size, noise_scale, barrier_height, b, noise
    )
    _seed_words(seed)
    return _run_plain(x0, grad_fn, sched, 1, clamp, seed, noise, int(thin))


def doublewell_langevin_chain(
    x0: Tensor,
    n_steps: int,
    step_size: Schedule,
    noise_scale: Schedule = 1.0,
    *,
    barrier_height: float = 2.0,
    b: float = 1.0,
    seed: int = 0,
    clamp: Optional[Tuple[float, float]] = None,
    noise: Optional[Tensor] = None,
) -> Tensor:
    """Full n-step Langevin chain on the double-well energy in one kernel;
    the state may have any shape and is stepped element by element."""
    grad_fn, coef, b2, sched = _doublewell_args(
        x0, n_steps, step_size, noise_scale, barrier_height, b, noise
    )
    seed_lo, seed_hi = _seed_words(seed)
    if x0.device.type == "cpu":
        return _run_plain(x0, grad_fn, sched, 1, clamp, seed, noise, None)[1]
    out = torch.empty_like(x0)
    use_clamp, lo, hi = _clamp_args(clamp)
    _launch(
        "doublewell_langevin_chain", x0.device,
        _ptr(x0), _ptr(out), _ptr(sched), _ptr(noise), x0.numel(), int(n_steps),
        coef, b2, use_clamp, lo, hi, seed_lo, seed_hi,
    )
    doublewell_langevin_chain.launches += 1
    return out


def doublewell_langevin_chain_trajectory(
    x0: Tensor,
    n_steps: int,
    step_size: Schedule,
    noise_scale: Schedule = 1.0,
    *,
    thin: int = 1,
    barrier_height: float = 2.0,
    b: float = 1.0,
    seed: int = 0,
    clamp: Optional[Tuple[float, float]] = None,
    noise: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """:func:`doublewell_langevin_chain` recording every ``thin``-th state:
    returns ``(traj, final)`` with ``traj`` ``(n_steps // thin, *x0.shape)``."""
    n_kept = _check_thin(n_steps, thin)
    grad_fn, coef, b2, sched = _doublewell_args(
        x0, n_steps, step_size, noise_scale, barrier_height, b, noise
    )
    seed_lo, seed_hi = _seed_words(seed)
    if x0.device.type == "cpu":
        return _run_plain(x0, grad_fn, sched, 1, clamp, seed, noise, int(thin))
    out = torch.empty_like(x0)
    traj = torch.empty((n_kept, *x0.shape), dtype=torch.float32, device=x0.device)
    use_clamp, lo, hi = _clamp_args(clamp)
    _launch(
        "doublewell_langevin_chain_trajectory", x0.device,
        _ptr(x0), _ptr(out), _ptr(traj), _ptr(sched), _ptr(noise), x0.numel(),
        int(n_steps), int(thin), coef, b2, use_clamp, lo, hi, seed_lo, seed_hi,
    )
    doublewell_langevin_chain_trajectory.launches += 1
    return traj, out


_WRAPPERS = (
    mixture_langevin_chain,
    mixture_langevin_chain_trajectory,
    doublewell_langevin_chain,
    doublewell_langevin_chain_trajectory,
)
for _fn in _WRAPPERS:
    _fn.launches = 0


def launch_counts() -> dict:
    """``{wrapper name: kernel launches so far}``."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0
