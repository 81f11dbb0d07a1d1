r"""Device-mesh plumbing: construction, batch and parameter placements,
multi-process start-up (counterpart of :mod:`torchebm_tpu.parallel.mesh`).

Built on ``torch.distributed``: a :class:`~torch.distributed.device_mesh.DeviceMesh`
takes the place of ``jax.sharding.Mesh``, a tuple of DTensor placements
(``Shard``, ``Replicate``, one per mesh dimension) that of a
``NamedSharding``, FSDP2 (``fully_shard``) carries the parameter axis, and
``torch.distributed.checkpoint`` saves sharded state
(:mod:`~torchebm_tpu_torch.utils.training`). The design rule carries over:
components never require a process group; every helper degrades to a
single-process identity.

Canonical axes:

- ``"data"``: chains or batch rows (MCMC chains are a batch dimension);
- ``"fsdp"``: the parameter axis; on a ``("data", "fsdp")`` mesh
  :func:`fsdp_shard_params` gives HSDP (shard over ``"fsdp"``, replicate
  over ``"data"``).

What a sharded tensor means at each boundary. XLA runs any function on a
sharded input and returns the unsharded result; PyTorch compiles nothing, so
the port decides where a DTensor is taken:

- every sampler's ``sample(x=DTensor)`` (``ParallelTemperingLangevin.
  run_replicas`` on a ladder sharded on its chain axis, the HMC and NUTS
  warmups) runs each shard with the Philox streams (or, on the generic
  loops, the generator's draws) of its rows in the whole batch, pools its
  statistics and the reads that steer it over the shards, and returns a
  DTensor equal to the unsharded call; ``annealed_importance_sampling``
  splits its chains over the mesh of its DTensor inputs and returns the
  unsharded result on every process;
- the CD losses take a DTensor batch, their negatives run on the local rows;
- the couplings gather both batches and return the local rows;
- the R̂ and ESS estimators pool per-chain sums over the sharded axis;
- the trainer records the parameters' placements, averages the gradients
  of the parameters FSDP2 leaves replicated, and checkpoints sharded state;
- ``FlowSampler`` integrates the local rows; its adaptive integrators'
  error norm is pooled over the shards, so every process takes the same
  steps, and ``ReflowCoupling`` shards through it.

The helpers at the end of this module (:func:`row_shard`, :func:`like_rows`,
:func:`row_shards`, :func:`sum_over_rows`) are what those consumers share.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..core.module import default_device

Tensor = torch.Tensor

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "replicate",
    "fsdp_shard_params",
    "init_distributed",
    "local_shard_bounds",
]


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def make_mesh(axes: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None,
              devices: Any = None):
    """A :class:`~torch.distributed.device_mesh.DeviceMesh` over every process,
    with ``mesh_dim_names=axes``.

    With ``shape=None`` every process goes to the first axis and the rest get
    1; ``make_mesh(("data", "fsdp"), (2, 2))`` builds the 2-D chains × params
    layout over four processes. ``devices`` names the device type (``"cpu"``
    or ``"cuda"``, or a ``torch.device``); by default the card's, where there
    is one. Raises ``ValueError`` when ``shape`` does not cover the world.

    In a single process with no group, a world of one comes up first (a
    store in memory, NCCL on the card and gloo on the CPU), so every helper
    runs unchanged; :func:`is_distributed` stays false.
    """
    from torch.distributed.device_mesh import init_device_mesh

    device_type = (default_device() if devices is None else torch.device(devices)).type
    if not dist.is_initialized():
        if device_type == "cuda":
            torch.cuda.set_device(torch.cuda.current_device())
        dist.init_process_group(_backend(device_type), store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    axes = tuple(axes)
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes) or math.prod(shape) != n:
        raise ValueError(f"Mesh shape {shape} over axes {axes} does not cover {n} processes.")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def _axis(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r}; its axes are {names}")
    return names.index(axis)


def batch_sharding(mesh, ndim: int, axis: str = "data") -> tuple:
    """The placements that split dim 0 over ``axis`` and replicate over every
    other mesh dimension (``ndim``, the array's rank, is kept for the JAX
    signature: a placement names dim 0 whatever the rank)."""
    if ndim < 1:
        raise ValueError("a batch needs at least one dimension")
    from torch.distributed.tensor import Replicate, Shard

    i = _axis(mesh, axis)
    return tuple(Shard(0) if j == i else Replicate() for j in range(mesh.ndim))


def replicated_sharding(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def _tree_map(fn, tree):
    """``fn`` over the tensors of nested dicts, lists and tuples; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, Tensor) else tree


def shard_batch(x: Any, mesh, axis: str = "data") -> Any:
    """Every tensor of ``x`` as a DTensor split on dim 0 over ``axis``. Each
    process passes the whole batch; rank 0's copy is the one distributed."""
    from torch.distributed.tensor import distribute_tensor

    return _tree_map(lambda a: distribute_tensor(a, mesh, batch_sharding(mesh, a.ndim, axis)), x)


def replicate(tree: Any, mesh) -> Any:
    """Every tensor of ``tree`` as a DTensor replicated over the mesh."""
    from torch.distributed.tensor import distribute_tensor

    return _tree_map(lambda a: distribute_tensor(a, mesh, replicated_sharding(mesh)), tree)


def _shard_dim(shape: Sequence[int], numel: int, axis_size: int, min_size: int) -> Optional[int]:
    """The JAX rule (``mesh.py:91-118``): a leaf of at least ``min_size``
    elements is split on its largest dimension that the axis divides; None
    leaves it replicated."""
    if numel < min_size:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % axis_size == 0:
            return i
    return None


def fsdp_shard_params(params: Any, mesh, axis: str = "fsdp", min_size: int = 2**14) -> Any:
    """Parameter sharding over ``axis`` by the JAX rule: a leaf of at least
    ``min_size`` elements is split on its largest dimension that the axis
    divides, every other leaf stays replicated. An axis of size 1 splits too
    (one shard holding the whole leaf), so a one-card mesh runs the code of a
    larger one.

    - An ``nn.Module`` is sharded in place by FSDP2, ``fully_shard(module,
      mesh=..., shard_placement_fn=..., ignored_params=...)``, and returned:
      over a 1-D ``(axis,)`` mesh that is FSDP, over a 2-D ``("data", axis)``
      mesh HSDP (replicated over ``"data"``). Its sharded parameters become
      DTensors; the replicated ones are FSDP2's ``ignored_params``, plain
      tensors whose gradients FSDP2 does not reduce: the trainer averages
      them over the mesh (``BaseTrainer._optimizer_step``), and a loop of
      one's own must too. Shard a model before building its optimizer.
    - Nested dicts, lists and tuples of tensors (an EMA copy, a template)
      come back as DTensors with the same placements (the replicated leaves
      replicated over the whole mesh).
    """
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    i = _axis(mesh, axis)
    axis_size = mesh.size(i)

    def dim_of(t: Tensor) -> Optional[int]:
        return _shard_dim(tuple(t.shape), t.numel(), axis_size, min_size)

    if isinstance(params, nn.Module):
        from torch.distributed.fsdp import fully_shard

        if not (mesh.ndim == 1 or (mesh.ndim == 2 and i == 1)):
            raise ValueError(f"FSDP2 shards over a 1-D ({axis!r},) mesh or the last axis of a "
                             f"2-D one; got axes {mesh.mesh_dim_names}")
        dims = {p: dim_of(p) for p in params.parameters()}
        ignored = {p for p, d in dims.items() if d is None}
        fully_shard(params, mesh=mesh, shard_placement_fn=lambda p: Shard(dims[p]),
                    ignored_params=ignored or None)
        return params

    def place(t: Tensor):
        d = dim_of(t)
        placements = [Replicate()] * mesh.ndim
        if d is not None:
            placements[i] = Shard(d)
        return distribute_tensor(t, mesh, placements)

    return _tree_map(place, params)


#: environment variables of a launch that configures the world explicitly
#: (torchrun's), and of cluster schedulers whose launches are detected
_EXPLICIT_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")
_AUTODETECT_ENV = ("TORCHEBM_DISTRIBUTED", "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE")


def _scheduler_rank_world(env) -> Tuple[Optional[int], Optional[int]]:
    """``(rank, world)`` as Slurm or OpenMPI state them, else torchrun's."""
    for rank_var, world_var in (("RANK", "WORLD_SIZE"), ("SLURM_PROCID", "SLURM_NTASKS"),
                                ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE")):
        if env.get(rank_var) is not None and env.get(world_var) is not None:
            return int(env[rank_var]), int(env[world_var])
    return None, None


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, **kwargs) -> Tuple[int, int]:
    """Bring up the process group; a no-op in a single process. Returns
    ``(rank, world)``. Safe to call unconditionally (the reference's "helpers
    degrade to identity" rule). Resolution order, the JAX package's
    (``mesh.py:135-185``):

    1. a group is already up: return its ``(rank, world)``;
    2. explicit arguments, or torchrun's environment (``MASTER_ADDR``,
       ``WORLD_SIZE``, ``RANK``): ``init_process_group`` with them
       (``init_method`` by default ``env://``, which reads ``MASTER_ADDR``
       and ``MASTER_PORT``);
    3. a cluster launch is detected (``TORCHEBM_DISTRIBUTED=1``, Slurm or
       OpenMPI): the rank and world from the scheduler's variables, the
       address from ``MASTER_ADDR`` / ``MASTER_PORT``; a world of one stays
       single-process;
    4. otherwise touch nothing: ``(0, 1)``.

    The backend is NCCL when CUDA is present, gloo otherwise; with CUDA the
    process's device is set from ``LOCAL_RANK`` first. ``kwargs`` go to
    ``init_process_group``.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    explicit = (init_method is not None or world_size is not None or rank is not None
                or all(env.get(v) for v in _EXPLICIT_ENV))
    if not explicit:
        if not any(env.get(v) for v in _AUTODETECT_ENV):
            return 0, 1
        rank, world_size = _scheduler_rank_world(env)
        if world_size is None or world_size <= 1:
            return 0, 1
    if world_size is None or rank is None:
        env_rank, env_world = _scheduler_rank_world(env)
        rank = env_rank if rank is None else rank
        world_size = env_world if world_size is None else world_size
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    dist.init_process_group(_backend("cuda" if cuda else "cpu"),
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kwargs)
    return dist.get_rank(), dist.get_world_size()


def local_shard_bounds(global_batch: int, process_index: Optional[int] = None) -> Tuple[int, int]:
    """``[start, end)`` rows of a global batch owned by this process (an even split)."""
    from .shim import get_rank, get_world_size

    pi = get_rank() if process_index is None else process_index
    pc = get_world_size()
    if global_batch % pc != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {pc} processes")
    per = global_batch // pc
    return pi * per, (pi + 1) * per


# ---------------------------------------------------------------------------
# a batch sharded on its rows: what the samplers, losses, couplings,
# diagnostics and the trainer share
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dtensor_type() -> Optional[type]:
    if not dist.is_available():
        return None
    from torch.distributed.tensor import DTensor

    return DTensor


def is_dtensor(x: Any) -> bool:
    t = _dtensor_type()
    return t is not None and isinstance(x, t)


def row_shard(x, dim: int = 0) -> Tuple[Tensor, int, int]:
    """``(local rows, their first row in the whole batch, the batch's rows)``
    of a DTensor split on its row dimension ``dim`` (``Shard(dim)`` or
    ``Replicate()`` on each mesh dimension; a ladder of replicas has its
    chains on dim 1); any other placement raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    for p in x.placements:
        if not (isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim == dim)):
            raise ValueError(f"a batch is sharded on its rows (dim {dim}) only; got placements "
                             f"{x.placements}")
    _, offset = compute_local_shape_and_global_offset(x.shape, x.device_mesh, x.placements)
    return x.to_local(), int(offset[dim]) if offset else 0, int(x.shape[dim])


def like_rows(local: Tensor, like, dim: int = 0) -> Any:
    """``local``, this process's rows of a batch laid out as ``like`` (a
    DTensor sharded on its rows, as :func:`row_shard` takes one), as a
    DTensor with ``like``'s mesh and placements, its rows on ``dim`` (a
    ladder of replicas holds a batch's rows on dim 1); its other dimensions
    are ``local``'s own."""
    from torch.distributed.tensor import DTensor, Shard

    rows = next(p.dim for p in like.placements if isinstance(p, Shard)) if any(
        isinstance(p, Shard) for p in like.placements) else dim
    shape = list(local.shape)
    shape[dim] = like.shape[rows]
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    placements = [Shard(dim) if isinstance(p, Shard) else p for p in like.placements]
    return DTensor.from_local(local.contiguous(), like.device_mesh, placements,
                              run_check=False, shape=torch.Size(shape), stride=stride)


def row_shards(like) -> int:
    """How many processes hold distinct rows of ``like``: the product of the
    sizes of the mesh dimensions on which it is ``Shard(0)``."""
    from torch.distributed.tensor import Shard

    return math.prod(like.device_mesh.size(i) for i, p in enumerate(like.placements)
                     if isinstance(p, Shard))


def sum_over_rows(t: Tensor, like) -> Tensor:
    """``t``, a sum over this process's rows of the batch ``like``, summed
    over the processes that hold the other rows (the mesh dimensions on which
    ``like`` is ``Shard(0)``); a new tensor."""
    from torch.distributed.tensor import Shard

    out = t.clone()
    for i, p in enumerate(like.placements):
        if isinstance(p, Shard):
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=like.device_mesh.get_group(i))
    return out
