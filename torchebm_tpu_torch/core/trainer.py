r"""Generic training loop and the CD trainer (counterpart of
:mod:`torchebm_tpu.core.trainer`).

A :class:`TrainState` holds everything a run needs to resume: the module
whose parameters train, its optimizer, the step, the generator every random
draw comes from, an EMA copy of the parameters and the loss's own state (the
PCD replay buffer). The JAX package's state is an immutable pytree that its
jitted step replaces; here ``train_step`` updates the state in place (the
parameters by the optimizer, the buffer by its ring write) and returns it, so
``state, metrics = trainer.train_step(state, batch)`` reads the same.

- The optimizer is any ``torch.optim`` class or factory taking the
  parameters: ``ContrastiveDivergenceTrainer`` builds ``torch.optim.Adam``,
  whose defaults equal ``optax.adam``'s.
- ``grad_accum_steps = k`` sums the gradients of k micro-batches and applies
  their mean in one optimizer step, as ``optax.MultiSteps`` does; the
  parameters stay put in between.
- Metrics stay on the device per step and are reduced once per epoch.
- ``cuda_graph=True`` replays each micro-batch's loss and gradients from a
  pair of CUDA graphs (:class:`_GraphedStep`) where they apply: a large
  model at a small batch otherwise leaves the card waiting on the host's
  thousands of launches a step. The optimizer and the EMA run as they are.
- Callbacks: ``on_train_start/end``, ``on_epoch_start/end``,
  ``on_batch_start/end``.

Mesh handling, for a model sharded by
:func:`~torchebm_tpu_torch.parallel.fsdp_shard_params` (FSDP2, DTensor
parameters) before :meth:`BaseTrainer.init_state` and batches sharded on
their rows (:func:`~torchebm_tpu_torch.parallel.shard_batch`):

- ``init_state`` puts the DTensor parameters and the plain ones (FSDP2's
  replicated ``ignored_params``) in two parameter groups of the optimizer,
  since a multi-tensor update takes no mix of the two;
- ``_param_shardings`` records each parameter's placements before a step and
  ``_constrain`` holds the parameters and the EMA copy to them after the
  optimizer and EMA updates (an EMA entry is redistributed where needed);
- the gradients of the parameters that are not DTensors are averaged over
  the processes that hold other rows of a sharded batch (over the
  parameters' mesh when the batch is not sharded): FSDP2 reduces only its
  own;
- a state holding DTensors is saved and restored through
  ``torch.distributed.checkpoint``, each process writing its own shards and
  a restore landing on the template's placements; ``_align_state_mesh``
  then gives every process rank 0's step and generator state, and places an
  EMA entry that is not a DTensor onto its parameter's placements.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from ..losses.contrastive_divergence import ContrastiveDivergence
from ..parallel.mesh import is_dtensor, row_shards, sum_over_rows
from ..parallel.shim import broadcast_object, psum_mean
from ..utils.profiling import count, span
from ..utils.training import latest_checkpoint_step, load_checkpoint, save_checkpoint, update_ema

Tensor = torch.Tensor

__all__ = ["TrainState", "BaseTrainer", "ContrastiveDivergenceTrainer"]

logger = logging.getLogger(__name__)


@dataclass(eq=False)
class TrainState:
    """Everything a training run needs to resume."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator
    ema_params: Optional[Dict[str, Tensor]] = None
    loss_state: Any = None  # e.g. the PCD ReplayBuffer
    #: micro-batches whose gradients wait for the next optimizer step
    accum_count: int = 0

    @property
    def params(self) -> Dict[str, Tensor]:
        """The trained parameters by name (the module's own tensors)."""
        return dict(self.model.named_parameters())


def _split_batch(batch) -> Tuple[Tensor, Dict[str, Any]]:
    """Accepts ``x`` / ``(x, cond_dict)`` / ``{"data": x, **cond}`` batches."""
    if isinstance(batch, dict):
        if "data" not in batch:
            raise ValueError("Dict batches must contain a 'data' key.")
        return batch["data"], {k: v for k, v in batch.items() if k != "data"}
    if isinstance(batch, (tuple, list)):
        if len(batch) != 2 or not isinstance(batch[1], dict):
            raise ValueError("Tuple batches must be (data, cond_dict).")
        return batch[0], dict(batch[1])
    return batch, {}


def _unstack(batches, i: int):
    """Step ``i`` of a stacked epoch (every tensor indexed on its leading axis)."""
    if isinstance(batches, dict):
        return {k: _unstack(v, i) for k, v in batches.items()}
    if isinstance(batches, (tuple, list)):
        return type(batches)(_unstack(v, i) for v in batches)
    return batches[i]


def _leading(batches) -> int:
    if isinstance(batches, dict):
        return _leading(next(iter(batches.values())))
    if isinstance(batches, (tuple, list)):
        return _leading(batches[0])
    return batches.shape[0]


class _GraphedStep:
    """The loss of one micro-batch and its parameters' gradients, replayed
    from a pair of CUDA graphs: the forward, then the backward, captured at
    the first step with each key and replayed in order on the current
    stream, with the batch copied into the captured inputs first. The key
    holds the batch's shapes, dtypes and device, the module's ``training``,
    each parameter's storage and ``requires_grad`` and the generator, so a
    replaced parameter (``module.to``, a restore that assigns) or another
    generator captures anew. The draws come from the generator as an eager
    step would take them, each replay advancing it as much.

    The captured loss and gradients live in the graphs' memory and are
    overwritten by the next replay: :meth:`forward` returns a copy of the
    loss, and :meth:`backward` hands the gradients to the parameters as
    their ``.grad`` (a copy, or added to one already there, when gradients
    accumulate), which the optimizer consumes before the next replay."""

    #: eager passes on the capture stream before a capture (cuBLAS and
    #: autograd set themselves up outside the graph)
    WARMUP = 3

    def __init__(self):
        self.release()

    def release(self) -> None:
        """Drop the graphs and what lives in their memory."""
        self.key = self.generator = self.graphs = None
        self.x = self.mk = self.loss = self.grads = self.params = None

    @staticmethod
    def _key(model: nn.Module, params: Dict[str, Tensor], x: Tensor,
             mk: Dict[str, Tensor]) -> tuple:
        return ((x.shape, x.dtype, x.device),
                tuple((k, v.shape, v.dtype, v.device) for k, v in sorted(mk.items())),
                model.training,
                tuple((p.data_ptr(), p.requires_grad) for p in params.values()))

    def _capture(self, loss_of, params: Dict[str, Tensor], x: Tensor, mk: Dict[str, Tensor],
                 generator: torch.Generator) -> None:
        if self.graphs is not None:
            self.release()
            torch.cuda.empty_cache()
        device = x.device
        self.params = [p for p in params.values() if p.requires_grad]
        self.x, self.mk = x.detach().clone(), {k: v.detach().clone() for k, v in mk.items()}
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        scratch = torch.Generator(device).manual_seed(0)
        with torch.cuda.stream(stream):
            for _ in range(self.WARMUP):
                torch.autograd.grad(loss_of(self.x, scratch, self.mk), self.params,
                                    allow_unused=True)
        torch.cuda.current_stream(device).wait_stream(stream)
        forward, backward = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        if generator is not torch.cuda.default_generators[device.index]:
            forward.register_generator_state(generator)  # the default one is already
        with torch.cuda.graph(forward, stream=stream):
            self.loss = loss_of(self.x, generator, self.mk)
        with torch.cuda.graph(backward, pool=forward.pool(), stream=stream):
            self.grads = torch.autograd.grad(self.loss, self.params, allow_unused=True)
        self.graphs = (forward, backward)
        self.generator = generator

    def forward(self, loss_of, model: nn.Module, params: Dict[str, Tensor], x: Tensor,
                mk: Dict[str, Tensor], generator: torch.Generator) -> Tensor:
        """The micro-batch's loss (a copy), capturing first where the key
        or the generator changed; ``params`` are ``model``'s, by name."""
        key = self._key(model, params, x, mk)
        if key != self.key or generator is not self.generator:
            self._capture(loss_of, params, x, mk, generator)
            self.key = key
        self.x.copy_(x)
        for k, v in mk.items():
            self.mk[k].copy_(v)
        self.graphs[0].replay()
        return self.loss.detach().clone()

    def backward(self, accumulating: bool) -> None:
        """The gradients of the last :meth:`forward`, into each parameter's
        ``.grad``."""
        self.graphs[1].replay()
        with torch.no_grad():
            for p, g in zip(self.params, self.grads):
                if g is None:
                    continue
                if p.grad is not None:
                    p.grad.add_(g)
                else:
                    p.grad = g.clone() if accumulating else g


def _loss_state_tree(loss_state: Any) -> Any:
    """A dataclass loss state (the replay buffer) as a plain dict, for the
    checkpoint; anything else as it is."""
    if dataclasses.is_dataclass(loss_state):
        return {f.name: getattr(loss_state, f.name) for f in dataclasses.fields(loss_state)}
    return loss_state


class BaseTrainer:
    """Generic loop around ``loss(params, x, generator, [state], model_kwargs=...)``.

    Args:
        loss_fn: A :class:`~torchebm_tpu_torch.losses.base.BaseLoss` (stateful
            losses like PCD return ``(loss, (aux, new_state))``) or any
            callable with the same signature; it is called with
            ``params=None``, its model's parameters being the trained module's.
        optimizer: ``torch.optim`` class or factory: ``optimizer(parameters)``
            builds the optimizer, e.g. ``functools.partial(torch.optim.Adam, lr=1e-3)``.
        ema_decay: Keep an EMA copy of the parameters when set.
        grad_accum_steps: Apply the mean gradient of this many micro-batches.
        callbacks: Objects with any of ``on_{train,epoch,batch}_{start,end}``.
        cuda_graph: Replay each micro-batch's loss and gradients from CUDA
            graphs (:class:`_GraphedStep`) where that applies: a loss without
            state, on a batch and model kwargs of CUDA tensors, parameters
            that are not DTensors and a CUDA generator. Elsewhere the step
            runs eagerly. The loss must make no host read (a capture raises
            on one), and its metrics are the loss alone.
    """

    def __init__(self, loss_fn: Any, optimizer: Callable[..., torch.optim.Optimizer], *,
                 ema_decay: Optional[float] = None, grad_accum_steps: int = 1,
                 callbacks: Iterable[Any] = (), stateful_loss: Optional[bool] = None,
                 cuda_graph: bool = False):
        if grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.ema_decay = ema_decay
        self.grad_accum_steps = int(grad_accum_steps)
        self.callbacks = list(callbacks)
        if stateful_loss is None:
            stateful_loss = isinstance(loss_fn, ContrastiveDivergence)
        self.stateful_loss = stateful_loss
        self.cuda_graph = bool(cuda_graph)
        self._graphed = _GraphedStep() if cuda_graph else None

    # ------------------------------------------------------------------

    def init_state(self, model: nn.Module, generator: torch.Generator,
                   loss_state: Any = None) -> TrainState:
        """A fresh state training ``model`` (the module the loss's energy
        evaluates), with every random draw from ``generator``. A model
        sharded by FSDP2 must be sharded before this call."""
        params = list(model.parameters())
        sharded = [p for p in params if is_dtensor(p)]
        if sharded and len(sharded) < len(params):
            groups = [{"params": sharded}, {"params": [p for p in params if not is_dtensor(p)]}]
            optimizer = self.optimizer(groups)
        else:
            optimizer = self.optimizer(params)
        ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
               if self.ema_decay is not None else None)
        return TrainState(model=model, optimizer=optimizer, step=0, generator=generator,
                          ema_params=ema, loss_state=loss_state)

    def compute_metrics(self, loss: Tensor, aux: Any, model: nn.Module, x: Tensor,
                        mk) -> Dict[str, Tensor]:
        return {"loss": loss}

    # ------------------------------------------------------------ mesh

    @staticmethod
    def _param_shardings(params: Dict[str, Tensor]) -> Optional[Dict[str, tuple]]:
        """``{name: placements}`` of the DTensor entries of ``params``, or
        None when none is a DTensor."""
        shardings = {n: tuple(p.placements) for n, p in params.items() if is_dtensor(p)}
        return shardings or None

    @staticmethod
    def _constrain(params: Dict[str, Tensor],
                   shardings: Optional[Dict[str, tuple]]) -> Dict[str, Tensor]:
        """``params`` with every recorded entry on its recorded placements
        (redistributed where it moved); raises if one is no DTensor now."""
        if shardings is None:
            return params
        out = dict(params)
        for name, placements in shardings.items():
            t = params[name]
            if not is_dtensor(t):
                raise RuntimeError(f"{name} lost its placements {placements}")
            if tuple(t.placements) != placements:
                out[name] = t.redistribute(t.device_mesh, placements)
        return out

    @staticmethod
    def _mean_replicated_grads(model: nn.Module, x) -> None:
        """Average the gradients of the parameters that are not DTensors over
        the processes holding other rows of the sharded batch ``x``, or over
        the whole mesh of the DTensor parameters when ``x`` is not sharded."""
        plain = [p for p in model.parameters() if p.grad is not None and not is_dtensor(p)]
        if not plain:
            return
        if is_dtensor(x):
            for p in plain:
                p.grad = sum_over_rows(p.grad, x) / row_shards(x)
            return
        mesh = next(p.device_mesh for p in model.parameters() if is_dtensor(p))
        for p in plain:
            g = p.grad
            for axis in mesh.mesh_dim_names:
                g = psum_mean(g, axis, mesh=mesh)
            p.grad = g

    @staticmethod
    def _align_state_mesh(state: TrainState) -> TrainState:
        """After a restore: rank 0's step, pending accumulation and generator
        state on every process, and each EMA entry that is not a DTensor
        placed as its parameter is."""
        step, accum, gen = broadcast_object(
            (state.step, state.accum_count, state.generator.get_state()))
        state.step, state.accum_count = int(step), int(accum)
        state.generator.set_state(gen)
        if state.ema_params is not None:
            from torch.distributed.tensor import distribute_tensor

            params = state.params
            for name, e in state.ema_params.items():
                p = params[name]
                if is_dtensor(p) and not is_dtensor(e):
                    state.ema_params[name] = distribute_tensor(e, p.device_mesh, p.placements)
        return state

    def _loss(self, x: Tensor, generator: torch.Generator, loss_state: Any, mk):
        """``(loss, aux, new_loss_state)`` of one micro-batch."""
        if self.stateful_loss:
            loss, (aux, new_loss_state) = self.loss_fn(None, x, generator, loss_state,
                                                       model_kwargs=mk)
            return loss, aux, new_loss_state
        return self.loss_fn(None, x, generator, model_kwargs=mk), None, loss_state

    def _graph_applies(self, state: TrainState, x, mk, shardings) -> bool:
        """Whether the step replays from CUDA graphs; ``shardings`` is None
        where no parameter is a DTensor."""
        return (self._graphed is not None and shardings is None and not self.stateful_loss
                and isinstance(x, Tensor) and x.is_cuda and not is_dtensor(x)
                and state.generator.device.type == "cuda" and torch.is_grad_enabled()
                and all(isinstance(v, Tensor) and v.is_cuda for v in mk.values())
                and hasattr(torch.cuda.CUDAGraph, "register_generator_state"))

    def _optimizer_step(self, state: TrainState) -> None:
        """Apply the mean of the accumulated gradients every
        ``grad_accum_steps`` micro-batches."""
        state.accum_count += 1
        if state.accum_count < self.grad_accum_steps:
            return
        if self.grad_accum_steps > 1:
            for p in state.model.parameters():
                if p.grad is not None:
                    p.grad.div_(self.grad_accum_steps)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.accum_count = 0

    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, Tensor]]:
        """One optimisation step (or one micro-batch of an accumulated one),
        in place; returns ``(state, metrics)`` with device-resident metrics.

        The step is the span ``trainer.train_step``, its phases
        ``trainer.forward`` (the loss), ``trainer.backward`` (the gradients)
        and ``trainer.optimizer`` (the update, the EMA and the metrics), each
        timed on the batch's CUDA device as well
        (:func:`~torchebm_tpu_torch.utils.profiling.span`)."""
        with span("trainer.train_step"):
            x, mk = _split_batch(batch)
            device = x.device
            # one walk of the module a step: the card waits for the host here
            params = state.params
            shardings = self._param_shardings(params)
            graphed = self._graph_applies(state, x, mk, shardings)
            with span("trainer.forward", device):
                if graphed:
                    loss = self._graphed.forward(
                        lambda x_, g, mk_: self._loss(x_, g, None, mk_)[0], state.model, params,
                        x, mk, state.generator)
                    aux, new_loss_state = None, state.loss_state
                else:
                    loss, aux, new_loss_state = self._loss(x, state.generator, state.loss_state,
                                                           mk)
            with span("trainer.backward", device):
                if graphed:
                    self._graphed.backward(self.grad_accum_steps > 1)
                else:
                    loss.backward()
                if shardings is not None or is_dtensor(x):
                    self._mean_replicated_grads(state.model, x)
            with span("trainer.optimizer", device):
                self._optimizer_step(state)
                params = self._constrain(state.params, shardings)
                if any(params[n] is not p for n, p in state.params.items()):
                    raise RuntimeError("the optimizer step moved a parameter off its placements")
                if self.ema_decay is not None:
                    update_ema(state.ema_params, params, self.ema_decay)
                    state.ema_params = self._constrain(state.ema_params, shardings)
                with torch.no_grad():
                    metrics = self.compute_metrics(loss.detach(), aux, state.model, x, mk)
            state.loss_state = new_loss_state
            state.step += 1
        return state, metrics

    # ------------------------------------------------------------------

    def _fire(self, hook: str, *args):
        for cb in self.callbacks:
            fn = getattr(cb, hook, None)
            if fn is not None:
                fn(self, *args)

    @staticmethod
    def _reduce(accum: Dict[str, list]) -> Dict[str, float]:
        """Host means of the per-step metrics: one transfer per epoch."""
        if not accum:
            return {}
        means = torch.stack([torch.stack(v).float().mean() for v in accum.values()])
        count("host_reads")
        return dict(zip(accum, means.tolist()))

    def train_epoch(self, state: TrainState,
                    batches: Iterable[Any]) -> Tuple[TrainState, Dict[str, float]]:
        """One pass over ``batches``; returns host-side mean metrics."""
        self._fire("on_epoch_start", state)
        accum: Dict[str, list] = {}
        for batch in batches:
            self._fire("on_batch_start", state, batch)
            state, metrics = self.train_step(state, batch)
            for k, v in metrics.items():
                accum.setdefault(k, []).append(v)
            self._fire("on_batch_end", state, metrics)
        reduced = self._reduce(accum)
        logger.info("epoch done (step=%d): %s", state.step, reduced)
        self._fire("on_epoch_end", state, reduced)
        return state, reduced

    def train_epoch_scanned(self, state: TrainState,
                            batches) -> Tuple[TrainState, Dict[str, float]]:
        """One pass over a STACKED epoch: every tensor of ``batches`` carries a
        leading steps axis (``x`` of shape ``(n_steps, batch, *event)``, or the
        tuple or dict batch forms stacked the same way, see
        :func:`~torchebm_tpu_torch.utils.stack_batches`). The same steps as
        :meth:`train_epoch` over the unstacked batches, with the same draws
        and metrics; per-batch callbacks do not fire, epoch-level ones do."""
        self._fire("on_epoch_start", state)
        accum: Dict[str, list] = {}
        for i in range(_leading(batches)):
            state, metrics = self.train_step(state, _unstack(batches, i))
            for k, v in metrics.items():
                accum.setdefault(k, []).append(v)
        reduced = self._reduce(accum)
        logger.info("epoch done (step=%d): %s", state.step, reduced)
        self._fire("on_epoch_end", state, reduced)
        return state, reduced

    def train(self, state: TrainState, epochs: int,
              batch_iter_fn: Callable[[int], Iterable[Any]], *,
              ckpt_dir: Optional[str] = None,
              ckpt_every_epochs: int = 1) -> Tuple[TrainState, list]:
        """Multi-epoch driver: ``batch_iter_fn(epoch)`` yields an epoch's
        batches; with ``ckpt_dir`` a checkpoint is written every
        ``ckpt_every_epochs`` epochs and after the last."""
        self._fire("on_train_start", state)
        history = []
        for epoch in range(epochs):
            state, metrics = self.train_epoch(state, batch_iter_fn(epoch))
            history.append(metrics)
            if ckpt_dir is not None and (
                (epoch + 1) % max(ckpt_every_epochs, 1) == 0 or epoch == epochs - 1
            ):
                self.save(state, ckpt_dir)
        self._fire("on_train_end", state, history)
        return state, history

    # ------------------------------------------------------- checkpointing

    @staticmethod
    def _sharded(state: TrainState) -> bool:
        """Whether the state holds DTensors (parameters, or a sharded buffer)."""
        tree = _loss_state_tree(state.loss_state)
        leaves = tree.values() if isinstance(tree, dict) else (tree,)
        return any(is_dtensor(p) for p in state.model.parameters()) or any(
            is_dtensor(t) for t in leaves)

    @staticmethod
    def _payload(state: TrainState, sharded: bool) -> Tuple[Dict[str, Any], Any]:
        """``(params, opt_state)`` of ``state``: FQN-keyed state dicts of
        ``torch.distributed.checkpoint`` when ``sharded``."""
        if sharded:
            from torch.distributed.checkpoint.state_dict import get_state_dict

            return get_state_dict(state.model, state.optimizer)
        return ({n: p.detach() for n, p in state.params.items()},
                state.optimizer.state_dict())

    def save(self, state: TrainState, ckpt_dir: str) -> str:
        """Write the whole state (parameters, optimizer, EMA, step, generator
        state, loss state, pending accumulation) as a step-numbered checkpoint:
        a sharded state through ``torch.distributed.checkpoint`` (each process
        its own shards), any other as one file (written by rank 0)."""
        params, opt_state = self._payload(state, self._sharded(state))
        return save_checkpoint(
            ckpt_dir, state.step, params, ema_params=state.ema_params, opt_state=opt_state,
            extra={"generator": state.generator.get_state(),
                   "loss_state": _loss_state_tree(state.loss_state),
                   "accum_count": state.accum_count},
        )

    def restore(self, ckpt_dir: str, template: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load a checkpoint into ``template`` (a state from :meth:`init_state`
        of the same shapes, sharded as the saved one was) and return it;
        ``step=None`` takes the latest. The loss state keeps the template's
        type (a replay buffer stays one). A sharded checkpoint lands on the
        template's placements."""
        if self._sharded(template):
            return self._restore_sharded(ckpt_dir, template, step)
        device = next(template.model.parameters()).device
        payload = load_checkpoint(ckpt_dir, step, map_location=device)
        with torch.no_grad():
            for name, p in template.model.named_parameters():
                p.copy_(payload["params"][name])
        template.optimizer.load_state_dict(payload["opt_state"])
        if template.ema_params is not None:
            template.ema_params = {n: t.clone() for n, t in payload["ema_params"].items()}
        self._restore_extra(template, payload)
        return template

    @staticmethod
    def _restore_extra(template: TrainState, payload: Dict[str, Any]) -> None:
        extra = payload["extra"]
        template.generator.set_state(extra["generator"].cpu())
        loss_state = extra["loss_state"]
        if dataclasses.is_dataclass(template.loss_state):
            loss_state = type(template.loss_state)(**loss_state)
        template.loss_state = loss_state
        template.accum_count = int(extra["accum_count"])
        template.step = int(payload["step"])

    def _restore_sharded(self, ckpt_dir: str, template: TrainState,
                         step: Optional[int]) -> TrainState:
        """:meth:`restore` of a ``torch.distributed.checkpoint`` checkpoint,
        read in place into the template's tensors (its EMA copy included)."""
        from torch.distributed.checkpoint.state_dict import set_state_dict

        params, opt_state = self._payload(template, True)
        payload = {"step": 0, "params": params, "opt_state": opt_state,
                   "extra": {"generator": template.generator.get_state(),
                             "loss_state": _loss_state_tree(template.loss_state),
                             "accum_count": 0}}
        if template.ema_params is not None:
            payload["ema_params"] = template.ema_params
        payload = load_checkpoint(ckpt_dir, step, template=payload)
        set_state_dict(template.model, template.optimizer,
                       model_state_dict=payload["params"], optim_state_dict=payload["opt_state"])
        self._restore_extra(template, payload)
        return self._align_state_mesh(template)

    def restore_or_init(self, ckpt_dir: str, model: nn.Module, generator: torch.Generator,
                        loss_state: Any = None) -> TrainState:
        """Resume from the latest checkpoint under ``ckpt_dir`` if there is
        one, else a fresh state: the preemption-safe entry point."""
        template = self.init_state(model, generator, loss_state)
        if latest_checkpoint_step(ckpt_dir) is None:
            return template
        return self.restore(ckpt_dir, template)


class ContrastiveDivergenceTrainer(BaseTrainer):
    """CD/PCD trainer: Adam at ``learning_rate`` by default, around a
    :class:`~torchebm_tpu_torch.losses.ContrastiveDivergence` loss, logging the
    mean energies of the data and of the negatives beside the loss.

    Those energies are the loss's own, at the parameters the step's gradient
    was taken at, so logging costs no forward pass; the JAX package evaluates
    the model once more, on the updated parameters, inside its jitted step."""

    def __init__(self, cd_loss: ContrastiveDivergence, learning_rate: float = 1e-3,
                 optimizer: Optional[Callable[..., torch.optim.Optimizer]] = None, **kwargs):
        if optimizer is None:
            optimizer = functools.partial(torch.optim.Adam, lr=learning_rate)
        super().__init__(cd_loss, optimizer, stateful_loss=True, **kwargs)

    def init_state(self, model: nn.Module, generator: torch.Generator,
                   loss_state: Any = None) -> TrainState:
        if loss_state is None and self.loss_fn.persistent:
            raise ValueError(
                "Persistent CD needs a ReplayBuffer: pass "
                "loss_state=cd.init_buffer(generator, data_shape)."
            )
        return super().init_state(model, generator, loss_state)

    def _loss(self, x: Tensor, generator: torch.Generator, loss_state: Any, mk):
        loss, (_, new_loss_state), energies = self.loss_fn.loss_and_energies(
            None, x, generator, loss_state, model_kwargs=mk)
        return loss, energies, new_loss_state

    def compute_metrics(self, loss, aux, model, x, mk):
        return {"loss": loss, **aux}
