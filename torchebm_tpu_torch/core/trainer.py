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
- Callbacks: ``on_train_start/end``, ``on_epoch_start/end``,
  ``on_batch_start/end``.

The JAX package's mesh handling (``_param_shardings``, ``_constrain``,
``_align_state_mesh``) comes with the distributed slice.
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
    """

    def __init__(self, loss_fn: Any, optimizer: Callable[..., torch.optim.Optimizer], *,
                 ema_decay: Optional[float] = None, grad_accum_steps: int = 1,
                 callbacks: Iterable[Any] = (), stateful_loss: Optional[bool] = None):
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

    # ------------------------------------------------------------------

    def init_state(self, model: nn.Module, generator: torch.Generator,
                   loss_state: Any = None) -> TrainState:
        """A fresh state training ``model`` (the module the loss's energy
        evaluates), with every random draw from ``generator``."""
        optimizer = self.optimizer(model.parameters())
        ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
               if self.ema_decay is not None else None)
        return TrainState(model=model, optimizer=optimizer, step=0, generator=generator,
                          ema_params=ema, loss_state=loss_state)

    def compute_metrics(self, loss: Tensor, aux: Any, model: nn.Module, x: Tensor,
                        mk) -> Dict[str, Tensor]:
        return {"loss": loss}

    def _loss(self, x: Tensor, generator: torch.Generator, loss_state: Any, mk):
        """``(loss, aux, new_loss_state)`` of one micro-batch."""
        if self.stateful_loss:
            loss, (aux, new_loss_state) = self.loss_fn(None, x, generator, loss_state,
                                                       model_kwargs=mk)
            return loss, aux, new_loss_state
        return self.loss_fn(None, x, generator, model_kwargs=mk), None, loss_state

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
        in place; returns ``(state, metrics)`` with device-resident metrics."""
        x, mk = _split_batch(batch)
        loss, aux, new_loss_state = self._loss(x, state.generator, state.loss_state, mk)
        loss.backward()
        self._optimizer_step(state)
        if self.ema_decay is not None:
            update_ema(state.ema_params, state.params, self.ema_decay)
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

    def save(self, state: TrainState, ckpt_dir: str) -> str:
        """Write the whole state (parameters, optimizer, EMA, step, generator
        state, loss state, pending accumulation) as a step-numbered checkpoint."""
        return save_checkpoint(
            ckpt_dir, state.step, {n: p.detach() for n, p in state.params.items()},
            ema_params=state.ema_params, opt_state=state.optimizer.state_dict(),
            extra={"generator": state.generator.get_state(),
                   "loss_state": _loss_state_tree(state.loss_state),
                   "accum_count": state.accum_count},
        )

    def restore(self, ckpt_dir: str, template: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load a checkpoint into ``template`` (a state from :meth:`init_state`
        of the same shapes) and return it; ``step=None`` takes the latest.
        The loss state keeps the template's type (a replay buffer stays one)."""
        device = next(template.model.parameters()).device
        payload = load_checkpoint(ckpt_dir, step, map_location=device)
        with torch.no_grad():
            for name, p in template.model.named_parameters():
                p.copy_(payload["params"][name])
        template.optimizer.load_state_dict(payload["opt_state"])
        if template.ema_params is not None:
            template.ema_params = {n: t.clone() for n, t in payload["ema_params"].items()}
        extra = payload["extra"]
        template.generator.set_state(extra["generator"].cpu())
        loss_state = extra["loss_state"]
        if dataclasses.is_dataclass(template.loss_state):
            loss_state = type(template.loss_state)(**loss_state)
        template.loss_state = loss_state
        template.accum_count = int(extra["accum_count"])
        template.step = int(payload["step"])
        return template

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
