r"""Loss contract and parameter injection (counterpart of :mod:`torchebm_tpu.losses.base`).

The JAX package passes the trainable parameters explicitly to every loss
call and differentiates the call with respect to them. Here the parameters
live in the ``nn.Module`` the loss holds, and autograd reaches them through
``loss.backward()``; the call keeps its JAX shape, ``loss(params, x,
generator, ...)``, with ``params=None`` meaning "the module's own". A
functional :class:`~torchebm_tpu_torch.core.WrappedEnergy`
(``fn(params, x)``) still takes a ``params`` value by :func:`inject_params`.
"""

from __future__ import annotations

import copy
from typing import Any

__all__ = ["BaseLoss", "inject_params"]


def inject_params(model: Any, params: Any) -> Any:
    """``model`` with ``params`` swapped in.

    ``params=None`` returns ``model`` itself: the identity for modules,
    which carry their parameters. A wrapper with a ``params`` field gets a
    shallow copy holding ``params``; anything else raises.
    """
    if params is None:
        return model
    if getattr(model, "params", None) is not None:
        out = copy.copy(model)
        out.params = params
        return out
    raise TypeError(
        f"Cannot inject params into {type(model).__name__}: its parameters live in the "
        "module (pass params=None), or wrap a functional fn(params, x) in WrappedEnergy."
    )


class BaseLoss:
    """Loss base contract.

    Call convention::

        loss = loss_fn(params, x, generator, model_kwargs=...)        # stateless
        loss, aux = cd(params, x, generator, state, model_kwargs=...) # stateful (CD)

    ``params=None`` uses the stored model's own parameters.
    """

    def _model(self, params: Any = None):
        return inject_params(self.model, params)

    def __call__(self, params, x, generator, *args, **kwargs):
        raise NotImplementedError
