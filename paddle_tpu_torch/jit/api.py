"""``TrainStep``: the single-device counterpart of
``paddle_tpu/jit/api.py``'s. The reference compiles forward, backward
and the optimizer update into one XLA program with donated buffers;
here the same step runs eagerly (no ``torch.compile``), and the
parameters and optimizer state are updated in place."""

from __future__ import annotations

from typing import Callable

__all__ = ["TrainStep"]


class TrainStep:
    """``step = TrainStep(model, opt, loss_fn); loss = step(x, y)``:
    ``loss_fn(model, *args)`` forward, its backward, ``opt.step()``
    (bias corrections at the optimizer's ``_global_step + 1``), then the
    gradients cleared. Returns the loss, detached; with ``has_aux``
    ``loss_fn`` returns (loss, aux) and the step returns both."""

    def __init__(self, model, optimizer, loss_fn: Callable,
                 has_aux: bool = False):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.has_aux = has_aux

    def __call__(self, *args):
        res = self.loss_fn(self.model, *args)
        loss, aux = res if self.has_aux else (res, None)
        loss.backward()
        self.optimizer.step()
        self.optimizer.clear_grad()
        if self.has_aux:
            return loss.detach(), aux
        return loss.detach()
