"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

The reference jits one update of every parameter and its state; here
:meth:`Optimizer.step` runs eagerly, updating each parameter that has a
gradient and its slots in place under ``torch.no_grad()``: elementwise
torch ops, no kernel of the port's own.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Optimizer"]


def f32(x) -> float:
    """``x`` rounded to float32, as the reference's traced scalars are
    (learning rate, decay coefficient, bias corrections)."""
    return float(np.float32(x))


class Optimizer:
    """``parameters``: tensors, or (name, tensor) pairs as
    ``nn.Module.named_parameters()`` yields them; a parameter without a
    name is ``param_<i>``, as in the reference. ``weight_decay``: None, a
    float or a callable giving one. LR schedulers and gradient clipping
    are not ported (ROADMAP.md Queue 1, item 5) and raise."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters must be provided (dygraph-style "
                             "optimizer)")
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip: nn/clip.py is not ported yet (ROADMAP.md "
                "Queue 1, item 5)")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "LR schedulers (optimizer/lr.py) are not ported yet "
                "(ROADMAP.md Queue 1, item 5)")
        self._names, self._parameter_list = [], []
        for i, p in enumerate(parameters):
            name, p = p if isinstance(p, tuple) else (f"param_{i}", p)
            self._names.append(name)
            self._parameter_list.append(p)
        self._lr = float(learning_rate)
        self._weight_decay = weight_decay
        # per-parameter slot state, keyed by slot name then param index
        self._accumulators: dict[str, list[torch.Tensor]] = {}
        self._global_step = 0

    def get_lr(self) -> float:
        return self._lr

    def set_lr(self, value: float):
        self._lr = float(value)

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- state --------------------------------------------------------------
    def _ensure_state(self):
        """Subclasses create their slots here, once."""

    def _init_slot(self, name: str, like_master: bool = False):
        if name not in self._accumulators:
            self._accumulators[name] = [
                torch.zeros(p.shape, device=p.device,
                            dtype=torch.float32 if like_master else p.dtype)
                for p in self._parameter_list]

    def state_dict(self) -> dict:
        out = {"global_step": self._global_step}
        for slot, arrs in self._accumulators.items():
            for i, a in enumerate(arrs):
                out[f"{slot}_{i}"] = a
        return out

    def set_state_dict(self, state: dict):
        self._ensure_state()
        self._global_step = int(state.get("global_step", 0))
        for slot, arrs in self._accumulators.items():
            for i, a in enumerate(arrs):
                key = f"{slot}_{i}"
                if key in state:
                    with torch.no_grad():
                        a.copy_(torch.as_tensor(state[key]))

    # -- the update ---------------------------------------------------------
    def _decay_coeff_value(self):
        """The weight-decay coefficient of this step, or None."""
        wd = self._weight_decay
        if wd is None:
            return None
        return float(wd()) if callable(wd) else float(wd)

    def _update(self, i, p, g, lr, step, coeff):
        """Update parameter ``i`` (``p``, gradient ``g`` in p's type) and
        its slots in place; ``step`` is the 1-based step of the bias
        corrections."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self):
        """Update every parameter that requires grad and has one, with
        bias corrections at ``_global_step + 1``; then count the step."""
        self._ensure_state()
        todo = [(i, p) for i, p in enumerate(self._parameter_list)
                if p.grad is not None and p.requires_grad]
        lr, coeff = f32(self.get_lr()), self._decay_coeff_value()
        for i, p in todo:
            self._update(i, p, p.grad.to(p.dtype), lr,
                         self._global_step + 1,
                         None if coeff is None else f32(coeff))
        self._global_step += 1
