"""Load a JAX ``paddle_tpu`` Llama ``state_dict`` into the port.

The reference's ``LlamaForCausalLM.state_dict()`` names its stacked
decoder parameters bare (``wq``, ``w_gate``, ...); the port keeps them
under ``layers.<name>``. Either spelling is accepted here. Arrays cross
as numpy, so nothing of JAX is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from . import DEFAULT_DEVICE
from .models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["from_jax_state_dict"]


def from_jax_state_dict(state: dict, config: LlamaConfig | str,
                        device=DEFAULT_DEVICE, dtype=None, trainable=False):
    """A :class:`LlamaForCausalLM` on ``device`` holding the arrays of
    ``state`` (name -> numpy array), cast to ``dtype`` (default: the
    configuration's). Its parameters require grad only with
    ``trainable`` (for serving they need not). Raises ``KeyError`` for a
    missing or unknown name and ``ValueError`` for a shape that does not
    match."""
    model = LlamaForCausalLM(config, dtype=dtype, device="meta")
    want = dict(model.named_parameters())
    given = {}
    for name, arr in state.items():
        key = name if name in want else f"layers.{name}"
        if key not in want:
            raise KeyError(f"unknown parameter {name!r}")
        given[key] = np.asarray(arr)
    missing = sorted(set(want) - set(given))
    if missing:
        raise KeyError(f"missing parameters: {missing}")
    tensors = {}
    for key, arr in given.items():
        p = want[key]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(p.shape)}")
        tensors[key] = torch.from_numpy(
            np.array(arr, dtype=np.float32)).to(
            device=device, dtype=p.dtype)
    model.load_state_dict(tensors, assign=True)
    for p in model.parameters():
        p.requires_grad_(trainable)
    return model
