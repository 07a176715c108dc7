"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

The port grows slice by slice beside the JAX package, which stays the
reference. It holds two paths, each on hand-written CUDA kernels for
Hopper (``kernels/csrc/``):

- paged Llama serving: ``inference.serving.DecodeEngine`` over a
  block-pool KV cache, with the prefix cache, the priority scheduler,
  int8 KV, chunked prefill and self-speculative decoding; its decode
  attention runs on ``paged_decode.cu`` (``paged_decode_int8.cu`` for
  int8 pools). On a tensor-parallel mesh (``inference.sharding``) each
  step's prefill chunks, verify windows and decode tokens go through
  one mixed step whose attention runs on ``mixed_paged.cu``;
- Llama pretraining on one card: ``models.llama.LlamaForCausalLM`` and
  ``llama_loss_fn``, ``optimizer.AdamW`` (fp32 master weights) and
  ``jit.TrainStep``, with causal attention on the FlashAttention-2
  forward, dQ and dK/dV kernels (``flash_fwd.cu``, ``flash_bwd.cu``)
  and layer recompute.

Importing this package does no work: it imports no torch, builds no
kernel, probes no device and allocates nothing. Kernels build on their
first launch on a CUDA tensor.
"""

from __future__ import annotations

__all__ = ["DEFAULT_DEVICE", "__version__", "seed"]

__version__ = "0.1.0"

#: Device every entry point uses unless the caller names another one.
#: There is no silent CPU fallback: pass ``device="cpu"`` to run the
#: plain PyTorch versions of the kernels.
DEFAULT_DEVICE = "cuda"


def seed(value: int, device=DEFAULT_DEVICE):
    """A ``torch.Generator`` on ``device`` seeded with ``value``.

    The port threads explicit generators through every random draw
    (model initialisation, sampling) instead of seeding global state."""
    import torch
    return torch.Generator(device=device).manual_seed(int(value))
