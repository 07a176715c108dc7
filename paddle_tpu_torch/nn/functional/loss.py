"""Losses (counterpart of ``paddle_tpu/nn/functional/loss.py``)."""

from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross entropy against hard labels, as the reference
    computes it: bf16 and fp16 logits go up to f32 first; a label equal
    to ``ignore_index`` scores 0; the "mean" is over the labels kept,
    divided by max(count, 1). ``reduction`` is "mean", "sum" or "none".
    Soft labels, class weights, label smoothing and ``use_softmax=False``
    are not ported (ROADMAP.md Queue 1, item 7) and raise."""
    if soft_label or weight is not None or label_smoothing \
            or not use_softmax:
        raise NotImplementedError(
            "cross_entropy: only hard labels with softmax are ported "
            "(ROADMAP.md Queue 1, item 7)")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    logits = input
    if logits.dtype in (torch.bfloat16, torch.float16):
        logits = logits.float()
    logp = torch.log_softmax(logits, dim=axis).movedim(axis, -1)
    ids = label.long()
    if ids.dim() == logp.dim():
        ids = ids.squeeze(axis)
    valid = ids != ignore_index
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    picked = logp.gather(-1, safe[..., None])[..., 0]
    out = torch.where(valid, -picked, torch.zeros_like(picked))
    if reduction == "mean":
        return out.sum() / torch.clamp(valid.sum().to(out.dtype), min=1.0)
    if reduction == "sum":
        return out.sum()
    return out
