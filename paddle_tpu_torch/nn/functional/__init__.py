"""Functional ops of the port (counterpart of
``paddle_tpu.nn.functional``)."""

from .loss import cross_entropy

__all__ = ["cross_entropy"]
