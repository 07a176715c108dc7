"""Training-step driver of the port (counterpart of ``paddle_tpu.jit``)."""

from .api import TrainStep

__all__ = ["TrainStep"]
