"""Serving telemetry of the port: metrics primitives and per-request
lifecycle traces (the part of ``paddle_tpu.observability`` that the
engine uses)."""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry, now
from .tracing import LIFECYCLE_STATES, TERMINAL_STATES, RequestTrace

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "now",
           "RequestTrace", "LIFECYCLE_STATES", "TERMINAL_STATES"]
