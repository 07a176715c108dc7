"""Thread-safe metrics primitives and their registry, in the Prometheus
data model (Counter / Gauge / Histogram) and free of dependencies.

- one lock per metric, no allocation on the observe path;
- a ``Gauge`` may read a callback at collection time (``fn=``), so a
  value such as allocator occupancy has one source of truth;
- a ``Histogram`` has fixed log-spaced latency buckets (powers of two
  from 0.1 ms to about 100 s), ``le`` inclusive, counts cumulated only
  when they are read.
"""

from __future__ import annotations

import logging
import threading
import time
from bisect import bisect_left

from ..utils.log import get_logger, log_kv

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "now",
           "DEFAULT_LATENCY_BUCKETS"]

_log = get_logger("paddle_tpu_torch.observability.metrics")

#: the monotonic clock every telemetry call site shares
now = time.perf_counter

# 0.1 ms .. ~104.8 s in powers of two: 21 edges + implicit +Inf.
DEFAULT_LATENCY_BUCKETS = tuple(1e-4 * 2 ** i for i in range(21))


class Counter:
    """Monotonically increasing float counter."""

    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"Counter {self.name}: inc({v}) < 0")
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value: set(), or a read-time callback (``fn``) for
    a value another object owns."""

    __slots__ = ("name", "help", "_value", "_fn", "_lock")

    def __init__(self, name: str, help: str = "", fn=None):
        self.name = name
        self.help = help
        self._value = 0.0
        self._fn = fn
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def bind(self, fn) -> None:
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception as e:  # noqa: BLE001 — collection must
                # not throw; NaN is the sentinel scrapers expect
                log_kv(_log, "gauge_callback_failed",
                       level=logging.DEBUG, gauge=self.name,
                       error=type(e).__name__, detail=str(e))
                return float("nan")
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram; per-bucket counts are stored
    non-cumulative and cumulated only when read."""

    __slots__ = ("name", "help", "buckets", "_counts", "_overflow",
                 "_sum", "_count", "_min", "_max", "_lock")

    def __init__(self, name: str, help: str = "", buckets=None):
        self.name = name
        self.help = help
        edges = tuple(float(b) for b in
                      (buckets if buckets is not None
                       else DEFAULT_LATENCY_BUCKETS))
        if list(edges) != sorted(edges) or len(set(edges)) != len(edges):
            raise ValueError(
                f"Histogram {name}: bucket edges must be strictly "
                f"increasing, got {edges}")
        self.buckets = edges
        self._counts = [0] * len(edges)
        self._overflow = 0
        self._sum = 0.0
        self._count = 0
        self._min = None
        self._max = None
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect_left(self.buckets, v)    # le is inclusive
        with self._lock:
            if i < len(self._counts):
                self._counts[i] += 1
            else:
                self._overflow += 1
            self._sum += v
            self._count += 1
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def cumulative(self) -> list[tuple[float, int]]:
        """[(le, cumulative_count), ..., (inf, count)]."""
        with self._lock:
            out, acc = [], 0
            for le, c in zip(self.buckets, self._counts):
                acc += c
                out.append((le, acc))
            out.append((float("inf"), acc + self._overflow))
            return out

    def quantile(self, q: float) -> float:
        """Upper edge of the bucket holding the q-th observation (the
        observed max caps the +Inf bucket); 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile({q})")
        cum = self.cumulative()
        total = cum[-1][1]
        if total == 0:
            return 0.0
        rank = q * total
        for le, acc in cum:
            if acc >= rank:
                if le == float("inf"):
                    return self._max if self._max is not None else 0.0
                return le
        return self._max if self._max is not None else 0.0

    def summary(self) -> dict:
        with self._lock:
            mn, mx, s, n = self._min, self._max, self._sum, self._count
        return {"count": n, "sum": s, "min": mn, "max": mx,
                "p50": self.quantile(0.5), "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Name -> metric map with get-or-create accessors and a JSON-able
    snapshot. Each engine owns a private registry by default."""

    def __init__(self):
        self._metrics: dict[str, object] = {}   # guarded-by: _lock
        self._lock = threading.Lock()

    def _get_or_create(self, name, cls, *args, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help)

    def gauge(self, name: str, help: str = "", fn=None) -> Gauge:
        g = self._get_or_create(name, Gauge, help)
        if fn is not None:
            g.bind(fn)
        return g

    def histogram(self, name: str, help: str = "",
                  buckets=None) -> Histogram:
        return self._get_or_create(name, Histogram, help, buckets)

    def snapshot(self) -> dict:
        """Counters and gauges as scalars, histograms as summaries with
        cumulative bucket counts."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            items = sorted(self._metrics.items())
        for name, m in items:
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            elif isinstance(m, Histogram):
                h = m.summary()
                h["buckets"] = {("+Inf" if le == float("inf")
                                 else format(le, "g")): c
                                for le, c in m.cumulative()}
                out["histograms"][name] = h
        return out
