"""Per-request lifecycle tracing: a :class:`RequestTrace` is an
append-only list of ``(state, t)`` pairs stamped with the shared clock.
The engine marks transitions (``queued`` -> ``admitted`` ->
``prefill_chunk``* -> ``first_token`` -> (``decode_chunk`` |
``spec_verify``)* -> ``retired`` | ``preempted`` | ``failed``), and
every latency metric (TTFT, TPOT, queue wait) is derived from the
trace. A preempted request keeps its trace and opens a
second queued/admitted stint; :attr:`RequestTrace.queue_wait` sums them.
"""

from __future__ import annotations

import itertools
import threading

from .metrics import now

__all__ = ["RequestTrace", "TERMINAL_STATES", "LIFECYCLE_STATES"]

LIFECYCLE_STATES = ("arrival", "queued", "admitted", "prefill_chunk",
                    "first_token", "decode_chunk", "spec_verify",
                    "preempted", "retired", "failed")
TERMINAL_STATES = frozenset({"retired", "failed"})

_ids = itertools.count(1)
_ids_lock = threading.Lock()


def _next_id() -> int:
    with _ids_lock:
        return next(_ids)


class RequestTrace:
    """Timestamped lifecycle record for one generation request."""

    __slots__ = ("request_id", "events", "_event_tokens")

    def __init__(self, request_id=None, t=None):
        self.request_id = _next_id() if request_id is None else request_id
        self.events: list[tuple[str, float]] = [
            ("arrival", now() if t is None else t)]
        self._event_tokens: dict[int, int] = {}

    def mark(self, state: str, t: float | None = None,
             n_tokens: int | None = None) -> float:
        """Append a transition; returns its timestamp. ``n_tokens``
        records how many output tokens the event emitted."""
        t = now() if t is None else t
        if n_tokens is not None:
            self._event_tokens[len(self.events)] = int(n_tokens)
        self.events.append((state, t))
        return t

    def mark_once(self, state: str, t: float | None = None):
        """Mark only if ``state`` was never recorded (a resumed request
        gets no second ``first_token``); None when it was."""
        if self.first(state) is not None:
            return None
        return self.mark(state, t)

    def first(self, state: str):
        for s, t in self.events:
            if s == state:
                return t
        return None

    def last(self, state: str):
        for s, t in reversed(self.events):
            if s == state:
                return t
        return None

    def count(self, state: str) -> int:
        return sum(1 for s, _ in self.events if s == state)

    @property
    def arrival(self) -> float:
        return self.events[0][1]

    @property
    def terminal(self):
        """The terminal state reached, or None while in flight."""
        for s, _ in reversed(self.events):
            if s in TERMINAL_STATES:
                return s
        return None

    @property
    def ttft(self):
        """Arrival -> first emitted token (None before it)."""
        tf = self.first("first_token")
        return None if tf is None else tf - self.arrival

    @property
    def queue_wait(self) -> float:
        """Time spent waiting for admission, summed over every
        queued -> admitted stint."""
        total, tq, saw_pair = 0.0, None, False
        for s, t in self.events:
            if s == "queued" and tq is None:
                tq = t
            elif s == "admitted" and tq is not None:
                total += t - tq
                tq = None
                saw_pair = True
        if not saw_pair:
            ta = self.first("admitted")
            return 0.0 if ta is None else ta - self.arrival
        return total

    @property
    def preemptions(self) -> int:
        return self.count("preempted")

    @property
    def served_tokens(self) -> int:
        """Output tokens emitted so far, from the ``n_tokens``
        annotations."""
        return sum(self._event_tokens.values())

    def is_monotone(self) -> bool:
        ts = [t for _, t in self.events]
        return all(b >= a for a, b in zip(ts, ts[1:]))
