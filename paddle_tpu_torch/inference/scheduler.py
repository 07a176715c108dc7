"""Request scheduler for the paged DecodeEngine: a priority + FCFS
queue of requests that hold no slot yet, and the per-step token budget.

Ordering is (priority desc, arrival asc). A preempted request re-enters
with its original arrival stamp, so preemption never costs it its FCFS
place. Page charging and the preemption policy live in the engine; the
scheduler answers "who goes next", and under chunked prefill which
prompt chunks a step's token budget funds.
"""

from __future__ import annotations

import heapq

__all__ = ["RequestScheduler", "StepBudget"]


class StepBudget:
    """Token budget of one engine step. ``take`` funds whole work items
    only; ``force=True`` records a spend that may not be refused
    (decode lanes), so ``used`` is the step's real load."""

    __slots__ = ("total", "used")

    def __init__(self, total: int):
        self.total = max(0, int(total))
        self.used = 0

    @property
    def remaining(self) -> int:
        return max(0, self.total - self.used)

    def take(self, tokens: int, force: bool = False) -> bool:
        tokens = int(tokens)
        if tokens <= 0:
            return True
        if not force and tokens > self.remaining:
            return False
        self.used += tokens
        return True


class RequestScheduler:
    """Priority + FCFS queue of pending generation requests. The first
    :meth:`add` stamps a request with its arrival sequence for life."""

    def __init__(self):
        self._heap: list = []
        self._arrivals = 0

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def add(self, req) -> None:
        if getattr(req, "_sched_seq", None) is None:
            req._sched_seq = self._arrivals
            self._arrivals += 1
        prio = int(getattr(req, "priority", 0) or 0)
        trace = getattr(req, "trace", None)
        if trace is not None:
            trace.mark("queued")        # every enqueue opens a stint
        heapq.heappush(self._heap, (-prio, req._sched_seq, req))

    def peek(self):
        """The next request (None when empty), left in the queue:
        admission pops only once its pages are funded, so a starved
        high-priority request is never overtaken."""
        return self._heap[0][2] if self._heap else None

    def pop(self):
        if not self._heap:
            raise IndexError("pop from an empty RequestScheduler")
        return heapq.heappop(self._heap)[2]

    def pending_tokens(self) -> int:
        """Queued prompt tokens not yet prefilled."""
        return sum(e[2].ids.reshape(-1).size for e in self._heap)

    # -- per-step token budget (chunked prefill) -----------------------------
    def _prefill_key(self, req):
        """Chunk-funding order: priority desc, arrival asc, the order
        admission itself uses."""
        return (-int(getattr(req, "priority", 0) or 0), req._sched_seq)

    def plan_prefill(self, budget: StepBudget, candidates) -> list:
        """Fund whole prefill chunks out of ``budget``: the candidate
        ``(request, chunk_tokens)`` pairs in :meth:`_prefill_key` order,
        stopping at the first chunk that does not fit, so a later small
        chunk never overtakes a starved earlier one. Returns the funded
        pairs in order."""
        funded = []
        for req, tokens in sorted(candidates,
                                  key=lambda c: self._prefill_key(c[0])):
            if not budget.take(tokens):
                break
            funded.append((req, tokens))
        return funded
