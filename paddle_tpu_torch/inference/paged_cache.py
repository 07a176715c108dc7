"""Block-pool allocator for the paged KV cache.

The device side is a ``[L, n_blocks, block_size, kvh, hd]`` pool plus a
per-row int32 block table; this module owns the host side, a free list
of page ids. Page 0 is the reserved NULL page
(``kernels.paged_attention.NULL_PAGE``): padded table entries and
inactive rows point there, so device steps need no validity masks, and
the allocator never hands it out.

Pages are refcounted: ``allocate`` hands pages out at refcount 1; the
prefix cache and every row that maps a shared page take more
references with :meth:`incref` and drop them with :meth:`decref`, and a
page returns to the LIFO free list only when its last reader lets go.
Double frees, foreign ids and unilateral frees of shared pages raise:
each would alias live KV history.

An engine with int8 pools sets ``track_allocations``: every page handed
out is logged until :meth:`drain_allocated`, so the engine can reset a
recycled page's per-(page, kv head) scale before its next write.
"""

from __future__ import annotations

from ..kernels.paged_attention import NULL_PAGE

__all__ = ["BlockAllocator"]


class BlockAllocator:
    """Refcounted free list over page ids ``1..n_blocks-1``."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(
                f"n_blocks={n_blocks}: need at least one allocatable "
                f"page beyond the reserved NULL page")
        self.n_blocks = int(n_blocks)
        # LIFO: freed pages are reused first; NULL_PAGE is never listed
        self._free = list(range(self.n_blocks - 1, NULL_PAGE, -1))
        self._rc: dict[int, int] = {}   # page -> live reference count
        self.high_watermark = 0         # max pages in use at once
        self.total_allocated = 0        # cumulative pages handed out
        self.total_freed = 0            # cumulative pages returned
        # int8 pools: log hand-outs for drain_allocated()
        self.track_allocations = False
        self._handed_out: list[int] = []

    @property
    def capacity(self) -> int:
        """Allocatable pages (the NULL page excluded)."""
        return self.n_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return len(self._rc)

    in_use = num_used

    def refcount(self, page: int) -> int:
        """Live references on ``page`` (0 = not allocated)."""
        return self._rc.get(page, 0)

    @property
    def conservation_ok(self) -> bool:
        """Every page ever allocated is still referenced or freed."""
        return self.total_allocated - self.total_freed == len(self._rc)

    def shortfall(self, n: int) -> int:
        """Pages missing for ``allocate(n)`` to succeed (0 = it will)."""
        return max(0, n - len(self._free))

    def allocate(self, n: int) -> list[int] | None:
        """``n`` pages at refcount 1, all or nothing: None when the pool
        cannot cover them (the caller defers, evicts, preempts or
        fails)."""
        if n < 0:
            raise ValueError(f"allocate({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        if self.track_allocations:
            self._handed_out.extend(pages)
        self.total_allocated += n
        self.high_watermark = max(self.high_watermark, len(self._rc))
        return pages

    def drain_allocated(self) -> list[int]:
        """Pages handed out since the last drain. A recycled page still
        carries its previous tenant's running-max scale, which only
        grows and would coarsen every row quantized into the page; an
        int8 engine sets ``track_allocations`` and drains this list
        before each call that writes KV, resetting those scales to the
        floor. With tracking off the list stays empty."""
        out = self._handed_out
        self._handed_out = []
        return out

    def incref(self, page: int) -> None:
        """A new reader maps an allocated page (prefix hit)."""
        if page not in self._rc:
            raise ValueError(
                f"incref of page {page} which is not allocated")
        self._rc[page] += 1

    def decref(self, page: int) -> None:
        """Drop one reference; the last one frees the page."""
        rc = self._rc.get(page)
        if rc is None:
            raise ValueError(
                f"decref of page {page} which is not allocated "
                f"(double-free or foreign id)")
        if rc > 1:
            self._rc[page] = rc - 1
        else:
            del self._rc[page]
            self._free.append(page)
            self.total_freed += 1

    def free(self, pages) -> None:
        """Return exclusively-owned pages. Double frees, foreign ids and
        shared pages raise (shared pages release through decref)."""
        for p in pages:
            rc = self._rc.get(p)
            if rc is None:
                raise ValueError(
                    f"free of page {p} which is not allocated "
                    f"(double-free or foreign id)")
            if rc != 1:
                raise ValueError(
                    f"free of page {p} with {rc} live references — "
                    f"shared pages release via decref")
            del self._rc[p]
            self._free.append(p)
            self.total_freed += 1

    def stats(self) -> dict:
        return {"capacity": self.capacity, "used": self.num_used,
                "free": self.num_free,
                "high_watermark": self.high_watermark,
                "total_allocated": self.total_allocated,
                "total_freed": self.total_freed}
