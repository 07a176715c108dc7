"""Prefix-sharing radix cache over the paged KV pool: a radix tree over
token-id sequences at page granularity, refcounts layered into the
block allocator, copy-on-write for partially shared pages, LRU eviction
of unreferenced leaves.

Everything here is host-side bookkeeping: the tree maps token prefixes
to page ids in the device pool and never touches device memory. The
engine calls :meth:`PrefixCache.match` at admission (seeding the row's
block table from cached pages and prefilling only the uncached tail)
and :meth:`PrefixCache.insert` at retire and preempt (publishing the
row's now-immutable prefix pages).

- Interior nodes cover exactly ``block_size`` tokens. Their pages are
  shared read-only: a matching row maps them and takes a reference; its
  own writes start strictly after them.
- A node shorter than ``block_size`` is a leaf (a partly filled page).
  It is never mapped shared, because the matching row's next token
  writes into that page: the row gets a private copy instead (the
  engine copies the page on the device).
- The tree holds one reference per node page. Eviction (LRU, childless
  nodes only, cascading upward) drops it; the allocator frees the page
  once no row reads it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .paged_cache import BlockAllocator

__all__ = ["PrefixCache", "PrefixMatch"]


@dataclass
class PrefixMatch:
    """One admission's view of the cache: ``pages`` are full shared
    pages (a reference is held on each), ``cow_src`` an optional
    partly matching page to copy privately (also referenced), and
    ``cached_len`` the matched token count."""

    pages: list[int] = field(default_factory=list)
    cow_src: int | None = None
    cow_len: int = 0
    _full_tokens: int = 0

    @property
    def cached_len(self) -> int:
        return self._full_tokens + self.cow_len


class _Node:
    __slots__ = ("key", "page", "children", "parent", "clock")

    def __init__(self, key, page, parent):
        self.key = key                  # tuple of token ids, len <= bs
        self.page = page
        self.children = {}              # key tuple -> _Node
        self.parent = parent
        self.clock = 0


class PrefixCache:
    """Radix tree of cached KV pages, keyed by token ids."""

    def __init__(self, alloc: BlockAllocator, block_size: int):
        self._alloc = alloc
        self._bs = int(block_size)
        self._root = _Node((), None, None)
        self._clock = 0                 # LRU tick (match and insert)
        self._n_nodes = 0
        self.hits = 0                   # matches with cached_len > 0
        self.queries = 0
        self.hit_tokens = 0
        self.evicted_pages = 0

    def __len__(self) -> int:
        return self._n_nodes

    def _tick(self, node: _Node) -> None:
        self._clock += 1
        node.clock = self._clock

    def match(self, tokens, limit: int) -> PrefixMatch:
        """Longest cached prefix of ``tokens[:limit]``: full-page
        children exactly, then the child with the longest common
        partial prefix as a copy-on-write source. A reference is taken
        on every returned page; the caller adopts them or gives them
        back with :meth:`release`. ``limit`` keeps at least one token
        uncached, so the prefill has a real last position."""
        bs = self._bs
        tokens = [int(t) for t in tokens]
        self.queries += 1
        m = PrefixMatch()
        node = self._root
        f = 0
        while (f + 1) * bs <= limit:
            child = node.children.get(tuple(tokens[f * bs:(f + 1) * bs]))
            if child is None:
                break
            self._alloc.incref(child.page)
            self._tick(child)
            m.pages.append(child.page)
            node = child
            f += 1
        m._full_tokens = f * bs
        cap = min(bs, limit - f * bs)
        best_t, best = 0, None
        for child in node.children.values():
            t = 0
            for a, b in zip(child.key, tokens[f * bs:f * bs + cap]):
                if a != b:
                    break
                t += 1
            if t > best_t:
                best_t, best = t, child
        if best is not None:
            self._alloc.incref(best.page)
            self._tick(best)
            m.cow_src = best.page
            m.cow_len = best_t
        if m.cached_len:
            self.hits += 1
            self.hit_tokens += m.cached_len
        return m

    def release_cow(self, m: PrefixMatch) -> None:
        """Drop the copy-on-write source's reference."""
        if m.cow_src is not None:
            self._alloc.decref(m.cow_src)
            m.cow_src = None
            m.cow_len = 0

    def release(self, m: PrefixMatch) -> None:
        """Give back every reference ``match`` took."""
        for p in m.pages:
            self._alloc.decref(p)
        m.pages = []
        m._full_tokens = 0
        self.release_cow(m)

    def insert(self, tokens, pages) -> int:
        """Publish a row's prefix: ``tokens`` are the ids whose KV is
        valid in ``pages`` (``ceil(len(tokens)/bs)`` pages in table
        order). Segments already cached keep their page (first wins).
        The tree takes one reference per adopted page; returns how many
        it adopted."""
        bs = self._bs
        tokens = [int(t) for t in tokens]
        node = self._root
        adopted = 0
        n_full = len(tokens) // bs
        keys = [tuple(tokens[i * bs:(i + 1) * bs]) for i in range(n_full)]
        if len(tokens) > n_full * bs:
            keys.append(tuple(tokens[n_full * bs:]))
        for i, key in enumerate(keys):
            child = node.children.get(key)
            if child is None:
                child = _Node(key, pages[i], node)
                self._alloc.incref(pages[i])
                node.children[key] = child
                self._n_nodes += 1
                adopted += 1
            self._tick(child)
            node = child
        return adopted

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` by dropping the least recently used
        childless nodes that nothing but the tree references; returns
        the pages freed."""
        freed = 0
        while freed < n_pages:
            victim = None
            stack = [self._root]
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if (node is not self._root and not node.children
                        and self._alloc.refcount(node.page) == 1
                        and (victim is None or node.clock < victim.clock)):
                    victim = node
            if victim is None:
                break
            del victim.parent.children[victim.key]
            self._alloc.decref(victim.page)     # rc 1 -> page freed
            self._n_nodes -= 1
            freed += 1
        self.evicted_pages += freed
        return freed

    @property
    def hit_rate(self) -> float:
        return self.hits / self.queries if self.queries else 0.0

    def stats(self) -> dict:
        return {"nodes": self._n_nodes, "hits": self.hits,
                "queries": self.queries, "hit_tokens": self.hit_tokens,
                "hit_rate": round(self.hit_rate, 4),
                "evicted_pages": self.evicted_pages}
