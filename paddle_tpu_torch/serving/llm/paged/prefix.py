"""PagedPrefixStore: prefix sharing through the page arena, with no copy
(counterpart of ``paddle_tpu/serving/llm/paged/prefix.py``:
``PagedPrefixEntry``, ``PagedPrefixStore``).

The slot layout's :class:`~..prefix.PrefixStore` keeps prefix K/V on the
host and copies it into every hitting slot. With pages the rows never
move: a cached prefix is a list of page ids into the live arena. A hit
splices those pages into the new sequence's block table
(``PagedKVCache.adopt_shared_page``: one refcount and one table entry a
page, zero K/V bytes), and the store holds one pool reference a page, so
the rows live as long as the entry, after every sharer has finished.

Shared pages are immutable: a sequence never writes a page whose
references it does not hold alone. The batcher adopts the full shared
pages in place and copies the first page the sequence will write (the
partial page at the divergence) with ``adopt_copied_page``, the COW
split. ``bytes_shared``/``bytes_copied`` count both (a page-aligned hit
copies 0 bytes). Hashing is ``chain_hashes`` with ``block = page_size``,
checked byte for byte on lookup; eviction is LRU by last hit under a
page budget, and evicting an entry releases its references (a sequence
still sharing a page keeps it alive by its own).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ....core.monitor import StatRegistry
from ..prefix import ShapeSig, _PinnedLRU, chain_hashes
from .pool import PagedKVCache


class PagedPrefixEntry:
    """One cached page-aligned prefix: its tokens and the page ids that
    hold its rows in the arena (a claim on live pages, not a copy)."""

    __slots__ = ("key", "tokens", "page_ids", "n_tokens", "sig")

    def __init__(self, key: bytes, tokens: np.ndarray,
                 page_ids: Tuple[int, ...], sig: ShapeSig):
        self.key = key
        self.tokens = tokens
        self.page_ids = tuple(int(p) for p in page_ids)
        self.n_tokens = int(tokens.size)
        self.sig = sig

    def __repr__(self):
        return (f"PagedPrefixEntry(n_tokens={self.n_tokens}, "
                f"pages={len(self.page_ids)})")


class PagedPrefixStore(_PinnedLRU):
    """Ref-counted, page-budgeted store of shared prefix pages. The
    default budget is a quarter of the pool."""

    def __init__(self, kv: PagedKVCache, capacity_pages: Optional[int] = None,
                 registry: Optional[StatRegistry] = None,
                 stat_prefix: str = "serving.llm.prefix"):
        super().__init__(registry, stat_prefix)
        self.kv = kv
        self.page_size = kv.page_size
        self.capacity_pages = (max(1, kv.pool.num_pages // 4)
                               if capacity_pages is None
                               else int(capacity_pages))
        self._pages = 0
        self._hits = 0
        self._misses = 0
        self._stat_set("pages", 0)
        self._stat_set("entries", 0)

    @property
    def pages_used(self) -> int:
        with self._lock:
            return self._pages

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "pages": self._pages,
                "capacity_pages": self.capacity_pages,
                "page_size": self.page_size,
                "pinned": sum(1 for n in self._refs.values() if n > 0),
                "bytes_shared": self._bytes_shared,
                "bytes_copied": self._bytes_copied,
                "hits": self._hits,
                "misses": self._misses,
            }

    def lookup(self, tokens, max_tokens: int,
               sig: ShapeSig) -> Tuple[Optional[PagedPrefixEntry], int]:
        """Longest cached prefix of ``tokens`` reusable at most
        ``max_tokens`` tokens (a page multiple). A hit comes back pinned;
        the caller adopts ``entry.page_ids[: n // page_size]`` and unpins
        when its request leaves."""
        toks = np.asarray(tokens, dtype=np.int32).reshape(-1)
        np_max = min(int(max_tokens), toks.size) // self.page_size
        entry, n = None, 0
        if np_max >= 1:
            hashes = chain_hashes(toks, self.page_size)[:np_max]
            with self._lock:
                key, entry, n = self._find_locked(toks, hashes, sig,
                                                  self.page_size)
                if entry is not None:
                    self._pin_locked(key)
                    self._hits += 1
        if entry is None:
            with self._lock:
                self._misses += 1
            self._stat_add("misses", 1)
            return None, 0
        self._stat_add("hits", 1)
        self._stat_add("hit_tokens", n)
        return entry, n

    def insert(self, tokens, page_ids,
               sig: ShapeSig) -> Optional[PagedPrefixEntry]:
        """Claim the pages holding a freshly prefilled prompt's
        page-aligned head: ``page_ids`` are the sequence's own pages over
        ``tokens[: len(page_ids) * page_size]``; the store takes a
        reference on each, copying nothing. Returns the entry pinned;
        dedups against an entry for the same chain (taking no new
        references). May evict LRU unpinned entries past the budget."""
        toks = np.asarray(tokens, dtype=np.int32).reshape(-1)
        page_ids = tuple(int(p) for p in page_ids)
        n = len(page_ids) * self.page_size
        if n < self.page_size or toks.size < n:
            return None
        toks = toks[:n]
        hashes = chain_hashes(toks, self.page_size)
        key = hashes[-1]
        with self._lock:
            existing = self._existing_locked(key, toks, sig)
            if existing is not None:
                self._pin_locked(existing.key)
                return existing
            for pid in page_ids:
                self.kv.pool.retain(pid)
            entry = PagedPrefixEntry(key, toks, page_ids, sig)
            self._add_locked(key, entry, hashes)
            self._pages += len(page_ids)
            for vk in self._lru_unpinned_locked():
                if self._pages <= self.capacity_pages:
                    break
                self._evict_locked(vk)
            self._stat_add("inserts", 1)
            self._stat_set("pages", self._pages)
            self._stat_set("entries", len(self._entries))
            return entry

    def _evict_locked(self, key: bytes) -> int:
        victim = self._drop_locked(key)
        self._pages -= len(victim.page_ids)
        for pid in victim.page_ids:
            self.kv.pool.release(pid)
        return len(victim.page_ids)

    def evict_unpinned(self, need_pages: int) -> int:
        """Drop LRU unpinned entries until ``need_pages`` pool references
        were released or none are left (the batcher's fallback when the
        pool runs dry). Returns the references released."""
        released = 0
        with self._lock:
            for vk in self._lru_unpinned_locked():
                if released >= need_pages:
                    break
                released += self._evict_locked(vk)
            self._stat_set("pages", self._pages)
            self._stat_set("entries", len(self._entries))
        return released

    def clear(self):
        """Drop every entry, pinned or not, releasing all its references
        (teardown)."""
        with self._lock:
            for key in list(self._entries):
                self._evict_locked(key)
            self._stat_set("pages", self._pages)
            self._stat_set("entries", len(self._entries))

    def __repr__(self):
        with self._lock:
            return (f"PagedPrefixStore(entries={len(self._entries)}, "
                    f"pages={self._pages}/{self.capacity_pages}, "
                    f"page={self.page_size})")
