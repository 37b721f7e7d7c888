"""PrefixStore: cross-request prefix K/V reuse for the static-slot decoder
(counterpart of ``paddle_tpu/serving/llm/prefix.py``: ``chain_hashes``,
``PrefixEntry``, ``PrefixStore``).

Requests that share their first N tokens (a system prompt) compute the
same K/V rows for those N positions, since causal attention never looks
right. The store keeps completed prompts' K/V on the host, keyed by a
block chain hash over the token prefix; on admission the scheduler
copies the longest cached prefix into the fresh slot
(``GPTStaticDecoder.insert_prefix``) and prefills only the tail
(``GPTStaticDecoder.tail_prefill``).

Tokens are grouped into ``block_tokens`` blocks; the chain hash of block
*i* is ``sha1(chain[i-1] || tokens[i*B:(i+1)*B])``, so equal chain values
identify equal prefixes (checked byte for byte on lookup anyway). An
entry holds host numpy K/V ``[num_layers, n_tokens, heads, head_dim]``
for one block-aligned prefix and is indexed under every intermediate
chain point: a prompt sharing only the first 2 of an entry's 4 blocks
still hits. Eviction is LRU by last hit under a byte capacity; entries
pinned by an in-flight request (``refs > 0``) are never evicted. Every
mutable structure is guarded by one lock.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...core.monitor import StatRegistry

#: the shape an entry must match to be copyable into a decoder's cache:
#: (num_layers, num_heads, head_dim, dtype string)
ShapeSig = Tuple


def chain_hashes(tokens, block: int) -> List[bytes]:
    """Chain hash per complete block: ``out[i]`` identifies the token
    prefix ``tokens[: (i + 1) * block]`` (byte-equal to the JAX
    package's)."""
    out: List[bytes] = []
    prev = b""
    n = (len(tokens) // block) * block
    arr = np.asarray(tokens[:n], dtype=np.int32)
    for i in range(n // block):
        prev = hashlib.sha1(
            prev + arr[i * block:(i + 1) * block].tobytes()).digest()
        out.append(prev)
    return out


class PrefixEntry:
    """One cached block-aligned prefix: an immutable payload; the store
    keeps the refcount and recency under its lock."""

    __slots__ = ("key", "tokens", "k", "v", "n_tokens", "nbytes", "sig")

    def __init__(self, key: bytes, tokens: np.ndarray, k: np.ndarray,
                 v: np.ndarray, sig: ShapeSig):
        self.key = key
        self.tokens = tokens
        self.k = k
        self.v = v
        self.n_tokens = int(tokens.size)
        self.nbytes = int(k.nbytes + v.nbytes)
        self.sig = sig

    def __repr__(self):
        return (f"PrefixEntry(n_tokens={self.n_tokens}, "
                f"nbytes={self.nbytes})")


class _PinnedLRU:
    """What both prefix stores share: the chain index, the pins and the
    recency clock, the ``bytes_copied``/``bytes_shared`` counters and the
    stats registry. Subclasses hold the lock while they touch any of it."""

    def __init__(self, registry: Optional[StatRegistry], stat_prefix: str):
        self._registry = registry if registry is not None \
            else StatRegistry()
        self._prefix = stat_prefix
        self._lock = threading.Lock()
        self._entries: Dict[bytes, object] = {}   # full-chain key
        self._index: Dict[bytes, bytes] = {}      # chain point -> key
        self._refs: Dict[bytes, int] = {}
        self._last_hit: Dict[bytes, int] = {}
        self._tick = 0                            # recency clock
        self._bytes_copied = 0
        self._bytes_shared = 0

    def _stat_add(self, name, v):
        self._registry.add(f"{self._prefix}.{name}", v)

    def _stat_set(self, name, v):
        self._registry.set(f"{self._prefix}.{name}", v)

    def note_copied(self, nbytes: int):
        """Record reused-prefix bytes that were copied into a sequence
        (the host store's insert, the paged store's COW splits)."""
        with self._lock:
            self._bytes_copied += int(nbytes)
        self._stat_add("bytes_copied", int(nbytes))

    def note_shared(self, nbytes: int):
        """Record reused-prefix bytes shared without a copy (always 0 for
        the host store; the paged store's table splices)."""
        with self._lock:
            self._bytes_shared += int(nbytes)
        self._stat_add("bytes_shared", int(nbytes))

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def unpin(self, entry):
        """Release one in-flight reference (eviction becomes possible at
        0); a second unpin leaves it at 0."""
        with self._lock:
            if entry.key in self._refs:
                self._refs[entry.key] = max(0, self._refs[entry.key] - 1)

    def _pin_locked(self, key: bytes):
        self._tick += 1
        self._last_hit[key] = self._tick
        self._refs[key] = self._refs.get(key, 0) + 1

    def _find_locked(self, toks: np.ndarray, hashes, sig, step: int):
        """The longest indexed chain point of ``hashes`` whose entry
        matches ``sig`` and ``toks`` byte for byte: ``(key, entry, n)``,
        or ``(None, None, 0)``."""
        for i in range(len(hashes) - 1, -1, -1):
            key = self._index.get(hashes[i])
            if key is None:
                continue
            entry = self._entries.get(key)
            n = (i + 1) * step
            if entry is None or entry.sig != sig or entry.n_tokens < n \
                    or not np.array_equal(entry.tokens[:n], toks[:n]):
                continue
            return key, entry, n
        return None, None, 0

    def _existing_locked(self, key: bytes, toks: np.ndarray, sig):
        """The entry already covering exactly the chain ``key`` ends, or
        None (insert's dedup)."""
        existing_key = self._index.get(key)
        if existing_key is None:
            return None
        existing = self._entries.get(existing_key)
        n = toks.size
        if existing is not None and existing.sig == sig \
                and existing.n_tokens >= n \
                and np.array_equal(existing.tokens[:n], toks):
            return existing
        return None

    def _add_locked(self, key: bytes, entry, hashes):
        self._entries[key] = entry
        self._tick += 1
        self._last_hit[key] = self._tick
        self._refs[key] = 1
        for h in hashes:
            self._index[h] = key

    def _lru_unpinned_locked(self) -> List[bytes]:
        recency = dict(self._last_hit)
        return sorted((vk for vk in self._entries
                       if self._refs.get(vk, 0) == 0),
                      key=lambda vk: recency.get(vk, 0))

    def _drop_locked(self, key: bytes):
        victim = self._entries.pop(key)
        self._refs.pop(key, None)
        self._last_hit.pop(key, None)
        for h in [h for h, k2 in self._index.items() if k2 == key]:
            del self._index[h]
        self._stat_add("evictions", 1)
        return victim


class PrefixStore(_PinnedLRU):
    """Ref-counted, capacity-bounded host store of prompt-prefix K/V."""

    def __init__(self, capacity_bytes: int = 256 << 20,
                 block_tokens: int = 16,
                 registry: Optional[StatRegistry] = None,
                 stat_prefix: str = "serving.llm.prefix"):
        if block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, got {block_tokens}")
        super().__init__(registry, stat_prefix)
        self.capacity_bytes = int(capacity_bytes)
        self.block_tokens = int(block_tokens)
        self._bytes = 0
        self._stat_set("bytes", 0)
        self._stat_set("entries", 0)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "capacity_bytes": self.capacity_bytes,
                "block_tokens": self.block_tokens,
                "pinned": sum(1 for n in self._refs.values() if n > 0),
                "bytes_copied": self._bytes_copied,
                "bytes_shared": self._bytes_shared,
            }

    def lookup(self, tokens, max_tokens: int,
               sig: ShapeSig) -> Tuple[Optional[PrefixEntry], int]:
        """Longest cached prefix of ``tokens`` reusable at most
        ``max_tokens`` tokens with a matching shape signature. A hit is
        returned pinned (the caller unpins when its request leaves the
        engine) with the reusable token count (a block multiple)."""
        toks = np.asarray(tokens, dtype=np.int32).reshape(-1)
        nb_max = min(int(max_tokens), toks.size) // self.block_tokens
        if nb_max < 1:
            self._stat_add("misses", 1)
            return None, 0
        hashes = chain_hashes(toks, self.block_tokens)[:nb_max]
        with self._lock:
            key, entry, n = self._find_locked(toks, hashes, sig,
                                              self.block_tokens)
            if entry is not None:
                self._pin_locked(key)
        if entry is None:
            self._stat_add("misses", 1)
            return None, 0
        self._stat_add("hits", 1)
        self._stat_add("hit_tokens", n)
        return entry, n

    def insert(self, tokens, k: np.ndarray, v: np.ndarray,
               sig: ShapeSig) -> Optional[PrefixEntry]:
        """Store the K/V of a block-aligned prompt prefix (``k``/``v``:
        host ``[L, n, H, D]``, n a block multiple equal to
        ``len(tokens)`` rounded down). Returns the entry pinned; dedups
        against an entry covering the same chain. May evict LRU unpinned
        entries to fit the byte budget (pinned ones never, so the store
        can exceed it while pins churn)."""
        toks = np.asarray(tokens, dtype=np.int32).reshape(-1)
        n = (toks.size // self.block_tokens) * self.block_tokens
        if n < self.block_tokens:
            return None
        toks = toks[:n]
        if k.shape[1] != n or v.shape[1] != n:
            raise ValueError(
                f"prefix K/V rows {k.shape[1]}/{v.shape[1]} != {n} tokens")
        hashes = chain_hashes(toks, self.block_tokens)
        key = hashes[-1]
        with self._lock:
            existing = self._existing_locked(key, toks, sig)
            if existing is not None:
                self._pin_locked(existing.key)
                return existing
            entry = PrefixEntry(key, toks, np.ascontiguousarray(k),
                                np.ascontiguousarray(v), sig)
            self._add_locked(key, entry, hashes)
            self._bytes += entry.nbytes
            for vk in self._lru_unpinned_locked():
                if self._bytes <= self.capacity_bytes:
                    break
                self._bytes -= self._drop_locked(vk).nbytes
            self._stat_add("inserts", 1)
            self._stat_set("bytes", self._bytes)
            self._stat_set("entries", len(self._entries))
            return entry

    def __repr__(self):
        with self._lock:
            return (f"PrefixStore(entries={len(self._entries)}, "
                    f"bytes={self._bytes}/{self.capacity_bytes}, "
                    f"block={self.block_tokens})")
