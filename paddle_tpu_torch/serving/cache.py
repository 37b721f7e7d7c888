"""ExecutableCache: a program cache keyed on (model, shapes, dtypes)
(counterpart of ``paddle_tpu/serving/cache.py``: ``signature_of``,
``ExecutableCache`` and ``default_cache``).

In the JAX package an entry is a ``jax.jit`` wrapper or an AOT
executable, and a miss is an XLA compile. Here the LLM decoders' entries
are :class:`~paddle_tpu_torch.core.graphs.Program` objects, one per shape
signature, which capture a CUDA graph at their first call for each KV
cache and replay it after (the CPU runs them eagerly); an eviction or
:meth:`ExecutableCache.clear` releases the entry's graphs and their
memory. The detection ``Engine`` serves any callable, which it does not
capture, so its entries mark the first sighting of a padded signature.
The counters (hits, misses, evictions) keep the JAX package's meaning.
The persistent tiers (JAX's compilation cache and the
serialized-executable store) are XLA-only and not ported.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

#: signature element: ((dim, ...), dtype-string) per input array
SigT = Tuple[Tuple[Tuple[int, ...], str], ...]


def signature_of(arrays: Sequence[Any]) -> SigT:
    """Shape/dtype signature of a list of arrays (numpy or torch)."""
    return tuple((tuple(int(d) for d in a.shape), str(a.dtype))
                 for a in arrays)


def _release(entry):
    release = getattr(entry, "release", None)
    if release is not None:
        release()


class ExecutableCache:
    """LRU cache of programs with hit/miss/eviction counters."""

    def __init__(self, capacity: int = 128):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._capacity = capacity
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Any, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get_or_compile(self, key: Any, compile_fn: Callable[[], Any]) -> Any:
        """The cached entry for ``key``, made by ``compile_fn`` on a miss
        (outside the lock; concurrent misses on one key race benignly,
        the first finisher's entry wins). An evicted entry is released."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return entry
            self.misses += 1
        made = compile_fn()
        evicted = []
        with self._lock:
            winner = self._entries.setdefault(key, made)
            self._entries.move_to_end(key)
            while len(self._entries) > self._capacity:
                evicted.append(self._entries.popitem(last=False)[1])
                self.evictions += 1
        for entry in evicted:
            _release(entry)
        return winner

    def contains(self, key: Any) -> bool:
        with self._lock:
            return key in self._entries

    def clear(self):
        """Drop (and release) every entry; the counters stay."""
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for entry in entries:
            _release(entry)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"size": len(self._entries), "capacity": self._capacity,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}


_DEFAULT: Optional[ExecutableCache] = None
_DEFAULT_LOCK = threading.Lock()


def default_cache() -> ExecutableCache:
    """The process-wide cache (capacity 128). The LLM decoders and
    ``LLMEngine`` use it when given none, as the JAX package's do (their
    keys carry the model's spec, so decoders do not collide); the
    detection ``Engine`` owns a fresh one unless given one."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = ExecutableCache(capacity=128)
        return _DEFAULT
