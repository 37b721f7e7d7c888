"""ExecutableCache: a callable cache keyed on (model, shapes, dtypes)
(counterpart of ``paddle_tpu/serving/cache.py``: ``signature_of``,
``ExecutableCache`` and ``default_cache``).

In the JAX package an entry is a ``jax.jit`` wrapper or an AOT
executable, and a miss is an XLA compile. The port runs eagerly, so the
engine stores only a marker under a key of its own (never the model),
and a miss marks the first time it sees a padded signature: the
counters (hits, misses, evictions) keep their meaning for the engine's
stats and stay comparable with the JAX package's. The LRU bound is
kept. The persistent tiers (JAX's compilation cache and the
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


class ExecutableCache:
    """LRU cache of callables with hit/miss/eviction counters."""

    def __init__(self, capacity: int = 128):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._capacity = capacity
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Any, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_compile(self, key: Any, compile_fn: Callable[[], Any]) -> Any:
        """The cached entry for ``key``, made by ``compile_fn`` on a miss
        (outside the lock; concurrent misses on one key race benignly,
        the first finisher's entry wins)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return entry
            self.misses += 1
        made = compile_fn()
        with self._lock:
            winner = self._entries.setdefault(key, made)
            self._entries.move_to_end(key)
            while len(self._entries) > self._capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
        return winner

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"size": len(self._entries), "capacity": self._capacity,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}


_DEFAULT: Optional[ExecutableCache] = None
_DEFAULT_LOCK = threading.Lock()


def default_cache() -> ExecutableCache:
    """A process-wide cache (capacity 128) for engines that should count
    into one place; pass it as ``Engine(..., cache=default_cache())``.
    An engine given no cache owns a fresh one."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = ExecutableCache(capacity=128)
        return _DEFAULT
