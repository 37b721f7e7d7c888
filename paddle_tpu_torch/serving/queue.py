"""BatchQueue: bounded FIFO admission queue with deadline eviction
(counterpart of ``paddle_tpu/serving/queue.py``).

``put`` blocks up to the caller's patience when the queue is full (or
rejects at once with ``block=False``) and raises :class:`QueueFull`, so
load shedding is an explicit error. Deadline-expired requests are evicted
at the head and their futures fail before any device work is spent.
Items duck-type ``expired``, ``fail_expired()``, ``fail(exc)`` and
``req_id``. Each ``put`` is a ``serving/queue_put`` span, so a blocked
admission shows on the timeline beside the worker's batches.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from ..observability import tracer as _otrace
from .request import EngineDraining, QueueFull


class BatchQueue:
    """Bounded FIFO with condition-variable hand-off between submitters
    and the engine worker."""

    def __init__(self, max_size: int = 256, clock=time.monotonic):
        if max_size < 1:
            raise ValueError("max_size must be >= 1")
        self._max = max_size
        self._clock = clock
        self._dq: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False
        self._evicted_expired = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    @property
    def evicted_expired(self) -> int:
        with self._lock:
            return self._evicted_expired

    def close(self):
        """Stop admission (drain): waiting putters fail with
        EngineDraining; takers drain what is left, then see nothing."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def put(self, req, block: bool = True, timeout: Optional[float] = None):
        with _otrace.span("serving/queue_put"):
            self._put(req, block, timeout)

    def _put(self, req, block: bool, timeout: Optional[float]):
        with self._not_full:
            if self._closed:
                raise EngineDraining("engine is draining; request rejected")
            if len(self._dq) >= self._max:
                if not block:
                    raise QueueFull(
                        f"queue at capacity ({self._max}); request rejected")
                end = None if timeout is None else self._clock() + timeout
                while len(self._dq) >= self._max and not self._closed:
                    remaining = None if end is None else end - self._clock()
                    if remaining is not None and remaining <= 0:
                        raise QueueFull(
                            f"queue stayed at capacity ({self._max}) for "
                            f"{timeout}s; request rejected")
                    self._not_full.wait(remaining)
                if self._closed:
                    raise EngineDraining(
                        "engine began draining while request waited for "
                        "queue space")
            self._dq.append(req)
            self._not_empty.notify()

    def fail_all(self, exc_factory: Callable[[], BaseException]) -> list:
        """Hard-kill path: close admission and fail every queued request
        with ``exc_factory()`` (a drain lets takers consume the backlog;
        a kill must not). Returns one record per request failed here,
        ``{"req_id", "phase": "queued", "tokens": 0}`` (a queued request
        has generated nothing)."""
        with self._lock:
            self._closed = True
            victims = list(self._dq)
            self._dq.clear()
            self._not_empty.notify_all()
            self._not_full.notify_all()
        return [{"req_id": req.req_id, "phase": "queued", "tokens": 0}
                for req in victims if req.fail(exc_factory())]

    def take(self, timeout: Optional[float] = None,
             fits: Optional[Callable[[object], bool]] = None):
        """Pop the head request, or None: timed out empty, closed and
        empty, or the head exists but ``fits(head)`` is False (the
        caller's batch is full or shape-incompatible; the head stays
        queued). Expired heads are evicted (their futures fail)."""
        end = None if timeout is None else self._clock() + timeout
        with self._not_empty:
            while True:
                while self._dq and self._dq[0].expired:
                    victim = self._dq.popleft()
                    victim.fail_expired()
                    self._evicted_expired += 1
                    self._not_full.notify()
                if self._dq:
                    head = self._dq[0]
                    if fits is not None and not fits(head):
                        return None
                    self._dq.popleft()
                    self._not_full.notify()
                    return head
                if self._closed:
                    return None
                remaining = None if end is None else end - self._clock()
                if remaining is not None and remaining <= 0:
                    return None
                self._not_empty.wait(remaining)

    def take_many(self, max_n: int, timeout: Optional[float] = None) -> list:
        """Up to ``max_n`` requests: wait (as :meth:`take`) for the first,
        then take what is queued without waiting."""
        out: list = []
        if max_n < 1:
            return out
        first = self.take(timeout=timeout)
        if first is None:
            return out
        out.append(first)
        while len(out) < max_n:
            nxt = self.take(timeout=0)
            if nxt is None:
                break
            out.append(nxt)
        return out
