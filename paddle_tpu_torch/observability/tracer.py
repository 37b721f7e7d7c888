"""Structured span tracer: low-overhead host timeline spans (counterpart
of ``paddle_tpu/observability/tracer.py``).

* **Disabled cost: one list index.** ``span()`` runs on every train
  step, decode tick and serving request, so the off path allocates
  nothing: the module-level ``_ENABLED = [False]`` gate (beside
  ``profiler._ACTIVE``) returns one shared immutable no-op. Hot paths go
  through ``span()``; building a ``Span`` directly (or ``span_always``)
  bypasses the gate, and ``tests/test_torch_span_hot_path.py`` scans the
  port's hot-path modules for that.
* **Lock-free recording.** Finished spans land in a bounded
  ``deque(maxlen=...)``, whose append and iteration are atomic under the
  GIL, so worker threads, the train loop and a flight dump share the
  ring without a lock; ``dropped`` counts what the ring pushed out.
* **Timeline alignment.** While a ``paddle_tpu_torch.profiler``
  profile runs, each span also enters
  ``torch.profiler.record_function(name)``, so host spans line up with
  the CUDA kernels in the same trace.

A span measures host wall time. Spans sit around calls and ticks, never
inside a compiled program's function, which a CUDA graph replay does not
run. Timestamps are ``time.perf_counter_ns``; ``clock_origin_ns`` and
``wall_origin_s`` map them onto wall time. ``PADDLE_TPU_TRACE=1``
enables tracing at import, ``PADDLE_TPU_TRACE_CAPACITY`` sizes the ring.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from .. import profiler as _profiler

#: module-level gate, mirroring ``profiler._ACTIVE``: a one-element list so
#: the hot-path check is a single LOAD + index with no attribute lookup on
#: a rebindable global.
_ENABLED = [False]

#: default ring capacity (finished spans retained)
DEFAULT_CAPACITY = int(os.environ.get("PADDLE_TPU_TRACE_CAPACITY", "8192"))

_tls = threading.local()


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


class _NoopSpan:
    """Shared do-nothing context manager returned while tracing is off.

    One module-level instance; ``__enter__``/``__exit__`` do no work, so an
    instrumented call site costs one function call + one index when
    tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set_attr(self, key, value):  # API parity with Span
        return self


NOOP_SPAN = _NoopSpan()


class Span:
    """One timed region. Create via ``span()`` / ``SpanTracer.span()`` —
    never directly in hot paths (the constructor runs even when tracing is
    disabled, defeating the fast path)."""

    __slots__ = ("name", "attrs", "t0_ns", "t1_ns", "tid", "thread_name",
                 "depth", "_tracer", "_ann")

    def __init__(self, tracer: "SpanTracer", name: str,
                 attrs: Optional[Dict] = None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0_ns = 0
        self.t1_ns = 0
        self.tid = 0
        self.thread_name = ""
        self.depth = 0
        self._ann = None

    def set_attr(self, key, value):
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value
        return self

    def __enter__(self):
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.thread_name = t.name
        stack = _stack()
        self.depth = len(stack)
        stack.append(self)
        if _profiler._ACTIVE[0]:
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.t1_ns = time.perf_counter_ns()
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
            self._ann = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        else:  # unbalanced exit (e.g. generator abandoned mid-span)
            try:
                stack.remove(self)
            except ValueError:
                pass
        if exc_type is not None:
            self.set_attr("error", exc_type.__name__)
        self._tracer._record(self)
        return False


class SpanTracer:
    """Span factory + bounded ring of finished spans.

    The module-level default tracer (``enable()``/``span()``) is what all
    built-in instrumentation uses; standalone tracers exist for tests."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._ring = deque(maxlen=capacity)  # GIL-atomic append
        self._dropped = 0
        self.pid = os.getpid()
        # perf_counter->wall mapping, refreshed on enable()
        self.clock_origin_ns = time.perf_counter_ns()
        self.wall_origin_s = time.time()

    # -- recording ----------------------------------------------------------
    def span_always(self, name: str, attrs: Optional[Dict] = None) -> Span:
        """Unconditionally-recording span (tests, cold paths). Hot paths
        must use the module-level ``span()``, the only entry point
        with the zero-allocation disabled path."""
        return Span(self, name, attrs)

    def _record(self, s: Span):
        ring = self._ring
        if len(ring) == ring.maxlen:
            self._dropped += 1
        ring.append({
            "name": s.name,
            "ts_ns": s.t0_ns,
            "dur_ns": s.t1_ns - s.t0_ns,
            "tid": s.tid,
            "thread": s.thread_name,
            "depth": s.depth,
            "attrs": s.attrs,
        })

    # -- readout ------------------------------------------------------------
    def drain(self) -> List[Dict]:
        """Snapshot and clear the ring (export consumes spans once)."""
        out = []
        ring = self._ring
        while True:
            try:
                out.append(ring.popleft())
            except IndexError:
                return out

    def spans(self) -> List[Dict]:
        """Non-destructive snapshot of recorded spans, oldest first."""
        return list(self._ring)

    @property
    def dropped(self) -> int:
        return self._dropped

    def clear(self):
        self._ring.clear()
        self._dropped = 0


_TRACER = SpanTracer()


def default_tracer() -> SpanTracer:
    return _TRACER


def is_enabled() -> bool:
    return _ENABLED[0]


def enable(capacity: Optional[int] = None):
    """Turn span recording on (idempotent). ``capacity`` resizes the ring."""
    if capacity is not None and capacity != _TRACER.capacity:
        _TRACER.capacity = capacity
        _TRACER._ring = deque(_TRACER._ring, maxlen=capacity)
    _TRACER.clock_origin_ns = time.perf_counter_ns()
    _TRACER.wall_origin_s = time.time()
    _ENABLED[0] = True


def disable():
    _ENABLED[0] = False


def span(name: str, attrs: Optional[Dict] = None):
    """The instrumentation entry point: ``with span("train/step"): ...``.

    Returns the shared no-op when tracing is disabled — zero allocation on
    the hot path. Pass attributes as a dict (``span("x", {"k": v})``) only
    where the dict itself is cheap relative to the region timed."""
    if not _ENABLED[0]:
        return NOOP_SPAN
    return Span(_TRACER, name, attrs)


# the environment's opt-in: the import's one side effect is a getenv
if os.environ.get("PADDLE_TPU_TRACE", "").lower() in ("1", "true", "on"):
    enable()
