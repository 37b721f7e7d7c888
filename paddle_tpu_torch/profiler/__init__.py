"""paddle.profiler: tracing and profiling (counterpart of
``paddle_tpu/profiler/__init__.py``; reference: paddle/fluid/platform/
profiler.cc:59 RecordEvent, python/paddle/fluid/profiler.py:314
``profiler``, start_profiler :190 / stop_profiler :257, and the newer
paddle.profiler.Profiler API).

Here the timeline comes from ``torch.profiler``: host annotations are
``torch.profiler.record_function`` ranges, the device timeline is
CUPTI's (the CUDA activity, on a machine with a card; the CPU activity
alone elsewhere), and :meth:`Profiler.stop` writes one Chrome trace
(``trace_<pid>_<n>.json``) into ``log_dir``, which Perfetto or
``chrome://tracing`` open. While a profile runs, :data:`_ACTIVE` is set:
the op funnel (``ops/dispatch.py``) then opens an ``op::<name>`` range
around every op, and each span of ``observability.tracer`` a range of
its own name.

Usage::

    with paddle.profiler.Profiler(log_dir="./prof") as prof:
        for batch in loader:
            train_step(batch)
            prof.step()
    print(prof.export())        # the directory that holds the trace
"""
from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Optional

import torch

#: the gate the op funnel and the span tracer read: a one-element list,
#: so the hot-path check is one index
_ACTIVE = [False]

_TRACE_NO = itertools.count()


def is_profiling() -> bool:
    return _ACTIVE[0]


class RecordEvent:
    """A named host range (reference: platform/profiler.cc:59 RecordEvent;
    python: paddle.profiler.RecordEvent), a ``record_function`` range on
    the trace's timeline. A context manager or a begin()/end() pair."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._ann = None
        self.begin_ns: Optional[int] = None

    def begin(self):
        self._ann = torch.profiler.record_function(self.name)
        self._ann.__enter__()
        self.begin_ns = time.perf_counter_ns()

    def end(self):
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            self._ann = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class Profiler:
    """reference: paddle.profiler.Profiler / fluid/profiler.py:314.
    Records a ``torch.profiler`` trace between :meth:`start` and
    :meth:`stop` and writes it into ``log_dir`` as Chrome trace JSON
    (``trace_path``); :meth:`step` closes one ``ProfilerStep#<n>`` range
    and opens the next, and keeps the host step times that
    :meth:`step_info` and :meth:`summary` report. ``timer_only`` keeps
    the step times and records no trace. ``on_trace_ready(prof)`` is
    called at :meth:`stop`. ``torch_profiler`` is the underlying
    ``torch.profiler.profile`` (its ``key_averages()`` has the kernels'
    device times)."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 log_dir: str = "./profiler_log", timer_only: bool = False):
        self.log_dir = log_dir
        self.timer_only = timer_only
        self._on_trace_ready = on_trace_ready
        self._running = False
        self._step_no = 0
        self._step_ann = None
        self._step_times = []
        self._last_step_t = None
        self.torch_profiler = None
        self.trace_path: Optional[str] = None

    def start(self):
        if self._running:
            return
        if not self.timer_only:
            os.makedirs(self.log_dir, exist_ok=True)
            self.torch_profiler = torch.profiler.profile(
                activities=_activities())
            self.torch_profiler.__enter__()
        _ACTIVE[0] = True
        self._running = True
        self._last_step_t = time.perf_counter()
        self._begin_step_annotation()

    def stop(self):
        if not self._running:
            return
        self._end_step_annotation()
        _ACTIVE[0] = False
        if self.torch_profiler is not None:
            self.torch_profiler.__exit__(None, None, None)
            self.trace_path = os.path.join(
                self.log_dir, f"trace_{os.getpid()}_{next(_TRACE_NO)}.json")
            self.torch_profiler.export_chrome_trace(self.trace_path)
        self._running = False
        if self._on_trace_ready is not None:
            self._on_trace_ready(self)

    def _begin_step_annotation(self):
        if not self.timer_only:
            self._step_ann = torch.profiler.record_function(
                f"ProfilerStep#{self._step_no}")
            self._step_ann.__enter__()

    def _end_step_annotation(self):
        if self._step_ann is not None:
            self._step_ann.__exit__(None, None, None)
            self._step_ann = None

    def step(self, num_samples: Optional[int] = None):
        """Mark a training-step boundary (reference: Profiler.step)."""
        now = time.perf_counter()
        if self._last_step_t is not None:
            self._step_times.append(now - self._last_step_t)
        self._last_step_t = now
        self._end_step_annotation()
        self._step_no += 1
        if self._running:
            self._begin_step_annotation()

    def step_info(self, unit=None) -> str:
        if not self._step_times:
            return "no steps recorded"
        ts = self._step_times
        return (f"steps={len(ts)} avg={sum(ts) / len(ts) * 1e3:.3f}ms "
                f"min={min(ts) * 1e3:.3f}ms max={max(ts) * 1e3:.3f}ms")

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        """The host step-time summary, as the reference prints it; the
        per-op and per-kernel table is the trace's (``torch_profiler``'s
        ``key_averages()``)."""
        print(self.step_info())

    def export(self, path=None, format=None):
        """The log directory, which holds the Chrome trace once
        :meth:`stop` has run."""
        return self.log_dir

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


# -- fluid-style module functions (reference: fluid/profiler.py) -------------

_FLUID_PROF: Optional[Profiler] = None


def start_profiler(state: str = "All", tracer_option: str = "Default",
                   log_dir: str = "./profiler_log"):
    """reference: fluid/profiler.py:190."""
    global _FLUID_PROF
    if _FLUID_PROF is None:
        _FLUID_PROF = Profiler(log_dir=log_dir)
        _FLUID_PROF.start()


def stop_profiler(sorted_key=None, profile_path: Optional[str] = None):
    """reference: fluid/profiler.py:257."""
    global _FLUID_PROF
    if _FLUID_PROF is not None:
        _FLUID_PROF.stop()
        _FLUID_PROF = None


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key=None, profile_path=None,
             tracer_option: str = "Default", log_dir: str = "./profiler_log"):
    """reference: fluid/profiler.py:314 (the context-manager form)."""
    start_profiler(state, tracer_option, log_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def cuda_profiler(*a, **k):
    """A no-op kept for ported scripts, as in the reference
    (fluid/profiler.py cuda_profiler)."""
    yield


def reset_profiler():
    pass
