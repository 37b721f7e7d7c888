"""Compiled programs: one CUDA graph per shape signature and state
(counterpart of ``jax.jit`` as the JAX package's serving programs and
``Model``'s train step use it, and of ``jax.disable_jit``).

The JAX package jits each serving program and train step once per shape
signature and counts the traces (``trace_counter``); every later call
with the same shapes runs the compiled executable. Here a :class:`Program` wraps the
same plain function (``raw(params, state, *inputs)``) and, on CUDA,
captures it once into a CUDA graph, whose replay relaunches every kernel
of the step from one host call. A graph binds addresses where a jit binds
shapes, so a program keeps one graph per *state*, the object whose device
buffers the step reads and writes in place (a decoder's KV cache, a
``Model``'s train state), and per generator:

- the first call for a state runs ``raw`` eagerly on the state's capture
  stream (the warm-up: it builds the kernels, makes the cuBLAS workspace
  and the kernels' scratch for that stream, and its outputs are the
  call's result), then captures ``raw`` on the same stream into the
  memory pool that every graph of that state shares (they never run at
  the same time), counting one trace;
- later calls copy any input tensor that is not the very tensor of the
  first call into it, and replay. The first call's tensors are the
  graph's inputs: a caller that passes the same tensors every time (the
  engine's static vectors) copies nothing. Outputs are the graph's own
  buffers, overwritten by the next call: read or copy them first;
- ``params`` (the weights; for a train step also the optimizer's state
  and its lr and step scalars) are read where they were at capture: a
  call with any of them at other addresses raises, so new weights are
  copied in place (``Tensor.copy_``) or the programs dropped
  (``ExecutableCache.clear``, ``Program.release``).

The function must have no host side effects: the warm-up and the capture
both run it, so a train step's host counters (``_global_step``) move
outside it, and tensors it needs across calls (optimizer state) are made
before the first call (made during a capture they would live in the
graph's pool). Autograd's backward runs inside the capture on the
forward's stream, custom kernels included.

On the CPU a program runs the same static-buffer program eagerly (the
inputs copied into the first call's tensors, the outputs into the first
call's outputs) and counts a trace at each state's first sighting.
:func:`disable_graphs` runs every program's plain function instead, for
holding the graphed lane against the eager one; nothing enters that lane
by itself. A failed capture or replay raises: there is no fallback.

A replay does not call the kernels' Python wrappers, so their launch
counts would miss it: at capture each :func:`counted` wrapper's count is
put back to what it was (a capture launches nothing) and what the
capture added is added again at every replay.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

import torch

__all__ = ["Program", "GraphPool", "disable_graphs", "graphs_enabled",
           "counted", "scratch_owner"]

_EAGER = [0]
_EAGER_LOCK = threading.Lock()
_LOCAL = threading.local()
_TOKENS = itertools.count(1)
#: kernel wrappers whose ``launches`` (and ``launches_by_dtype``) a
#: replay adds to
_COUNTED: List[Callable] = []


@contextlib.contextmanager
def disable_graphs():
    """Run every :class:`Program` as its plain function while inside
    (process-wide, as ``jax.disable_jit``: an engine's worker thread sees
    it too): no capture, no replay, no trace counted."""
    with _EAGER_LOCK:
        _EAGER[0] += 1
    try:
        yield
    finally:
        with _EAGER_LOCK:
            _EAGER[0] -= 1


def graphs_enabled() -> bool:
    return _EAGER[0] == 0


def counted(wrapper: Callable) -> Callable:
    """Register a kernel wrapper whose ``launches`` count replays must
    keep honest; returns it."""
    _COUNTED.append(wrapper)
    return wrapper


def scratch_owner() -> Optional[int]:
    """The token of the :class:`GraphPool` whose warm-up or capture runs
    in this thread, else None. A kernel wrapper keys the scratch it makes
    by it instead of by the stream, so graphs of different states never
    share scratch, and raises if a capture finds none made (scratch made
    inside a capture would live in the graph's pool)."""
    return getattr(_LOCAL, "owner", None)


@contextlib.contextmanager
def _owning(pool: "GraphPool"):
    _LOCAL.owner = pool.token
    try:
        yield
    finally:
        _LOCAL.owner = None


class GraphPool:
    """What the graphs bound to one state share: a CUDA memory pool and
    a capture stream, both made at the first capture, and the token that
    keys their kernels' scratch. A state's graphs run one at a time (one
    engine, one generate call), so they may share intermediates."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.token = next(_TOKENS)
        self._handle = None
        self._stream = None

    @property
    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle

    @property
    def stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def nbytes(self) -> int:
        """Device bytes the pool's segments hold (0 before any capture,
        and on the CPU)."""
        if self._handle is None:
            return 0
        pool = tuple(self._handle)
        return sum(seg["total_size"]
                   for seg in torch.cuda.memory._snapshot()["segments"]
                   if tuple(seg.get("segment_pool_id", ())) == pool)


def _leaves(params) -> List[torch.Tensor]:
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in _leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [t for p in params for t in _leaves(p)]
    return []


def _snapshot_counts():
    return [(w.launches, dict(getattr(w, "launches_by_dtype", {})))
            for w in _COUNTED]


def _add_counts(deltas):
    for w, (n, by) in zip(_COUNTED, deltas):
        if n:
            w.launches += n
        for k, v in by.items():
            w.launches_by_dtype[k] = w.launches_by_dtype.get(k, 0) + v


class _Bound:
    """One state's (and generator's) binding of a program: the first
    call's inputs, the weights' addresses, and on CUDA the graph, its
    outputs and the launches it replays."""

    def __init__(self, params, inputs):
        self.params = params
        # held so the memory the graph reads outlives any rebinding
        self.param_leaves = _leaves(params)
        self.param_ptrs = tuple(t.data_ptr() for t in self.param_leaves)
        self.inputs = inputs
        self.graph = None
        self.outputs = None
        self.launches = None

    def check_params(self, params):
        if params is self.params:
            return
        got = tuple(t.data_ptr() for t in _leaves(params))
        if got != self.param_ptrs:
            raise RuntimeError(
                "the weights are not where this program's graph reads "
                "them: copy new weights in place (Tensor.copy_) or drop "
                "the programs (ExecutableCache.clear)")
        self.params = params

    def load(self, inputs):
        if len(inputs) != len(self.inputs):
            raise ValueError("program called with another number of "
                             "inputs than at its capture")
        for new, old in zip(inputs, self.inputs):
            if new is old:
                continue
            if isinstance(old, torch.Tensor):
                _copy_in(old, new)
            elif isinstance(old, tuple):
                for n, o in zip(new, old):
                    if n is not o:
                        _copy_in(o, n)
            elif new != old:
                raise ValueError(
                    f"program input {new!r} differs from its capture's "
                    f"{old!r}")


def _copy_in(static: torch.Tensor, new):
    if not isinstance(new, torch.Tensor) or new.shape != static.shape \
            or new.dtype != static.dtype:
        raise ValueError(
            f"program input of shape {tuple(getattr(new, 'shape', ()))} "
            f"{getattr(new, 'dtype', type(new))} does not match its "
            f"capture's {tuple(static.shape)} {static.dtype}")
    static.copy_(new)


def _copy_out(static, new):
    if isinstance(static, torch.Tensor):
        static.copy_(new)
    else:
        for s, n in zip(static, new):
            _copy_out(s, n)


def _record(outs, stream):
    if isinstance(outs, torch.Tensor):
        outs.record_stream(stream)
    elif isinstance(outs, (list, tuple)):
        for o in outs:
            _record(o, stream)


class Program:
    """One shape signature's program: ``raw(params, state, *inputs)``
    captured once per state and generator (the last input that is a
    ``torch.Generator`` or None when none is), replayed after.

    ``state`` carries ``graph_pool`` (a :class:`GraphPool`), and may
    carry ``generators``, the CUDA generators the function draws from
    without taking them as inputs (a model's dropout generator), which
    every graph registers; it is held weakly: when it is collected its
    graphs go with it. ``inputs`` are
    tensors, tuples of tensors (``SamplingVectors``), a generator or
    None. ``trace_counter["traces"]`` counts captures (first sightings
    on the CPU), ``capture_ms`` each capture's wall time, ``replays`` the
    replays. :meth:`release` drops every graph (an ``ExecutableCache``
    eviction or ``clear`` calls it)."""

    def __init__(self, raw: Callable):
        self.raw = raw
        self.trace_counter = {"traces": 0}
        self.capture_ms: List[float] = []
        self.replays = 0
        self._bound: "weakref.WeakKeyDictionary[Any, Dict[Any, _Bound]]" \
            = weakref.WeakKeyDictionary()
        self._lock = threading.Lock()

    def __call__(self, params, state, *inputs):
        if not graphs_enabled():
            return self.raw(params, state, *inputs)
        gen = next((a for a in reversed(inputs)
                    if isinstance(a, torch.Generator)), None)
        with self._lock:
            per_state = self._bound.get(state)
            bound = None if per_state is None else per_state.get(gen)
        if bound is None:
            return self._first_call(params, state, inputs, gen)
        bound.check_params(params)
        bound.load(inputs)
        if bound.graph is None:
            outs = self.raw(params, state, *bound.inputs)
            _copy_out(bound.outputs, outs)
            return bound.outputs
        bound.graph.replay()
        self.replays += 1
        _add_counts(bound.launches)
        return bound.outputs

    def _first_call(self, params, state, inputs, gen):
        bound = _Bound(params, inputs)
        pool: GraphPool = state.graph_pool
        if pool.device.type != "cuda":
            outs = self.raw(params, state, *inputs)
            bound.outputs = outs
        else:
            outs = self._capture(bound, params, state, inputs, gen, pool)
        with self._lock:
            self._bound.setdefault(state, {})[gen] = bound
            self.trace_counter["traces"] += 1
        return outs

    def _capture(self, bound, params, state, inputs, gen, pool):
        caller = torch.cuda.current_stream(pool.device)
        stream = pool.stream
        stream.wait_stream(caller)
        with _owning(pool), torch.cuda.stream(stream):
            outs = self.raw(params, state, *inputs)
        _record(outs, caller)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        gens = {id(g): g for g in (gen, *getattr(state, "generators", ()))
                if g is not None and g.device.type == "cuda"}
        for g in gens.values():
            graph.register_generator_state(g)
        before = _snapshot_counts()
        try:
            with _owning(pool), torch.cuda.graph(
                    graph, pool=pool.handle, stream=stream,
                    capture_error_mode="thread_local"):
                static = self.raw(params, state, *inputs)
        finally:
            after = _snapshot_counts()
            for w, (n, by) in zip(_COUNTED, before):
                w.launches = n
                if hasattr(w, "launches_by_dtype"):
                    w.launches_by_dtype = by
        bound.launches = [
            (a - b, {k: v - by.get(k, 0) for k, v in aby.items()
                     if v != by.get(k, 0)})
            for (a, aby), (b, by) in zip(after, before)]
        caller.wait_stream(stream)
        bound.graph, bound.outputs = graph, static
        self.capture_ms.append((time.perf_counter() - t0) * 1e3)
        return outs

    def release(self):
        """Drop every graph of this program."""
        with self._lock:
            self._bound = weakref.WeakKeyDictionary()
