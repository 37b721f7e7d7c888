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

No garbage is collected during a capture (``_collector_held``): a
dropped graph destroyed inside another capture would invalidate it.

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
counts would miss it: each kernel wrapper counts through
:func:`note_launch`, which adds a launch recorded on a capturing stream
to that capture's tally (a capture launches nothing; autograd records a
captured backward from a thread of its own, on the capture's stream),
and every replay adds the tally again. Engines on one card run their
workers in threads of their own, one capturing while another replays:
the sibling's launches are on other streams, and every count moves
under one lock, so no launch is lost or counted twice.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

import torch

from ..observability import tracer as _otrace

__all__ = ["Program", "GraphPool", "disable_graphs", "graphs_enabled",
           "counted", "scratch_owner"]

_EAGER = [0]
_EAGER_LOCK = threading.Lock()
#: captures in flight, and whether the collector ran before the first
_HELD = {"captures": 0, "was_enabled": False}
_HELD_LOCK = threading.Lock()
_LOCAL = threading.local()
_TOKENS = itertools.count(1)
#: guards every kernel wrapper's ``launches`` and ``launches_by_dtype``
#: (engine workers launch and replay from threads of their own)
_COUNT_LOCK = threading.Lock()
#: the captures running: capture stream's handle -> the capture's tally
_TALLIES: Dict[Any, dict] = {}


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


@contextlib.contextmanager
def _collector_held():
    """Keep Python's cyclic garbage collector from running while a graph
    is captured. A dropped program's graph lives on in reference cycles
    (an engine and its worker thread) until the collector finds it; a
    collection that lands inside another capture destroys that graph
    there, which is not permitted during a capture and invalidates it
    (torch no longer collects when a capture begins). So hold the
    collector off until the last capture in flight ends; what it would
    have found is collected after."""
    with _HELD_LOCK:
        if _HELD["captures"] == 0:
            _HELD["was_enabled"] = gc.isenabled()
            gc.disable()
        _HELD["captures"] += 1
    try:
        yield
    finally:
        with _HELD_LOCK:
            _HELD["captures"] -= 1
            if _HELD["captures"] == 0 and _HELD["was_enabled"]:
                gc.enable()


def _stream_key():
    """The current CUDA stream's handle: the stream a wrapper just
    launched on."""
    return torch.cuda.current_stream().cuda_stream


def note_launch(wrapper: Callable, dtype: Optional[str] = None):
    """Count one launch of ``wrapper``'s kernel (and one of its inputs'
    type ``dtype`` in ``launches_by_dtype``): in the tally of the capture
    recording the current stream, else in the wrapper's counts."""
    tally = _TALLIES.get(_stream_key()) if _TALLIES else None
    with _COUNT_LOCK:
        if tally is not None:
            n, by = tally.get(wrapper, (0, {}))
            tally[wrapper] = (n + 1, by)
        else:
            wrapper.launches += 1
            by = wrapper.launches_by_dtype if dtype is not None else None
        if dtype is not None:
            by[dtype] = by.get(dtype, 0) + 1


@contextlib.contextmanager
def _tallying(key):
    """Collect the :func:`note_launch` calls on the stream ``key`` (a
    capture's) in a tally; yields it, ``{wrapper: (n, by dtype)}``."""
    tally = {}
    with _COUNT_LOCK:
        _TALLIES[key] = tally
    try:
        yield tally
    finally:
        with _COUNT_LOCK:
            _TALLIES.pop(key, None)


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


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the storage a graph reads); a plain
    tensor as it is. Taken without autograd: a recorded ``to_local`` of
    a parameter would keep its gradient accumulator alive from the
    default stream, and a later capture of its backward would fail."""
    if type(t) is torch.Tensor:
        return t
    from ..distributed.mesh import local
    with torch.no_grad():
        return local(t)


def _leaves(params) -> List[torch.Tensor]:
    if isinstance(params, torch.Tensor):
        return [_local(params)]
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in _leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [t for p in params for t in _leaves(p)]
    return []


def _add_counts(deltas):
    """Add a replay's launches: ``{wrapper: (n, by dtype)}``."""
    with _COUNT_LOCK:
        for w, (n, by) in deltas.items():
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
        _local(outs).record_stream(stream)
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
    eviction or ``clear`` calls it). A first call (warm-up and capture)
    is a ``jit/compile`` span carrying ``span_attrs`` (``{"fn": name}``;
    the ``ExecutableCache`` puts its key there)."""

    def __init__(self, raw: Callable, name: Optional[str] = None):
        self.raw = raw
        # a functools.partial is named after its function
        self.span_attrs = {"fn": name or getattr(
            getattr(raw, "func", raw), "__name__", "program")}
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
            with _otrace.span("jit/compile", dict(self.span_attrs)):
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
        with _tallying(stream.cuda_stream) as tally, _collector_held(), \
                _owning(pool), \
                torch.cuda.graph(graph, pool=pool.handle, stream=stream,
                                 capture_error_mode="thread_local"):
            static = self.raw(params, state, *inputs)
        bound.launches = tally
        caller.wait_stream(stream)
        bound.graph, bound.outputs = graph, static
        self.capture_ms.append((time.perf_counter() - t0) * 1e3)
        return outs

    def outputs(self, state, generator=None):
        """The output buffers later calls for ``state`` (and
        ``generator``) return, or None before its first call. A first
        call on CUDA returns its warm-up's tensors instead; a caller that
        keeps the outputs' addresses (the sentinel's probe reads the
        gradients where they are) takes these."""
        with self._lock:
            per_state = self._bound.get(state)
            bound = None if per_state is None else per_state.get(generator)
        return None if bound is None else bound.outputs

    def release(self):
        """Drop every graph of this program."""
        with self._lock:
            self._bound = weakref.WeakKeyDictionary()
