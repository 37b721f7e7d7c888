"""Engine: the dynamic-batching inference front door, and the drain
plumbing serving engines share (counterpart of
``paddle_tpu/serving/engine.py``: ``EngineConfig``,
``DrainableEngineBase`` and ``Engine``).

One worker thread runs the dispatch loop: form a bucketed batch
(:class:`~.batcher.DynamicBatcher`), concatenate and zero-pad the
requests' numpy rows up to the bucket, move them to the engine's device
as torch tensors, count the padded signature in the shape-keyed
:class:`~.cache.ExecutableCache`, run the model, bring the outputs back
as numpy, slice them apart and resolve each request's future. Stats go
to a
:class:`~paddle_tpu_torch.core.monitor.StatRegistry` (queue depth, batch
fill, latency and batch time histograms, cache counters). Drain is
graceful: admission stops, queued work flushes, every admitted future
resolves. :meth:`DrainableEngineBase.kill` is the hard stop.

The model is a callable ``fn(*tensors) -> tensor or list of tensors``
taking one tensor per request input, rows first, on the engine's
device. Predictors and ``jit.save`` artifact paths are not ported yet
(ROADMAP.md queue A11); preemption guards and signal handlers neither
(A8). Tracing spans and the flight recorder of the JAX package are not
ported (A8).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import InvalidStateError
from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..core.monitor import StatRegistry
from .batcher import Batch, DynamicBatcher
from .buckets import BucketSpec, pad_rows, pad_seq, unpad_rows
from .cache import ExecutableCache, signature_of
from .queue import BatchQueue
from .request import (Deadline, EngineDraining, EngineKilled,
                      InferenceRequest, RequestTooLarge)


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: a later slice of the port "
        f"(ROADMAP.md queue {item})")


class EngineConfig:
    """Tunables for the serving engine."""

    def __init__(self,
                 batch_buckets: Sequence[int] = (),
                 seq_buckets: Optional[Sequence[int]] = None,
                 max_batch: int = 64,
                 max_queue: int = 256,
                 max_batch_delay: float = 0.005,
                 admission_block: bool = True,
                 admission_timeout: Optional[float] = 2.0,
                 oversize_policy: str = "split",
                 default_deadline: Optional[float] = None,
                 stat_prefix: str = "serving"):
        self.buckets = BucketSpec(batch_buckets, seq_buckets,
                                  max_batch=max_batch)
        self.max_queue = int(max_queue)
        self.max_batch_delay = float(max_batch_delay)
        self.admission_block = bool(admission_block)
        self.admission_timeout = admission_timeout
        if oversize_policy not in ("split", "reject"):
            raise ValueError(
                f"oversize_policy must be 'split' or 'reject', "
                f"got {oversize_policy!r}")
        self.oversize_policy = oversize_policy
        self.default_deadline = default_deadline
        self.stat_prefix = stat_prefix


class DrainableEngineBase:
    """Drain, admission pause and hard kill shared by :class:`Engine` and
    the LLM engine.

    Subclasses call :meth:`_init_serving_base` in ``__init__``, own a
    ``BatchQueue`` in ``self._queue`` and run one worker thread that
    polls :attr:`draining`.
    """

    def _init_serving_base(self, registry: Optional[StatRegistry],
                           stat_prefix: str):
        self._registry = registry if registry is not None else StatRegistry()
        self._prefix = stat_prefix
        self._draining = threading.Event()
        self._stopped = threading.Event()
        self._admission_paused = threading.Event()
        self._killed = threading.Event()
        self._kill_reason = ""

    @property
    def registry(self) -> StatRegistry:
        return self._registry

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def arm_preemption(self, guard=None):
        raise _later("arm_preemption (drain on a PreemptionGuard)", "A8")

    def install_drain_signal_handler(self, signals=None):
        raise _later("install_drain_signal_handler", "A8")

    def begin_drain(self):
        """Stop admission and let the worker flush the queue
        (non-blocking)."""
        self._draining.set()
        self._queue.close()

    @property
    def admission_paused(self) -> bool:
        return self._admission_paused.is_set()

    def pause_admission(self):
        """Stop admitting new requests without draining: queued and
        in-flight work completes, the worker stays alive, and
        :meth:`resume_admission` reopens the front door."""
        self._admission_paused.set()

    def resume_admission(self):
        self._admission_paused.clear()

    @property
    def was_killed(self) -> bool:
        return self._killed.is_set()

    def kill(self, reason: str = "killed") -> List[dict]:
        """Hard kill: fail every queued request with :class:`EngineKilled`
        at once (unlike drain, nothing is flushed) and flag the worker to
        stop at its next poll point. Returns one record per failed
        request (``{"req_id", "phase", "tokens"}``). Safe from any
        thread; idempotent."""
        self._kill_reason = str(reason)
        self._killed.set()
        self._draining.set()
        return self._queue.fail_all(
            lambda: EngineKilled(
                f"engine hard-killed ({self._kill_reason}); "
                f"request aborted before execution"))

    def _stat_add(self, name: str, v):
        self._registry.add(f"{self._prefix}.{name}", v)

    def _stat_set(self, name: str, v):
        self._registry.set(f"{self._prefix}.{name}", v)

    def _stat_observe(self, name: str, v):
        self._registry.observe(f"{self._prefix}.{name}", v)


class Engine(DrainableEngineBase):
    """submit()/submit_many()/drain() over a batched, cached callable
    model on one device (CUDA unless ``device="cpu"``)."""

    def __init__(self, model: Callable[..., Any],
                 config: Optional[EngineConfig] = None,
                 registry: Optional[StatRegistry] = None,
                 cache: Optional[ExecutableCache] = None, *,
                 device: DeviceLike = None):
        if isinstance(model, str) or callable(getattr(model, "run", None)):
            raise _later("Engine over a Predictor or a jit.save artifact",
                         "A11")
        if not callable(model):
            raise TypeError(f"model must be a callable; got "
                            f"{type(model).__name__}")
        self._device = resolve_device(device)
        self._config = config or EngineConfig()
        self._init_serving_base(registry, self._config.stat_prefix)
        self._model_fn = model
        # the callable runs eagerly: the cache only records which padded
        # signatures this engine has seen. Its key is a token of the
        # engine's own, never the model, so no cache keeps a model (and
        # its weights on the card) alive; each engine counts on its own
        # cache unless given a shared one
        self._cache_token = object()
        self._cache = cache if cache is not None else ExecutableCache()
        self._queue = BatchQueue(max_size=self._config.max_queue)
        self._batcher = DynamicBatcher(
            self._queue, self._config.buckets,
            max_batch_delay=self._config.max_batch_delay)
        # admitted-but-unresolved futures, keyed to their request id so
        # kill() can return an exact snapshot of what was in flight
        self._inflight: dict = {}
        self._inflight_lock = threading.Lock()
        self._worker = threading.Thread(
            target=self._worker_loop, name="paddle-tpu-torch-serving-worker",
            daemon=True)
        self._worker.start()

    # -- public API ---------------------------------------------------------
    @property
    def config(self) -> EngineConfig:
        return self._config

    @property
    def cache(self) -> ExecutableCache:
        return self._cache

    @property
    def device(self) -> torch.device:
        return self._device

    def submit(self, inputs: Sequence[np.ndarray],
               deadline: Optional[Union[Deadline, float]] = None):
        """Enqueue one request; returns a ``concurrent.futures.Future``
        whose result is the list of output arrays (numpy, rows matching
        the request's rows)."""
        if self._killed.is_set():
            self._stat_add("rejected_killed", 1)
            raise EngineKilled(
                f"engine was hard-killed ({self._kill_reason}); "
                f"submit rejected")
        if self._draining.is_set():
            self._stat_add("rejected_draining", 1)
            raise EngineDraining("engine is draining; submit rejected")
        if self._admission_paused.is_set():
            self._stat_add("rejected_paused", 1)
            raise EngineDraining(
                "engine admission is paused; submit rejected")
        if deadline is None and self._config.default_deadline is not None:
            deadline = self._config.default_deadline
        if deadline is not None and not isinstance(deadline, Deadline):
            deadline = Deadline(float(deadline))
        req = InferenceRequest(inputs, deadline=deadline)
        if (self._config.oversize_policy == "reject"
                and req.nrows > self._config.buckets.max_batch):
            self._stat_add("rejected_oversize", 1)
            raise RequestTooLarge(
                f"request has {req.nrows} rows but the largest batch bucket "
                f"is {self._config.buckets.max_batch} and oversize_policy="
                f"'reject'; split the request or raise max_batch")
        try:
            self._queue.put(req, block=self._config.admission_block,
                            timeout=self._config.admission_timeout)
        except Exception:
            self._stat_add("rejected_queue_full", 1)
            raise
        with self._inflight_lock:
            self._inflight[req.future] = req.req_id
        req.future.add_done_callback(self._forget_future)
        self._stat_set("queue_depth", len(self._queue))
        return req.future

    def submit_many(self, requests: Sequence[Sequence[np.ndarray]],
                    deadline: Optional[Union[Deadline, float]] = None):
        return [self.submit(inputs, deadline=deadline)
                for inputs in requests]

    def kill(self, reason: str = "killed") -> List[dict]:
        """Hard kill, returning records for queued requests (failed here)
        and the admitted-but-unresolved ones the worker aborts at its
        next poll point (``phase: "inflight"``)."""
        records = list(super().kill(reason))
        seen = {r["req_id"] for r in records}
        with self._inflight_lock:
            records += [{"req_id": rid, "phase": "inflight", "tokens": 0}
                        for rid in self._inflight.values()
                        if rid not in seen]
        return records

    def drain(self, timeout: Optional[float] = None) -> List:
        """Graceful drain: stop admission, flush every queued request,
        wait for the worker, and return the futures of all requests in
        flight when the drain began (all resolved on return)."""
        with self._inflight_lock:
            inflight = list(self._inflight)
        self.begin_drain()
        self._stopped.wait(timeout)
        self._stat_set("queue_depth", 0)
        return inflight

    close = drain

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.drain()
        return False

    def stats(self) -> dict:
        """Scalar stats + histogram summaries + cache counters."""
        pre = self._prefix + "."
        return {"stats": self._registry.stats_with_prefix(pre),
                "histograms": self._registry.histograms_with_prefix(pre),
                "executable_cache": self._cache.stats(),
                "draining": self.draining,
                "queue_depth": len(self._queue)}

    # -- worker -------------------------------------------------------------
    def _forget_future(self, fut):
        with self._inflight_lock:
            self._inflight.pop(fut, None)

    def _worker_loop(self):
        poll = max(0.01, self._config.max_batch_delay)
        try:
            while not self._killed.is_set():
                batch = self._batcher.next_batch(timeout=poll)
                self._stat_set("queue_depth", len(self._queue))
                self._stat_set("deadline_evicted",
                               self._queue.evicted_expired)
                if batch is None:
                    if self._draining.is_set() and len(self._queue) == 0:
                        break
                    continue
                self._execute(batch)
                self._publish_cache_stats()
        finally:
            if self._killed.is_set():
                # fail what was admitted but not resolved (queued requests
                # were failed by kill() itself)
                with self._inflight_lock:
                    victims = list(self._inflight)
                exc = EngineKilled(
                    f"engine hard-killed ({self._kill_reason}); "
                    f"in-flight request aborted")
                for fut in victims:
                    try:
                        fut.set_exception(exc)
                    except InvalidStateError:
                        pass  # resolved by a racing finish; verdict stands
            self._stopped.set()

    def _publish_cache_stats(self):
        s = self._cache.stats()
        self._stat_set("cache.hits", s["hits"])
        self._stat_set("cache.misses", s["misses"])
        self._stat_set("cache.evictions", s["evictions"])
        self._stat_set("recompiles", s["misses"])

    def _dispatch(self, arrays: List[np.ndarray]) -> List[np.ndarray]:
        """Run one padded, bucket-shaped batch through the model on the
        engine's device; outputs come back as numpy."""
        self._cache.get_or_compile(
            (self._cache_token, signature_of(arrays)), lambda: True)
        tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(self._device)
                   for a in arrays]
        outs = self._model_fn(*tensors)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        return [o.detach().cpu().numpy() if isinstance(o, torch.Tensor)
                else np.asarray(o) for o in outs]

    def _execute(self, batch: Batch):
        t0 = time.monotonic()
        reqs = batch.requests
        try:
            if batch.oversize:
                # one request wider than every bucket: run it alone in
                # max-bucket chunks and stitch the rows back together
                outs = self._execute_oversize(reqs[0], batch.seq_bucket)
                self._finish(reqs[0], outs)
            else:
                n_in = len(reqs[0].inputs)
                padded_inputs = [pad_seq(r.inputs, batch.seq_bucket)
                                 for r in reqs]
                cols = [np.concatenate([p[i] for p in padded_inputs], axis=0)
                        for i in range(n_in)]
                padded = pad_rows(cols, batch.bucket_rows)
                outs = unpad_rows(self._dispatch(padded), batch.rows)
                offset = 0
                for r in reqs:
                    self._finish(r, [o[offset:offset + r.nrows]
                                     if getattr(o, "ndim", 0) > 0 else o
                                     for o in outs])
                    offset += r.nrows
                self._stat_observe("batch_fill", batch.fill_ratio)
                self._stat_observe("batch_requests", len(reqs))
                if len(reqs) > 1:
                    self._stat_add("coalesced_batches", 1)
            self._stat_add("batches", 1)
            self._stat_add("rows", batch.rows)
            self._stat_observe("batch_exec_ms",
                               (time.monotonic() - t0) * 1000.0)
        except Exception as e:  # a failed batch fails its requests only
            self._stat_add("batch_errors", 1)
            for r in reqs:
                r.fail(e)

    def _execute_oversize(self, req: InferenceRequest,
                          seq_bucket) -> List[np.ndarray]:
        spec = self._config.buckets
        step = spec.max_batch
        chunks: List[List[np.ndarray]] = []
        inputs = pad_seq(req.inputs, seq_bucket)
        for start in range(0, req.nrows, step):
            part = [a[start:start + step] for a in inputs]
            rows = part[0].shape[0]
            padded = pad_rows(part, spec.batch_bucket_for(rows))
            chunks.append(unpad_rows(self._dispatch(padded), rows))
        self._stat_add("oversize_splits", 1)
        return [np.concatenate([c[i] for c in chunks], axis=0)
                for i in range(len(chunks[0]))]

    def _finish(self, req: InferenceRequest, outs: List[np.ndarray]):
        if req.expired:
            req.fail_expired()
            return
        if not req.future.done():
            self._stat_observe(
                "latency_ms", (time.monotonic() - req.t_enqueue) * 1000.0)
            self._stat_add("completed", 1)
            req.future.set_result(outs)
