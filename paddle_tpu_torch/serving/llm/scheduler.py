"""ContinuousBatcher + LLMEngine: the token-level serving loop (counterpart
of ``paddle_tpu/serving/llm/scheduler.py``).

One worker thread runs decode ticks over all KV slots; between ticks,
sequences join (bucketed prefill into a free slot, straight off the
:class:`BatchQueue`) or leave (eos, length budget, mid-stream deadline
eviction) — continuous batching: admission never waits for the current
batch to finish, and a finished sequence's slot is reusable on the next
tick. Host<->device traffic per tick is one fetch of the ``[num_slots]``
next-token vector, which streaming needs on the host anyway. The decode
step and each prefill bucket run as compiled programs from the engine's
``ExecutableCache`` (``cache=``, the process-wide ``default_cache()``
when None): captured as CUDA graphs at warm-up and replayed every tick;
the per-slot device vectors they read are static buffers, written in
place between ticks and never rebound.

Drain stops admission and lets the worker finish every in-flight and
queued sequence; ``pause_admission`` stops admission alone; ``kill``
fails the queue and aborts the in-flight sequences before the next tick.
Both KV layouts are served: ``kv_layout="slot"`` (the default, the
static-slot :class:`GPTStaticDecoder` under this module's
:class:`ContinuousBatcher`) and ``kv_layout="paged"`` (``paged/``). The
knobs of later slices (``spec_k > 0``, ``prefix_cache``, int8 weights or
KV, ``measure_mfu``) raise ``NotImplementedError`` naming the queue item
in ``ROADMAP.md``; crash recovery (evacuation for replay), migration and
weight hot-swap are not ported yet.
"""
from __future__ import annotations

import itertools
import queue as _pyqueue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ...core.monitor import StatRegistry
from ..buckets import pow2_buckets
from ..cache import ExecutableCache, default_cache
from ..engine import DrainableEngineBase
from ..queue import BatchQueue
from ..request import (Deadline, DeadlineExceeded, EngineDraining,
                       EngineKilled, RequestTooLarge)
from .decode import (GPTDecoderBase, GPTStaticDecoder, SamplingParams,
                     pack_sampling)
from .kvcache import _later

_REQ_IDS = itertools.count(1)
_STREAM_END = object()


class GenerationRequest:
    """One queued generation: prompt + sampling params + result future.

    The future resolves to ``{"tokens": [...], "finish_reason": ...,
    "req_id": ...}``; with ``stream=True``, :meth:`iter_tokens` yields the
    tokens as ticks produce them.
    """

    __slots__ = ("req_id", "prompt", "sampling", "deadline", "future",
                 "t_enqueue", "t_first_token", "tokens", "finish_reason",
                 "_stream_q", "_clock", "_t_last")

    def __init__(self, prompt, sampling: SamplingParams,
                 deadline: Optional[Deadline] = None, stream: bool = False,
                 clock=time.monotonic):
        arr = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if arr.size < 1:
            raise ValueError("prompt must contain at least one token")
        self.req_id = next(_REQ_IDS)
        self.prompt = arr
        self.sampling = sampling
        self.deadline = deadline
        self.future: Future = Future()
        self._clock = clock
        self.t_enqueue = clock()
        self.t_first_token: Optional[float] = None
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self._stream_q = _pyqueue.Queue() if stream else None
        self._t_last: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def seq_len(self) -> int:
        """Prompt plus generated tokens."""
        return self.prompt_len + len(self.tokens)

    @property
    def expired(self) -> bool:
        return self.deadline is not None and self.deadline.expired()

    def fail(self, exc: BaseException) -> bool:
        if self.future.done():
            return False
        self.future.set_exception(exc)
        if self._stream_q is not None:
            self._stream_q.put(exc)
            self._stream_q.put(_STREAM_END)
        return True

    def fail_expired(self) -> bool:
        return self.fail(DeadlineExceeded(
            f"generation request {self.req_id} exceeded its "
            f"{self.deadline.seconds}s deadline"))

    def _emit(self, tok: int):
        if self.t_first_token is None:
            self.t_first_token = self._clock()
        self.tokens.append(tok)
        if self._stream_q is not None:
            self._stream_q.put(tok)

    def _finish(self, reason: str):
        self.finish_reason = reason
        if not self.future.done():
            self.future.set_result(
                {"tokens": list(self.tokens), "finish_reason": reason,
                 "req_id": self.req_id})
        if self._stream_q is not None:
            self._stream_q.put(_STREAM_END)

    def iter_tokens(self, timeout: Optional[float] = None):
        """Yield tokens as they are generated (``stream=True`` only);
        raises the failure on eviction or abort."""
        if self._stream_q is None:
            raise ValueError("request was not submitted with stream=True")
        while True:
            item = self._stream_q.get(timeout=timeout)
            if item is _STREAM_END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def result(self, timeout: Optional[float] = None) -> dict:
        return self.future.result(timeout)


class LLMEngineConfig:
    """Tunables of the LLM engine; same fields and validation as the JAX
    package's ``LLMEngineConfig``."""

    def __init__(self,
                 num_slots: int = 8,
                 max_seq: int = 256,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 max_queue: int = 256,
                 admission_block: bool = True,
                 admission_timeout: Optional[float] = 2.0,
                 default_deadline: Optional[float] = None,
                 default_max_new_tokens: int = 64,
                 max_top_k: int = 64,
                 idle_poll: float = 0.01,
                 warmup: bool = True,
                 seed: int = 0,
                 measure_mfu: bool = False,
                 prefix_cache: bool = False,
                 prefix_block: int = 16,
                 prefix_capacity_mb: float = 256.0,
                 spec_k: int = 0,
                 role: str = "mixed",
                 weight_dtype: str = "float32",
                 kv_dtype: str = "float32",
                 kv_layout: str = "slot",
                 page_size: int = 16,
                 num_pages: Optional[int] = None,
                 paged_attn_impl: str = "auto",
                 stat_prefix: str = "serving.llm"):
        self.num_slots = int(num_slots)
        self.max_seq = int(max_seq)
        if prefill_buckets is None:
            prefill_buckets = pow2_buckets(self.max_seq,
                                           start=min(8, self.max_seq))
        buckets = tuple(sorted(set(int(b) for b in prefill_buckets)))
        if not buckets or buckets[0] < 1 or buckets[-1] > self.max_seq:
            raise ValueError(
                f"prefill buckets must lie in [1, max_seq={self.max_seq}]; "
                f"got {buckets}")
        self.prefill_buckets = buckets
        self.max_queue = int(max_queue)
        self.admission_block = bool(admission_block)
        self.admission_timeout = admission_timeout
        self.default_deadline = default_deadline
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.max_top_k = int(max_top_k)
        self.idle_poll = float(idle_poll)
        self.warmup = bool(warmup)
        self.seed = int(seed)
        self.measure_mfu = bool(measure_mfu)
        self.prefix_cache = bool(prefix_cache)
        self.prefix_block = int(prefix_block)
        self.prefix_capacity_mb = float(prefix_capacity_mb)
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        self.spec_k = int(spec_k)
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(
                f"role must be prefill/decode/mixed, got {role!r}")
        self.role = role
        if weight_dtype not in ("float32", "int8"):
            raise ValueError(
                f"weight_dtype must be 'float32' or 'int8', got "
                f"{weight_dtype!r}")
        if kv_dtype not in ("float32", "int8"):
            raise ValueError(
                f"kv_dtype must be 'float32' or 'int8', got {kv_dtype!r}")
        if kv_dtype == "int8" and self.prefix_cache:
            raise ValueError(
                "prefix_cache requires a dense KV cache. Set "
                "kv_dtype='float32' or prefix_cache=False.")
        if kv_dtype == "int8" and self.spec_k > 0:
            raise ValueError(
                "speculative decoding (spec_k > 0) requires a dense KV "
                "cache. Set kv_dtype='float32' or spec_k=0.")
        self.weight_dtype = weight_dtype
        self.kv_dtype = kv_dtype
        if kv_layout not in ("slot", "paged"):
            raise ValueError(
                f"kv_layout must be 'slot' or 'paged', got {kv_layout!r}")
        if paged_attn_impl not in ("auto", "gather", "kernel"):
            raise ValueError(
                f"paged_attn_impl must be 'auto', 'gather' or 'kernel', "
                f"got {paged_attn_impl!r}")
        self.kv_layout = kv_layout
        self.page_size = int(page_size)
        self.num_pages = None if num_pages is None else int(num_pages)
        self.paged_attn_impl = paged_attn_impl
        if kv_layout == "paged":
            if self.page_size < 1 or self.max_seq % self.page_size:
                raise ValueError(
                    f"page_size {self.page_size} must divide "
                    f"max_seq {self.max_seq}")
            if self.num_pages is not None and self.num_pages < \
                    self.max_seq // self.page_size:
                raise ValueError(
                    f"num_pages {self.num_pages} cannot hold even one "
                    f"max_seq sequence "
                    f"({self.max_seq // self.page_size} pages)")
        self.stat_prefix = stat_prefix

    @property
    def max_prompt_len(self) -> int:
        """Longest admissible prompt: fits a bucket and leaves room for
        one generated token."""
        return min(self.prefill_buckets[-1], self.max_seq - 1)

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.prefill_buckets:
            if prompt_len <= b:
                return b
        raise RequestTooLarge(
            f"prompt of {prompt_len} tokens exceeds the largest prefill "
            f"bucket ({self.prefill_buckets[-1]})")


class ContinuousBatcher:
    """Slot scheduling state and the per-tick device interaction.

    Owns the KV cache, the per-slot device vectors (``finished``,
    ``last_tokens``, packed sampling params), the sampling generator and
    the slot -> request table. ``admit`` prefills and delivers the first
    token; ``tick`` advances every active sequence one token and retires
    finished or evicted slots. Only the engine worker calls in.
    """

    def __init__(self, decoder: GPTDecoderBase, config: LLMEngineConfig,
                 registry: StatRegistry, clock=time.monotonic):
        self.decoder = decoder
        self.config = config
        self._registry = registry
        self._prefix = config.stat_prefix
        self._clock = clock
        self.device = decoder.device
        self.kv = decoder.new_kv(config.num_slots, config.max_seq)
        self._params = decoder.params()
        self._reqs: Dict[int, GenerationRequest] = {}
        self._slot_samp: List[SamplingParams] = [
            SamplingParams() for _ in range(config.num_slots)]
        # static buffers: the compiled programs bind these addresses, so
        # they are written in place and never rebound
        self._samp_vecs = pack_sampling(self._slot_samp, self.device)
        self._finished = torch.zeros((config.num_slots,), dtype=torch.bool,
                                     device=self.device)
        self._last = torch.zeros((config.num_slots,), dtype=torch.int32,
                                 device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(config.seed)

    # -- introspection -------------------------------------------------------
    @property
    def active(self) -> int:
        return len(self._reqs)

    @property
    def free_slots(self) -> int:
        return self.kv.free_slots

    # -- internals -----------------------------------------------------------
    def _stat_add(self, name, v):
        self._registry.add(f"{self._prefix}.{name}", v)

    def _stat_set(self, name, v):
        self._registry.set(f"{self._prefix}.{name}", v)

    def _stat_observe(self, name, v):
        self._registry.observe(f"{self._prefix}.{name}", v)

    def _ids(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int32, device=self.device)

    def _prefill_one(self, req: GenerationRequest, slot: int):
        """Bucketed prefill of ``req`` into ``slot``; returns the first
        token as a ``[1]`` device tensor."""
        lp = self.config.bucket_for(req.prompt_len)
        padded = np.zeros((1, lp), np.int32)
        padded[0, :req.prompt_len] = req.prompt
        nxt, finished = self.decoder.prefill(
            self.kv, self._params,
            torch.from_numpy(padded).to(self.device),
            self._ids([req.prompt_len]), self._ids([slot]),
            self._finished, pack_sampling([req.sampling], self.device),
            self._gen)
        self._finished.copy_(finished)
        return nxt

    def _start(self, req: GenerationRequest, slot: int, t0: float):
        """Register ``req`` in ``slot``, prefill it and deliver its first
        token (the fetch streaming needs for time to first token)."""
        self._reqs[slot] = req
        self._slot_samp[slot] = req.sampling
        for dst, src in zip(self._samp_vecs,
                            pack_sampling(self._slot_samp, self.device)):
            dst.copy_(src)
        nxt = self._prefill_one(req, slot)
        self._last[slot] = nxt[0]
        tok = int(nxt[0].item())
        now = self._clock()
        self._stat_observe("prefill_ms", (now - t0) * 1000.0)
        self._stat_observe("ttft_ms", (now - req.t_enqueue) * 1000.0)
        self._stat_add("prefills", 1)
        req._emit(tok)
        req._t_last = now
        self._stat_add("tokens_generated", 1)
        self._maybe_finish(slot, req, tok)

    # -- scheduling ----------------------------------------------------------
    def admit(self, req: GenerationRequest):
        """Prefill ``req`` into a free slot and deliver its first token.
        The caller guarantees ``free_slots > 0`` and a bucket-fitting
        prompt (``submit`` validated both)."""
        t0 = self._clock()
        self._start(req, self.kv.alloc(), t0)

    def tick(self) -> int:
        """One decode tick: advance every slot, deliver tokens, retire
        finished slots. Returns the number of sequences advanced."""
        if not self._reqs:
            return 0
        t0 = self._clock()
        nxt, finished = self.decoder.decode_step(
            self.kv, self._params, self._finished, self._last,
            self._samp_vecs, self._gen)
        self._finished.copy_(finished)
        self._last.copy_(nxt)
        # THE one host fetch of the tick: streaming delivery and host-side
        # finish detection both need the [num_slots] token vector
        toks = nxt.cpu().numpy()
        n = len(self._reqs)
        dt = max(self._clock() - t0, 1e-9)
        self._stat_observe("decode_tick_ms", dt * 1000.0)
        self._stat_observe("tpot_ms", dt * 1000.0)
        self._stat_add("tokens_generated", n)
        self._stat_add("decode_ticks", 1)
        self._stat_set("tokens_per_sec", n / dt)
        now = self._clock()
        for slot, req in list(self._reqs.items()):
            if req.expired:
                self._evict(slot, req)
                continue
            tok = int(toks[slot])
            req._emit(tok)
            if req._t_last is not None:
                self._stat_observe("intertoken_ms",
                                   (now - req._t_last) * 1000.0)
            req._t_last = now
            self._maybe_finish(slot, req, tok)
        return n

    def _maybe_finish(self, slot: int, req: GenerationRequest, tok: int):
        s = req.sampling
        if s.eos_token_id is not None and tok == int(s.eos_token_id):
            self._release(slot, req, "stop")
        elif len(req.tokens) >= s.max_new_tokens:
            self._release(slot, req, "length")
        elif req.seq_len >= self.config.max_seq:
            self._release(slot, req, "length")

    def _release(self, slot: int, req: GenerationRequest, reason: str):
        del self._reqs[slot]
        self.kv.free(slot)
        req._finish(reason)
        self._stat_add("completed", 1)
        self._stat_observe("request_latency_ms",
                           (self._clock() - req.t_enqueue) * 1000.0)

    def _evict(self, slot: int, req: GenerationRequest):
        """Mid-stream deadline eviction: the slot is reclaimed and the
        future fails."""
        del self._reqs[slot]
        self.kv.free(slot)
        req.fail(DeadlineExceeded(
            f"generation request {req.req_id} exceeded its "
            f"{req.deadline.seconds}s deadline after "
            f"{len(req.tokens)} tokens"))
        self._stat_add("evicted_midstream", 1)

    def abort_all(self, exc_factory):
        """Fail every in-flight sequence (the worker died)."""
        for slot, req in list(self._reqs.items()):
            del self._reqs[slot]
            self.kv.free(slot)
            req.fail(exc_factory(req))

    # -- warmup --------------------------------------------------------------
    def warmup(self):
        """Run one prefill per bucket and one decode step through the real
        buffers before serving: each is its program's first call, which
        captures it on CUDA (and builds the kernels), so no request pays
        a capture. Then reset the slot state in place."""
        t0 = self._clock()
        samp = pack_sampling([SamplingParams()], self.device)
        slot0 = self._ids([0])
        for lp in self.config.prefill_buckets:
            self.decoder.prefill(
                self.kv, self._params,
                torch.zeros((1, lp), dtype=torch.int32, device=self.device),
                self._ids([lp]), slot0, self._finished, samp, self._gen)
        nxt, _ = self.decoder.decode_step(
            self.kv, self._params, self._finished, self._last,
            self._samp_vecs, self._gen)
        nxt.cpu()
        self._stat_set("warmup_decode_steps", 1)
        self.kv.reset()
        self._finished.zero_()
        self._last.zero_()
        self._stat_set("warmup_ms", (self._clock() - t0) * 1000.0)


class LLMEngine(DrainableEngineBase):
    """submit()/generate()/drain() continuous-batching generation over one
    GPT model, on the model's device. Construction warms up (optionally)
    and starts the worker thread."""

    def __init__(self, model, config: Optional[LLMEngineConfig] = None,
                 registry: Optional[StatRegistry] = None,
                 cache: Optional[ExecutableCache] = None,
                 draft_model=None):
        self._config = config or LLMEngineConfig()
        cfg = self._config
        if cfg.spec_k > 0 or draft_model is not None:
            raise _later("speculative decoding (spec_k > 0)", "A6")
        if cfg.prefix_cache:
            raise _later("prefix caching (prefix_cache=True)", "A6/A7")
        if cfg.measure_mfu:
            raise _later("measure_mfu", "A8")
        self._init_serving_base(registry, cfg.stat_prefix)
        # `is not None`: an empty ExecutableCache has len() 0 and is falsy
        self._cache = cache if cache is not None else default_cache()
        if cfg.kv_layout == "paged":
            # lazy import: paged/batcher imports this module's classes
            from .paged import GPTPagedDecoder, PagedBatcher
            self._decoder = GPTPagedDecoder(
                model, max_top_k=cfg.max_top_k,
                weight_dtype=cfg.weight_dtype, kv_dtype=cfg.kv_dtype,
                page_size=cfg.page_size, num_pages=cfg.num_pages,
                attn_impl=cfg.paged_attn_impl, exec_cache=self._cache)
            self._batcher = PagedBatcher(self._decoder, cfg, self._registry)
        else:
            self._decoder = GPTStaticDecoder(
                model, max_top_k=cfg.max_top_k, exec_cache=self._cache,
                weight_dtype=cfg.weight_dtype, kv_dtype=cfg.kv_dtype)
            self._batcher = ContinuousBatcher(self._decoder, cfg,
                                              self._registry)
        self._queue = BatchQueue(max_size=cfg.max_queue)
        if cfg.warmup:
            self._batcher.warmup()
        self._worker = threading.Thread(
            target=self._worker_loop, name="paddle-tpu-torch-llm-worker",
            daemon=True)
        self._worker.start()

    # -- public API ----------------------------------------------------------
    @property
    def config(self) -> LLMEngineConfig:
        return self._config

    @property
    def cache(self) -> ExecutableCache:
        """The cache the decoder's compiled programs live in."""
        return self._cache

    @property
    def decoder(self) -> GPTDecoderBase:
        return self._decoder

    def submit(self, prompt, *, max_new_tokens: Optional[int] = None,
               do_sample: bool = False, temperature: float = 1.0,
               top_k: int = 0, eos_token_id: Optional[int] = None,
               deadline: Optional[Union[Deadline, float]] = None,
               stream: bool = False) -> GenerationRequest:
        """Enqueue one prompt; returns the :class:`GenerationRequest`
        (``.result()`` for the whole result, ``.iter_tokens()`` when
        ``stream=True``)."""
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
        arr = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if arr.size > self._config.max_prompt_len:
            self._stat_add("rejected_oversize", 1)
            raise RequestTooLarge(
                f"prompt of {arr.size} tokens exceeds max_prompt_len="
                f"{self._config.max_prompt_len} (largest prefill bucket "
                f"capped at max_seq-1)")
        if top_k > self._decoder.max_top_k:
            raise ValueError(
                f"top_k={top_k} exceeds the engine's max_top_k="
                f"{self._decoder.max_top_k}")
        if max_new_tokens is None:
            max_new_tokens = self._config.default_max_new_tokens
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if deadline is None and self._config.default_deadline is not None:
            deadline = self._config.default_deadline
        if deadline is not None and not isinstance(deadline, Deadline):
            deadline = Deadline(float(deadline))
        samp = SamplingParams(
            do_sample=bool(do_sample), temperature=float(temperature),
            top_k=int(top_k), eos_token_id=eos_token_id,
            max_new_tokens=int(max_new_tokens))
        req = GenerationRequest(arr, samp, deadline=deadline, stream=stream)
        try:
            self._queue.put(req, block=self._config.admission_block,
                            timeout=self._config.admission_timeout)
        except Exception:
            self._stat_add("rejected_queue_full", 1)
            raise
        self._stat_set("queue_depth", len(self._queue))
        return req

    def generate(self, prompt, **kw) -> dict:
        """Synchronous convenience: submit and wait."""
        return self.submit(prompt, **kw).result()

    def kill(self, reason: str = "killed") -> List[dict]:
        """Hard kill, returning one record per affected request (id,
        phase, tokens emitted): queued requests fail here, in-flight
        generations are aborted with :class:`EngineKilled` by the worker
        before its next tick."""
        inflight = [{"req_id": r.req_id, "phase": "decode",
                     "tokens": len(r.tokens)}
                    for r in list(self._batcher._reqs.values())]
        return list(super().kill(reason)) + inflight

    def drain(self, timeout: Optional[float] = None) -> List:
        """Stop admission, finish every in-flight and queued sequence,
        stop the worker. Returns the requests in flight when the drain
        began (all resolved on return unless ``timeout`` ran out)."""
        inflight = list(self._batcher._reqs.values())
        self.begin_drain()
        self._stopped.wait(timeout)
        self._stat_set("queue_depth", 0)
        return inflight

    def stats(self) -> dict:
        """Scalar stats, histogram summaries, slot occupancy, the KV
        buffers' device bytes and the bytes of the memory pool their
        graphs share (0 on the CPU), the executable cache's counters, and
        page occupancy (paged layout; None for the slot layout)."""
        pre = self._prefix + "."
        kv = self._batcher.kv
        paged = self._config.kv_layout == "paged"
        return {
            "stats": self._registry.stats_with_prefix(pre),
            "histograms": self._registry.histograms_with_prefix(pre),
            "draining": self.draining,
            "queue_depth": len(self._queue),
            "slots": {"total": self._config.num_slots,
                      "in_use": self._batcher.active,
                      "free": self._batcher.free_slots},
            "role": self._config.role,
            "kv_layout": self._config.kv_layout,
            "device": str(self._decoder.device),
            "kv_bytes": kv.kv_bytes(),
            "graph_pool_bytes": kv.graph_pool.nbytes(),
            "executable_cache": self._cache.stats(),
            "pages": ({"total": kv.pool.num_pages,
                       "free": kv.pool.free_pages,
                       "pending": len(self._batcher._pending),
                       "kv_bytes": kv.kv_bytes()} if paged else None),
        }

    # -- worker --------------------------------------------------------------
    def _worker_loop(self):
        cfg = self._config
        try:
            while True:
                if self._killed.is_set():
                    # queued requests were failed by kill() itself
                    self._batcher.abort_all(
                        lambda req: EngineKilled(
                            f"engine hard-killed ({self._kill_reason}) "
                            f"with request {req.req_id} in flight after "
                            f"{len(req.tokens)} tokens"))
                    return
                if self._draining.is_set() and not self._queue.closed:
                    self._queue.close()
                free = self._batcher.free_slots
                if free > 0:
                    timeout = 0.0 if self._batcher.active else cfg.idle_poll
                    for req in self._queue.take_many(free, timeout=timeout):
                        self._batcher.admit(req)
                self._stat_set("queue_depth", len(self._queue))
                self._stat_set("deadline_evicted_queued",
                               self._queue.evicted_expired)
                self._stat_set("slots_in_use", self._batcher.active)
                if self._batcher.active:
                    self._batcher.tick()
                elif self._draining.is_set() and len(self._queue) == 0:
                    break
        except BaseException as e:  # worker death must not strand futures
            self._batcher.abort_all(
                lambda req, e=e: RuntimeError(
                    f"LLM worker died while request {req.req_id} was in "
                    f"flight: {e!r}"))
            raise
        finally:
            self._stopped.set()
