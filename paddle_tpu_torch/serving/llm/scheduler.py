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
:class:`ContinuousBatcher`) and ``kv_layout="paged"`` (``paged/``), each
with prefix reuse (``prefix_cache=True``: a hit prefills only the
prompt's tail behind a cached head; the slot layout copies the head from
a host :class:`PrefixStore`, the paged one shares its pages) and draft-
model speculative decoding (``spec_k > 0`` with a ``draft_model``: a
tick emits 1 to k+1 tokens, ``spec.py``), and int8 serving
(``weight_dtype="int8"``: per-out-channel int8 projection weights;
``kv_dtype="int8"``: int8 KV rows with a scale each), alone or together,
on both layouts. As in the JAX package the config refuses prefix reuse
and speculation over int8 KV, and the slot engine a shared
``prefix_store`` over it; speculation over int8 weights, which the JAX
package takes and then fails in its verify, is refused at construction.
``measure_mfu`` counts the decode step's FLOPs once, at the first plain
tick (``observability.stepmeter``: the step run once on the live state,
with the lengths and the generator put back), publishes
``decode_flops_per_tick`` and, every plain tick, ``mfu`` over the
tick's wall time (token fetch included: delivered MFU). Admission is a
``serving.llm/prefill`` span, ticks ``serving.llm/decode_tick`` or
``serving.llm/spec_tick``. Preemption and signal drains are the
engine base's (``arm_preemption``, ``install_drain_signal_handler``);
the worker records ``engine_killed``, ``llm_worker_death`` and
``sigterm_drain`` in the flight recorder, dumping it when armed on the
last two.

Zero-loss serving (``serving/fleet/migrate.py``): control calls queued
by :meth:`LLMEngine._run_on_worker` run on the worker at the top of its
loop, between ticks, never under a replaying program. Over them a paged
engine exports its live sequences as host manifests
(``export_sequences``) and splices a sibling's in (``import_sequence``),
the per-slot buffers written in place. ``enable_recovery`` arms the
sequence journal (the worker notes the live requests each tick, O(1), no
host sync) and makes ``kill`` evacuate in-flight streams for a replay
elsewhere (``take_evacuated``, ``resubmit_for_recovery``) instead of
failing them; a resumed request's dedup guard verifies each re-generated
token against what its client already has. ``swap_weights`` installs a
state dict into the quiesced engine's model in place
(``Layer.set_state_dict``), so the captured programs read the new
weights with no new capture, and stamps the new ``weights_version``.
"""
from __future__ import annotations

import collections
import itertools
import os
import queue as _pyqueue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ...core.monitor import StatRegistry
from ...observability import flight as _flight
from ...observability import tracer as _otrace
from ..buckets import pow2_buckets
from ..cache import ExecutableCache, default_cache
from ..engine import DrainableEngineBase
from ..queue import BatchQueue
from ...utils.resilience import fault_injector
from ..request import (Deadline, DeadlineExceeded, EngineDraining,
                       EngineKilled, RequestTooLarge, TokenStreamDivergence)
from .decode import (GPTDecoderBase, GPTStaticDecoder, SamplingParams,
                     pack_sampling)
from .prefix import PrefixStore
from .spec import GPTSpecDecoder

_REQ_IDS = itertools.count(1)
_STREAM_END = object()


class GenerationRequest:
    """One queued generation: prompt + sampling params + result future.

    The future resolves to ``{"tokens": [...], "finish_reason": ...,
    "req_id": ..., "weights_version": ...}``; with ``stream=True``,
    :meth:`iter_tokens` yields the tokens as ticks produce them.
    """

    __slots__ = ("req_id", "prompt", "sampling", "deadline", "future",
                 "t_enqueue", "t_first_token", "tokens", "finish_reason",
                 "_stream_q", "_clock", "_t_last", "_prefix_entry",
                 "weights_version", "_replay_pos", "_resume_offset")

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
        # the prefix-store pin held while the request is in flight (the
        # batcher unpins it on every exit)
        self._prefix_entry = None
        # stamped at admission from the batcher's weight generation; a
        # generation runs on one generation (a swap waits for the slots to
        # quiesce), so its result is old weights or new, never a mix
        self.weights_version: Optional[int] = None
        # the resume-dedup guard: after a migration or replay rebinds the
        # request, `_replay_pos` is the next already-streamed token the
        # engine must verify before a new one may flow; `_resume_offset`
        # counts the generated tokens folded into the rebuilt prompt, so
        # `seq_len` is the same across resumes
        self._replay_pos: Optional[int] = None
        self._resume_offset = 0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def seq_len(self) -> int:
        """The ORIGINAL prompt plus the generated tokens: the same across
        resumes (a resumed prompt holds generated tokens, which
        ``_resume_offset`` backs out)."""
        return self.prompt_len - self._resume_offset + len(self.tokens)

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

    def begin_resume(self, n_resume: int) -> "GenerationRequest":
        """Rebind the request for resumption elsewhere with ``n_resume``
        generated tokens' state restored (a migrated KV splice or a
        journal replay): the prompt becomes ``original_prompt +
        tokens[:n_resume]``, so a plain prefill rebuilds the cache, and
        the dedup guard arms: each re-generated token of
        ``tokens[n_resume:]`` is verified against what the client has and
        swallowed. Raises :class:`TokenStreamDivergence` when ``n_resume``
        is past what the client has (a gap)."""
        n = int(n_resume)
        if n < 0 or n > len(self.tokens):
            raise TokenStreamDivergence(
                f"request {self.req_id}: cannot resume at token {n}; "
                f"the client has {len(self.tokens)} - the restored "
                f"state is AHEAD of the stream and would emit a gap")
        base = self.prompt[:self.prompt.size - self._resume_offset]
        self.prompt = (np.concatenate(
            [base, np.asarray(self.tokens[:n], np.int32)]) if n else base)
        self._resume_offset = n
        self._replay_pos = n if n < len(self.tokens) else None
        self._t_last = None
        return self

    def _emit(self, tok: int) -> bool:
        """Deliver one token. During a resume replay it is checked against
        the client's transcript and swallowed; a mismatch fails the
        request with :class:`TokenStreamDivergence` and returns False
        (the caller then forgets the slot without finishing it)."""
        if self._replay_pos is not None:
            pos = self._replay_pos
            if pos < len(self.tokens):
                if tok != self.tokens[pos]:
                    self.fail(TokenStreamDivergence(
                        f"request {self.req_id}: resumed stream produced "
                        f"token {tok} at position {pos} but the client "
                        f"already received {self.tokens[pos]} - refusing "
                        f"to corrupt the stream"))
                    return False
                self._replay_pos = pos + 1
                if self._replay_pos >= len(self.tokens):
                    self._replay_pos = None
                return True
            self._replay_pos = None
        if self.t_first_token is None:
            self.t_first_token = self._clock()
        self.tokens.append(tok)
        if self._stream_q is not None:
            self._stream_q.put(tok)
        return True

    def _finish(self, reason: str):
        self.finish_reason = reason
        if not self.future.done():
            self.future.set_result(
                {"tokens": list(self.tokens), "finish_reason": reason,
                 "req_id": self.req_id,
                 "weights_version": self.weights_version})
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
    the slot -> request table; with a ``prefix_store`` the prefix reuse
    of admission, with a ``spec_decoder`` the draft's cache (sharing the
    target cache's lengths) and the speculative tick. ``admit`` prefills
    and delivers the first token; ``tick`` advances every active sequence
    (one token, or 1..k+1 speculatively) and retires finished or evicted
    slots. Only the engine worker calls in.
    """

    def __init__(self, decoder: GPTDecoderBase, config: LLMEngineConfig,
                 registry: StatRegistry, clock=time.monotonic,
                 prefix_store: Optional[PrefixStore] = None,
                 spec_decoder: Optional[GPTSpecDecoder] = None):
        self.decoder = decoder
        self.config = config
        self._registry = registry
        self._prefix = config.stat_prefix
        self._clock = clock
        self.device = decoder.device
        self.kv = decoder.new_kv(config.num_slots, config.max_seq)
        self._params = decoder.params()
        self.prefix_store = prefix_store
        self.spec = spec_decoder
        self.kv_draft = None
        self._draft_params = None
        if spec_decoder is not None:
            # the draft cache mirrors the target's slots and positions;
            # ONE lengths tensor advances both
            self.kv_draft = spec_decoder.new_draft_kv(
                config.num_slots, config.max_seq, lengths=self.kv.lengths)
            self._draft_params = spec_decoder.draft_params()
        self._spec_proposed = 0
        self._spec_accepted = 0
        #: the weight generation: the engine's swap_weights bumps it once
        #: the slots quiesce; admission stamps it on each request
        self.weights_version = 0
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
        # measure_mfu: FLOPs of THE decode step, counted at the first
        # plain tick (0.0 when nothing was counted), and the peak
        self._decode_flops: Optional[float] = None
        self._peak_flops: Optional[float] = None

    # -- introspection -------------------------------------------------------
    @property
    def active(self) -> int:
        return len(self._reqs)

    @property
    def free_slots(self) -> int:
        return self.kv.free_slots

    def refresh_params(self):
        """Read the model's parameters again after an in-place change (a
        weight swap): the same tensors, so the captured programs read the
        new values; with int8 weights this quantizes them again into the
        decoder's resident tensors."""
        self._params = self.decoder.params()

    # -- internals -----------------------------------------------------------
    def _stat_add(self, name, v):
        self._registry.add(f"{self._prefix}.{name}", v)

    def _stat_set(self, name, v):
        self._registry.set(f"{self._prefix}.{name}", v)

    def _stat_observe(self, name, v):
        self._registry.observe(f"{self._prefix}.{name}", v)

    def _ids(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int32, device=self.device)

    def _padded(self, tokens) -> torch.Tensor:
        """``tokens`` right-padded to their prefill bucket, ``[1, Lp]``
        on the device."""
        padded = np.zeros((1, self.config.bucket_for(len(tokens))),
                          np.int32)
        padded[0, :len(tokens)] = tokens
        return torch.from_numpy(padded).to(self.device)

    def _prefill_one(self, req: GenerationRequest, slot: int, samp1):
        """Bucketed prefill of ``req`` into ``slot``; returns the first
        token as a ``[1]`` device tensor."""
        nxt, finished = self.decoder.prefill(
            self.kv, self._params, self._padded(req.prompt),
            self._ids([req.prompt_len]), self._ids([slot]),
            self._finished, samp1, self._gen)
        self._finished.copy_(finished)
        return nxt

    def _tail_prefill_one(self, req: GenerationRequest, slot: int,
                          start: int, samp1):
        """Bucketed prefill of ``req``'s tail from ``start`` into
        ``slot``, whose rows ``[0, start)`` hold the reused head; returns
        the first token as a ``[1]`` device tensor."""
        tail = req.prompt[start:]
        nxt, finished = self.decoder.tail_prefill(
            self.kv, self._params, self._padded(tail),
            self._ids([int(tail.size)]), self._ids([start]),
            self._ids([slot]), self._finished, samp1, self._gen)
        self._finished.copy_(finished)
        return nxt

    def _set_sampling(self, slot: int, sampling: SamplingParams):
        """Give ``slot`` its request's sampling, in place in the static
        vectors the programs read."""
        self._slot_samp[slot] = sampling
        for dst, src in zip(self._samp_vecs,
                            pack_sampling(self._slot_samp, self.device)):
            dst.copy_(src)

    def _lookup_prefix(self, req: GenerationRequest, step: int):
        """The prefix store's hit for ``req`` (pinned) and its reusable
        token count, shrunk by ``step`` until the padded tail bucket fits
        behind the head (a clamped write would corrupt the reused rows);
        ``(None, 0)`` on a miss. At least one prompt token prefills, the
        logits' source."""
        entry, reuse_n = self.prefix_store.lookup(
            req.prompt, req.prompt_len - 1, self.decoder.prefix_sig(self.kv))
        while reuse_n > 0 and reuse_n + self.config.bucket_for(
                req.prompt_len - reuse_n) > self.config.max_seq:
            reuse_n -= step
        if entry is not None and reuse_n <= 0:
            self.prefix_store.unpin(entry)
            entry, reuse_n = None, 0
        return entry, reuse_n

    def _export_prefix(self, req: GenerationRequest, slot: int):
        """After a miss's prefill: hand the block-aligned head of the
        prompt to the store (pinned by ``req`` until it leaves). The slot
        layout copies its rows to the host, one device-to-host copy."""
        blk = self.prefix_store.block_tokens
        n = (req.prompt_len // blk) * blk
        if n < blk:
            return
        t0 = self._clock()
        k_h, v_h = self.kv.host_slot_kv(slot, n)
        self._stat_observe("prefix.export_ms", (self._clock() - t0) * 1e3)
        ins = self.prefix_store.insert(req.prompt[:n], k_h, v_h,
                                       self.decoder.prefix_sig(self.kv))
        if ins is not None:
            req._prefix_entry = ins

    def _start(self, req: GenerationRequest, slot: int, t0: float,
               entry=None, reuse_n: int = 0):
        """Register ``req`` in ``slot``, prefill it (its tail only behind
        a reused head of ``reuse_n`` rows when ``entry`` hit, pinned until
        the request leaves; a miss exports its head to the store), prefill
        the draft cache under speculation, and deliver the first token
        (the fetch streaming needs for time to first token)."""
        req.weights_version = self.weights_version
        self._reqs[slot] = req
        self._set_sampling(slot, req.sampling)
        samp1 = pack_sampling([req.sampling], self.device)
        if entry is not None:
            req._prefix_entry = entry
            nxt = self._tail_prefill_one(req, slot, reuse_n, samp1)
            self._stat_add("prefix.reused_tokens", reuse_n)
        else:
            nxt = self._prefill_one(req, slot, samp1)
            if self.prefix_store is not None:
                self._export_prefix(req, slot)
        if self.spec is not None:
            # the draft never reuses prefixes (it is cheap and its K/V is
            # not stored): a full-prompt prefill, K/V kept
            self.spec.draft_prefill(
                self.kv_draft, self._draft_params, self._padded(req.prompt),
                self._ids([req.prompt_len]), self._ids([slot]),
                self._finished, samp1)
        self._last[slot] = nxt[0]
        tok = int(nxt[0].item())
        now = self._clock()
        self._stat_observe("prefill_ms", (now - t0) * 1000.0)
        self._stat_observe("ttft_ms", (now - req.t_enqueue) * 1000.0)
        self._stat_add("prefills", 1)
        if not req._emit(tok):
            self._forget(slot, req)
            return
        req._t_last = now
        self._stat_add("tokens_generated", 1)
        self._maybe_finish(slot, req, tok)

    # -- scheduling ----------------------------------------------------------
    def admit(self, req: GenerationRequest):
        """Prefill ``req`` into a free slot and deliver its first token.
        The caller guarantees ``free_slots > 0`` and a bucket-fitting
        prompt (``submit`` validated both)."""
        with _otrace.span("serving.llm/prefill"):
            self._admit_inner(req)

    def _admit_inner(self, req: GenerationRequest):
        t0 = self._clock()
        slot = self.kv.alloc()
        entry, reuse_n = None, 0
        if self.prefix_store is not None:
            entry, reuse_n = self._lookup_prefix(
                req, self.prefix_store.block_tokens)
        if entry is not None:
            # a hit: copy the cached head in, prefill only the tail
            t1 = self._clock()
            self.decoder.insert_prefix(self.kv, entry.k[:, :reuse_n],
                                       entry.v[:, :reuse_n], slot)
            self._stat_observe("prefix.insert_ms",
                               (self._clock() - t1) * 1e3)
            self.prefix_store.note_copied(
                int(entry.k[:, :reuse_n].nbytes
                    + entry.v[:, :reuse_n].nbytes))
        self._start(req, slot, t0, entry, reuse_n)

    def tick(self) -> int:
        """One decode tick: advance every slot (one token, or 1..k+1
        under speculation), deliver tokens, retire finished slots.
        Returns the number of sequences advanced."""
        if not self._reqs:
            return 0
        if self.spec is not None:
            if self._spec_room_ok():
                with _otrace.span("serving.llm/spec_tick"):
                    return self._spec_tick()
            # near the end of a row there is no room for k+1 candidate
            # rows: the plain one-token step instead
            self._stat_add("spec.fallback_ticks", 1)
        with _otrace.span("serving.llm/decode_tick"):
            return self._plain_tick()

    def _spec_room_ok(self) -> bool:
        """True when every active slot can take k+1 candidate rows: its
        next write position is ``seq_len - 1`` (the last emitted token is
        not in the cache yet) and the verify writes up to position + k."""
        k = self.spec.k
        return all(req.seq_len - 1 + k + 1 <= self.config.max_seq
                   for req in self._reqs.values())

    def _spec_tick(self) -> int:
        t0 = self._clock()
        finished, last, out_dev = self.spec.step(
            self.kv, self.kv_draft, self._params, self._draft_params,
            self._finished, self._last, self._samp_vecs, self._gen)
        self._finished.copy_(finished)
        self._last.copy_(last)
        # THE one host fetch of the tick: the packed [S, k+2]
        # (count | tokens...) matrix
        out = out_dev.cpu().numpy()
        n = len(self._reqs)
        dt = max(self._clock() - t0, 1e-9)
        total = 0
        for slot, req in list(self._reqs.items()):
            if req.expired:
                self._evict(slot, req)
                continue
            n_emit = int(out[slot, 0])
            if not req.sampling.do_sample:
                # acceptance is a greedy-lane count: sampling slots take
                # one verified token a tick by construction
                self._spec_proposed += self.spec.k
                self._spec_accepted += n_emit - 1
                self._stat_add("spec.proposed", self.spec.k)
                self._stat_add("spec.accepted", n_emit - 1)
            total += self._emit_many(slot, req, out[slot, 1:1 + n_emit])
        self._stat_observe("decode_tick_ms", dt * 1000.0)
        # per token: the tick advanced each slot total/n tokens on average
        self._stat_observe("tpot_ms", dt * 1000.0 * n / max(1, total))
        self._stat_add("tokens_generated", total)
        self._stat_set("tokens_per_sec", total / dt)
        self._stat_add("spec.ticks", 1)
        if self._spec_proposed:
            self._stat_set("spec.acceptance_rate",
                           self._spec_accepted / self._spec_proposed)
        return n

    def _emit_many(self, slot: int, req: GenerationRequest, toks) -> int:
        """Deliver a spec tick's tokens in order, stopping at the first
        finish (eos before the budgets, as :meth:`_maybe_finish`); the
        tokens past it are dropped with the slot."""
        emitted = 0
        now = self._clock()
        if req._t_last is not None:
            self._stat_observe("intertoken_ms",
                               (now - req._t_last) * 1000.0)
        req._t_last = now
        s = req.sampling
        for tok in toks:
            tok = int(tok)
            if not req._emit(tok):
                self._forget(slot, req)
                break
            emitted += 1
            if s.eos_token_id is not None and tok == int(s.eos_token_id):
                self._release(slot, req, "stop")
                break
            if len(req.tokens) >= s.max_new_tokens \
                    or req.seq_len >= self.config.max_seq:
                self._release(slot, req, "length")
                break
        return emitted

    def _plain_tick(self) -> int:
        if self.config.measure_mfu and self._decode_flops is None:
            self._measure_decode_flops()
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
        if self._decode_flops:
            # the tick's wall includes the token fetch: delivered MFU
            self._stat_set("mfu", self._decode_flops / dt / self._peak_flops)
        now = self._clock()
        for slot, req in list(self._reqs.items()):
            if req.expired:
                self._evict(slot, req)
                continue
            tok = int(toks[slot])
            if not req._emit(tok):
                self._forget(slot, req)
                continue
            if req._t_last is not None:
                self._stat_observe("intertoken_ms",
                                   (now - req._t_last) * 1000.0)
            req._t_last = now
            self._maybe_finish(slot, req, tok)
        return n

    def _measure_decode_flops(self):
        """Count THE decode step's FLOPs once (``measure_mfu``): its plain
        function runs once, eagerly, on the live cache (never inside a
        capture), and what it moves is put back: the lengths it advances
        and the generator it draws from. The K/V rows it writes at each
        slot's next position are the rows the real step writes there."""
        from ...observability import stepmeter as _sm
        fn = self.decoder.decode_fn(self.kv.num_slots, self.kv.max_seq)
        lengths = self.kv.lengths.clone()
        gen_state = self._gen.get_state()
        try:
            with _otrace.span("observability/cost_analysis"), \
                    torch.no_grad():
                flops = _sm.compiled_flops(
                    fn.raw, self._params, self.kv, self._finished,
                    self._last, self._samp_vecs, self._gen)
        finally:
            self.kv.lengths.copy_(lengths)
            self._gen.set_state(gen_state)
        self._peak_flops = _sm.default_peak_flops(self.device)
        self._decode_flops = flops if flops else 0.0
        if flops:
            self._stat_set("decode_flops_per_tick", flops)

    def _maybe_finish(self, slot: int, req: GenerationRequest, tok: int):
        s = req.sampling
        if s.eos_token_id is not None and tok == int(s.eos_token_id):
            self._release(slot, req, "stop")
        elif len(req.tokens) >= s.max_new_tokens:
            self._release(slot, req, "length")
        elif req.seq_len >= self.config.max_seq:
            self._release(slot, req, "length")

    def _unpin_prefix(self, req: GenerationRequest):
        """Drop the request's prefix-store pin, if any, as it leaves the
        engine (every exit calls this): its entry may be evicted again."""
        if req._prefix_entry is not None and self.prefix_store is not None:
            self.prefix_store.unpin(req._prefix_entry)
            req._prefix_entry = None

    def _release(self, slot: int, req: GenerationRequest, reason: str):
        del self._reqs[slot]
        self.kv.free(slot)
        self._unpin_prefix(req)
        req._finish(reason)
        self._stat_add("completed", 1)
        self._stat_observe("request_latency_ms",
                           (self._clock() - req.t_enqueue) * 1000.0)

    def _evict(self, slot: int, req: GenerationRequest):
        """Mid-stream deadline eviction: the slot is reclaimed and the
        future fails."""
        del self._reqs[slot]
        self.kv.free(slot)
        self._unpin_prefix(req)
        req.fail(DeadlineExceeded(
            f"generation request {req.req_id} exceeded its "
            f"{req.deadline.seconds}s deadline after "
            f"{len(req.tokens)} tokens"))
        self._stat_add("evicted_midstream", 1)

    def _forget(self, slot: int, req: GenerationRequest):
        """Reclaim the slot of a request that already resolved (the dedup
        guard failed it mid-replay): free its resources, touch neither
        its future nor its stream."""
        del self._reqs[slot]
        self.kv.free(slot)
        self._unpin_prefix(req)
        self._stat_add("stream_divergence", 1)

    def evacuate(self) -> List[GenerationRequest]:
        """Detach every in-flight request WITHOUT failing it (the
        zero-loss half of a hard kill): slots and prefix pins are
        reclaimed, the futures stay pending for the router's replay."""
        out: List[GenerationRequest] = []
        for slot, req in list(self._reqs.items()):
            del self._reqs[slot]
            self.kv.free(slot)
            self._unpin_prefix(req)
            out.append(req)
        return out

    def abort_all(self, exc_factory):
        """Fail every in-flight sequence (a kill without recovery, or the
        worker died)."""
        for slot, req in list(self._reqs.items()):
            del self._reqs[slot]
            self.kv.free(slot)
            self._unpin_prefix(req)
            req.fail(exc_factory(req))

    # -- warmup --------------------------------------------------------------
    def warmup(self):
        """Run one prefill per bucket (and with a prefix store one tail
        prefill, under speculation one draft prefill), one decode step and
        under speculation one spec step through the real buffers before
        serving: each is its program's first call, which captures it on
        CUDA (and builds the kernels), so no request pays a capture. Then
        reset the slot state in place."""
        t0 = self._clock()
        samp = pack_sampling([SamplingParams()], self.device)
        slot0 = self._ids([0])
        for lp in self.config.prefill_buckets:
            zeros = torch.zeros((1, lp), dtype=torch.int32,
                                device=self.device)
            self.decoder.prefill(self.kv, self._params, zeros,
                                 self._ids([lp]), slot0, self._finished,
                                 samp, self._gen)
            if self.prefix_store is not None:
                # one program per tail bucket serves every reuse offset:
                # the starts are a device input
                self.decoder.tail_prefill(
                    self.kv, self._params, zeros, self._ids([lp]),
                    self._ids([0]), slot0, self._finished, samp, self._gen)
            if self.spec is not None:
                self.spec.draft_prefill(
                    self.kv_draft, self._draft_params, zeros,
                    self._ids([lp]), slot0, self._finished, samp)
        nxt, _ = self.decoder.decode_step(
            self.kv, self._params, self._finished, self._last,
            self._samp_vecs, self._gen)
        nxt.cpu()
        self._stat_set("warmup_decode_steps", 1)
        if self.spec is not None:
            # the spec step needs room for k+1 candidate rows: run it on
            # zeroed lengths
            self.kv.reset()
            self.kv_draft.reset()
            self._finished.zero_()
            self._last.zero_()
            _, _, out = self.spec.step(
                self.kv, self.kv_draft, self._params, self._draft_params,
                self._finished, self._last, self._samp_vecs, self._gen)
            out.cpu()
            self._stat_set("warmup_spec_steps", 1)
            self.kv_draft.reset()
        self.kv.reset()
        self._finished.zero_()
        self._last.zero_()
        self._stat_set("warmup_ms", (self._clock() - t0) * 1000.0)


class LLMEngine(DrainableEngineBase):
    """submit()/generate()/drain() continuous-batching generation over one
    GPT model, on the model's device. Construction warms up (optionally)
    and starts the worker thread.

    ``draft_model`` (a small GPT on the same device and vocab) serves
    ``spec_k > 0``; ``prefix_store`` (slot layout only) shares one host
    :class:`PrefixStore` between engines and turns prefix reuse on even
    without ``prefix_cache``; a paged engine builds its own page-sharing
    store from ``prefix_cache``."""

    def __init__(self, model, config: Optional[LLMEngineConfig] = None,
                 registry: Optional[StatRegistry] = None,
                 cache: Optional[ExecutableCache] = None,
                 draft_model=None,
                 prefix_store: Optional[PrefixStore] = None):
        self._config = config or LLMEngineConfig()
        cfg = self._config
        self._init_serving_base(registry, cfg.stat_prefix)
        # `is not None`: an empty ExecutableCache has len() 0 and is falsy
        self._cache = cache if cache is not None else default_cache()
        if cfg.kv_layout == "paged":
            # lazy import: paged/batcher imports this module's classes
            from .paged import (GPTPagedDecoder, GPTPagedSpecDecoder,
                                PagedBatcher)
            if prefix_store is not None:
                raise NotImplementedError(
                    "paged engines share prefix pages inside their own "
                    "arena; an external PrefixStore cannot be attached "
                    "- set prefix_cache=True instead")
            self._decoder = GPTPagedDecoder(
                model, max_top_k=cfg.max_top_k,
                weight_dtype=cfg.weight_dtype, kv_dtype=cfg.kv_dtype,
                page_size=cfg.page_size, num_pages=cfg.num_pages,
                attn_impl=cfg.paged_attn_impl, exec_cache=self._cache)
            spec_decoder = None
            if cfg.spec_k > 0:
                spec_decoder = GPTPagedSpecDecoder(
                    self._decoder, _require_draft(draft_model),
                    k=cfg.spec_k, exec_cache=self._cache)
            self._batcher = PagedBatcher(self._decoder, cfg, self._registry,
                                         spec_decoder=spec_decoder)
            # the batcher builds its page-sharing store (it needs the
            # arena); the engine shows it as it shows the host store
            self._prefix_store = self._batcher.prefix_store
        else:
            self._decoder = GPTStaticDecoder(
                model, max_top_k=cfg.max_top_k, exec_cache=self._cache,
                weight_dtype=cfg.weight_dtype, kv_dtype=cfg.kv_dtype)
            # an explicit store (engines sharing one) turns reuse on even
            # when the config's flag is off
            if prefix_store is not None and cfg.kv_dtype == "int8":
                raise ValueError(
                    "a shared PrefixStore requires a dense KV cache "
                    "(kv_dtype='float32'): prefix export/insert moves raw "
                    "float rows between engines")
            self._prefix_store = prefix_store
            if self._prefix_store is None and cfg.prefix_cache:
                self._prefix_store = PrefixStore(
                    capacity_bytes=int(cfg.prefix_capacity_mb * (1 << 20)),
                    block_tokens=cfg.prefix_block, registry=self._registry,
                    stat_prefix=f"{cfg.stat_prefix}.prefix")
            spec_decoder = None
            if cfg.spec_k > 0:
                spec_decoder = GPTSpecDecoder(
                    self._decoder, _require_draft(draft_model),
                    k=cfg.spec_k, exec_cache=self._cache)
            self._batcher = ContinuousBatcher(
                self._decoder, cfg, self._registry,
                prefix_store=self._prefix_store, spec_decoder=spec_decoder)
        self._queue = BatchQueue(max_size=cfg.max_queue)
        # the between-tick control plane: closures queued here run on the
        # worker at the top of its loop, never under a tick (sequence
        # export and import touch batcher state and device buffers the
        # captured programs read)
        self._ctl: "collections.deque" = collections.deque()
        # held by a caller's check-and-enqueue and by the worker's exit
        # drain, so no call lands after the drain and waits out its timeout
        self._ctl_lock = threading.Lock()
        #: the crash-recovery journal, armed by :meth:`enable_recovery`
        self.journal = None
        self._evacuated: List[GenerationRequest] = []
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

    @property
    def prefix_store(self):
        """The engine's prefix store (a host :class:`PrefixStore` on the
        slot layout, a ``PagedPrefixStore`` on the paged one), or None."""
        return self._prefix_store

    @property
    def role(self) -> str:
        return self._config.role

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

    @property
    def weights_version(self) -> int:
        return self._batcher.weights_version

    def swap_weights(self, state_dict: dict, *, timeout: float = 30.0,
                     poll: float = 0.005) -> int:
        """Live weight hot-swap: copy ``state_dict`` into the model in
        place and read the parameters again, with no new engine and no
        new capture (the programs read the weights where they lie, so the
        executable cache's misses stay put). The caller pauses admission
        first; this waits until every in-flight slot retires and the
        queue is empty, so a generation runs on the old weights or on the
        new ones, never a mix. Returns the new weights version, stamped
        on every later request's result. Observes ``weight_swap_ms`` and
        adds the cache misses the swap caused to
        ``weight_swap_compiles``."""
        if not (self._admission_paused.is_set() or self._draining.is_set()):
            raise RuntimeError(
                "swap_weights requires pause_admission() first: in-flight "
                "sequences must quiesce before params change under them")
        deadline = time.monotonic() + timeout
        while self._batcher.active > 0 or len(self._queue) > 0:
            if self._killed.is_set():
                raise EngineKilled(
                    f"engine hard-killed ({self._kill_reason}) while "
                    f"quiescing for a weight swap")
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"engine did not quiesce within {timeout}s "
                    f"(active={self._batcher.active}, "
                    f"queued={len(self._queue)}); weight swap aborted")
            time.sleep(poll)
        # quiesced with admission closed: the worker touches no parameter
        # (admission and ticks need a request) until this returns
        t0 = time.perf_counter()
        with _otrace.span("serving.llm/weight_swap"):
            misses_before = self._cache.stats()["misses"]
            self._decoder.model.set_state_dict(state_dict)
            self._batcher.refresh_params()
            self._batcher.weights_version += 1
        self._stat_observe("weight_swap_ms",
                           (time.perf_counter() - t0) * 1e3)
        # programs the swap compiled or captured: 0 when it reuses them
        self._stat_add("weight_swap_compiles",
                       self._cache.stats()["misses"] - misses_before)
        self._stat_add("weight_swaps", 1)
        self._stat_set("weights_version", self._batcher.weights_version)
        _flight.record_event(
            "weight_swap",
            {"engine": self._prefix,
             "version": self._batcher.weights_version,
             "cache_misses_before": misses_before})
        return self._batcher.weights_version

    # -- zero-loss serving: migration and crash recovery ---------------------
    def _run_on_worker(self, fn, timeout: float = 30.0):
        """Run ``fn`` on the worker at the top of its next loop, between
        ticks; block until it ran and re-raise what it raised. A worker
        that exits first fails the call with :class:`EngineKilled`."""
        box: Dict[str, object] = {}
        ev = threading.Event()
        with self._ctl_lock:
            if self._stopped.is_set():
                raise EngineKilled(
                    f"engine worker already stopped "
                    f"({self._kill_reason or 'drained'})")
            self._ctl.append((fn, box, ev))
        if not ev.wait(timeout):
            raise TimeoutError(
                f"engine worker did not service the control call within "
                f"{timeout}s")
        if "exc" in box:
            raise box["exc"]
        return box.get("ret")

    @property
    def supports_migration(self) -> bool:
        """True when live sequences can be exported and imported as page
        payloads: the paged layout only (a slot engine still recovers by
        journal replay)."""
        return bool(getattr(self._batcher, "supports_export", False))

    def export_sequences(self, *, timeout: float = 30.0) -> List:
        """Snapshot and detach every live sequence, and the queued backlog
        shipped cold, as host-side ``SequenceManifest``s
        (``serving/fleet/migrate.py``). Pause admission first. Runs on the
        worker between ticks; on return the engine holds none of them and
        their futures are pending: ownership passes to the caller. Fault
        site ``seq_export``."""
        if not self.supports_migration:
            raise NotImplementedError(
                "sequence export requires the paged KV cache "
                "(kv_layout='paged')")
        action = fault_injector().fire("seq_export")
        if action == "slow_io":
            time.sleep(float(os.environ.get(
                "PADDLE_TPU_FAULT_SLOW_IO_S", "1.0")))
        elif action is not None:
            raise RuntimeError(f"injected seq_export fault: {action}")
        from ..fleet.migrate import SequenceManifest

        def _export():
            mans = self._batcher.export_all()
            if len(self._queue):
                for req in self._queue.take_many(len(self._queue),
                                                 timeout=0.0):
                    mans.append(SequenceManifest.for_queued(req))
            return mans
        mans = self._run_on_worker(_export, timeout=timeout)
        self._stat_add("migrated_out", len(mans))
        self._stat_set("queue_depth", len(self._queue))
        return mans

    def import_sequence(self, manifest, *, timeout: float = 30.0) -> bool:
        """Splice a migrated sequence in and resume it at its next token.
        False when the engine cannot take it (a cold, newer or
        other-weights manifest, other geometry, pool pressure, the
        ``seq_import`` fault site): the migrator falls back to replay."""
        if self._killed.is_set() or self._draining.is_set() \
                or self._stopped.is_set() or not self.supports_migration:
            return False
        from ..fleet.migrate import MANIFEST_VERSION
        if manifest.version != MANIFEST_VERSION or manifest.cold:
            return False
        if manifest.weights_version != self.weights_version:
            # KV computed under other weights never continues under these
            return False
        action = fault_injector().fire("seq_import")
        if action == "slow_io":
            time.sleep(float(os.environ.get(
                "PADDLE_TPU_FAULT_SLOW_IO_S", "1.0")))
        elif action is not None:
            return False
        ok = bool(self._run_on_worker(
            lambda: self._batcher.import_manifest(manifest),
            timeout=timeout))
        if ok:
            self._stat_add("migrated_in", 1)
        return ok

    def resubmit(self, req: GenerationRequest) -> bool:
        """Adopt a request that never started decoding on its donor (a
        migrated queue entry): it re-queues as if just submitted."""
        if self._killed.is_set() or self._draining.is_set() \
                or self._stopped.is_set():
            return False
        if req.tokens:       # partly streamed: the replay path
            return self.resubmit_for_recovery(req, req.tokens)
        self._queue.put(req, block=False)
        self._stat_set("queue_depth", len(self._queue))
        return True

    def resubmit_for_recovery(self, req: GenerationRequest,
                              resume_tokens) -> bool:
        """Adopt an evacuated request by REPLAY: re-prefill
        ``original_prompt + resume_tokens`` (the journaled transcript,
        possibly a few tokens behind) and let the dedup guard verify and
        swallow the re-generated gap. A transcript that contradicts the
        client's stream fails the request and raises."""
        if self._killed.is_set() or self._draining.is_set() \
                or self._stopped.is_set():
            return False
        resume = [int(t) for t in resume_tokens]
        n = min(len(resume), len(req.tokens))
        if resume[:n] != req.tokens[:n]:
            exc = TokenStreamDivergence(
                f"request {req.req_id}: journaled transcript diverges "
                f"from the client stream within the first {n} tokens")
            req.fail(exc)
            raise exc
        # the rebuilt prompt must stay admissible; a shorter resume point
        # is always safe (the gap is re-generated and verified)
        cap = self._config.max_prompt_len \
            - (req.prompt_len - req._resume_offset)
        req.begin_resume(max(0, min(n, cap)))
        self._queue.put(req, block=False)
        self._stat_add("recovered", 1)
        self._stat_set("queue_depth", len(self._queue))
        return True

    def enable_recovery(self, capacity: int = 1024):
        """Arm crash recovery (idempotent): the worker notes the live
        requests into a ``SequenceJournal`` each tick (flushed on its own
        thread), and :meth:`kill` then evacuates in-flight requests,
        futures pending, instead of failing them. Returns the journal."""
        if self.journal is None:
            from ..fleet.migrate import SequenceJournal
            self.journal = SequenceJournal(
                capacity=capacity, registry=self._registry,
                stat_prefix=f"{self._prefix}.journal")
        return self.journal

    def take_evacuated(self) -> List[GenerationRequest]:
        """Hand over the requests the worker detached at kill time
        (futures pending); ownership passes to the caller, once."""
        out, self._evacuated = self._evacuated, []
        return out

    def kill(self, reason: str = "killed") -> List[dict]:
        """Hard kill, returning one record per affected request (id,
        phase, tokens emitted, whether it is evacuated): queued requests
        fail here; in-flight generations are evacuated for replay when
        recovery is armed, else aborted with :class:`EngineKilled`, by
        the worker before its next tick."""
        journaled = self.journal is not None
        inflight = [{"req_id": r.req_id, "phase": "decode",
                     "tokens": len(r.tokens), "evacuated": journaled}
                    for r in list(self._batcher._reqs.values())]
        return list(super().kill(reason)) + inflight

    def drain(self, timeout: Optional[float] = None) -> List:
        """Stop admission, finish every in-flight and queued sequence,
        stop the worker. Returns the requests in flight when the drain
        began (all resolved on return unless ``timeout`` ran out)."""
        inflight = list(self._batcher._reqs.values())
        self.begin_drain()
        self._stopped.wait(timeout)
        if self.journal is not None:
            self.journal.close()
        self._stat_set("queue_depth", 0)
        return inflight

    close = drain

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.drain()
        return False

    def stats(self) -> dict:
        """Scalar stats, histogram summaries, slot occupancy, the KV
        buffers' device bytes and the bytes of the memory pool their
        graphs share (0 on the CPU), the executable cache's counters, the
        speculation depth, the prefix store's stats (None without one),
        and page occupancy with the COW splits (paged layout; None for the
        slot layout)."""
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
            "spec_k": self._config.spec_k,
            "prefix_store": (self._prefix_store.stats()
                             if self._prefix_store is not None else None),
            "pages": ({"total": kv.pool.num_pages,
                       "free": kv.pool.free_pages,
                       "cow_splits": kv.cow_splits,
                       "pending": len(self._batcher._pending),
                       "kv_bytes": kv.kv_bytes()} if paged else None),
        }

    # -- worker --------------------------------------------------------------
    def _worker_loop(self):
        cfg = self._config
        try:
            while True:
                while self._ctl:
                    fn, box, ev = self._ctl.popleft()
                    try:
                        box["ret"] = fn()
                    except BaseException as e:  # noqa: BLE001 -- boxed, re-raised on the calling thread
                        box["exc"] = e
                    finally:
                        ev.set()
                if self._killed.is_set():
                    return
                self._poll_drain()
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
                    if self.journal is not None and self._batcher.active:
                        # a reference enqueue: the journal's own thread
                        # copies, the tick never pays for durability
                        self.journal.note(self._batcher._reqs.values())
                elif self._draining.is_set() and len(self._queue) == 0:
                    break
                self._publish_cache_stats()
        except BaseException as e:  # worker death must not strand futures
            _flight.record_event(
                "llm_worker_death",
                {"error": f"{type(e).__name__}: {e}",
                 "active": self._batcher.active,
                 "queued": len(self._queue)})
            _flight.dump_if_armed("llm_worker_death")
            self._batcher.abort_all(
                lambda req, e=e: RuntimeError(
                    f"LLM worker died while request {req.req_id} was in "
                    f"flight: {e!r}"))
            raise
        finally:
            if self._killed.is_set():
                self._abort_killed()
            self._dump_signalled_drain()
            # unblock any control call racing the worker's exit
            with self._ctl_lock:
                while self._ctl:
                    fn, box, ev = self._ctl.popleft()
                    box["exc"] = EngineKilled(
                        "engine worker exited before servicing the "
                        "control call")
                    ev.set()
                self._stopped.set()

    def _publish_cache_stats(self):
        """The executable cache's counters as the engine's stats (the
        reference's ``cache.hits``, ``cache.misses`` and ``recompiles``,
        which ``/metricsz`` exposes)."""
        s = self._cache.stats()
        self._stat_set("cache.hits", s["hits"])
        self._stat_set("cache.misses", s["misses"])
        self._stat_set("recompiles", s["misses"])

    def _abort_killed(self):
        """After a hard kill (kill() failed the queued requests): with
        recovery armed EVACUATE the in-flight sequences, futures pending,
        for the router's replay; else abort them. Records
        ``engine_killed``."""
        n = self._batcher.active
        if self.journal is not None:
            self._evacuated.extend(self._batcher.evacuate())
        else:
            self._batcher.abort_all(
                lambda req: EngineKilled(
                    f"engine hard-killed ({self._kill_reason}) with request "
                    f"{req.req_id} in flight after {len(req.tokens)} "
                    f"tokens"))
        _flight.record_event(
            "engine_killed",
            {"engine": self._prefix, "reason": self._kill_reason,
             "aborted": 0 if self.journal is not None else n,
             "evacuated": n if self.journal is not None else 0})


def _require_draft(draft_model):
    if draft_model is None:
        raise ValueError(
            "spec_k > 0 requires a draft_model (the small GPT that "
            "proposes candidate tokens)")
    return draft_model
