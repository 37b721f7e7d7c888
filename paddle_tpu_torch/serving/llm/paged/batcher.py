"""PagedBatcher: admission on pages at current lengths, not max_seq slots
(counterpart of ``paddle_tpu/serving/llm/paged/batcher.py``; the prefix
store, speculative decode and migration are later slices).

With paged KV the scarce resource is the page pool, so admission asks
"are there pages for THIS prompt at ITS length, plus headroom for the
sequences already running":

- **admit** maps exactly the pages the prompt needs now. If the pool or
  the slot table cannot take it, the request waits in a pending deque;
  ``free_slots`` reports 0 while anything is pending and ``active``
  counts pending requests, so the worker keeps ticking (ticks free
  pages). A request that cannot fit even into an otherwise empty pool
  fails with :class:`RequestTooLarge` instead of deadlocking.
- **per-tick capacity**: before each tick one pass maps the next write
  position of every active slot. When the pool runs dry mid-stream the
  YOUNGEST request is evicted (least progress lost); a lone sequence that
  cannot grow finishes with reason ``"length"``.
"""
from __future__ import annotations

import collections
from typing import Optional

from ...request import RequestTooLarge
from ..scheduler import ContinuousBatcher, GenerationRequest
from .decode import GPTPagedDecoder
from .pool import PagedKVCache, PagesExhausted, pages_for_tokens


class PagedBatcher(ContinuousBatcher):
    """Page-pool admission over the inherited tick loop. Single-threaded
    like the base: only the engine worker calls in."""

    def __init__(self, decoder: GPTPagedDecoder, config, registry,
                 clock=None):
        if not isinstance(decoder, GPTPagedDecoder):
            raise TypeError("PagedBatcher needs a GPTPagedDecoder "
                            "(kv_layout='paged')")
        kw = {} if clock is None else {"clock": clock}
        super().__init__(decoder, config, registry, **kw)
        self.kv: PagedKVCache
        self._pending = collections.deque()
        self._stat_set("pages_free", self.kv.pool.free_pages)

    # -- introspection -------------------------------------------------------
    @property
    def active(self) -> int:
        # pending requests count: the worker must keep ticking (ticks free
        # pages) and drain must not exit while any wait for pages
        return len(self._reqs) + len(self._pending)

    @property
    def free_slots(self) -> int:
        # queue order is admission order: take nothing new while requests
        # already wait for pages
        if self._pending:
            return 0
        return self.kv.free_slots

    def _publish_pages(self):
        self._stat_set("pages_free", self.kv.pool.free_pages)

    # -- admission -----------------------------------------------------------
    def admit(self, req: GenerationRequest):
        self._drain_pending()
        if self._pending or not self._try_admit(req):
            self._park_or_fail(req)
        self._publish_pages()

    def _drain_pending(self):
        while self._pending:
            head = self._pending[0]
            if head.expired:
                self._pending.popleft()
                head.fail_expired()
                continue
            if not self._try_admit(head):
                if not self._reqs:
                    # nothing running: no page will ever free up
                    self._pending.popleft()
                    self._fail_oversize(head)
                    continue
                break
            self._pending.popleft()

    def _park_or_fail(self, req: GenerationRequest):
        if not self._reqs:
            self._fail_oversize(req)
            return
        self._pending.append(req)
        self._stat_set("pages_pending_requests", len(self._pending))

    def _fail_oversize(self, req: GenerationRequest):
        need = pages_for_tokens(req.prompt_len, self.kv.page_size)
        req.fail(RequestTooLarge(
            f"prompt of {req.prompt_len} tokens needs {need} pages but "
            f"the pool holds {self.kv.pool.num_pages} "
            f"({self.kv.pool.free_pages} free, none reclaimable)"))
        self._stat_add("rejected_pool_exhausted", 1)

    def _try_admit(self, req: GenerationRequest) -> bool:
        """Admit ``req`` if a slot AND its pages are available; no partial
        state on False (the page math runs before any allocation)."""
        if self.kv.free_slots < 1:
            return False
        need = pages_for_tokens(req.prompt_len, self.kv.page_size)
        # headroom: one lookahead page per running sequence, so admitting
        # cannot force a mid-stream eviction at the next capacity pass
        if need + len(self._reqs) > self.kv.pool.free_pages:
            return False
        t0 = self._clock()
        slot = self.kv.alloc()
        self.kv.ensure_pages(slot, req.prompt_len)
        self._start(req, slot, t0)
        return True

    # -- per-tick capacity ---------------------------------------------------
    def tick(self) -> int:
        self._drain_pending()
        self._stat_set("pages_pending_requests", len(self._pending))
        if not self._reqs:
            self._publish_pages()
            return 0
        self._ensure_decode_capacity()
        n = super().tick() if self._reqs else 0
        self._publish_pages()
        return n

    def _ensure_decode_capacity(self):
        """Map the next write position of every active slot before the
        tick. Pool dry: evict the youngest other request; a lone sequence
        that cannot grow finishes at its current length."""
        for slot in sorted(self._reqs):
            req = self._reqs.get(slot)
            if req is None:
                continue
            need_tok = min(req.seq_len, self.config.max_seq)
            while True:
                try:
                    self.kv.ensure_pages(slot, need_tok)
                    break
                except PagesExhausted:
                    victim = self._youngest_other(slot)
                    if victim is None:
                        self._stat_add("pages_truncations", 1)
                        self._release(slot, req, "length")
                        break
                    self._evict_for_pages(victim)

    def _youngest_other(self, slot: int) -> Optional[int]:
        others = [(s, r) for s, r in self._reqs.items() if s != slot]
        if not others:
            return None
        return max(others, key=lambda sr: sr[1].t_enqueue)[0]

    def _evict_for_pages(self, slot: int):
        req = self._reqs.pop(slot)
        self.kv.free(slot)
        req.fail(PagesExhausted(
            f"request {req.req_id} evicted after {len(req.tokens)} "
            f"tokens: page pool exhausted and it was the youngest "
            f"sequence"))
        self._stat_add("pages_evicted_midstream", 1)
        self._stat_add("evicted_midstream", 1)

    # -- exits ---------------------------------------------------------------
    def abort_all(self, exc_factory):
        super().abort_all(exc_factory)
        while self._pending:
            req = self._pending.popleft()
            req.fail(exc_factory(req))
        self._publish_pages()
