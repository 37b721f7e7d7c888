"""PagedBatcher: admission on pages at current lengths, not max_seq slots
(counterpart of ``paddle_tpu/serving/llm/paged/batcher.py``).

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
  position of every active slot (``+k+1`` under speculation). When the
  pool runs dry mid-stream, unpinned prefix entries go first, then the
  YOUNGEST request is evicted (least progress lost); a lone sequence that
  cannot grow finishes with reason ``"length"``.
- **prefix sharing copies nothing** (``prefix_cache=True``, a
  :class:`PagedPrefixStore`): a hit adopts the full shared pages by table
  splice (``bytes_shared``); where the entry runs past the last full
  page the sequence may reuse, that one partial page is COW-split
  (``adopt_copied_page``, the only bytes a hit copies, in
  ``bytes_copied``). A miss's page-aligned head is claimed by the store
  by reference. Gauges ``pages_free`` and ``pages_cow_splits`` publish
  the pool at every admission and tick.
- **live migration** (between ticks, on the worker): ``export_all``
  snapshots and detaches every live sequence as a host manifest (its
  pages read once); ``import_manifest`` splices one in under the same
  admission math as a new request (its page-aligned prompt head adopted
  zero-copy from the prefix store when cached), writing the slot's
  ``finished``, last-token and sampling entries in place, or returns
  False with no side effect. Each export and import observes its wall
  ms (``seq_export_ms``, ``seq_import_ms``) and adds its payload bytes
  (``seq_export_bytes``, ``seq_import_bytes``: the pages it copied).
"""
from __future__ import annotations

import collections
import time
from typing import Optional

import numpy as np

from ....observability import tracer as _otrace
from ...request import RequestTooLarge
from ..scheduler import ContinuousBatcher, GenerationRequest
from .decode import GPTPagedDecoder
from .pool import PagedKVCache, PagesExhausted, pages_for_tokens
from .prefix import PagedPrefixStore


def _nbytes(pages) -> int:
    """Bytes of a manifest's page payload (an array, or the int8
    ``{"q", "s"}`` pair)."""
    if isinstance(pages, dict):
        return sum(int(a.nbytes) for a in pages.values())
    return int(pages.nbytes)


class PagedBatcher(ContinuousBatcher):
    """Page-pool admission over the inherited tick loop. Single-threaded
    like the base: only the engine worker calls in."""

    def __init__(self, decoder: GPTPagedDecoder, config, registry,
                 clock=None, prefix_store=None, spec_decoder=None):
        if not isinstance(decoder, GPTPagedDecoder):
            raise TypeError("PagedBatcher needs a GPTPagedDecoder "
                            "(kv_layout='paged')")
        if prefix_store is not None:
            raise NotImplementedError(
                "paged engines share prefix pages inside their own arena; "
                "an external (host) PrefixStore cannot be attached - set "
                "prefix_cache=True and let the batcher build its "
                "PagedPrefixStore")
        kw = {} if clock is None else {"clock": clock}
        super().__init__(decoder, config, registry, spec_decoder=spec_decoder,
                         **kw)
        self.kv: PagedKVCache
        self._pending = collections.deque()
        if config.prefix_cache:
            self.prefix_store = PagedPrefixStore(
                self.kv, registry=registry,
                stat_prefix=f"{config.stat_prefix}.prefix")
        self._stat_set("pages_free", self.kv.pool.free_pages)
        self._stat_set("pages_cow_splits", 0)

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
        self._stat_set("pages_cow_splits", self.kv.cow_splits)

    # -- admission -----------------------------------------------------------
    def admit(self, req: GenerationRequest):
        # a span of its own (the JAX package's paged admission has none),
        # so a paged engine's trace reads as a slot engine's
        with _otrace.span("serving.llm/prefill"):
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
        """Admit ``req`` if a slot AND its pages are available at its
        length, its shared prefix pages counted as free; no partial state
        on False (the page math runs before any allocation)."""
        if self.kv.free_slots < 1:
            return False
        page = self.kv.page_size
        entry, reuse_n = None, 0
        if self.prefix_store is not None:
            entry, reuse_n = self._lookup_prefix(req, page)
        # COW extension: where the entry runs past the last FULL page the
        # sequence may share (hits are page-aligned, the reuse cap of
        # prompt_len - 1 seldom is), the partial page is copied and the
        # tail overwrites the private copy from its first own row: rows
        # [reuse_n, ext_n) come along for free
        cow_src = None
        ext_n = min(entry.n_tokens, req.prompt_len - 1) if entry else 0
        if (entry is not None and reuse_n < ext_n
                and ext_n - reuse_n < page
                and ext_n + self.config.bucket_for(
                    req.prompt_len - ext_n) <= self.config.max_seq
                and np.array_equal(entry.tokens[reuse_n:ext_n],
                                   req.prompt[reuse_n:ext_n])):
            cow_src = entry.page_ids[reuse_n // page]
        else:
            ext_n = reuse_n
        # the COW page is one of the pages to allocate; headroom: one
        # lookahead page per running sequence, so admitting cannot force
        # a mid-stream eviction at the next capacity pass
        need_alloc = pages_for_tokens(req.prompt_len, page) - reuse_n // page
        shortfall = need_alloc + len(self._reqs) - self.kv.pool.free_pages
        if shortfall > 0 and self.prefix_store is not None:
            shortfall -= self.prefix_store.evict_unpinned(shortfall)
        if shortfall > 0:
            if entry is not None:
                self.prefix_store.unpin(entry)
            return False
        t0 = self._clock()
        slot = self.kv.alloc()
        if reuse_n > 0:
            for pid in entry.page_ids[:reuse_n // page]:
                self.kv.adopt_shared_page(slot, pid)
            self.prefix_store.note_shared(
                (reuse_n // page) * self.kv.page_nbytes())
        if cow_src is not None:
            self.kv.adopt_copied_page(slot, cow_src)
            self.prefix_store.note_copied(self.kv.page_nbytes())
            self._stat_add("prefix.cow_splits", 1)
        self.kv.ensure_pages(slot, req.prompt_len)
        self._start(req, slot, t0, entry, ext_n)
        return True

    def _export_prefix(self, req: GenerationRequest, slot: int):
        """After a miss's prefill the store claims the page-aligned head
        BY REFERENCE: it retains the sequence's own pages, nothing
        moves."""
        page = self.kv.page_size
        n = (req.prompt_len // page) * page
        if n < page:
            return
        ins = self.prefix_store.insert(req.prompt[:n],
                                       self.kv.slot_page_ids(slot)[:n // page],
                                       self.decoder.prefix_sig(self.kv))
        if ins is not None:
            req._prefix_entry = ins

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
        """Map the next write positions of every active slot before the
        tick: one token plain, k+1 under speculation (the verify writes
        k+1 candidate rows). Pool dry: drop unpinned prefix entries, then
        evict the youngest other request; a lone sequence that cannot
        grow finishes at its current length."""
        horizon = self.spec.k + 1 if self.spec is not None else 1
        for slot in sorted(self._reqs):
            req = self._reqs.get(slot)
            if req is None:
                continue
            need_tok = min(req.seq_len - 1 + horizon, self.config.max_seq)
            while True:
                try:
                    self.kv.ensure_pages(slot, need_tok)
                    break
                except PagesExhausted:
                    short = (pages_for_tokens(need_tok, self.kv.page_size)
                             - self.kv.mapped_pages(slot)
                             - self.kv.pool.free_pages)
                    if self.prefix_store is not None and \
                            self.prefix_store.evict_unpinned(
                                max(1, short)) > 0:
                        continue
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
        self._unpin_prefix(req)
        req.fail(PagesExhausted(
            f"request {req.req_id} evicted after {len(req.tokens)} "
            f"tokens: page pool exhausted and it was the youngest "
            f"sequence"))
        self._stat_add("pages_evicted_midstream", 1)
        self._stat_add("evicted_midstream", 1)

    # -- live sequence migration ---------------------------------------------
    #: the paged substrate ships sequences as page payloads
    supports_export = True

    def export_all(self):
        """Snapshot and detach every live sequence into host manifests
        (worker thread, between ticks). A request still mid-replay from an
        earlier resume ships without payload (its cache is not yet a
        faithful transcript: the target replays it); pending
        (page-starved) requests ship cold. On return the batcher holds
        none of them."""
        from ...fleet.migrate import SequenceManifest
        sig = self.decoder.prefix_sig(self.kv)
        out = []
        for slot in sorted(self._reqs):
            req = self._reqs[slot]
            if req._replay_pos is None:
                n_cached = req.seq_len - 1   # the last token is not cached
                t0 = time.perf_counter()
                _, k_pages, v_pages = self.decoder.export_sequence(
                    self.kv, slot, n_cached)
                self._stat_observe("seq_export_ms",
                                   (time.perf_counter() - t0) * 1e3)
                self._stat_add("seq_export_bytes",
                               _nbytes(k_pages) + _nbytes(v_pages))
                man = SequenceManifest(
                    req, req.prompt, req.tokens, req.sampling,
                    weights_version=req.weights_version,
                    n_cached_tokens=n_cached, page_size=self.kv.page_size,
                    sig=sig, k_pages=k_pages, v_pages=v_pages)
            else:
                man = SequenceManifest.for_queued(req)
            out.append(man)
            del self._reqs[slot]
            self.kv.free(slot)
            self._unpin_prefix(req)
        while self._pending:
            out.append(SequenceManifest.for_queued(self._pending.popleft()))
        self._stat_set("pages_pending_requests", 0)
        self._publish_pages()
        return out

    def import_manifest(self, man) -> bool:
        """Splice a migrated sequence into a free slot, armed for the next
        tick (worker thread, between ticks). Page-aligned prompt pages
        this engine's prefix store holds are adopted zero-copy; the rest
        are allocated and written from the payload. Returns False WITHOUT
        side effects when the geometry differs or the slot table or the
        pool cannot take it (the migrator then replays)."""
        if man.sig != self.decoder.prefix_sig(self.kv) \
                or man.page_size != self.kv.page_size:
            return False
        n_cached = man.n_cached_tokens
        if not (0 < n_cached < self.config.max_seq) or not man.tokens:
            return False
        if self.kv.free_slots < 1:
            return False
        req = man.req
        page = self.kv.page_size
        total = pages_for_tokens(n_cached, page)
        entry, reuse_n = None, 0
        if self.prefix_store is not None:
            entry, reuse_n = self.prefix_store.lookup(
                req.prompt, min(req.prompt_len, n_cached), man.sig)
            reuse_n = (reuse_n // page) * page   # whole pages only
            if entry is not None and reuse_n <= 0:
                self.prefix_store.unpin(entry)
                entry, reuse_n = None, 0
        shared = reuse_n // page
        # _try_admit's math: the pages to write plus one lookahead page
        # per running sequence
        shortfall = (total - shared) + len(self._reqs) \
            - self.kv.pool.free_pages
        if shortfall > 0 and self.prefix_store is not None:
            shortfall -= self.prefix_store.evict_unpinned(shortfall)
        if shortfall > 0:
            if entry is not None:
                self.prefix_store.unpin(entry)
            return False
        slot = self.kv.alloc()
        try:
            if shared:
                for pid in entry.page_ids[:shared]:
                    self.kv.adopt_shared_page(slot, pid)
                self.prefix_store.note_shared(shared * self.kv.page_nbytes())
            t0 = time.perf_counter()
            self.decoder.import_sequence(self.kv, slot, n_cached,
                                         man.k_pages, man.v_pages,
                                         shared_pages=shared)
            # to the end of the host-to-device copies (the in-place page
            # writes behind them are queued on the stream)
            self._stat_observe("seq_import_ms",
                               (time.perf_counter() - t0) * 1e3)
            self._stat_add("seq_import_bytes",
                           (_nbytes(man.k_pages) + _nbytes(man.v_pages))
                           * (total - shared) // total)
        except Exception:
            self.kv.free(slot)
            if entry is not None:
                self.prefix_store.unpin(entry)
            raise
        req._prefix_entry = entry
        req._t_last = None
        self._reqs[slot] = req
        # arm the programs' per-slot state in place: the next tick feeds
        # the last emitted token and writes its row at n_cached
        self._set_sampling(slot, req.sampling)
        self._finished[slot] = False
        self._last[slot] = int(req.tokens[-1])
        self._stat_add("migrated_pages_shared", shared)
        self._stat_add("migrated_pages_copied", total - shared)
        self._publish_pages()
        return True

    # -- mfu -----------------------------------------------------------------
    def _measure_decode_flops(self):
        """``measure_mfu`` on pages: the paged decode step's own count
        (the JAX package's probe compiles the slot program, which a paged
        engine never runs, and so reports nothing). The step reads the
        device block tables, refreshed first as ``decode_step`` does; on
        the kernel lane B4 adds the rows the live positions attend."""
        self.kv.refresh_block_tables()
        super()._measure_decode_flops()

    # -- exits ---------------------------------------------------------------
    def evacuate(self):
        out = super().evacuate()
        while self._pending:
            out.append(self._pending.popleft())
        self._stat_set("pages_pending_requests", 0)
        self._publish_pages()
        return out

    def abort_all(self, exc_factory):
        super().abort_all(exc_factory)
        while self._pending:
            req = self._pending.popleft()
            req.fail(exc_factory(req))
        self._publish_pages()
