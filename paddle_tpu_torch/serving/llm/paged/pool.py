"""PagePool + block tables: the paged KV memory substrate (counterpart of
``paddle_tpu/serving/llm/paged/pool.py``).

K and V live in one preallocated arena each, of fixed-size token pages,

    arena[k|v] : [num_pages + 1, num_layers, page_size, H, D]

and each slot owns a block table row, ``[pages_per_seq]`` int32, mapping
logical page index -> physical page: logical row ``t`` of a slot lives at
``arena[bt[t // page_size], :, t % page_size]``. Pages are ref-counted on
the host. The LAST physical page (index ``num_pages``) is the trash page:
unmapped block-table entries point at it and right-padded prefill junk
is routed to it, so every program writes unconditionally while unmapped
rows never touch live pages; every read of it is masked by the slot's
length.

Writes happen IN PLACE (``index_put_`` into the arena). The JAX package
rebuilds the arena functionally and leaves the copy to XLA's buffer
donation; in eager PyTorch a functional update would copy the whole
arena — 3.2 GB for GPT-3 1.3B with 8 slots of 1024 tokens — on every
tick. The host holds the authoritative block table; the decoder refreshes
the device copy (:meth:`PagedKVCache.refresh_block_tables`, in place)
before a program runs, never inside one: a CUDA graph binds the device
table's address and cannot record a copy from pageable host memory. The
arenas, the table and ``lengths`` keep their addresses for the life of
the cache, so a shared-page adoption or a copy-on-write split between
ticks reaches a captured program through those in-place writes.

Pages are shared by refcount (a page of a cached prefix and two live
sequences has refcount 3): prefix reuse splices shared pages into a
table (``adopt_shared_page``, zero bytes copied) and the first page a
sequence writes is its own (``adopt_copied_page``, the copy-on-write
split). With ``kv_dtype="int8"`` each arena is a ``{"q": int8 codes,
"s": float32 [P+1, L, page] scales}`` dict (``kvcache.py``'s
representation, one scale a row): the writers quantize the rows they
land and the gather returns both leaves.

Sequence migration (``serving/fleet/migrate.py``) reads and writes whole
pages between ticks: ``read_pages`` gathers a sequence's pages with one
``index_select`` and one device-to-host copy per arena leaf into pinned
memory (NumPy, in the JAX package's ``[n, L, page, H, D]`` layout, or its
``{"q", "s"}`` pair), and ``write_page`` copies one shipped page into the
arena in place, so a captured decode program reads it at the arena's
address.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np
import torch

from ....core.device import DeviceLike, resolve_device
from ....core.graphs import GraphPool
from ..kvcache import (SlotsExhausted, _zero_buf, is_quantized_kv,
                       kv_leaves, kv_nbytes, put_rows)


class PagesExhausted(RuntimeError):
    """The pool cannot satisfy an allocation (callers gate on
    :attr:`PagePool.free_pages` or evict before hitting this)."""


class PagePool:
    """Host free list + per-page refcounts over the physical pages. A page
    is free at refcount 0; ``alloc`` hands out the lowest free index;
    releasing a free page raises (the double-free guard)."""

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"need num_pages >= 1, got {num_pages}")
        self.num_pages = int(num_pages)
        self._refs = np.zeros(self.num_pages, np.int64)
        self._free: List[int] = list(range(self.num_pages))
        heapq.heapify(self._free)
        self.total_allocs = 0
        self.total_retains = 0
        self.total_releases = 0
        self.peak_in_use = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def refcount(self, pid: int) -> int:
        return int(self._refs[pid])

    def alloc_many(self, n: int) -> List[int]:
        """Claim ``n`` fresh pages atomically: all of them, or none and
        :class:`PagesExhausted`."""
        if n < 0:
            raise ValueError(f"alloc_many({n})")
        if n > len(self._free):
            raise PagesExhausted(
                f"need {n} pages, only {len(self._free)} of "
                f"{self.num_pages} free")
        out = [heapq.heappop(self._free) for _ in range(n)]
        for pid in out:
            self._refs[pid] = 1
        self.total_allocs += n
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return out

    def alloc(self) -> int:
        return self.alloc_many(1)[0]

    def retain(self, pid: int):
        """Add a reference to a live page."""
        if not (0 <= pid < self.num_pages):
            raise ValueError(f"retain of non-pool page {pid}")
        if self._refs[pid] <= 0:
            raise ValueError(f"retain of free page {pid}")
        self._refs[pid] += 1
        self.total_retains += 1

    def release(self, pid: int) -> bool:
        """Drop one reference; True when the page went back to the free
        list. Raises on a release at refcount 0."""
        if not (0 <= pid < self.num_pages):
            raise ValueError(f"release of non-pool page {pid}")
        if self._refs[pid] <= 0:
            raise ValueError(
                f"page {pid} double-free: released with refcount 0")
        self._refs[pid] -= 1
        self.total_releases += 1
        if self._refs[pid] == 0:
            heapq.heappush(self._free, pid)
            return True
        return False

    def reset(self):
        self._refs[:] = 0
        self._free = list(range(self.num_pages))
        heapq.heapify(self._free)

    def __repr__(self):
        return (f"PagePool(pages={self.num_pages}, "
                f"in_use={self.pages_in_use}, "
                f"allocs={self.total_allocs}, "
                f"releases={self.total_releases})")


# -- in-place writers / readers ----------------------------------------------

def paged_write_rows(buf, rows, pids, ppos):
    """Write one row per entry into a single layer's arena view, in place.
    ``buf``: ``[P+1, page, H, D]``; ``rows``: ``[N, H, D]``;
    ``pids``/``ppos``: ``[N]`` physical page and in-page offset. Rows sent
    to the trash page may collide; they are junk by construction. An
    int8 view's rows are quantized (one scale each) and both leaves
    written."""
    return put_rows(buf, (pids.long(), ppos.long()), rows)


def paged_write_prompt_rows(buf, rows, pids, ppos):
    """Write ``N`` tokens' rows for ALL layers into a whole arena, in
    place. ``buf``: ``[P+1, L, page, H, D]``; ``rows``: ``[N, L, H, D]``;
    token ``n``'s layer-``l`` row lands at ``buf[pids[n], l, ppos[n]]``
    (an int8 arena's quantized, both leaves)."""
    num_layers = rows.shape[1]
    li = torch.arange(num_layers, device=rows.device)[None, :]  # [1, L]
    return put_rows(buf, (pids.long()[:, None], li, ppos.long()[:, None]),
                    rows)


def paged_gather_rows(buf, block_tables):
    """Contiguous logical rows from a single layer's arena view:
    ``[P+1, page, H, D]`` through ``[S, PP]`` block tables ->
    ``[S, PP*page, H, D]`` (a copy); an int8 view gives ``{"q": [S,
    PP*page, H, D], "s": [S, PP*page]}``."""
    bt = block_tables.long()
    if is_quantized_kv(buf):
        q, s = buf["q"][bt], buf["s"][bt]
        sh = q.shape
        return {"q": q.reshape(sh[0], sh[1] * sh[2], sh[3], sh[4]),
                "s": s.reshape(sh[0], sh[1] * sh[2])}
    g = buf[bt]
    sh = g.shape
    return g.reshape(sh[0], sh[1] * sh[2], sh[3], sh[4])


def as_page_tensor(rows) -> torch.Tensor:
    """A shipped page payload (a NumPy array, read-only ones included, or
    a tensor) as a tensor, without copying what it need not."""
    if isinstance(rows, np.ndarray) and not rows.flags.writeable:
        rows = rows.copy()
    return torch.as_tensor(rows)


def pages_for_tokens(n_tokens: int, page_size: int) -> int:
    """ceil(n_tokens / page_size)."""
    return -(-int(n_tokens) // int(page_size))


class PagedKVCache:
    """Paged per-slot KV storage: one arena per K and V, per-slot block
    tables and the per-slot ``lengths`` vector (the position the next
    token is written at), all on ``device``.

    ``k``/``v``: ``[num_pages + 1, num_layers, page_size, H, D]`` (index
    ``num_pages`` is the trash page), or with ``kv_dtype="int8"`` the
    ``{"q", "s"}`` dicts of int8 codes and ``[num_pages + 1, num_layers,
    page_size]`` scales. :attr:`block_tables`:
    ``[num_slots, pages_per_seq]`` int32 on the device, unmapped entries
    pointing at the trash page. The host tracks the pages each slot holds
    references on; ``free`` returns them to the :class:`PagePool`.
    """

    def __init__(self, num_slots: int, num_layers: int, max_seq: int,
                 num_heads: int, head_dim: int, dtype=torch.float32,
                 kv_dtype: Optional[str] = None, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 device: DeviceLike = None):
        if num_slots < 1 or max_seq < 2:
            raise ValueError(
                f"need num_slots >= 1 and max_seq >= 2, got "
                f"{num_slots}/{max_seq}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_dtype must be None (dense) or 'int8', got "
                f"{kv_dtype!r}")
        if page_size < 1 or max_seq % page_size:
            raise ValueError(
                f"page_size {page_size} must divide max_seq {max_seq}")
        self.num_slots = int(num_slots)
        self.num_layers = int(num_layers)
        self.max_seq = int(max_seq)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.page_size = int(page_size)
        self.pages_per_seq = self.max_seq // self.page_size
        if num_pages is None:
            # worst case: every slot fully grown
            num_pages = self.num_slots * self.pages_per_seq
        if num_pages < self.pages_per_seq:
            raise ValueError(
                f"num_pages {num_pages} cannot hold even one full "
                f"sequence ({self.pages_per_seq} pages)")
        self.num_pages = int(num_pages)
        self.trash = self.num_pages
        self.dtype = dtype
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype == "int8"
        self.device = resolve_device(device)
        shape = (self.num_pages + 1, self.num_layers, self.page_size,
                 self.num_heads, self.head_dim)
        self.k = _zero_buf(shape, dtype, self.quantized, self.device)
        self.v = _zero_buf(shape, dtype, self.quantized, self.device)
        self._bt_host = np.full((self.num_slots, self.pages_per_seq),
                                self.trash, np.int32)
        self._bt_dev = torch.from_numpy(self._bt_host.copy()).to(self.device)
        self._bt_dirty = False
        self.lengths = torch.zeros((self.num_slots,), dtype=torch.int32,
                                   device=self.device)
        self.pool = PagePool(self.num_pages)
        self._slot_pages: List[List[int]] = [[] for _ in
                                             range(self.num_slots)]
        self._free: List[int] = list(range(self.num_slots))
        self._active: set = set()
        self.graph_pool = GraphPool(self.device)
        #: copy-on-write splits made (admission divergence)
        self.cow_splits = 0

    def refresh_block_tables(self):
        """Copy the host block tables into the device table, in place, if
        a mapping changed since the last refresh. Raises under a CUDA
        graph capture, which would record a copy from pageable memory:
        the decoder refreshes before a program runs."""
        if self._bt_dirty:
            if self.device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "block tables changed under a capture; refresh them "
                    "before the program runs")
            self._bt_dev.copy_(torch.from_numpy(self._bt_host))
            self._bt_dirty = False

    @property
    def block_tables(self) -> torch.Tensor:
        """The device block tables (``[num_slots, pages_per_seq]`` int32,
        a fixed address), refreshed first if a mapping changed."""
        self.refresh_block_tables()
        return self._bt_dev

    # -- slot lifecycle (host side) ------------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise SlotsExhausted(
                f"all {self.num_slots} KV slots are in use")
        slot = self._free.pop(0)
        self._active.add(slot)
        return slot

    def free(self, slot: int):
        """Return a slot and its page references; raises on a slot that
        is not active (double free)."""
        if not (0 <= slot < self.num_slots) or slot not in self._active:
            raise ValueError(
                f"slot {slot} is not active (double free?)")
        self._active.discard(slot)
        for pid in self._slot_pages[slot]:
            self.pool.release(pid)
        self._slot_pages[slot] = []
        self._bt_host[slot] = self.trash
        self._bt_dirty = True
        self._free.append(slot)
        self._free.sort()

    def reset(self):
        """Free every slot and page, point every table entry at the trash
        page and zero the arenas and lengths, all in place (their
        addresses never change: graphs bind them)."""
        for slot in list(self._active):
            self.free(slot)
        self._free = list(range(self.num_slots))
        self._slot_pages = [[] for _ in range(self.num_slots)]
        self.pool.reset()
        self._bt_host[:] = self.trash
        self._bt_dirty = True
        for t in kv_leaves(self.k) + kv_leaves(self.v):
            t.zero_()
        self.lengths.zero_()

    # -- page mapping (the host decides, the block table records) ------------
    def mapped_pages(self, slot: int) -> int:
        return len(self._slot_pages[slot])

    def mapped_tokens(self, slot: int) -> int:
        return len(self._slot_pages[slot]) * self.page_size

    def slot_page_ids(self, slot: int) -> Tuple[int, ...]:
        return tuple(self._slot_pages[slot])

    def _map_page(self, slot: int, pid: int):
        idx = len(self._slot_pages[slot])
        if idx >= self.pages_per_seq:
            raise ValueError(
                f"slot {slot} already maps {idx} pages (max_seq reached)")
        self._slot_pages[slot].append(pid)
        self._bt_host[slot, idx] = pid
        self._bt_dirty = True

    def ensure_pages(self, slot: int, n_tokens: int) -> int:
        """Map fresh pages so logical rows ``[0, n_tokens)`` are backed;
        returns how many were allocated. Atomic: raises
        :class:`PagesExhausted` without mapping anything."""
        need = pages_for_tokens(n_tokens, self.page_size)
        have = len(self._slot_pages[slot])
        if need <= have:
            return 0
        fresh = self.pool.alloc_many(need - have)
        for pid in fresh:
            self._map_page(slot, pid)
        return len(fresh)

    def adopt_shared_page(self, slot: int, pid: int):
        """Splice a live page (a prefix-store page) into the slot's table
        at its next logical index: one more reference, zero bytes
        copied."""
        self.pool.retain(pid)
        self._map_page(slot, pid)

    def adopt_copied_page(self, slot: int, src_pid: int) -> int:
        """Copy-on-write split: claim a private page, copy the shared
        page's rows into it (both arenas, every layer, in place) and map
        it, so the new occupant writes its divergent rows without
        touching the sharers. Returns the new page."""
        pid = self.pool.alloc()
        for t in kv_leaves(self.k) + kv_leaves(self.v):
            t[pid].copy_(t[src_pid])
        self._map_page(slot, pid)
        self.cow_splits += 1
        return pid

    # -- sequence migration (between ticks: export and import) --------------
    def read_pages(self, page_ids) -> Tuple[object, object]:
        """Host copies of the K and V arena rows of ``page_ids``, stacked
        over the pages: ``[n, L, page, H, D]`` NumPy arrays, or for an int8
        arena ``{"q": ..., "s": [n, L, page]}``. One ``index_select`` (a
        contiguous gather, never a strided view) and one device-to-host
        copy per leaf, into pinned memory on CUDA (PyTorch's host cache
        hands the blocks of earlier payloads back once they are dropped).
        Runs on the engine worker between ticks."""
        idx = torch.tensor([int(p) for p in page_ids], dtype=torch.long,
                           device=self.device)

        def _host(t):
            rows = torch.index_select(t, 0, idx)
            if rows.device.type != "cuda":
                return rows.numpy()
            out = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
            out.copy_(rows)
            return out.numpy()

        def _take(buf):
            if is_quantized_kv(buf):
                return {n: _host(buf[n]) for n in ("q", "s")}
            return _host(buf)
        return _take(self.k), _take(self.v)

    def write_page(self, pid: int, k_page, v_page):
        """Install one shipped page (a ``read_pages`` row: an array or a
        tensor per leaf) at physical page ``pid``, in place in both
        arenas. The caller owns the page alone (mapped, refcount 1): a
        shared or free page would let sharers see the write, so it
        raises."""
        if self.pool.refcount(pid) != 1:
            raise ValueError(
                f"write_page({pid}): refcount {self.pool.refcount(pid)} "
                f"!= 1 - importing into a shared or free page would "
                f"corrupt sharers")
        for buf, page in ((self.k, k_page), (self.v, v_page)):
            pairs = ([(buf[n], page[n]) for n in ("q", "s")]
                     if is_quantized_kv(buf) else [(buf, page)])
            for arena, rows in pairs:
                dst = arena[pid]
                dst.copy_(as_page_tensor(rows).to(device=dst.device,
                                                  dtype=dst.dtype))

    def set_length(self, slot: int, n_tokens: int):
        """Set a slot's position in the device lengths (in place)."""
        if not (0 <= n_tokens <= self.max_seq):
            raise ValueError(f"set_length({slot}, {n_tokens})")
        self.lengths[slot] = int(n_tokens)

    def kv_bytes(self) -> int:
        """Device bytes of the K+V arenas (trash page included)."""
        return kv_nbytes(self.k) + kv_nbytes(self.v)

    def page_nbytes(self) -> int:
        """Device bytes of ONE physical page across both arenas and every
        layer (codes and scales of an int8 arena): the unit of the prefix
        store's byte counters."""
        return self.kv_bytes() // (self.num_pages + 1)

    def host_lengths(self) -> np.ndarray:
        return self.lengths.cpu().numpy()

    def __repr__(self):
        return (f"PagedKVCache(slots={self.num_slots}, "
                f"layers={self.num_layers}, max_seq={self.max_seq}, "
                f"page={self.page_size}, pages={self.num_pages}, "
                f"in_use={self.pool.pages_in_use}, "
                f"active={len(self._active)})")
