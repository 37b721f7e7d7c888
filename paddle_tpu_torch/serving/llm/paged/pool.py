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
the cache.
"""
from __future__ import annotations

import heapq
from typing import List, Optional

import numpy as np
import torch

from ....core.device import DeviceLike, resolve_device
from ....core.graphs import GraphPool
from ..kvcache import SlotsExhausted, kv_nbytes


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
    to the trash page may collide; they are junk by construction."""
    buf.index_put_((pids.long(), ppos.long()), rows.to(buf.dtype))
    return buf


def paged_write_prompt_rows(buf, rows, pids, ppos):
    """Write ``N`` tokens' rows for ALL layers into a whole arena, in
    place. ``buf``: ``[P+1, L, page, H, D]``; ``rows``: ``[N, L, H, D]``;
    token ``n``'s layer-``l`` row lands at ``buf[pids[n], l, ppos[n]]``."""
    num_layers = rows.shape[1]
    li = torch.arange(num_layers, device=buf.device)[None, :]  # [1, L]
    buf.index_put_((pids.long()[:, None], li, ppos.long()[:, None]),
                   rows.to(buf.dtype))
    return buf


def paged_gather_rows(buf, block_tables):
    """Contiguous logical rows from a single layer's arena view:
    ``[P+1, page, H, D]`` through ``[S, PP]`` block tables ->
    ``[S, PP*page, H, D]`` (a copy)."""
    g = buf[block_tables.long()]
    sh = g.shape
    return g.reshape(sh[0], sh[1] * sh[2], sh[3], sh[4])


def pages_for_tokens(n_tokens: int, page_size: int) -> int:
    """ceil(n_tokens / page_size)."""
    return -(-int(n_tokens) // int(page_size))


class PagedKVCache:
    """Paged per-slot KV storage: one arena per K and V, per-slot block
    tables and the per-slot ``lengths`` vector (the position the next
    token is written at), all on ``device``.

    ``k``/``v``: ``[num_pages + 1, num_layers, page_size, H, D]`` (index
    ``num_pages`` is the trash page). :attr:`block_tables`:
    ``[num_slots, pages_per_seq]`` int32 on the device, unmapped entries
    pointing at the trash page. The host tracks the pages each slot holds
    references on; ``free`` returns them to the :class:`PagePool`.
    """

    def __init__(self, num_slots: int, num_layers: int, max_seq: int,
                 num_heads: int, head_dim: int, dtype=torch.float32,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 device: DeviceLike = None):
        if num_slots < 1 or max_seq < 2:
            raise ValueError(
                f"need num_slots >= 1 and max_seq >= 2, got "
                f"{num_slots}/{max_seq}")
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
        self.device = resolve_device(device)
        shape = (self.num_pages + 1, self.num_layers, self.page_size,
                 self.num_heads, self.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
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
        self.k.zero_()
        self.v.zero_()
        self.lengths.zero_()

    # -- page mapping (the host decides, the block table records) ------------
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

    def kv_bytes(self) -> int:
        """Device bytes of the K+V arenas (trash page included)."""
        return kv_nbytes(self.k) + kv_nbytes(self.v)

    def host_lengths(self) -> np.ndarray:
        return self.lengths.cpu().numpy()

    def __repr__(self):
        return (f"PagedKVCache(slots={self.num_slots}, "
                f"layers={self.num_layers}, max_seq={self.max_seq}, "
                f"page={self.page_size}, pages={self.num_pages}, "
                f"in_use={self.pool.pages_in_use}, "
                f"active={len(self._active)})")
