"""StaticKVCache and its writers (counterpart of
``paddle_tpu/serving/llm/kvcache.py``: ``StaticKVCache``,
``append_token_kv``, ``append_tokens_kv``, ``write_prompt_kv``,
``write_prompt_kv_at``, ``valid_mask``, the layer view and ``kv_nbytes``).

K and V live in ``[num_slots, num_layers, max_seq, H, D]`` buffers on the
device; a sequence holds one slot row for its whole life, and the
per-slot ``lengths`` vector (the position the next token is written at)
gates which rows are valid. The JAX package rebuilds the buffers
functionally every step and restacks the layers; eager PyTorch would copy
them (3.2 GB a tick for GPT-3 1.3B with 8 slots of 1024 rows), so here
every write lands IN PLACE through the layer view, as the paged arena's
do. The buffers and ``lengths`` keep their addresses for the life of
the cache (``reset`` zeroes them in place), since the decoder's CUDA
graphs bind them; ``graph_pool`` is the memory pool and capture stream
those graphs share (``core/graphs.py``). int8 KV is queue A7 and a
slot-sharded mesh A10 in ROADMAP.md; each raises naming its item.

Slot lifecycle (host side, no device traffic):

    free --alloc()--> active --free()--> free
        (prefill writes [0, Lp))    (rows stay; the length masks them and
                                     the next prefill overwrites them)
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ...core.device import DeviceLike, resolve_device
from ...core.graphs import GraphPool


class SlotsExhausted(RuntimeError):
    """alloc() called with every slot in use (callers gate on
    ``free_slots`` instead of catching this)."""


def kv_layer_view(buf: torch.Tensor, li: int) -> torch.Tensor:
    """Layer ``li``'s slice of a whole-cache buffer, ``[N, L, ...] ->
    [N, ...]``. A strided view: writing into it writes the buffer."""
    return buf[:, li]


def kv_nbytes(buf: torch.Tensor) -> int:
    """Device bytes of a KV buffer."""
    return buf.numel() * buf.element_size()


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: a later slice of the port "
        f"(ROADMAP.md queue {item})")


class StaticKVCache:
    """Preallocated per-slot K/V buffers plus the per-slot lengths.

    ``k``/``v``: ``[num_slots, num_layers, max_seq, heads, head_dim]`` on
    ``device``; ``lengths``: ``[num_slots]`` int32 on ``device``, the
    number of valid rows of each slot (the position its next token is
    written at). The decoder's programs write all three in place; the
    free list lives on the host. ``graph_pool``: what the programs'
    graphs bound to this cache share.
    """

    def __init__(self, num_slots: int, num_layers: int, max_seq: int,
                 num_heads: int, head_dim: int, dtype=torch.float32,
                 mesh=None, kv_dtype=None, *, device: DeviceLike = None):
        if num_slots < 1 or max_seq < 2:
            raise ValueError(
                f"need num_slots >= 1 and max_seq >= 2, got "
                f"{num_slots}/{max_seq}")
        if kv_dtype == "int8":
            raise _later("kv_dtype='int8' (int8 KV)", "A7")
        if kv_dtype is not None:
            raise ValueError(
                f"kv_dtype must be None (dense) or 'int8', got "
                f"{kv_dtype!r}")
        if mesh is not None:
            raise _later("a slot-sharded mesh (mesh=...)", "A10")
        self.num_slots = int(num_slots)
        self.num_layers = int(num_layers)
        self.max_seq = int(max_seq)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.device = resolve_device(device)
        shape = (self.num_slots, self.num_layers, self.max_seq,
                 self.num_heads, self.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.lengths = torch.zeros((self.num_slots,), dtype=torch.int32,
                                   device=self.device)
        self._free: List[int] = list(range(self.num_slots))
        self._active: set = set()
        self.graph_pool = GraphPool(self.device)

    # -- slot lifecycle (host side) -----------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> Tuple[int, ...]:
        return tuple(sorted(self._active))

    def alloc(self) -> int:
        """Claim the lowest free slot. The caller prefills it before
        decoding it."""
        if not self._free:
            raise SlotsExhausted(
                f"all {self.num_slots} KV slots are in use")
        slot = self._free.pop(0)
        self._active.add(slot)
        return slot

    def free(self, slot: int):
        """Return a slot. Its rows stay; the length masks them and the
        next occupant's prefill overwrites them. Raises on an
        out-of-range slot and on one that is not active: a silent double
        free would hand the slot to two sequences at once."""
        if not (0 <= slot < self.num_slots) or slot not in self._active:
            raise ValueError(
                f"slot {slot} is not active (double free?)")
        self._active.discard(slot)
        self._free.append(slot)
        self._free.sort()

    def reset(self):
        """Free every slot and zero the buffers and lengths in place
        (their addresses never change: graphs bind them)."""
        self._free = list(range(self.num_slots))
        self._active.clear()
        self.k.zero_()
        self.v.zero_()
        self.lengths.zero_()

    def kv_bytes(self) -> int:
        """Device bytes of the K and V buffers."""
        return kv_nbytes(self.k) + kv_nbytes(self.v)

    def host_lengths(self) -> np.ndarray:
        """One deliberate device-to-host fetch of the lengths (tests and
        stats; the tick loop never calls it)."""
        return self.lengths.cpu().numpy()

    def host_slot_kv(self, slot: int, n: int) -> Tuple[np.ndarray,
                                                        np.ndarray]:
        """One deliberate device-to-host copy of a slot's first ``n``
        K/V rows as host ``[num_layers, n, heads, head_dim]`` arrays (new
        memory, contiguous): the prefix store's export, once per
        admission, never on the tick path. From CUDA the arrays lie in
        pinned (page-locked) memory, so the copy out and the later copies
        back in (``decode.insert_prefix_rows``) run at the bus's rate
        rather than a pageable buffer's."""
        if not (0 <= slot < self.num_slots) or not (0 < n <= self.max_seq):
            raise ValueError(f"bad prefix export slot={slot} n={n}")

        def fetch(buf):
            src = buf[slot, :, :n]
            if src.device.type != "cuda":
                return src.clone().numpy()
            out = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            out.copy_(src)
            return out.numpy()

        return fetch(self.k), fetch(self.v)

    def __repr__(self):
        return (f"StaticKVCache(slots={self.num_slots}, "
                f"layers={self.num_layers}, max_seq={self.max_seq}, "
                f"heads={self.num_heads}, head_dim={self.head_dim}, "
                f"active={len(self._active)})")


# -- in-place writers ---------------------------------------------------------

def token_index(positions, max_seq: int):
    """``(slots, rows)``: where each slot's new token lands in a layer's
    ``[S, max_seq, H, D]`` view. Every slot advances every tick, free ones
    included, so a position can pass ``max_seq``. The JAX package's
    ``lax.dynamic_update_slice`` clamps the start into range; so does this
    (a position past the end writes row ``max_seq - 1``, a negative one
    row 0) instead of indexing out of range, which on CUDA is a
    device-side assert."""
    rows = positions.long().clamp(0, max_seq - 1)
    return torch.arange(rows.shape[0], device=rows.device), rows


def append_token_kv(kb, vb, k_new, v_new, positions, index=None):
    """Write one new token's K/V for every slot at that slot's position
    (clamped, :func:`token_index`), in place, into one layer's
    ``[S, max_seq, H, D]`` views. ``k_new`` / ``v_new``: ``[S, H, D]``;
    ``positions``: ``[S]``. A caller that writes every layer at the same
    positions passes ``index``, that step's :func:`token_index`, and
    ``positions`` is then not read."""
    idx = index if index is not None else token_index(positions,
                                                      kb.shape[1])
    kb[idx] = k_new.to(kb.dtype)
    vb[idx] = v_new.to(vb.dtype)
    return kb, vb


def append_tokens_kv(kb, vb, k_new, v_new, positions):
    """Write ``T`` new tokens' K/V per slot at rows ``positions ..
    positions + T - 1``, in place, into one layer's ``[S, max_seq, H, D]``
    views (the speculative verify step lands its k+1 candidate rows with
    this). ``k_new``/``v_new``: ``[S, T, H, D]``. The start clamps into
    ``[0, max_seq - T]``, as ``lax.dynamic_update_slice``'s does."""
    t = k_new.shape[1]
    start = positions.long().clamp(0, kb.shape[1] - t)
    rows = start[:, None] + torch.arange(t, device=kb.device)[None, :]
    slots = torch.arange(kb.shape[0], device=kb.device)[:, None]
    kb[slots, rows] = k_new.to(kb.dtype)
    vb[slots, rows] = v_new.to(vb.dtype)
    return kb, vb


def write_prompt_kv_at(k_buf, v_buf, k_new, v_new, slot_ids, starts):
    """Write K/V rows ``[B, L_layers, L, H, D]`` into ``slot_ids`` at
    per-request row offsets ``starts`` (the prefix-reuse writer; starts
    of 0 are :func:`write_prompt_kv`), all layers in one indexed write
    per buffer, in place. Each start clamps into ``[0, max_seq - L]`` and
    each slot id into range, as ``dynamic_update_slice`` clamps."""
    lp = k_new.shape[2]
    n_slots, n_layers, max_seq = k_buf.shape[:3]
    if lp > max_seq:
        raise ValueError(f"{lp} rows exceed max_seq {max_seq}")
    dev = k_buf.device
    slots = torch.as_tensor(slot_ids, device=dev).long().clamp(
        0, n_slots - 1)
    start = torch.as_tensor(starts, device=dev).long().clamp(0, max_seq - lp)
    layers = torch.arange(n_layers, device=dev)
    rows = start[:, None] + torch.arange(lp, device=dev)[None, :]  # [B, L]
    idx = (slots[:, None, None], layers[None, :, None], rows[:, None, :])
    k_buf[idx] = k_new.to(k_buf.dtype)
    v_buf[idx] = v_new.to(v_buf.dtype)
    return k_buf, v_buf


def write_prompt_kv(k_buf, v_buf, k_prompt, v_prompt, slot_ids):
    """Write whole-prompt K/V ``[B, L_layers, Lp, H, D]`` into rows
    ``[0, Lp)`` of ``slot_ids`` (length-B ints or a device vector), in
    place, one indexed write per buffer. Out-of-range slot ids clamp,
    as the JAX package's ``dynamic_update_slice`` start does."""
    lp = k_prompt.shape[2]
    n_slots, n_layers, max_seq = k_buf.shape[:3]
    if lp > max_seq:
        raise ValueError(f"prompt of {lp} rows exceeds max_seq {max_seq}")
    dev = k_buf.device
    slots = torch.as_tensor(slot_ids, device=dev).long().clamp(
        0, n_slots - 1)
    layers = torch.arange(n_layers, device=dev)
    rows = torch.arange(lp, device=dev)
    idx = (slots[:, None, None], layers[None, :, None], rows[None, None, :])
    k_buf[idx] = k_prompt.to(k_buf.dtype)
    v_buf[idx] = v_prompt.to(v_buf.dtype)
    return k_buf, v_buf


def valid_mask(lengths: torch.Tensor, max_seq: int,
               dtype=torch.float32) -> torch.Tensor:
    """Additive mask ``[S, 1, 1, max_seq]``: 0 where the row index is <=
    the slot's current position (the just-written token sees itself), and
    -1e9 beyond, whose softmax weight underflows to exactly 0 in f32."""
    idx = torch.arange(max_seq, device=lengths.device)[None, :]
    ok = idx <= lengths.long()[:, None]
    zero = torch.zeros((), dtype=dtype, device=lengths.device)
    # cast from float32: -inf in float16, as the JAX package's cast gives
    neg = torch.full((), -1e9, device=lengths.device).to(dtype)
    return torch.where(ok, zero, neg)[:, None, None, :]
