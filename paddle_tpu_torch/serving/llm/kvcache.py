"""StaticKVCache and its writers (counterpart of
``paddle_tpu/serving/llm/kvcache.py``: ``StaticKVCache``,
``append_token_kv``, ``append_tokens_kv``, ``write_prompt_kv``,
``write_prompt_kv_at``, ``valid_mask``, the int8 representation
``quantize_kv_rows``, ``dequantize_kv``, ``is_quantized_kv``,
``kv_layer_view``, ``kv_stack_layers``, ``kv_max_seq``, ``kv_nbytes``, and
the int8 writers ``_append_token_kv_q`` and ``_write_prompt_kv_q``, here
the int8 branch of :func:`put_rows`, which every writer calls).

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
those graphs share (``core/graphs.py``). A slot-sharded mesh is the
second slice of queue A10 in ROADMAP.md and raises naming it.

With ``kv_dtype="int8"`` each buffer is a dict, as the JAX package's:
``{"q": int8 [..., H, D] codes, "s": float32 [...] scales}``, one absmax
scale per (slot, layer, row), so a loud token cannot flatten its
neighbours' resolution; a row dequantizes as ``q * (s / 127)``. The
writers quantize the new rows and land codes and scales in place; the
decode step dequantizes a layer's rows before it attends. Both leaves
keep their addresses like the dense buffers.

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


def quantize_kv_rows(x):
    """``[..., H, D]`` float rows -> ``{"q": int8 codes, "s": float32
    scales}`` with one absmax scale per row (every leading index)."""
    absmax = x.abs().amax(dim=(-2, -1))
    s = torch.where(absmax > 0, absmax, torch.ones_like(absmax)).float()
    q = torch.clamp(torch.round(x / s[..., None, None] * 127.0),
                    -127.0, 127.0).to(torch.int8)
    return {"q": q, "s": s}


def dequantize_kv(buf, dtype=torch.float32):
    """Dense rows of a quantized buffer; a dense buffer in ``dtype``
    (itself when it already is)."""
    if not isinstance(buf, dict):
        return buf.to(dtype)
    return (buf["q"].to(dtype)
            * (buf["s"][..., None, None] / 127.0).to(dtype))


def is_quantized_kv(buf) -> bool:
    return isinstance(buf, dict)


def kv_leaves(buf) -> Tuple[torch.Tensor, ...]:
    """The tensors of a KV buffer: itself, or its codes and scales."""
    return (buf["q"], buf["s"]) if isinstance(buf, dict) else (buf,)


def kv_layer_view(buf, li: int):
    """Layer ``li``'s slice of a whole-cache buffer, ``[N, L, ...] ->
    [N, ...]`` (both leaves of a quantized one). A strided view: writing
    into it writes the buffer."""
    if isinstance(buf, dict):
        return {"q": buf["q"][:, li], "s": buf["s"][:, li]}
    return buf[:, li]


def kv_stack_layers(bufs):
    """Inverse of :func:`kv_layer_view` over all layers: the per-layer
    buffers stacked on axis 1 (a copy)."""
    if bufs and isinstance(bufs[0], dict):
        return {"q": torch.stack([b["q"] for b in bufs], dim=1),
                "s": torch.stack([b["s"] for b in bufs], dim=1)}
    return torch.stack(bufs, dim=1)


def kv_max_seq(buf) -> int:
    return (buf["q"] if isinstance(buf, dict) else buf).shape[2]


def kv_nbytes(buf) -> int:
    """Device bytes of a (possibly quantized) KV buffer."""
    return sum(t.numel() * t.element_size() for t in kv_leaves(buf))


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: a later slice of the port "
        f"(ROADMAP.md queue {item})")


class StaticKVCache:
    """Preallocated per-slot K/V buffers plus the per-slot lengths.

    ``k``/``v``: ``[num_slots, num_layers, max_seq, heads, head_dim]`` on
    ``device`` (with ``kv_dtype="int8"``, ``{"q", "s"}`` dicts of int8
    codes and ``[num_slots, num_layers, max_seq]`` scales); ``lengths``:
    ``[num_slots]`` int32 on ``device``, the number of valid rows of each
    slot (the position its next token is written at). The decoder's
    programs write all three in place; the free list lives on the host. ``graph_pool``: what the programs'
    graphs bound to this cache share.
    """

    def __init__(self, num_slots: int, num_layers: int, max_seq: int,
                 num_heads: int, head_dim: int, dtype=torch.float32,
                 mesh=None, kv_dtype=None, *, device: DeviceLike = None):
        if num_slots < 1 or max_seq < 2:
            raise ValueError(
                f"need num_slots >= 1 and max_seq >= 2, got "
                f"{num_slots}/{max_seq}")
        if kv_dtype not in (None, "int8"):
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
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype == "int8"
        self.device = resolve_device(device)
        shape = (self.num_slots, self.num_layers, self.max_seq,
                 self.num_heads, self.head_dim)
        self.k = _zero_buf(shape, dtype, self.quantized, self.device)
        self.v = _zero_buf(shape, dtype, self.quantized, self.device)
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
        for t in kv_leaves(self.k) + kv_leaves(self.v):
            t.zero_()
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
        rather than a pageable buffer's. An int8 cache raises, as the
        JAX package's: prefix reuse is refused over int8 KV."""
        if self.quantized:
            raise NotImplementedError(
                "prefix export from an int8 KV cache is unsupported "
                "(prefix reuse is gated off at config time for "
                "kv_dtype='int8'; see LLMEngineConfig)")
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


def _zero_buf(shape, dtype, quantized: bool, device):
    """A zero KV buffer of ``shape`` (``[N, L, rows, H, D]``): dense in
    ``dtype``, or int8 codes with ``shape[:3]`` float32 scales."""
    if quantized:
        return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                "s": torch.zeros(shape[:3], dtype=torch.float32,
                                 device=device)}
    return torch.zeros(shape, dtype=dtype, device=device)


# -- in-place writers ---------------------------------------------------------

def put_rows(buf, index, rows):
    """Write ``rows`` at the advanced index ``index`` of a KV buffer, in
    place: in the buffer's type, or into both leaves of an int8 one, the
    rows quantized with one scale each. Every writer of both layouts
    lands its rows through this."""
    if isinstance(buf, dict):
        qs = quantize_kv_rows(rows)
        buf["q"][index] = qs["q"]
        buf["s"][index] = qs["s"]
    else:
        buf[index] = rows.to(buf.dtype)
    return buf


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
    idx = index if index is not None else token_index(
        positions, kv_leaves(kb)[0].shape[1])
    return put_rows(kb, idx, k_new), put_rows(vb, idx, v_new)


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
    return put_rows(kb, (slots, rows), k_new), put_rows(vb, (slots, rows),
                                                        v_new)


def write_prompt_kv_at(k_buf, v_buf, k_new, v_new, slot_ids, starts):
    """Write K/V rows ``[B, L_layers, L, H, D]`` into ``slot_ids`` at
    per-request row offsets ``starts`` (the prefix-reuse writer; starts
    of 0 are :func:`write_prompt_kv`), all layers in one indexed write
    per buffer, in place. Each start clamps into ``[0, max_seq - L]`` and
    each slot id into range, as ``dynamic_update_slice`` clamps."""
    lp = k_new.shape[2]
    n_slots, n_layers, max_seq = kv_leaves(k_buf)[0].shape[:3]
    if lp > max_seq:
        raise ValueError(f"{lp} rows exceed max_seq {max_seq}")
    dev = k_new.device
    slots = torch.as_tensor(slot_ids, device=dev).long().clamp(
        0, n_slots - 1)
    start = torch.as_tensor(starts, device=dev).long().clamp(0, max_seq - lp)
    layers = torch.arange(n_layers, device=dev)
    rows = start[:, None] + torch.arange(lp, device=dev)[None, :]  # [B, L]
    idx = (slots[:, None, None], layers[None, :, None], rows[:, None, :])
    return put_rows(k_buf, idx, k_new), put_rows(v_buf, idx, v_new)


def write_prompt_kv(k_buf, v_buf, k_prompt, v_prompt, slot_ids):
    """Write whole-prompt K/V ``[B, L_layers, Lp, H, D]`` into rows
    ``[0, Lp)`` of ``slot_ids`` (length-B ints or a device vector), in
    place, one indexed write per buffer. Out-of-range slot ids clamp,
    as the JAX package's ``dynamic_update_slice`` start does."""
    lp = k_prompt.shape[2]
    n_slots, n_layers, max_seq = kv_leaves(k_buf)[0].shape[:3]
    if lp > max_seq:
        raise ValueError(f"prompt of {lp} rows exceeds max_seq {max_seq}")
    dev = k_prompt.device
    slots = torch.as_tensor(slot_ids, device=dev).long().clamp(
        0, n_slots - 1)
    layers = torch.arange(n_layers, device=dev)
    rows = torch.arange(lp, device=dev)
    idx = (slots[:, None, None], layers[None, :, None], rows[None, None, :])
    return put_rows(k_buf, idx, k_prompt), put_rows(v_buf, idx, v_prompt)


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
