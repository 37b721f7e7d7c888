"""Paged prefill, the paged decode step, their compiled forms and
GPTPagedDecoder (counterpart of ``paddle_tpu/serving/llm/paged/decode.py``:
``build_paged_prefill_fn``/``build_paged_decode_step``/
``build_paged_tail_prefill_fn`` as :func:`paged_prefill`/
:func:`paged_decode_step`/:func:`paged_tail_prefill`, their ``get_*``
forms, ``GPTPagedDecoder``).

The forward math is the model's dense eval path; only where K/V rows live
changes: they are written into the page arena through each slot's block
table (in place, see ``pool.py``) and read back through it.

Two attention lanes sit behind ``attn_impl``:

- ``"gather"``: gather the slot's rows into ``[S, max_seq, H, D]`` and run
  matmul, additive mask, softmax, matmul — the JAX package's parity lane.
- ``"kernel"``: the paged-attention kernel (``ops/paged_attention.py``)
  walks the block table itself and never materialises the gather. On CPU
  tensors it runs the kernel's plain version, the counterpart of the JAX
  package's interpret mode. Float-equal to the gather lane, not bitwise:
  the online softmax sums in another order.

``"auto"`` means the kernel on CUDA and the gather lane on the CPU, as
the JAX package's ``"auto"`` means the kernel on the TPU. The kernel
takes every float type of a model (float32, bfloat16, float16) at any
head dim up to 1024 (``ops.paged_attention.takes``); the kernel lane on
CUDA raises at construction for heads past that. On CUDA the
decode step runs as a replayed CUDA graph (``core/graphs.py``), the
kernel lane's 24 launches of B4 inside it at GPT-3 1.3B; the decoder
refreshes the device block tables before each program runs. The tail
prefill of prefix reuse attends densely over the gathered row, as the
JAX package's does. Sequence migration: ``export_sequence`` reads a live
sequence's pages to the host (``PagedKVCache.read_pages``) and
``import_sequence`` writes them into fresh pages of another cache in
place and sets the slot's length, between ticks.

int8 serving: with ``weight_dtype="int8"`` every block multiplies
through ``decode._mm``, and the kernel lane runs B4 as with float
weights. An int8 arena (``kv_dtype="int8"``) is the JAX package's case
too: the kernel reads dense arenas only, so ``"auto"`` takes the gather
lane, which dequantizes the gathered rows before the attention, and
``"kernel"`` raises at construction (B4's wrapper refuses an int8 arena
itself). The tail prefill over int8 pages raises, as the JAX package's.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ....core.graphs import Program
from ....nn.functional import gelu, softmax
from ....ops.paged_attention import paged_attention, takes
from ..decode import (GPTDecodeSpec, GPTDecoderBase, SamplingVectors,
                      _dense_only, _layer_norm, _mm, prefill_forward,
                      sample_prefill, sample_step, tail_forward)
from ..kvcache import dequantize_kv, kv_layer_view, valid_mask
from .pool import (PagedKVCache, as_page_tensor, paged_gather_rows,
                   paged_write_prompt_rows, pages_for_tokens,
                   paged_write_rows)


def _write_page_index(block_tables, positions, page_size: int):
    """(physical page, in-page offset) of each slot's write position.
    Positions past the table (inactive slots, whose lengths keep
    advancing) clip to the last entry, the trash page for a freed slot."""
    pos = positions.long()
    idx = (pos // page_size).clamp(0, block_tables.shape[1] - 1)
    pid = block_tables.long().gather(1, idx[:, None])[:, 0]
    return pid, pos % page_size


def _paged_block_decode(spec: GPTDecodeSpec, lp, h, kb, vb, block_tables,
                        pid, ppos, positions, mask, scale, attn_impl):
    """One pre-norm block for one new token per slot. ``kb``/``vb``: this
    layer's ``[P+1, page, H, D]`` arena views; the token's K/V is written
    at (``pid``, ``ppos``) before attending."""
    s = h.shape[0]
    x = _layer_norm(h, lp["n1w"], lp["n1b"], spec.ln_epsilon)
    shape = (s, spec.num_heads, spec.head_dim)
    q = (_mm(x, lp["qw"]) + lp["qb"]).reshape(shape)
    kn = (_mm(x, lp["kw"]) + lp["kb"]).reshape(shape)
    vn = (_mm(x, lp["vw"]) + lp["vb"]).reshape(shape)
    paged_write_rows(kb, kn, pid, ppos)
    paged_write_rows(vb, vn, pid, ppos)
    if attn_impl == "kernel":
        out = paged_attention(q, kb, vb, block_tables, positions,
                              scale=scale).reshape(s, spec.hidden_size)
    else:
        kd = dequantize_kv(paged_gather_rows(kb, block_tables), h.dtype)
        vd = dequantize_kv(paged_gather_rows(vb, block_tables), h.dtype)
        qh = (q * scale)[:, :, None, :]                   # [S, H, 1, D]
        kt = kd.permute(0, 2, 1, 3)                       # [S, H, max, D]
        vt = vd.permute(0, 2, 1, 3)
        weights = softmax(torch.matmul(qh, kt.transpose(-1, -2)) + mask)
        out = torch.matmul(weights, vt).permute(0, 2, 1, 3).reshape(
            s, spec.hidden_size)
    h = h + (_mm(out, lp["ow"]) + lp["ob"])
    x = _layer_norm(h, lp["n2w"], lp["n2b"], spec.ln_epsilon)
    ffn = gelu(_mm(x, lp["w1"]) + lp["b1"])
    return h + (_mm(ffn, lp["w2"]) + lp["b2"])


def paged_decode_logits(spec: GPTDecodeSpec, params, kv: PagedKVCache,
                        last_tokens, attn_impl: str):
    """The forward half of a decode step: embed each slot's last token at
    its position, write its K/V rows into the arena (in place) and return
    the ``[S, V]`` f32 logits. ``kv.lengths`` is not advanced."""
    scale = 1.0 / math.sqrt(spec.head_dim)
    positions = kv.lengths
    block_tables = kv.block_tables
    posc = positions.long().clamp(0, spec.max_position_embeddings - 1)
    h = params["tok"][last_tokens.long()] + params["pos"][posc]   # [S, E]
    max_seq = block_tables.shape[1] * kv.page_size
    mask = (valid_mask(positions, max_seq, h.dtype)
            if attn_impl == "gather" else None)
    pid, ppos = _write_page_index(block_tables, positions, kv.page_size)
    for li, lp in enumerate(params["layers"]):
        h = _paged_block_decode(
            spec, lp, h, kv_layer_view(kv.k, li), kv_layer_view(kv.v, li),
            block_tables, pid, ppos, positions, mask, scale, attn_impl)
    h = _layer_norm(h, params["fnw"], params["fnb"], spec.ln_epsilon)
    return (h @ params["tok"].t()).float()


def paged_decode_step(spec: GPTDecodeSpec, max_top_k: int, params,
                      kv: PagedKVCache, finished, last_tokens,
                      samp: SamplingVectors, generator, attn_impl: str):
    """Advance every slot one token: logits, sampling, eos freezing, and
    ``kv.lengths += 1`` for every slot (inactive slots compute junk that
    the scheduler discards). Returns ``(next_tokens [S], finished [S])``."""
    lraw = paged_decode_logits(spec, params, kv, last_tokens, attn_impl)
    return sample_step(lraw, kv.lengths, finished, samp, generator,
                       max_top_k)


def paged_prefill(spec: GPTDecodeSpec, max_top_k: int, params,
                  kv: PagedKVCache, tokens, true_lens, slot_ids, finished,
                  samp: SamplingVectors, generator):
    """Prefill right-padded prompts ``tokens [B, Lp]`` into ``slot_ids``:
    the dense causal forward of ``prefill_forward``, the K/V rows written
    through each slot's block table (padding junk to the trash page), the
    slots' lengths set, and the first token sampled. Returns
    ``(next_tokens [B], finished [S])``."""
    lraw, k_new, v_new = prefill_forward(spec, params, tokens, true_lens)
    b, lp_len = tokens.shape
    pos = torch.arange(lp_len, device=tokens.device)
    ppos = (pos % kv.page_size).repeat(b)
    page_idx = pos // kv.page_size                     # < PP: buckets fit
    slots = slot_ids.long()
    mapped = kv.block_tables[slots].long()[:, page_idx]   # [B, Lp]
    pid = torch.where(pos[None, :] < true_lens.long()[:, None], mapped,
                      torch.full_like(mapped, kv.trash))
    rows = (b * lp_len,) + tuple(k_new.shape[1:2] + k_new.shape[3:])
    paged_write_prompt_rows(kv.k, k_new.transpose(1, 2).reshape(rows),
                            pid.reshape(-1), ppos)
    paged_write_prompt_rows(kv.v, v_new.transpose(1, 2).reshape(rows),
                            pid.reshape(-1), ppos)
    kv.lengths[slots] = true_lens.to(torch.int32)
    return sample_prefill(lraw, slots, finished, samp, generator, max_top_k)


def paged_tail_prefill(spec: GPTDecodeSpec, max_top_k: int, params,
                       kv: PagedKVCache, tokens, tail_lens, starts,
                       slot_ids, finished, samp: SamplingVectors,
                       generator):
    """Prefill prompt tails ``tokens [B, Lt]`` into ``slot_ids`` at
    offsets ``starts`` behind heads that arrived as shared pages (the
    program of ``build_paged_tail_prefill_fn``): each layer's tail rows
    go through the block table (the padding's to the trash page), then
    the slot's whole logical row is gathered back for the dense
    offset-causal attention of ``tail_forward``; the lengths become
    ``starts + tail_lens`` and the first token is sampled. Returns
    ``(next_tokens [B], finished [S])``. int8 pages raise, as the JAX
    package's."""
    _dense_only(kv, "tail prefill (prefix reuse)")
    b, lt = tokens.shape
    slots = slot_ids.long()
    bt_sel = kv.block_tables[slots]                          # [B, PP]
    pp_n = bt_sel.shape[1]
    t = torch.arange(lt, device=tokens.device)
    pos = starts.long()[:, None] + t[None, :]                # [B, Lt]
    page_idx = (pos // kv.page_size).clamp(0, pp_n - 1)
    pid = torch.where(t[None, :] < tail_lens.long()[:, None],
                      bt_sel.long().gather(1, page_idx),
                      torch.full_like(page_idx, kv.trash)).reshape(-1)
    ppos = (pos % kv.page_size).reshape(-1)
    rows = (b * lt, spec.num_heads, spec.head_dim)

    def write_layer(li, kn, vn):
        paged_write_rows(kv_layer_view(kv.k, li), kn.reshape(rows), pid, ppos)
        paged_write_rows(kv_layer_view(kv.v, li), vn.reshape(rows), pid, ppos)

    def read_layer(li):
        return (paged_gather_rows(kv_layer_view(kv.k, li), bt_sel),
                paged_gather_rows(kv_layer_view(kv.v, li), bt_sel))

    lraw, _, _ = tail_forward(spec, params, tokens, tail_lens, starts,
                              pp_n * kv.page_size, write_layer, read_layer)
    kv.lengths[slots] = (starts + tail_lens).to(torch.int32)
    return sample_prefill(lraw, slots, finished, samp, generator, max_top_k)


def get_paged_tail_prefill_fn(spec: GPTDecodeSpec,
                              max_top_k: int) -> Program:
    """The paged tail prefill as a compiled program
    (``get_paged_tail_prefill_fn``): ``fn(params, kv, tokens, tail_lens,
    starts, slot_ids, finished, samp, generator)``."""
    return Program(functools.partial(paged_tail_prefill, spec, max_top_k))


def get_paged_decode_step(spec: GPTDecodeSpec, max_top_k: int,
                          attn_impl: str) -> Program:
    """The paged decode step as a compiled program (the JAX package's
    ``get_paged_decode_step``), ``trace_counter`` as ``get_decode_step``'s:
    ``fn(params, kv, finished, last_tokens, samp, generator)``. The page
    size, a parameter of the JAX package's, is read from ``kv``."""
    return Program(functools.partial(paged_decode_step, spec, max_top_k,
                                     attn_impl=attn_impl))


def _resolve_attn_impl(impl: str, device_type: str, head_dim: int,
                       dtype, kv_dtype: str = "float32") -> str:
    """The attention lane of a paged decoder: ``"auto"`` is the kernel on
    CUDA over dense arenas and the gather lane on the CPU or over int8
    arenas; ``"kernel"`` over int8 arenas raises (as the JAX package's),
    and on CUDA for heads the kernel does not take (``takes``), never
    leaving the kernel for the gather lane unasked."""
    if impl == "kernel" and kv_dtype == "int8":
        raise ValueError(
            "the paged kernel lane reads dense arenas; int8 pages use "
            "attn_impl='gather' (dequantized in the step)")
    if impl == "auto":
        impl = ("kernel" if device_type == "cuda" and kv_dtype != "int8"
                else "gather")
    if impl == "kernel" and device_type == "cuda" \
            and not takes(head_dim, dtype):
        raise ValueError(
            f"the paged attention kernel does not take head_dim {head_dim} "
            f"in {dtype}; serve this model with attn_impl='gather'")
    return impl


def get_paged_prefill_fn(spec: GPTDecodeSpec, max_top_k: int) -> Program:
    """The paged prefill as a compiled program (``get_paged_prefill_fn``):
    ``fn(params, kv, tokens, true_lens, slot_ids, finished, samp,
    generator)``."""
    return Program(functools.partial(paged_prefill, spec, max_top_k))


class GPTPagedDecoder(GPTDecoderBase):
    """The paged decoder: ``new_kv`` returns a :class:`PagedKVCache` on
    the model's device and the programs thread its block tables.
    ``attn_impl``: ``"auto"`` (the kernel on CUDA, the gather lane on the
    CPU and over int8 pages), ``"kernel"`` or ``"gather"``; the kernel
    lane raises here over int8 pages, and on CUDA if the kernel does not
    take the model's heads. The programs'
    cache key adds ``("paged", page_size, attn_impl)`` to the static
    decoder's, as the JAX package's does."""

    def __init__(self, model, max_top_k: int = 64,
                 weight_dtype: str = "float32", kv_dtype: str = "float32",
                 page_size: int = 16, num_pages: Optional[int] = None,
                 attn_impl: str = "auto",
                 exec_cache=None):
        super().__init__(model, max_top_k=max_top_k,
                         weight_dtype=weight_dtype, kv_dtype=kv_dtype,
                         exec_cache=exec_cache)
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if attn_impl not in ("auto", "gather", "kernel"):
            raise ValueError(
                f"attn_impl must be 'auto', 'gather' or 'kernel', got "
                f"{attn_impl!r}")
        self.attn_impl = _resolve_attn_impl(
            attn_impl, self.device.type, self.spec.head_dim,
            self._model.gpt.word_embeddings.weight.dtype, kv_dtype)
        self.page_size = int(page_size)
        self.num_pages = None if num_pages is None else int(num_pages)
        self._key = self._key + ("paged", self.page_size, self.attn_impl)

    def new_kv(self, num_slots: int, max_seq: int) -> PagedKVCache:
        if max_seq > self.spec.max_position_embeddings:
            raise ValueError(
                f"max_seq {max_seq} exceeds the model's "
                f"{self.spec.max_position_embeddings} positions")
        return PagedKVCache(num_slots, self.spec.num_layers, max_seq,
                            self.spec.num_heads, self.spec.head_dim,
                            dtype=self._model.gpt.word_embeddings.weight.dtype,
                            kv_dtype=self._kv_arg, page_size=self.page_size,
                            num_pages=self.num_pages, device=self.device)

    def _decode_program(self) -> Program:
        return get_paged_decode_step(self.spec, self.max_top_k,
                                     self.attn_impl)

    def _prefill_program(self) -> Program:
        return get_paged_prefill_fn(self.spec, self.max_top_k)

    def _tail_prefill_program(self) -> Program:
        return get_paged_tail_prefill_fn(self.spec, self.max_top_k)

    def prefix_sig(self, kv: PagedKVCache):
        """Paged entries are page ids into THIS arena, so the signature
        also holds the page size."""
        return super().prefix_sig(kv) + (self.page_size,)

    def insert_prefix_fn(self, prefix_len: int):
        raise NotImplementedError(
            "paged prefix reuse shares pages through the block table "
            "(PagedPrefixStore): there is no bulk copy to compile")

    def insert_prefix(self, kv, k_pre, v_pre, slot: int):
        raise NotImplementedError(
            "paged prefix reuse shares pages through the block table "
            "(PagedPrefixStore.lookup and PagedKVCache.adopt_shared_page);"
            " a bulk copy would defeat the zero-copy contract")

    @torch.no_grad()
    def prefill(self, kv: PagedKVCache, params, tokens, true_lens,
                slot_ids, finished, samp, generator):
        kv.refresh_block_tables()
        return super().prefill(kv, params, tokens, true_lens, slot_ids,
                               finished, samp, generator)

    @torch.no_grad()
    def tail_prefill(self, kv: PagedKVCache, params, tokens, tail_lens,
                     starts, slot_ids, finished, samp, generator):
        kv.refresh_block_tables()
        return super().tail_prefill(kv, params, tokens, tail_lens, starts,
                                    slot_ids, finished, samp, generator)

    @torch.no_grad()
    def decode_step(self, kv: PagedKVCache, params, finished, last_tokens,
                    samp, generator):
        kv.refresh_block_tables()
        return super().decode_step(kv, params, finished, last_tokens, samp,
                                   generator)

    @torch.no_grad()
    def decode_logits(self, kv: PagedKVCache, params, last_tokens,
                      attn_impl: Optional[str] = None):
        """One decode step's logits on the current cache state, without
        advancing the lengths (for holding the two lanes against each
        other on the same state)."""
        return paged_decode_logits(self.spec, params, kv, last_tokens,
                                   attn_impl or self.attn_impl)

    # -- live sequence migration ---------------------------------------------
    def export_sequence(self, kv: PagedKVCache, slot: int, n_tokens: int):
        """The device half of a live sequence: host copies of the pages
        backing its logical rows ``[0, n_tokens)``. Returns ``(page_ids,
        k_pages, v_pages)``; the rest of a manifest (tokens, sampling,
        position) the batcher has on the host. Between ticks."""
        n_pages = pages_for_tokens(n_tokens, self.page_size)
        pids = kv.slot_page_ids(slot)[:n_pages]
        if len(pids) < n_pages:
            raise ValueError(
                f"slot {slot} maps {len(pids)} pages but {n_pages} are "
                f"needed for {n_tokens} cached tokens")
        k_pages, v_pages = kv.read_pages(pids)
        return pids, k_pages, v_pages

    def import_sequence(self, kv: PagedKVCache, slot: int, n_tokens: int,
                        k_pages, v_pages, shared_pages: int = 0):
        """Splice an exported sequence into ``slot``: its pages ``[0,
        shared_pages)`` were adopted zero-copy from this cache's prefix
        store; the rest are allocated here and filled from the payload
        (one host-to-device copy per leaf, then each page in place). Sets
        the slot's length, so the next tick writes the exact next token.
        Returns the pages copied."""
        total = pages_for_tokens(n_tokens, self.page_size)
        if not (0 <= shared_pages <= total):
            raise ValueError(
                f"shared_pages {shared_pages} out of range for "
                f"{total} total pages")
        kv.ensure_pages(slot, n_tokens)
        pids = kv.slot_page_ids(slot)

        def _shipped(pages):
            def _dev(a):
                return as_page_tensor(a[shared_pages:total]).to(kv.device)
            if isinstance(pages, dict):
                return {n: _dev(pages[n]) for n in ("q", "s")}
            return _dev(pages)

        def _row(pages, j):
            if isinstance(pages, dict):
                return {n: pages[n][j] for n in ("q", "s")}
            return pages[j]
        kd, vd = _shipped(k_pages), _shipped(v_pages)
        for i in range(shared_pages, total):
            j = i - shared_pages
            kv.write_page(pids[i], _row(kd, j), _row(vd, j))
        kv.set_length(slot, n_tokens)
        return total - shared_pages
