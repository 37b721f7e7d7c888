"""Paged prefill, the paged decode step, their compiled forms and
GPTPagedDecoder (counterpart of ``paddle_tpu/serving/llm/paged/decode.py``:
``build_paged_prefill_fn``/``build_paged_decode_step`` as
:func:`paged_prefill`/:func:`paged_decode_step`,
``get_paged_prefill_fn``/``get_paged_decode_step``, ``GPTPagedDecoder``).

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
refreshes the device block tables before each program runs. Tail
prefill (prefix reuse), speculative decode and sequence migration are
later slices of the port.
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
                      _layer_norm, prefill_forward, sample_prefill,
                      sample_step)
from ..kvcache import kv_layer_view, valid_mask
from .pool import (PagedKVCache, paged_gather_rows, paged_write_prompt_rows,
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
    q = (x @ lp["qw"] + lp["qb"]).reshape(shape)
    kn = (x @ lp["kw"] + lp["kb"]).reshape(shape)
    vn = (x @ lp["vw"] + lp["vb"]).reshape(shape)
    paged_write_rows(kb, kn, pid, ppos)
    paged_write_rows(vb, vn, pid, ppos)
    if attn_impl == "kernel":
        out = paged_attention(q, kb, vb, block_tables, positions,
                              scale=scale).reshape(s, spec.hidden_size)
    else:
        kd = paged_gather_rows(kb, block_tables).to(h.dtype)
        vd = paged_gather_rows(vb, block_tables).to(h.dtype)
        qh = (q * scale)[:, :, None, :]                   # [S, H, 1, D]
        kt = kd.permute(0, 2, 1, 3)                       # [S, H, max, D]
        vt = vd.permute(0, 2, 1, 3)
        weights = softmax(torch.matmul(qh, kt.transpose(-1, -2)) + mask)
        out = torch.matmul(weights, vt).permute(0, 2, 1, 3).reshape(
            s, spec.hidden_size)
    h = h + (out @ lp["ow"] + lp["ob"])
    x = _layer_norm(h, lp["n2w"], lp["n2b"], spec.ln_epsilon)
    ffn = gelu(x @ lp["w1"] + lp["b1"])
    return h + (ffn @ lp["w2"] + lp["b2"])


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


def get_paged_decode_step(spec: GPTDecodeSpec, max_top_k: int,
                          attn_impl: str) -> Program:
    """The paged decode step as a compiled program (the JAX package's
    ``get_paged_decode_step``), ``trace_counter`` as ``get_decode_step``'s:
    ``fn(params, kv, finished, last_tokens, samp, generator)``. The page
    size, a parameter of the JAX package's, is read from ``kv``."""
    return Program(functools.partial(paged_decode_step, spec, max_top_k,
                                     attn_impl=attn_impl))


def _resolve_attn_impl(impl: str, device_type: str, head_dim: int,
                       dtype) -> str:
    """The attention lane of a paged decoder: ``"auto"`` is the kernel on
    CUDA and the gather lane on the CPU; the kernel lane on CUDA raises
    for heads the kernel does not take (``takes``), never leaving the
    kernel for the gather lane unasked."""
    if impl == "auto":
        impl = "kernel" if device_type == "cuda" else "gather"
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
    CPU), ``"kernel"`` or ``"gather"``; the kernel lane on CUDA raises
    here if the kernel does not take the model's heads. The programs'
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
            self._model.gpt.word_embeddings.weight.dtype)
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
                            page_size=self.page_size,
                            num_pages=self.num_pages, device=self.device)

    def _decode_program(self) -> Program:
        return get_paged_decode_step(self.spec, self.max_top_k,
                                     self.attn_impl)

    def _prefill_program(self) -> Program:
        return get_paged_prefill_fn(self.spec, self.max_top_k)

    @torch.no_grad()
    def prefill(self, kv: PagedKVCache, params, tokens, true_lens,
                slot_ids, finished, samp, generator):
        kv.refresh_block_tables()
        return super().prefill(kv, params, tokens, true_lens, slot_ids,
                               finished, samp, generator)

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
