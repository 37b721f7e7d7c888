"""Paged prefill, the paged decode step and GPTPagedDecoder (counterpart
of ``paddle_tpu/serving/llm/paged/decode.py``).

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

``"auto"`` means the kernel on CUDA and the gather lane on the CPU. Tail
prefill (prefix reuse), speculative decode and sequence migration are
later slices of the port.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ....nn.functional import gelu, softmax
from ....ops.paged_attention import paged_attention
from ..decode import (GPTDecodeSpec, GPTDecoderBase, SamplingVectors,
                      _block_prefill, _layer_norm, _sample)
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
    nxt = _sample(lraw, samp.temperature, samp.top_k, samp.do_sample,
                  generator, max_top_k)
    has_eos = samp.eos >= 0
    nxt = torch.where(finished & has_eos, samp.eos, nxt)
    finished = finished | ((nxt == samp.eos) & has_eos)
    kv.lengths += 1
    return nxt, finished


def paged_prefill(spec: GPTDecodeSpec, max_top_k: int, params,
                  kv: PagedKVCache, tokens, true_lens, slot_ids, finished,
                  samp: SamplingVectors, generator):
    """Prefill right-padded prompts ``tokens [B, Lp]`` into ``slot_ids``:
    the dense causal forward of ``_block_prefill``, the K/V rows written
    through each slot's block table (padding junk to the trash page), the
    slots' lengths set, and the first token sampled. Returns
    ``(next_tokens [B], finished [S])``."""
    scale = 1.0 / math.sqrt(spec.head_dim)
    b, lp_len = tokens.shape
    dev = tokens.device
    pos = torch.arange(lp_len, device=dev)
    h = params["tok"][tokens.long()] + params["pos"][pos][None]   # [B, L, E]
    mask = torch.triu(torch.full((lp_len, lp_len), -1e9, dtype=h.dtype,
                                 device=dev), 1)[None, None]
    kcs, vcs = [], []
    for lp in params["layers"]:
        h, k, v = _block_prefill(spec, lp, h, mask, scale)
        kcs.append(k)
        vcs.append(v)
    k_new = torch.stack(kcs, dim=1)                    # [B, L, Lp, H, D]
    v_new = torch.stack(vcs, dim=1)
    ppos = pos % kv.page_size
    page_idx = pos // kv.page_size                     # < PP: buckets fit
    block_tables = kv.block_tables
    slots = slot_ids.long()
    for i in range(b):
        bt_row = block_tables[slots[i]].long()
        pid = torch.where(pos < true_lens[i], bt_row[page_idx],
                          torch.full_like(pos, kv.trash))
        paged_write_prompt_rows(kv.k, k_new[i].transpose(0, 1), pid, ppos)
        paged_write_prompt_rows(kv.v, v_new[i].transpose(0, 1), pid, ppos)
    kv.lengths[slots] = true_lens.to(torch.int32)
    h = _layer_norm(h, params["fnw"], params["fnb"], spec.ln_epsilon)
    last = h[torch.arange(b, device=dev), true_lens.long() - 1]    # [B, E]
    lraw = (last @ params["tok"].t()).float()
    nxt = _sample(lraw, samp.temperature, samp.top_k, samp.do_sample,
                  generator, max_top_k)
    finished = finished.clone()
    finished[slots] = (nxt == samp.eos) & (samp.eos >= 0)
    return nxt, finished


class GPTPagedDecoder(GPTDecoderBase):
    """The paged decoder: ``new_kv`` returns a :class:`PagedKVCache` on
    the model's device and the programs thread its block tables.
    ``attn_impl``: ``"auto"`` (the kernel on CUDA, the gather lane on the
    CPU), ``"kernel"`` or ``"gather"``."""

    def __init__(self, model, max_top_k: int = 64,
                 weight_dtype: str = "float32", kv_dtype: str = "float32",
                 page_size: int = 16, num_pages: Optional[int] = None,
                 attn_impl: str = "auto"):
        super().__init__(model, max_top_k=max_top_k,
                         weight_dtype=weight_dtype, kv_dtype=kv_dtype)
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if attn_impl not in ("auto", "gather", "kernel"):
            raise ValueError(
                f"attn_impl must be 'auto', 'gather' or 'kernel', got "
                f"{attn_impl!r}")
        if attn_impl == "auto":
            attn_impl = "kernel" if self.device.type == "cuda" else "gather"
        self.attn_impl = attn_impl
        self.page_size = int(page_size)
        self.num_pages = None if num_pages is None else int(num_pages)

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

    @torch.no_grad()
    def prefill(self, kv: PagedKVCache, params, tokens, true_lens,
                slot_ids, finished, samp, generator):
        return paged_prefill(self.spec, self.max_top_k, params, kv, tokens,
                             true_lens, slot_ids, finished, samp, generator)

    @torch.no_grad()
    def decode_step(self, kv: PagedKVCache, params, finished, last_tokens,
                    samp, generator):
        return paged_decode_step(self.spec, self.max_top_k, params, kv,
                                 finished, last_tokens, samp, generator,
                                 self.attn_impl)

    @torch.no_grad()
    def decode_logits(self, kv: PagedKVCache, params, last_tokens,
                      attn_impl: Optional[str] = None):
        """One decode step's logits on the current cache state, without
        advancing the lengths (for holding the two lanes against each
        other on the same state)."""
        return paged_decode_logits(self.spec, params, kv, last_tokens,
                                   attn_impl or self.attn_impl)
