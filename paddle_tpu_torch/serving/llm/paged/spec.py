"""Speculative decoding over a paged target cache (counterpart of
``paddle_tpu/serving/llm/paged/spec.py``: ``_paged_block_verify``, the
program of ``build_paged_spec_decode_step`` as :func:`paged_spec_step`,
``get_paged_spec_decode_step`` and ``GPTPagedSpecDecoder``).

The tick of ``serving/llm/spec.py``, with the draft keeping its own
small slot-layout cache (its contexts are small; paging them buys
nothing) and only the target's K/V in the page arena: the verify step
writes all ``k+1`` candidate rows a slot through the block table
(``[S*(k+1)]`` physical coordinates) and gathers the full logical rows
back for the dense multi-query attention. The batcher maps pages for
``lengths + k + 1`` before a spec tick (``PagedBatcher``'s capacity
pass), where the slot engine checks ``lengths + k + 1 <= max_seq``.
"""
from __future__ import annotations

import functools
import math

import torch

from ....core.graphs import Program
from ..decode import GPTDecodeSpec, SamplingVectors
from ..kvcache import StaticKVCache, kv_layer_view
from ..spec import (GPTSpecDecoder, _attend_rows, _verify_out, _verify_qkv,
                    accept, draft_propose, verify_logits)
from .decode import GPTPagedDecoder
from .pool import PagedKVCache, paged_gather_rows, paged_write_rows


def _paged_block_verify(spec: GPTDecodeSpec, lp, h, kb, vb, block_tables,
                        pid_flat, ppos_flat, mask, scale, eye):
    """``spec._block_verify`` over a paged layer: the T candidate rows a
    slot are written at (``pid_flat``, ``ppos_flat``), the ``[S*T]``
    physical coordinates of ``positions..positions+T-1``, then the whole
    logical rows are gathered for the attention."""
    s, t = h.shape[0], h.shape[1]
    q, kn, vn = _verify_qkv(spec, lp, h)
    flat = (s * t, spec.num_heads, spec.head_dim)
    paged_write_rows(kb, kn.reshape(flat), pid_flat, ppos_flat)
    paged_write_rows(vb, vn.reshape(flat), pid_flat, ppos_flat)
    kg = paged_gather_rows(kb, block_tables).to(h.dtype)  # [S, max, H, D]
    vg = paged_gather_rows(vb, block_tables).to(h.dtype)
    return _verify_out(spec, lp, h,
                       _attend_rows(q, kg, vg, mask, scale, eye))


def paged_verify_logits(tspec: GPTDecodeSpec, params_t, kv: PagedKVCache,
                        u):
    """``verify_logits`` over the paged target: the candidate rows of
    ``u [S, T]`` are written through the block table (positions past the
    table, inactive slots', clip to its last entry, the trash page for a
    freed slot)."""
    bt = kv.block_tables
    pp_n = bt.shape[1]
    pos_mat = kv.lengths.long()[:, None] + torch.arange(u.shape[1],
                                                        device=kv.device)
    page_idx = (pos_mat // kv.page_size).clamp(0, pp_n - 1)
    pid_flat = bt.long().gather(1, page_idx).reshape(-1)
    ppos_flat = (pos_mat % kv.page_size).reshape(-1)
    scale = 1.0 / math.sqrt(tspec.head_dim)
    eye = torch.eye(tspec.num_heads, dtype=params_t["tok"].dtype,
                    device=kv.device)

    def layer(li, lp, h, mask):
        return _paged_block_verify(tspec, lp, h, kv_layer_view(kv.k, li),
                                   kv_layer_view(kv.v, li), bt, pid_flat,
                                   ppos_flat, mask, scale, eye)

    return verify_logits(tspec, params_t, kv.lengths, u,
                         pp_n * kv.page_size, layer)


def paged_spec_step(tspec: GPTDecodeSpec, dspec: GPTDecodeSpec, k: int,
                    max_top_k: int, params, kv: PagedKVCache,
                    kv_draft: StaticKVCache, finished, last_tokens,
                    samp: SamplingVectors, generator):
    """The speculative tick over a paged target (the program of
    ``build_paged_spec_decode_step``); ``params``: ``(target, draft)``.
    Every active slot must have pages through ``lengths + k``. Returns
    ``(finished [S], new_last [S], out [S, k+2])``."""
    params_t, params_d = params
    drafts = draft_propose(dspec, params_d, kv_draft, kv.lengths,
                           last_tokens, k)
    u = torch.cat([last_tokens[:, None], drafts], dim=1)
    lraw = paged_verify_logits(tspec, params_t, kv, u)
    return accept(k, max_top_k, lraw, kv.lengths, finished, drafts, samp,
                  generator)


def get_paged_spec_decode_step(tspec: GPTDecodeSpec, dspec: GPTDecodeSpec,
                               k: int, max_top_k: int) -> Program:
    """The paged speculative tick as a compiled program
    (``get_paged_spec_decode_step``; the page size is read from the
    cache): ``fn((params_t, params_d), kv, kv_draft, finished,
    last_tokens, samp, generator)``."""
    if k < 1:
        raise ValueError(f"speculation depth k must be >= 1, got {k}")
    return Program(functools.partial(paged_spec_step, tspec, dspec, k,
                                     max_top_k))


class GPTPagedSpecDecoder(GPTSpecDecoder):
    """:class:`GPTSpecDecoder` whose target is a :class:`GPTPagedDecoder`:
    the draft's cache stays slot-layout, the spec step is the paged one,
    and the block tables are refreshed before it runs."""

    def __init__(self, target: GPTPagedDecoder, draft_model, k: int = 4,
                 exec_cache=None):
        if not isinstance(target, GPTPagedDecoder):
            raise TypeError(
                "GPTPagedSpecDecoder needs a GPTPagedDecoder target; use "
                "GPTSpecDecoder for slot-layout targets")
        super().__init__(target, draft_model, k=k, exec_cache=exec_cache)
        self._key = self._key + ("paged", target.page_size)

    def _spec_program(self) -> Program:
        return get_paged_spec_decode_step(self.target.spec, self.dspec,
                                          self.k, self.target.max_top_k)

    @torch.no_grad()
    def step(self, kv: PagedKVCache, kv_draft, params_t, params_d,
             finished, last_tokens, samp, generator):
        kv.refresh_block_tables()
        return super().step(kv, kv_draft, params_t, params_d, finished,
                            last_tokens, samp, generator)
