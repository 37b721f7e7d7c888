"""Draft-model speculative decoding (counterpart of
``paddle_tpu/serving/llm/spec.py``: ``_block_verify``, the program of
``build_spec_decode_step`` as :func:`static_spec_step`,
``get_spec_decode_step`` and ``GPTSpecDecoder``).

Decode streams the whole KV cache to make one token a slot. A small
draft GPT proposes ``k`` tokens a tick (k+1 micro-steps over its own
small cache), the target verifies them in one (k+1)-query step over the
full row, and the accept-prefix selection runs on the device; a tick
emits 1 to k+1 tokens. With per-slot position ``p`` and last emitted
token ``x0`` (not yet in the cache):

1. the draft greedily proposes ``d[0..k-1]``; its K/V rows for
   ``[x0, d0, .., d_{k-1}]`` land at ``p..p+k`` in the draft cache (the
   k+1-th micro-step only deposits the last row, so a fully accepted tick
   leaves the draft cache whole);
2. the target runs queries ``[x0, d0, .., d_{k-1}]`` at ``p..p+k`` under
   an offset-causal mask over the whole row, writing all k+1 K/V rows:
   its greedy verdict ``t[i]`` is what the plain step would emit after
   ``u[0..i]``;
3. ``m`` = the length of the longest prefix with ``d[i] == t[i]``; the
   tick emits ``d[0..m-1], t[m]`` and advances the lengths by ``m+1``.

The rows a query must not see carry the additive -1e9 mask, whose
softmax weight is exactly 0 in float32, so each verdict is the plain
step's up to the order in which the matrix products sum (the verify's
products have k+1 times the plain step's rows, and the card's GEMM
library may pick another kernel for them): greedy tokens are held equal
to the plain decoder's, a near-tie excepted, where the JAX package
states them bitwise. Sampling slots take one verified token a tick (the
position-0 logits, drawn from the engine's generator). The tick's one
host fetch is the packed ``[S, k+2]`` int32 ``[n_emitted | tokens...]``.

The draft cache and the target's share ONE lengths tensor (the draft
cache's ``lengths`` is the target cache's), which the spec step advances
in place; its CUDA graph reads both caches' buffers where they lie. The
JAX package's ``verify_blocks`` (Pallas blocks of a flash verify lane,
from its tuner) has no counterpart: the dense verify needs none.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ...core.graphs import Program
from ...nn.functional import gelu, softmax
from ..cache import ExecutableCache
from .decode import (GPTDecodeSpec, SamplingVectors, _block_decode,
                     _layer_norm, _sample, extract_gpt_params,
                     get_prefill_fn)
from .kvcache import (StaticKVCache, append_tokens_kv, kv_layer_view,
                      token_index, valid_mask)


def _attend_rows(q, kb, vb, mask, scale, eye):
    """Dense attention of ``T`` queries a slot over ``max_seq`` rows.
    ``q``: ``[S, T, H, D]``; ``kb``/``vb``: ``[S, max_seq, H, D]`` (a
    layer view, strided over slots, or a gathered copy); ``mask``:
    ``[S, T, max_seq]`` additive. As ``_block_decode`` does for one
    query, the heads become a block-diagonal ``[H*D, T*H]`` query, so one
    batched GEMM over slots reads each cache byte once and never copies
    the strided view; each head keeps its own diagonal block of the
    second GEMM. Returns ``[S, T, H*D]``."""
    s, t, nh, hd = q.shape
    qq = (q * scale).permute(0, 3, 1, 2)                     # [S, D, T, H]
    qbd = (qq[:, None] * eye[None, :, None, None, :]).reshape(
        s, nh * hd, t * nh)                                  # [S, H*D, T*H]
    prod = torch.bmm(kb.flatten(2), qbd)                     # [S, max, T*H]
    scores = prod.transpose(1, 2).reshape(s, t, nh, -1) + mask[:, :, None]
    weights = softmax(scores).reshape(s, t * nh, -1)         # [S, T*H, max]
    blocks = torch.bmm(weights, vb.flatten(2))               # [S, T*H, H*D]
    out = blocks.view(s, t, nh, nh, hd).diagonal(dim1=2, dim2=3)
    return out.transpose(2, 3).reshape(s, t, nh * hd)        # [S, T, E]


def _verify_qkv(spec: GPTDecodeSpec, lp, h):
    """LayerNorm and the q/k/v projections of ``h [S, T, E]``, each
    ``[S, T, H, D]``."""
    s, t = h.shape[0], h.shape[1]
    x = _layer_norm(h, lp["n1w"], lp["n1b"], spec.ln_epsilon)

    def heads(z):
        return z.reshape(s, t, spec.num_heads, spec.head_dim)

    return (heads(x @ lp["qw"] + lp["qb"]), heads(x @ lp["kw"] + lp["kb"]),
            heads(x @ lp["vw"] + lp["vb"]))


def _verify_out(spec: GPTDecodeSpec, lp, h, attn):
    """The block's tail after attention: output projection, residual,
    the second LayerNorm and the GELU MLP."""
    h = h + (attn @ lp["ow"] + lp["ob"])
    x = _layer_norm(h, lp["n2w"], lp["n2b"], spec.ln_epsilon)
    return h + (gelu(x @ lp["w1"] + lp["b1"]) @ lp["w2"] + lp["b2"])


def _block_verify(spec: GPTDecodeSpec, lp, h, kb, vb, positions, mask,
                  scale, eye):
    """One pre-norm block over ``T = k+1`` candidate tokens a slot
    against the whole row. ``h``: ``[S, T, E]``; ``kb``/``vb``: this
    layer's ``[S, max_seq, H, D]`` views, into which all T candidate rows
    are written at ``positions..positions+T-1`` (in place) before the
    attention, so query i sees its own row, as the one-token step does."""
    q, kn, vn = _verify_qkv(spec, lp, h)
    append_tokens_kv(kb, vb, kn, vn, positions)
    return _verify_out(spec, lp, h,
                       _attend_rows(q, kb, vb, mask, scale, eye))


def draft_propose(dspec: GPTDecodeSpec, params_d, kv_draft: StaticKVCache,
                  lengths, last_tokens, k: int):
    """The draft's k greedy proposals ``[S, k]`` from k+1 micro-steps
    over its slot cache (rows at ``lengths .. lengths+k``, in place); the
    last micro-step only deposits the last proposal's row."""
    scale = 1.0 / math.sqrt(dspec.head_dim)
    eye = None
    d_last = last_tokens
    drafts = []
    for i in range(k + 1):
        pos_i = lengths + i
        posc = pos_i.long().clamp(0, dspec.max_position_embeddings - 1)
        h = params_d["tok"][d_last.long()] + params_d["pos"][posc]
        if eye is None:
            eye = torch.eye(dspec.num_heads, dtype=h.dtype, device=h.device)
        mask = valid_mask(pos_i, kv_draft.max_seq, h.dtype)
        index = token_index(pos_i, kv_draft.max_seq)
        for li, lp in enumerate(params_d["layers"]):
            h = _block_decode(dspec, lp, h, kv_layer_view(kv_draft.k, li),
                              kv_layer_view(kv_draft.v, li), index, mask,
                              scale, eye)
        if i == k:
            break
        h = _layer_norm(h, params_d["fnw"], params_d["fnb"],
                        dspec.ln_epsilon)
        d_last = torch.argmax((h @ params_d["tok"].t()).float(),
                              dim=-1).to(torch.int32)
        drafts.append(d_last)
    return torch.stack(drafts, dim=1)


def verify_logits(tspec: GPTDecodeSpec, params_t, lengths, u,
                  max_seq: int, layer):
    """The target's forward over the candidate tokens ``u [S, T]`` at
    positions ``lengths .. lengths+T-1``: ``layer(li, lp, h, mask)`` runs
    block ``li`` over ``h [S, T, E]`` under the additive ``[S, T,
    max_seq]`` mask, writing the candidate rows. Returns the ``[S, T, V]``
    f32 logits; ``lengths`` is not advanced."""
    dev = lengths.device
    pos_mat = lengths.long()[:, None] + torch.arange(u.shape[1], device=dev)
    posc = pos_mat.clamp(0, tspec.max_position_embeddings - 1)
    h = params_t["tok"][u.long()] + params_t["pos"][posc]     # [S, T, E]
    j = torch.arange(max_seq, device=dev)[None, None, :]
    zero = torch.zeros((), dtype=h.dtype, device=dev)
    neg = torch.full((), -1e9, device=dev).to(h.dtype)
    mask = torch.where(j <= pos_mat[:, :, None], zero, neg)   # [S, T, max]
    for li, lp in enumerate(params_t["layers"]):
        h = layer(li, lp, h, mask)
    h = _layer_norm(h, params_t["fnw"], params_t["fnb"], tspec.ln_epsilon)
    return (h @ params_t["tok"].t()).float()


def static_verify_logits(tspec: GPTDecodeSpec, params_t, kv: StaticKVCache,
                         u):
    """:func:`verify_logits` over the slot cache's rows (the candidate
    rows written in place)."""
    scale = 1.0 / math.sqrt(tspec.head_dim)
    eye = torch.eye(tspec.num_heads, dtype=params_t["tok"].dtype,
                    device=kv.device)

    def layer(li, lp, h, mask):
        return _block_verify(tspec, lp, h, kv_layer_view(kv.k, li),
                             kv_layer_view(kv.v, li), kv.lengths, mask,
                             scale, eye)

    return verify_logits(tspec, params_t, kv.lengths, u, kv.max_seq, layer)


def accept(k: int, max_top_k: int, lraw, lengths, finished, drafts,
           samp: SamplingVectors, generator):
    """The on-device accept-prefix selection over the verify's logits
    ``lraw [S, k+1, V]``. Advances ``lengths`` by each slot's emitted
    count, in place; returns ``(finished [S], new_last [S],
    out [S, k+2])``."""
    s = lengths.shape[0]
    dev = lengths.device
    t_len = k + 1
    t_greedy = torch.argmax(lraw, dim=-1).to(torch.int32)
    match = (drafts == t_greedy[:, :k]).to(torch.int32)
    m = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)  # 0..k
    # sampling slots take one verified token a tick; finished slots
    # freeze (the host released them already), as the plain step does
    m = torch.where(samp.do_sample | finished, torch.zeros_like(m), m)
    bonus = t_greedy.gather(1, m.long()[:, None])[:, 0]
    samp_tok = _sample(lraw[:, 0], samp.temperature, samp.top_k,
                       samp.do_sample, generator, max_top_k)
    step_tok = torch.where(samp.do_sample, samp_tok, bonus)
    step_tok = torch.where(finished & (samp.eos >= 0), samp.eos, step_tok)
    idx = torch.arange(t_len, device=dev)[None]
    ext = torch.cat([drafts, torch.zeros((s, 1), dtype=torch.int32,
                                         device=dev)], dim=1)
    emit = torch.where(idx < m[:, None], ext,
                       torch.where(idx == m[:, None], step_tok[:, None],
                                   torch.zeros_like(ext)))
    n_emit = m + 1
    hit_eos = ((emit == samp.eos[:, None]) & (samp.eos >= 0)[:, None]
               & (idx < n_emit[:, None])).any(dim=1)
    finished = finished | hit_eos
    out = torch.cat([n_emit[:, None], emit], dim=1).to(torch.int32)
    lengths += n_emit
    return finished, step_tok, out


def static_spec_step(tspec: GPTDecodeSpec, dspec: GPTDecodeSpec, k: int,
                     max_top_k: int, params, kv: StaticKVCache,
                     kv_draft: StaticKVCache, finished, last_tokens,
                     samp: SamplingVectors, generator):
    """THE speculative tick over the slot caches (the program of
    ``build_spec_decode_step``). ``params``: ``(target, draft)``. Every
    active slot must have ``lengths + k + 1 <= max_seq`` (the scheduler's
    room check; it falls back to the plain step otherwise). Returns
    ``(finished [S], new_last [S], out [S, k+2])``."""
    params_t, params_d = params
    drafts = draft_propose(dspec, params_d, kv_draft, kv.lengths,
                           last_tokens, k)
    u = torch.cat([last_tokens[:, None], drafts], dim=1)
    lraw = static_verify_logits(tspec, params_t, kv, u)
    return accept(k, max_top_k, lraw, kv.lengths, finished, drafts, samp,
                  generator)


def get_spec_decode_step(tspec: GPTDecodeSpec, dspec: GPTDecodeSpec,
                         k: int, max_top_k: int) -> Program:
    """The speculative tick as a compiled program (the JAX package's
    ``get_spec_decode_step``): ``fn((params_t, params_d), kv, kv_draft,
    finished, last_tokens, samp, generator)``, captured once per target
    cache and replayed after."""
    if k < 1:
        raise ValueError(f"speculation depth k must be >= 1, got {k}")
    return Program(functools.partial(static_spec_step, tspec, dspec, k,
                                     max_top_k))


class GPTSpecDecoder:
    """Draft and verify over one target :class:`GPTStaticDecoder` and a
    small draft GPT: the draft's parameters, its own
    :class:`StaticKVCache` (the target's slots and positions, the
    draft's heads; the target cache's lengths tensor), and the compiled
    spec step and draft prefill from the executable cache."""

    def __init__(self, target, draft_model, k: int = 4,
                 exec_cache: Optional[ExecutableCache] = None):
        if k < 1:
            raise ValueError(f"speculation depth k must be >= 1, got {k}")
        if target.weight_dtype == "int8":
            # the JAX package takes this config and fails at its first
            # spec step: its verify multiplies the quantized weight dict
            # as a dense matrix (a TypeError); refused here, at build
            raise ValueError(
                "speculative decoding (spec_k > 0) needs float32 target "
                "weights: the verify step multiplies dense weight "
                "matrices and has no int8 form. Set weight_dtype="
                "'float32' or spec_k=0.")
        self.target = target
        self.k = int(k)
        self.dspec = GPTDecodeSpec.from_model(draft_model)
        if self.dspec.vocab_size != target.spec.vocab_size:
            raise ValueError(
                f"draft vocab {self.dspec.vocab_size} != target vocab "
                f"{target.spec.vocab_size}: speculative verification "
                f"compares token ids, the vocabularies must be shared")
        draft_dev = draft_model.gpt.word_embeddings.weight.device
        if draft_dev != target.device:
            raise ValueError(
                f"the draft model lives on {draft_dev}, the target on "
                f"{target.device}: both must be on one device")
        self._draft_model = draft_model
        # `is not None`: an empty ExecutableCache is falsy
        self.exec_cache = (exec_cache if exec_cache is not None
                           else target.exec_cache)
        self._key = ("gpt-spec", target.spec, self.dspec, self.k,
                     target.max_top_k)
        # the (target, draft) pair handed to the program: the same tuple
        # every tick, so a replay finds the weights by identity
        self._pair = (None, None)

    def draft_params(self):
        return extract_gpt_params(self._draft_model)

    def new_draft_kv(self, num_slots: int, max_seq: int,
                     lengths: Optional[torch.Tensor] = None
                     ) -> StaticKVCache:
        """The draft's slot cache; with ``lengths`` (the target cache's)
        its lengths ARE that tensor, so one vector advances both."""
        dtype = self._draft_model.gpt.word_embeddings.weight.dtype
        kv = StaticKVCache(num_slots, self.dspec.num_layers, max_seq,
                           self.dspec.num_heads, self.dspec.head_dim,
                           dtype=dtype, device=self.target.device)
        if lengths is not None:
            if tuple(lengths.shape) != (num_slots,):
                raise ValueError(f"lengths of shape {tuple(lengths.shape)} "
                                 f"for {num_slots} slots")
            kv.lengths = lengths
        return kv

    # -- compiled-program access ---------------------------------------------
    def _spec_program(self) -> Program:
        return get_spec_decode_step(self.target.spec, self.dspec, self.k,
                                    self.target.max_top_k)

    def spec_step_fn(self, num_slots: int, max_seq: int) -> Program:
        return self.exec_cache.get_or_compile(
            self._key + ("spec_step", num_slots, max_seq),
            self._spec_program)

    def draft_prefill_fn(self, batch: int, prompt_len: int) -> Program:
        # the draft prefill is greedy (drafts are proposals): top-k 0
        return self.exec_cache.get_or_compile(
            self._key + ("draft_prefill", batch, prompt_len),
            lambda: get_prefill_fn(self.dspec, 0))

    # -- convenience wrappers ------------------------------------------------
    @torch.no_grad()
    def draft_prefill(self, kv_draft: StaticKVCache, params_d, tokens,
                      true_lens, slot_ids, finished, samp):
        """Prefill the DRAFT cache for newly admitted prompts. Only the
        K/V rows count: the lengths it sets are the target prefill's
        (the tensor is shared), and its token and finished flags are
        dropped. Greedy, so it draws nothing from any generator."""
        fn = self.draft_prefill_fn(tokens.shape[0], tokens.shape[1])
        fn(params_d, kv_draft, tokens, true_lens, slot_ids, finished, samp,
           None)

    @torch.no_grad()
    def step(self, kv, kv_draft: StaticKVCache, params_t, params_d,
             finished, last_tokens, samp, generator):
        """Advance every slot 1..k+1 tokens, both caches in place;
        returns ``(finished [S], new_last [S], out [S, k+2])``, the
        program's output buffers (the caller fetches ``out`` once)."""
        if self._pair[0] is not params_t or self._pair[1] is not params_d:
            self._pair = (params_t, params_d)
        fn = self.spec_step_fn(kv.num_slots, kv.max_seq)
        return fn(self._pair, kv, kv_draft, finished, last_tokens, samp,
                  generator)
