"""GPT decode building blocks and the static-slot decoder (counterpart of
``paddle_tpu/serving/llm/decode.py``: ``GPTDecodeSpec``, ``SamplingParams``,
``pack_sampling``, ``extract_gpt_params``, ``_QUANT_WEIGHT_KEYS``,
``quantize_gpt_params``, ``_mm``, ``_layer_norm``, ``_block_prefill``,
``_block_decode``, ``_sample``, the programs of
``build_prefill_fn``, ``build_decode_step``, ``build_tail_prefill_fn``
and ``build_insert_prefix_fn`` (here :func:`static_prefill`,
:func:`static_decode_step`, :func:`static_tail_prefill` and
:func:`insert_prefix_rows`), their compiled forms ``get_prefill_fn``,
``get_decode_step``, ``get_tail_prefill_fn`` and
``get_insert_prefix_fn``, and ``GPTStaticDecoder``).

The math mirrors the model's dense eval path operation for operation
(LayerNorm with the biased variance, exact GELU, the additive -1e9 causal
mask, tied-embedding logits), so a decoder built on these emits the JAX
package's tokens. Per-slot sampling settings travel as device vectors
(``temperature``, ``top_k``, ``do_sample``, ``eos``; eos < 0 means "no
eos"), so requests with different settings share one decode step.
Sampling draws from an explicit ``torch.Generator``: the JAX package's
``jax.random`` streams cannot be reproduced, so sampled tokens differ
between the packages while greedy tokens are the same.

Each program is a plain function over the cache's buffers, which it
writes in place (``kvcache.py``). As the JAX package jits each program
once per shape and hands it out through its ``ExecutableCache`` with a
trace counter, ``get_decode_step``/``get_prefill_fn`` wrap it in a
:class:`~paddle_tpu_torch.core.graphs.Program` (a CUDA graph captured
once per shape and KV cache, replayed after; eager on the CPU), and the
decoders hand those out through ``decode_fn``/``prefill_fn`` under the
JAX package's keys. ``decode_step``/``prefill``/``tail_prefill`` run
through them. The prefix insert (``insert_prefix``) copies host rows into
the cache from another host buffer at every hit, which a graph, binding
addresses, would have to stage through one of its own: it stays eager,
one copy per layer and buffer (:class:`EagerProgram`).

int8 serving (``weight_dtype="int8"``, ``kv_dtype="int8"``): every block
multiplies through :func:`_mm`, which takes a dense weight or an int8
``{"q", "s"}`` leaf of :func:`quantize_gpt_params` (per-out-channel
scales applied to the product); an int8 KV cache (``kvcache.py``) is
written quantized and each layer's rows are dequantized before the
attention, the JAX package's order. A decoder quantizes its weights once
into tensors it keeps, and re-quantizes into the same tensors
(``copy_``) at every ``params()`` call, so a captured program reads new
weights after an in-place change. The model's float weights stay
resident beside the codes, as in the JAX package. The tail prefill and
the prefix insert over an int8 cache raise, as the JAX package's.
"""
from __future__ import annotations

import functools
import math
import weakref
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from ...core.graphs import Program
from ...nn.functional import gelu, softmax
from ..cache import ExecutableCache, default_cache
from .kvcache import (StaticKVCache, _later, append_token_kv, dequantize_kv,
                      kv_layer_view, token_index, valid_mask,
                      write_prompt_kv)


@dataclass(frozen=True)
class GPTDecodeSpec:
    """The static facts of the model a decoder runs."""
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    max_position_embeddings: int
    ln_epsilon: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def from_model(cls, model) -> "GPTDecodeSpec":
        c = model.gpt.config
        return cls(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                   num_layers=c.num_layers, num_heads=c.num_heads,
                   max_position_embeddings=c.max_position_embeddings)


@dataclass
class SamplingParams:
    """Per-request decode settings (host side; :func:`pack_sampling`
    turns a slot list of them into device vectors)."""
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    eos_token_id: Optional[int] = None
    max_new_tokens: int = 32

    def clamped_temperature(self) -> float:
        return max(float(self.temperature), 1e-6)


class SamplingVectors(NamedTuple):
    temperature: torch.Tensor    # [S] f32
    top_k: torch.Tensor          # [S] int32
    do_sample: torch.Tensor      # [S] bool
    eos: torch.Tensor            # [S] int32, -1 = none


def pack_sampling(params_list: Sequence[SamplingParams],
                  device) -> SamplingVectors:
    """Host SamplingParams -> the per-slot device vectors."""
    return SamplingVectors(
        torch.tensor([p.clamped_temperature() for p in params_list],
                     dtype=torch.float32, device=device),
        torch.tensor([int(p.top_k) for p in params_list],
                     dtype=torch.int32, device=device),
        torch.tensor([bool(p.do_sample) for p in params_list],
                     dtype=torch.bool, device=device),
        torch.tensor([-1 if p.eos_token_id is None else int(p.eos_token_id)
                      for p in params_list], dtype=torch.int32,
                     device=device))


def extract_gpt_params(model) -> Dict:
    """The GPT parameters as a dict of tensors (references, not copies;
    re-extract after the weights change)."""
    gpt = model.gpt
    layers = []
    for lyr in gpt.decoder.layers:
        a = lyr.self_attn
        layers.append({
            "qw": a.q_proj.weight, "qb": a.q_proj.bias,
            "kw": a.k_proj.weight, "kb": a.k_proj.bias,
            "vw": a.v_proj.weight, "vb": a.v_proj.bias,
            "ow": a.out_proj.weight, "ob": a.out_proj.bias,
            "w1": lyr.linear1.weight, "b1": lyr.linear1.bias,
            "w2": lyr.linear2.weight, "b2": lyr.linear2.bias,
            "n1w": lyr.norm1.weight, "n1b": lyr.norm1.bias,
            "n2w": lyr.norm2.weight, "n2b": lyr.norm2.bias,
        })
    return {"tok": gpt.word_embeddings.weight,
            "pos": gpt.position_embeddings.weight,
            "fnw": gpt.decoder.norm.weight, "fnb": gpt.decoder.norm.bias,
            "layers": tuple(layers)}


#: the per-layer weight matrices that become int8 (biases and norms stay
#: float: O(E) bytes and scale-sensitive)
_QUANT_WEIGHT_KEYS = ("qw", "kw", "vw", "ow", "w1", "w2")


@torch.no_grad()
def quantize_gpt_params(params: Dict, out: Optional[Dict] = None) -> Dict:
    """Per-out-channel int8 weights of the GPT parameter dict: each of
    :data:`_QUANT_WEIGHT_KEYS` becomes ``{"q": int8 [in, out], "s": f32
    [out]}`` with ``w ~ q * s`` (``quantization.quantize_weight_int8``);
    the embeddings (``tok`` is also the logit head), biases and norms stay
    as they are. With ``out`` (an earlier result for the same model) the
    codes and scales are written into ``out``'s tensors in place and the
    new dict holds those tensors."""
    from ...quantization import quantize_weight_int8

    def q8(key, li, w):
        q, s = quantize_weight_int8(w, quant_axis=1)
        if out is None:
            return {"q": q, "s": s}
        leaf = out["layers"][li][key]
        leaf["q"].copy_(q)
        leaf["s"].copy_(s)
        return leaf

    layers = tuple({k: (q8(k, li, v) if k in _QUANT_WEIGHT_KEYS else v)
                    for k, v in lp.items()}
                   for li, lp in enumerate(params["layers"]))
    return dict(params, layers=layers)


def _mm(x, w):
    """``x @ w`` for a dense weight, or for an int8 ``{"q", "s"}`` leaf
    ``(x @ q) * s``: the codes in ``x``'s type, the per-out-channel scale
    applied to the product (equal to dequantizing first up to the
    reassociated rounding)."""
    if isinstance(w, dict):
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w


def _layer_norm(x, w, b, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def _sample(lraw, temperature, top_k, do_sample, generator, max_top_k: int):
    """Greedy argmax, or temperature + top-k sampling, per slot.

    ``lraw``: ``[S, V]`` f32 logits. Greedy ignores the temperature;
    sampling divides by it, sets everything below the slot's k-th logit to
    -1e9 when its ``top_k > 0`` (``max_top_k`` bounds k), then takes the
    Gumbel-max draw ``argmax(logits - log(-log(u)))`` with ``u`` from
    ``generator`` — the recipe of ``jax.random.categorical``. With
    ``generator=None`` every slot is greedy and nothing is drawn (the
    caller guarantees that no slot samples), as greedy ``generate`` in
    the JAX package consumes no key.
    """
    greedy = torch.argmax(lraw, dim=-1).to(torch.int32)
    if generator is None:
        return greedy
    lt = lraw / temperature[:, None]
    if max_top_k > 0:
        vals = torch.topk(lt, max_top_k, dim=-1).values   # [S, maxK] desc
        kidx = (top_k.clamp(1, max_top_k) - 1).long()
        kth = vals.gather(-1, kidx[:, None])
        filtered = torch.where(lt < kth, torch.full_like(lt, -1e9), lt)
        lt = torch.where((top_k > 0)[:, None], filtered, lt)
    u = torch.rand(lt.shape, generator=generator, device=lt.device)
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    sampled = torch.argmax(lt - torch.log(-torch.log(u)),
                           dim=-1).to(torch.int32)
    return torch.where(do_sample, sampled, greedy)


def _block_prefill(spec: GPTDecodeSpec, lp, h, mask, scale):
    """One pre-norm block over a whole ``[B, L, E]`` prompt; returns
    ``(h, k, v)`` with K/V as ``[B, L, H, D]``."""
    b, l = h.shape[0], h.shape[1]
    x = _layer_norm(h, lp["n1w"], lp["n1b"], spec.ln_epsilon)

    def heads(t):
        return t.reshape(b, l, spec.num_heads, spec.head_dim)

    q = heads(_mm(x, lp["qw"]) + lp["qb"])
    k = heads(_mm(x, lp["kw"]) + lp["kb"])
    v = heads(_mm(x, lp["vw"]) + lp["vb"])
    qh = (q * scale).permute(0, 2, 1, 3)                  # [B, H, L, D]
    kh = k.permute(0, 2, 1, 3)
    vh = v.permute(0, 2, 1, 3)
    weights = softmax(torch.matmul(qh, kh.transpose(-1, -2)) + mask)
    out = torch.matmul(weights, vh).permute(0, 2, 1, 3).reshape(
        b, l, spec.hidden_size)
    h = h + (_mm(out, lp["ow"]) + lp["ob"])
    x = _layer_norm(h, lp["n2w"], lp["n2b"], spec.ln_epsilon)
    ffn = gelu(_mm(x, lp["w1"]) + lp["b1"])
    return h + (_mm(ffn, lp["w2"]) + lp["b2"]), k, v


def _block_decode(spec: GPTDecodeSpec, lp, h, kb, vb, index, mask, scale,
                  eye):
    """One pre-norm block for one new token per slot. ``h``: ``[S, E]``;
    ``kb``/``vb``: this layer's ``[S, max_seq, H, D]`` views of the slot
    buffers, into which the token's K/V is written at ``index`` (the
    step's :func:`~.kvcache.token_index`, in place) before attending over
    all ``max_seq`` rows under ``mask``; an int8 view is written quantized
    and its rows dequantized into ``h``'s type before the attention, as
    the JAX package's step does. ``eye``: the ``[H, H]`` identity
    in ``h``'s type. The step builds ``index``, ``mask`` and ``eye`` once
    for all its layers.

    The attention is dense, as the JAX package's, but never copies the
    layer view: ``kb[:, li]`` is strided over slots and heads, so
    ``[S, H, max_seq, D]`` is not one strided batch and ``torch.matmul``
    would copy it (64 MiB per buffer per layer per tick at 1.3B). Each
    slot's rows are instead one ``[max_seq, H*D]`` matrix, and the heads
    become a block-diagonal ``[H*D, H]`` query: one batched GEMM over
    slots gives every head's scores, a second gives ``[H, H*D]`` from
    which each head keeps its own diagonal block. That costs ``H`` times
    the dot products of the dense form and reads each cache byte once."""
    s = h.shape[0]
    nh, hd = spec.num_heads, spec.head_dim
    x = _layer_norm(h, lp["n1w"], lp["n1b"], spec.ln_epsilon)
    shape = (s, nh, hd)
    q = (_mm(x, lp["qw"]) + lp["qb"]).reshape(shape)
    kn = (_mm(x, lp["kw"]) + lp["kb"]).reshape(shape)
    vn = (_mm(x, lp["vw"]) + lp["vb"]).reshape(shape)
    append_token_kv(kb, vb, kn, vn, None, index=index)
    if isinstance(kb, dict):
        kb, vb = dequantize_kv(kb, h.dtype), dequantize_kv(vb, h.dtype)
    qbd = ((q * scale)[:, :, :, None] * eye[:, None, :]).reshape(
        s, nh * hd, nh)                                   # [S, H*D, H]
    prod = torch.bmm(kb.flatten(2), qbd)                  # [S, max, H]
    weights = softmax(prod.transpose(1, 2) + mask[:, 0])  # [S, H, max]
    blocks = torch.bmm(weights, vb.flatten(2))            # [S, H, H*D]
    out = blocks.view(s, nh, nh, hd).diagonal(dim1=1, dim2=2)  # [S, D, H]
    out = out.transpose(1, 2).reshape(s, spec.hidden_size)
    h = h + (_mm(out, lp["ow"]) + lp["ob"])
    x = _layer_norm(h, lp["n2w"], lp["n2b"], spec.ln_epsilon)
    ffn = gelu(_mm(x, lp["w1"]) + lp["b1"])
    return h + (_mm(ffn, lp["w2"]) + lp["b2"])


def prefill_forward(spec: GPTDecodeSpec, params, tokens, true_lens):
    """The dense causal forward of right-padded prompts ``tokens [B, Lp]``
    (``_block_prefill`` per layer): returns the logits of each prompt's
    last real token ``[B, V]`` f32 and its K/V ``[B, L, Lp, H, D]``.
    Right padding is safe under the causal mask: real position i attends
    only j <= i < true_len."""
    scale = 1.0 / math.sqrt(spec.head_dim)
    b, lp_len = tokens.shape
    dev = tokens.device
    pos = torch.arange(lp_len, device=dev)
    h = params["tok"][tokens.long()] + params["pos"][pos][None]   # [B, L, E]
    # -1e9 made in float32, then cast: -inf in float16, as the JAX
    # package's jnp.full(-1e9, float16) gives
    mask = torch.triu(torch.full((lp_len, lp_len), -1e9, device=dev)
                      .to(h.dtype), 1)[None, None]
    kcs, vcs = [], []
    for lp in params["layers"]:
        h, k, v = _block_prefill(spec, lp, h, mask, scale)
        kcs.append(k)
        vcs.append(v)
    h = _layer_norm(h, params["fnw"], params["fnb"], spec.ln_epsilon)
    last = h[torch.arange(b, device=dev), true_lens.long() - 1]    # [B, E]
    lraw = (last @ params["tok"].t()).float()
    return lraw, torch.stack(kcs, dim=1), torch.stack(vcs, dim=1)


def sample_prefill(lraw, slots, finished, samp: SamplingVectors, generator,
                   max_top_k: int):
    """The first token of each prefilled prompt, and ``finished`` with
    the prefilled ``slots`` set by whether it is their eos."""
    nxt = _sample(lraw, samp.temperature, samp.top_k, samp.do_sample,
                  generator, max_top_k)
    finished = finished.clone()
    finished[slots] = (nxt == samp.eos) & (samp.eos >= 0)
    return nxt, finished


def sample_step(lraw, lengths, finished, samp: SamplingVectors, generator,
                max_top_k: int):
    """The tail of every decode step: sample, freeze finished rows to
    their eos (per-row eos semantics of ``generate``), mark new eos hits
    and advance every slot's length by one, in place (inactive slots
    compute junk that the scheduler discards). Returns ``(next_tokens
    [S], finished [S])``."""
    nxt = _sample(lraw, samp.temperature, samp.top_k, samp.do_sample,
                  generator, max_top_k)
    has_eos = samp.eos >= 0
    nxt = torch.where(finished & has_eos, samp.eos, nxt)
    finished = finished | ((nxt == samp.eos) & has_eos)
    lengths += 1
    return nxt, finished


def static_decode_logits(spec: GPTDecodeSpec, params, kv: StaticKVCache,
                         last_tokens):
    """The forward half of a static-slot decode step: embed each slot's
    last token at its position (clamped to the position table, as the
    JAX package's), write its K/V into the slot buffers (in place) and
    return the ``[S, V]`` f32 logits. ``kv.lengths`` is not advanced."""
    scale = 1.0 / math.sqrt(spec.head_dim)
    positions = kv.lengths
    posc = positions.long().clamp(0, spec.max_position_embeddings - 1)
    h = params["tok"][last_tokens.long()] + params["pos"][posc]   # [S, E]
    mask = valid_mask(positions, kv.max_seq, h.dtype)
    index = token_index(positions, kv.max_seq)
    eye = torch.eye(spec.num_heads, dtype=h.dtype, device=h.device)
    for li, lp in enumerate(params["layers"]):
        h = _block_decode(spec, lp, h, kv_layer_view(kv.k, li),
                          kv_layer_view(kv.v, li), index, mask, scale, eye)
    h = _layer_norm(h, params["fnw"], params["fnb"], spec.ln_epsilon)
    return (h @ params["tok"].t()).float()


def static_decode_step(spec: GPTDecodeSpec, max_top_k: int, params,
                       kv: StaticKVCache, finished, last_tokens,
                       samp: SamplingVectors, generator):
    """Advance every slot one token (the program of the JAX package's
    ``build_decode_step``). Returns ``(next_tokens [S], finished [S])``."""
    lraw = static_decode_logits(spec, params, kv, last_tokens)
    return sample_step(lraw, kv.lengths, finished, samp, generator,
                       max_top_k)


def static_prefill(spec: GPTDecodeSpec, max_top_k: int, params,
                   kv: StaticKVCache, tokens, true_lens, slot_ids, finished,
                   samp: SamplingVectors, generator):
    """Prefill right-padded prompts ``tokens [B, Lp]`` into ``slot_ids``
    (the program of ``build_prefill_fn``): all ``Lp`` rows of K/V land in
    the slots, as the JAX package's ``write_prompt_kv`` writes them (the
    rows past ``true_len`` stay masked until decode overwrites them), the
    slots' lengths are set and the first token is sampled. Returns
    ``(next_tokens [B], finished [S])``."""
    lraw, k_new, v_new = prefill_forward(spec, params, tokens, true_lens)
    slots = slot_ids.long()
    write_prompt_kv(kv.k, kv.v, k_new, v_new, slots)
    kv.lengths[slots] = true_lens.to(torch.int32)
    return sample_prefill(lraw, slots, finished, samp, generator, max_top_k)


def tail_forward(spec: GPTDecodeSpec, params, tokens, tail_lens, starts,
                 max_seq: int, write_layer, read_layer):
    """The forward of prompt tails ``tokens [B, Lt]`` (right-padded,
    ``tail_lens`` real tokens) at per-request offsets ``starts`` over a
    cache whose rows ``[0, starts)`` already hold each prompt's head
    (the JAX package's ``build_tail_prefill_fn`` math). Per layer the
    tail's K/V is written first (``write_layer(li, k, v)``, ``[B, Lt, H,
    D]``, in place) and the whole ``[B, max_seq, H, D]`` row read back
    (``read_layer(li)``), which the JAX package reads as the gathered row
    with the tail spliced in; tail query i, at absolute position
    ``starts + i``, attends rows ``j <= starts + i`` under the additive
    -1e9 mask. Returns the ``[B, V]`` f32 logits of each tail's last real
    token and the tail's K/V ``[B, L, Lt, H, D]``."""
    scale = 1.0 / math.sqrt(spec.head_dim)
    b, lt = tokens.shape
    dev = tokens.device
    pos = starts.long()[:, None] + torch.arange(lt, device=dev)[None, :]
    posc = pos.clamp(0, spec.max_position_embeddings - 1)
    h = params["tok"][tokens.long()] + params["pos"][posc]   # [B, Lt, E]
    j = torch.arange(max_seq, device=dev)[None, None, :]
    zero = torch.zeros((), dtype=h.dtype, device=dev)
    neg = torch.full((), -1e9, device=dev).to(h.dtype)
    mask = torch.where(j <= pos[:, :, None], zero, neg)[:, None]  # [B,1,Lt,max]
    kcs, vcs = [], []
    for li, lp in enumerate(params["layers"]):
        x = _layer_norm(h, lp["n1w"], lp["n1b"], spec.ln_epsilon)

        def heads(t):
            return t.reshape(b, lt, spec.num_heads, spec.head_dim)

        q = heads(_mm(x, lp["qw"]) + lp["qb"])
        kn = heads(_mm(x, lp["kw"]) + lp["kb"])
        vn = heads(_mm(x, lp["vw"]) + lp["vb"])
        write_layer(li, kn, vn)
        row_k, row_v = read_layer(li)                        # [B, max, H, D]
        qh = (q * scale).permute(0, 2, 1, 3)                 # [B, H, Lt, D]
        kt = row_k.to(h.dtype).permute(0, 2, 1, 3)           # [B, H, max, D]
        vt = row_v.to(h.dtype).permute(0, 2, 1, 3)
        weights = softmax(torch.matmul(qh, kt.transpose(-1, -2)) + mask)
        out = torch.matmul(weights, vt).permute(0, 2, 1, 3).reshape(
            b, lt, spec.hidden_size)
        h = h + (_mm(out, lp["ow"]) + lp["ob"])
        x = _layer_norm(h, lp["n2w"], lp["n2b"], spec.ln_epsilon)
        ffn = gelu(_mm(x, lp["w1"]) + lp["b1"])
        h = h + (_mm(ffn, lp["w2"]) + lp["b2"])
        kcs.append(kn)
        vcs.append(vn)
    h = _layer_norm(h, params["fnw"], params["fnb"], spec.ln_epsilon)
    last = h[torch.arange(b, device=dev), tail_lens.long() - 1]      # [B, E]
    lraw = (last @ params["tok"].t()).float()
    return lraw, torch.stack(kcs, dim=1), torch.stack(vcs, dim=1)


def static_tail_prefill(spec: GPTDecodeSpec, max_top_k: int, params,
                        kv: StaticKVCache, tokens, tail_lens, starts,
                        slot_ids, finished, samp: SamplingVectors,
                        generator):
    """Prefill prompt tails ``tokens [B, Lt]`` into ``slot_ids`` at row
    offsets ``starts``, behind heads an :func:`insert_prefix_rows` landed
    (the program of ``build_tail_prefill_fn``): all ``Lt`` rows land at
    ``starts`` (clamped as ``dynamic_update_slice`` clamps), the lengths
    become ``starts + tail_lens`` and the first token is sampled.
    Returns ``(next_tokens [B], finished [S])``. An int8 cache raises,
    as the JAX package's."""
    _dense_only(kv, "tail prefill (prefix reuse)")
    slots = slot_ids.long()
    lt = tokens.shape[1]
    start = starts.long().clamp(0, kv.max_seq - lt)
    rows = start[:, None] + torch.arange(lt, device=tokens.device)[None, :]

    def write_layer(li, kn, vn):
        kv.k[slots[:, None], li, rows] = kn.to(kv.dtype)
        kv.v[slots[:, None], li, rows] = vn.to(kv.dtype)

    def read_layer(li):
        return kv.k[slots, li], kv.v[slots, li]

    lraw, _, _ = tail_forward(spec, params, tokens, tail_lens, starts,
                              kv.max_seq, write_layer, read_layer)
    kv.lengths[slots] = (starts + tail_lens).to(torch.int32)
    return sample_prefill(lraw, slots, finished, samp, generator, max_top_k)


def insert_prefix_rows(kv: StaticKVCache, k_pre, v_pre, slot: int):
    """Copy a cached host prefix ``[L, n, H, D]`` into ``slot``'s rows
    ``[0, n)`` (the program of ``build_insert_prefix_fn``), one copy per
    layer and buffer: a layer's rows are one contiguous block on both
    sides, where the whole ``[L, n]`` slice of a longer entry is not, and
    a strided host source would first be gathered into pageable memory.
    The slot's length is the tail prefill's to set. An int8 cache raises,
    as the JAX package's."""
    _dense_only(kv, "insert_prefix")
    for li in range(k_pre.shape[0]):
        kv.k[slot, li, :k_pre.shape[1]].copy_(torch.as_tensor(k_pre[li]))
        kv.v[slot, li, :v_pre.shape[1]].copy_(torch.as_tensor(v_pre[li]))


def _dense_only(kv, what: str):
    if getattr(kv, "quantized", False):
        raise NotImplementedError(
            f"{what} over an int8 KV cache is unsupported; "
            f"LLMEngineConfig gates prefix_cache off for kv_dtype='int8'")


class EagerProgram:
    """A program that runs eagerly on every device, with a
    ``trace_counter`` that counts a trace at each state's first call, as
    the CPU counts a :class:`~paddle_tpu_torch.core.graphs.Program`'s
    (the prefix insert, a copy from host memory that a CUDA graph cannot
    record)."""

    def __init__(self, raw):
        self.raw = raw
        self.trace_counter = {"traces": 0}
        self._seen = weakref.WeakSet()

    def __call__(self, state, *args):
        if state not in self._seen:
            self._seen.add(state)
            self.trace_counter["traces"] += 1
        return self.raw(state, *args)


def get_decode_step(spec: GPTDecodeSpec, max_top_k: int) -> Program:
    """THE static-slot decode step as a compiled program (the JAX
    package's ``get_decode_step``): ``fn(params, kv, finished,
    last_tokens, samp, generator) -> (next_tokens, finished)``, captured
    once per KV cache (``fn.trace_counter["traces"]`` counts captures) and
    replayed after. A new program each call, unlike the JAX package's
    ``lru_cache``: a program owns its graphs, and an ``ExecutableCache``
    eviction releases them, so two cache entries never share one."""
    return Program(functools.partial(static_decode_step, spec, max_top_k))


def get_prefill_fn(spec: GPTDecodeSpec, max_top_k: int) -> Program:
    """The static-slot prefill as a compiled program (``get_prefill_fn``):
    ``fn(params, kv, tokens, true_lens, slot_ids, finished, samp,
    generator) -> (next_tokens, finished)``, one per prompt shape."""
    return Program(functools.partial(static_prefill, spec, max_top_k))


def get_tail_prefill_fn(spec: GPTDecodeSpec, max_top_k: int) -> Program:
    """The static-slot tail prefill as a compiled program
    (``get_tail_prefill_fn``): ``fn(params, kv, tokens, tail_lens,
    starts, slot_ids, finished, samp, generator)``, one per (batch, tail
    bucket); ``starts`` is a device input, so one program serves every
    reuse offset."""
    return Program(functools.partial(static_tail_prefill, spec, max_top_k))


def get_insert_prefix_fn() -> EagerProgram:
    """The prefix insert (``get_insert_prefix_fn``): ``fn(kv, k_pre,
    v_pre, slot)``, eager (:class:`EagerProgram`)."""
    return EagerProgram(insert_prefix_rows)


class GPTDecoderBase:
    """What the engine needs of a decoder over one GPT model: its spec,
    its device, its parameters, the sampling bound and its programs
    (``decode_fn``/``prefill_fn``, from ``exec_cache`` under the JAX
    package's keys; the process-wide ``default_cache()`` when None);
    subclasses add the KV substrate (``new_kv``) and the program makers
    (``_decode_program``, ``_prefill_program``).

    The programs' graphs read the tensors ``params()`` returns where they
    lie: weights are changed in place (``Tensor.copy_``), or the cache's
    entries dropped (``exec_cache.clear()``); a program called with
    weights elsewhere raises. With ``weight_dtype="int8"``, ``params()``
    quantizes into the decoder's own code and scale tensors (the same
    ones at every call), so call it again after an in-place change. The
    AMP state a program saw at its first call stays in its graph, as a
    jit keeps what it saw at its first trace."""

    def __init__(self, model, max_top_k: int = 64,
                 weight_dtype: str = "float32", kv_dtype: str = "float32",
                 exec_cache: Optional[ExecutableCache] = None):
        if weight_dtype not in ("float32", "int8"):
            raise ValueError(
                f"weight_dtype must be 'float32' or 'int8', got "
                f"{weight_dtype!r}")
        if kv_dtype not in ("float32", "int8"):
            raise ValueError(
                f"kv_dtype must be 'float32' or 'int8', got {kv_dtype!r}")
        self.spec = GPTDecodeSpec.from_model(model)
        self._model = model
        self.max_top_k = max(0, min(int(max_top_k), self.spec.vocab_size))
        self.weight_dtype = weight_dtype
        self.kv_dtype = kv_dtype
        # `is not None`: an empty ExecutableCache has len() 0 and is falsy
        self.exec_cache = (exec_cache if exec_cache is not None
                           else default_cache())
        self._key = ("gpt-static", self.spec, self.max_top_k,
                     self.weight_dtype, self.kv_dtype)
        self._qparams = None

    @property
    def device(self) -> torch.device:
        return self._model.gpt.word_embeddings.weight.device

    @property
    def model(self):
        """The GPT model the decoder reads its parameters from."""
        return self._model

    def params(self):
        """The GPT parameter dict; with int8 weights its projection
        weights quantized into the decoder's resident tensors (written in
        place at every call after the first)."""
        p = extract_gpt_params(self._model)
        if self.weight_dtype == "int8":
            self._qparams = quantize_gpt_params(p, out=self._qparams)
            return self._qparams
        return p

    @property
    def _kv_arg(self):
        return "int8" if self.kv_dtype == "int8" else None

    def new_kv(self, num_slots: int, max_seq: int):
        raise NotImplementedError

    def _decode_program(self) -> Program:
        raise NotImplementedError

    def _prefill_program(self) -> Program:
        raise NotImplementedError

    def _tail_prefill_program(self) -> Program:
        raise NotImplementedError

    def prefix_sig(self, kv):
        """The shape a prefix-store entry must match to be reusable in
        this decoder's cache (``max_seq`` is not part of it: a prefix
        from a longer-row engine fits a shorter row as long as the
        scheduler's reuse cap holds)."""
        return (self.spec.num_layers, self.spec.num_heads,
                self.spec.head_dim, _dtype_name(kv.dtype))

    # -- compiled-program access --------------------------------------------
    def decode_fn(self, num_slots: int, max_seq: int) -> Program:
        """The decode step for ``num_slots`` x ``max_seq`` caches; the key
        carries the shape pair, so a miss is a new signature."""
        return self.exec_cache.get_or_compile(
            self._key + ("decode", num_slots, max_seq), self._decode_program)

    def prefill_fn(self, batch: int, prompt_len: int) -> Program:
        """The prefill of ``batch`` prompts padded to ``prompt_len``."""
        return self.exec_cache.get_or_compile(
            self._key + ("prefill", batch, prompt_len),
            self._prefill_program)

    def tail_prefill_fn(self, batch: int, tail_len: int) -> Program:
        """The tail prefill of ``batch`` prompt tails padded to
        ``tail_len``, under the JAX package's key."""
        return self.exec_cache.get_or_compile(
            self._key + ("tail_prefill", batch, tail_len),
            self._tail_prefill_program)

    @torch.no_grad()
    def tail_prefill(self, kv, params, tokens, tail_lens, starts, slot_ids,
                     finished, samp, generator):
        """Prefill prompt tails ``tokens [B, Lt]`` at row offsets
        ``starts`` through ``tail_prefill_fn(B, Lt)``, behind heads the
        cache already holds; returns ``(next_tokens [B], finished [S])``,
        the program's output buffers. An int8 cache raises, as the JAX
        package's."""
        _dense_only(kv, "tail_prefill")
        fn = self.tail_prefill_fn(tokens.shape[0], tokens.shape[1])
        return fn(params, kv, tokens, tail_lens, starts, slot_ids, finished,
                  samp, generator)

    @torch.no_grad()
    def prefill(self, kv, params, tokens, true_lens, slot_ids, finished,
                samp, generator):
        """Prefill ``tokens [B, Lp]`` into ``slot_ids`` through
        ``prefill_fn(B, Lp)``; returns ``(next_tokens [B], finished [S])``,
        the program's output buffers (read them before the next call)."""
        fn = self.prefill_fn(tokens.shape[0], tokens.shape[1])
        return fn(params, kv, tokens, true_lens, slot_ids, finished, samp,
                  generator)

    @torch.no_grad()
    def decode_step(self, kv, params, finished, last_tokens, samp,
                    generator):
        """Advance every slot one token through ``decode_fn``; returns
        ``(next_tokens [S], finished [S])``, the program's output
        buffers."""
        fn = self.decode_fn(kv.num_slots, kv.max_seq)
        return fn(params, kv, finished, last_tokens, samp, generator)


class GPTStaticDecoder(GPTDecoderBase):
    """The static-slot decoder over one GPT model: ``new_kv`` returns a
    :class:`StaticKVCache` on the model's device, and ``prefill`` /
    ``tail_prefill`` / ``decode_step`` write it in place through the
    compiled programs that ``prefill_fn``/``tail_prefill_fn``/
    ``decode_fn`` hand out; ``insert_prefix`` copies a prefix-store entry
    into a slot. A slot-sharded mesh is queue A10's second slice."""

    def __init__(self, model, max_top_k: int = 64,
                 exec_cache: Optional[ExecutableCache] = None, mesh=None,
                 weight_dtype: str = "float32", kv_dtype: str = "float32"):
        if mesh is not None:
            raise _later("a slot-sharded mesh (mesh=...)", "A10")
        super().__init__(model, max_top_k=max_top_k,
                         weight_dtype=weight_dtype, kv_dtype=kv_dtype,
                         exec_cache=exec_cache)

    def new_kv(self, num_slots: int, max_seq: int) -> StaticKVCache:
        if max_seq > self.spec.max_position_embeddings:
            raise ValueError(
                f"max_seq {max_seq} exceeds the model's "
                f"{self.spec.max_position_embeddings} positions")
        dtype = self._model.gpt.word_embeddings.weight.dtype
        return StaticKVCache(num_slots, self.spec.num_layers, max_seq,
                             self.spec.num_heads, self.spec.head_dim,
                             dtype=dtype, kv_dtype=self._kv_arg,
                             device=self.device)

    def _decode_program(self) -> Program:
        return get_decode_step(self.spec, self.max_top_k)

    def _prefill_program(self) -> Program:
        return get_prefill_fn(self.spec, self.max_top_k)

    @torch.no_grad()
    def decode_logits(self, kv: StaticKVCache, params, last_tokens):
        """One decode step's logits on the current cache state, without
        advancing the lengths (for holding the slot lane against the
        paged lanes on the same prompts)."""
        return static_decode_logits(self.spec, params, kv, last_tokens)

    def _tail_prefill_program(self) -> Program:
        return get_tail_prefill_fn(self.spec, self.max_top_k)

    def insert_prefix_fn(self, prefix_len: int) -> EagerProgram:
        """The prefix insert of ``prefix_len`` rows, under the JAX
        package's key."""
        return self.exec_cache.get_or_compile(
            self._key + ("insert_prefix", prefix_len), get_insert_prefix_fn)

    @torch.no_grad()
    def insert_prefix(self, kv: StaticKVCache, k_pre, v_pre, slot: int):
        """Copy a cached host prefix ``[L, n, H, D]`` into ``slot``'s rows
        ``[0, n)`` through ``insert_prefix_fn(n)``; the tail prefill that
        follows sets the slot's length. An int8 cache raises."""
        _dense_only(kv, "insert_prefix")
        self.insert_prefix_fn(int(k_pre.shape[1]))(kv, k_pre, v_pre,
                                                   int(slot))


def _dtype_name(dtype) -> str:
    """``torch.float32`` -> ``"float32"``, the JAX package's dtype
    string in a prefix signature."""
    return str(dtype).replace("torch.", "")
