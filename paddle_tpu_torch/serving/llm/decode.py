"""GPT decode building blocks and the static-slot decoder (counterpart of
``paddle_tpu/serving/llm/decode.py``: ``GPTDecodeSpec``, ``SamplingParams``,
``pack_sampling``, ``extract_gpt_params``, ``_layer_norm``,
``_block_prefill``, ``_block_decode``, ``_sample``, the programs of
``build_prefill_fn`` and ``build_decode_step`` (here
:func:`static_prefill` and :func:`static_decode_step`), their compiled
forms ``get_prefill_fn`` and ``get_decode_step``, and
``GPTStaticDecoder``).

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
JAX package's keys. ``decode_step``/``prefill`` run through them.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from ...core.graphs import Program
from ...nn.functional import gelu, softmax
from ..cache import ExecutableCache, default_cache
from .kvcache import (StaticKVCache, _later, append_token_kv, kv_layer_view,
                      token_index, valid_mask, write_prompt_kv)


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

    q = heads(x @ lp["qw"] + lp["qb"])
    k = heads(x @ lp["kw"] + lp["kb"])
    v = heads(x @ lp["vw"] + lp["vb"])
    qh = (q * scale).permute(0, 2, 1, 3)                  # [B, H, L, D]
    kh = k.permute(0, 2, 1, 3)
    vh = v.permute(0, 2, 1, 3)
    weights = softmax(torch.matmul(qh, kh.transpose(-1, -2)) + mask)
    out = torch.matmul(weights, vh).permute(0, 2, 1, 3).reshape(
        b, l, spec.hidden_size)
    h = h + (out @ lp["ow"] + lp["ob"])
    x = _layer_norm(h, lp["n2w"], lp["n2b"], spec.ln_epsilon)
    ffn = gelu(x @ lp["w1"] + lp["b1"])
    return h + (ffn @ lp["w2"] + lp["b2"]), k, v


def _block_decode(spec: GPTDecodeSpec, lp, h, kb, vb, index, mask, scale,
                  eye):
    """One pre-norm block for one new token per slot. ``h``: ``[S, E]``;
    ``kb``/``vb``: this layer's ``[S, max_seq, H, D]`` views of the slot
    buffers, into which the token's K/V is written at ``index`` (the
    step's :func:`~.kvcache.token_index`, in place) before attending over
    all ``max_seq`` rows under ``mask``. ``eye``: the ``[H, H]`` identity
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
    q = (x @ lp["qw"] + lp["qb"]).reshape(shape)
    kn = (x @ lp["kw"] + lp["kb"]).reshape(shape)
    vn = (x @ lp["vw"] + lp["vb"]).reshape(shape)
    append_token_kv(kb, vb, kn, vn, None, index=index)
    qbd = ((q * scale)[:, :, :, None] * eye[:, None, :]).reshape(
        s, nh * hd, nh)                                   # [S, H*D, H]
    prod = torch.bmm(kb.flatten(2), qbd)                  # [S, max, H]
    weights = softmax(prod.transpose(1, 2) + mask[:, 0])  # [S, H, max]
    blocks = torch.bmm(weights, vb.flatten(2))            # [S, H, H*D]
    out = blocks.view(s, nh, nh, hd).diagonal(dim1=1, dim2=2)  # [S, D, H]
    out = out.transpose(1, 2).reshape(s, spec.hidden_size)
    h = h + (out @ lp["ow"] + lp["ob"])
    x = _layer_norm(h, lp["n2w"], lp["n2b"], spec.ln_epsilon)
    ffn = gelu(x @ lp["w1"] + lp["b1"])
    return h + (ffn @ lp["w2"] + lp["b2"])


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
    weights elsewhere raises. The AMP state a program saw at its first
    call stays in its graph, as a jit keeps what it saw at its first
    trace."""

    def __init__(self, model, max_top_k: int = 64,
                 weight_dtype: str = "float32", kv_dtype: str = "float32",
                 exec_cache: Optional[ExecutableCache] = None):
        if weight_dtype != "float32":
            raise NotImplementedError(
                f"weight_dtype={weight_dtype!r}: int8 weights are a later "
                "slice of the port (queue A7 in ROADMAP.md)")
        if kv_dtype != "float32":
            raise NotImplementedError(
                f"kv_dtype={kv_dtype!r}: int8 KV is a later slice of the "
                "port (queue A7 in ROADMAP.md)")
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

    @property
    def device(self) -> torch.device:
        return self._model.gpt.word_embeddings.weight.device

    def params(self):
        return extract_gpt_params(self._model)

    def new_kv(self, num_slots: int, max_seq: int):
        raise NotImplementedError

    def _decode_program(self) -> Program:
        raise NotImplementedError

    def _prefill_program(self) -> Program:
        raise NotImplementedError

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
    ``decode_step`` write it in place through the compiled programs that
    ``prefill_fn``/``decode_fn`` hand out. Prefix reuse
    (``tail_prefill``, ``insert_prefix``) is queue A6 and a slot-sharded
    mesh A10."""

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
                             dtype=dtype, device=self.device)

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

    def tail_prefill(self, *args, **kw):
        raise _later("prefix reuse (tail_prefill)", "A6")

    def insert_prefix(self, *args, **kw):
        raise _later("prefix reuse (insert_prefix)", "A6")
