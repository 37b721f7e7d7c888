"""GPT decode building blocks (counterpart of ``paddle_tpu/serving/llm/decode.py``:
``GPTDecodeSpec``, ``SamplingParams``, ``pack_sampling``,
``extract_gpt_params``, ``_layer_norm``, ``_block_prefill``, ``_sample``).

The math mirrors the model's dense eval path operation for operation
(LayerNorm with the biased variance, exact GELU, the additive -1e9 causal
mask, tied-embedding logits), so a decoder built on these emits the JAX
package's tokens. Per-slot sampling settings travel as device vectors
(``temperature``, ``top_k``, ``do_sample``, ``eos``; eos < 0 means "no
eos"), so requests with different settings share one decode step.
Sampling draws from an explicit ``torch.Generator``: the JAX package's
``jax.random`` streams cannot be reproduced, so sampled tokens differ
between the packages while greedy tokens are the same.

PyTorch runs eagerly, so the JAX package's ``ExecutableCache``, jit trace
counters and ``GPTStaticDecoder`` façade have no counterpart here;
:class:`GPTDecoderBase` keeps the part of that façade the engine uses.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from ...nn.functional import gelu, softmax


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
    ``generator`` — the recipe of ``jax.random.categorical``.
    """
    greedy = torch.argmax(lraw, dim=-1).to(torch.int32)
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


class GPTDecoderBase:
    """What the engine needs of a decoder over one GPT model: its spec,
    its device, its parameters and the sampling bound; subclasses add the
    KV substrate (``new_kv``) and the programs (``prefill``,
    ``decode_step``)."""

    def __init__(self, model, max_top_k: int = 64,
                 weight_dtype: str = "float32", kv_dtype: str = "float32"):
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

    @property
    def device(self) -> torch.device:
        return self._model.gpt.word_embeddings.weight.device

    def params(self):
        return extract_gpt_params(self._model)

    def new_kv(self, num_slots: int, max_seq: int):
        raise NotImplementedError

    def prefill(self, kv, params, tokens, true_lens, slot_ids, finished,
                samp, generator):
        raise NotImplementedError

    def decode_step(self, kv, params, finished, last_tokens, samp,
                    generator):
        raise NotImplementedError
