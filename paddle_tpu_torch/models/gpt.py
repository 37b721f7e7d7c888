"""GPT: the decoder-only causal language model (counterpart of
``paddle_tpu/models/gpt.py``: ``GPTConfig``, ``GPTModel``,
``GPTForCausalLM`` with its incremental cache and ``generate``, and
``GPTPretrainingCriterion``).

Pre-norm transformer blocks, a final LayerNorm and an LM head tied to the
word embedding (``logits = h @ tok.T``). Parameter names match the JAX
package's state dict 1:1, so weights carry over with
``load_state_dict(framework_io.state_dict_from_reference(...))``.
Construction puts the parameters on ``device`` and draws them from a
``torch.Generator`` on that device seeded with ``seed``. ``generate``
returns an int32 torch tensor on the model's device (the port has no
Tensor class yet, ROADMAP.md queue A1). :func:`tp_partition_specs` is the
JAX package's tensor-parallel plan (``_TP_RULES``): laid out with
``distributed.shard_tensor``, the model trains on a mesh (its attention
runs the flash kernels on each rank's local heads). The pipeline plan is
ROADMAP A10's second slice.
"""
from __future__ import annotations

import re
import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..core.generator import default_generator
from ..distributed.mesh import is_dtensor, like, replicated
from ..nn.functional.loss import cross_entropy
from ..nn.layer_base import Layer
from ..nn.layers_common import Dropout, Embedding, LayerNorm, reset_parameters
from ..nn.transformer import (CAUSAL_MASK, TransformerEncoder,
                              TransformerEncoderLayer)
from ..ops.math import matmul


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    #: "auto" and "flash": the flash kernel for every eligible call;
    #: "dense": never (nn/transformer.py MultiHeadAttention)
    attn_impl: str = "auto"

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    def draft(self, scale: int = 4, *, hidden_size: Optional[int] = None,
              num_layers: Optional[int] = None,
              num_heads: Optional[int] = None) -> "GPTConfig":
        """A small draft-model config for speculative decoding against
        this target (the JAX package's ``GPTConfig.draft``): the same
        vocab and positions (the verify step compares token ids and shares
        the position range), everything else shrunk by ``scale`` unless
        given; heads drop until they divide the draft's hidden size."""
        h = hidden_size if hidden_size is not None \
            else max(1, self.hidden_size // scale)
        nl = num_layers if num_layers is not None \
            else max(1, self.num_layers // scale)
        nh = num_heads if num_heads is not None \
            else max(1, self.num_heads // scale)
        while h % nh:
            nh -= 1
        return GPTConfig(
            vocab_size=self.vocab_size, hidden_size=h, num_layers=nl,
            num_heads=nh,
            max_position_embeddings=self.max_position_embeddings,
            hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
            attn_impl=self.attn_impl)


class GPTModel(Layer):
    """Token + position embedding -> pre-norm decoder stack -> final norm."""

    def __init__(self, config: GPTConfig, *, device: DeviceLike = None):
        super().__init__()
        self.config = c = config
        dev = resolve_device(device)
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size,
                                         init_std=0.02, device=dev)
        self.position_embeddings = Embedding(
            c.max_position_embeddings, c.hidden_size, init_std=0.02,
            device=dev)
        self.embedding_dropout = Dropout(c.hidden_dropout_prob)
        layer = TransformerEncoderLayer(
            c.hidden_size, c.num_heads, c.ffn_size,
            dropout=c.hidden_dropout_prob, activation="gelu",
            attn_dropout=c.attention_dropout_prob, normalize_before=True,
            attn_impl=c.attn_impl, device=dev)
        self.decoder = TransformerEncoder(
            layer, c.num_layers, norm=LayerNorm(c.hidden_size, device=dev))

    def gen_cache(self, input_ids):
        """Per-layer incremental caches with no rows. Only the batch size
        and the type matter, so one token's embedding seeds them."""
        return self.decoder.gen_cache(self.word_embeddings(input_ids[:, :1]))

    def forward(self, input_ids, position_ids=None, cache=None):
        """The final hidden states ``[B, L, E]``; with a ``cache`` also
        the grown caches, and the new tokens' positions then start after
        the cached prefix.

        A position past the table embeds as NaN, as the JAX package's
        gather (``jnp.take``, fill mode) does: ``generate`` past
        ``max_position_embeddings`` then gives the JAX package's tokens,
        where an index past the table would be a device-side assert on
        CUDA."""
        w = self.word_embeddings.weight
        if is_dtensor(w) and not is_dtensor(input_ids):
            # a model laid out on a mesh: plain ids are the global batch,
            # the same on every rank
            input_ids = replicated(input_ids, w.device_mesh)
        if position_ids is None:
            seq_len = input_ids.shape[1]
            offset = int(cache[0].k.shape[2]) if cache is not None else 0
            position_ids = torch.arange(
                offset, offset + seq_len, device=input_ids.device).expand(
                    input_ids.shape[0], seq_len)
            if is_dtensor(input_ids):
                position_ids = like(position_ids.contiguous(), input_ids)
        n_pos = self.config.max_position_embeddings
        pos = self.position_embeddings(position_ids.clamp(max=n_pos - 1))
        pos = torch.where((position_ids >= n_pos)[..., None],
                          torch.full((), float("nan"), dtype=pos.dtype,
                                     device=pos.device), pos)
        h = self.word_embeddings(input_ids) + pos
        h = self.embedding_dropout(h)
        if cache is None:
            return self.decoder(h, src_mask=CAUSAL_MASK)
        return self.decoder(h, src_mask=CAUSAL_MASK, cache=cache)


class GPTForCausalLM(Layer):
    """GPT with the LM head tied to the word embedding."""

    def __init__(self, config: GPTConfig, *, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.gpt = GPTModel(config, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        reset_parameters(self, gen)

    @property
    def device(self) -> torch.device:
        return self.gpt.word_embeddings.weight.device

    def set_attn_impl(self, attn_impl: str):
        """Switch every attention layer to ``attn_impl`` (``"auto"``,
        ``"dense"`` or ``"flash"``)."""
        if attn_impl not in ("auto", "dense", "flash"):
            raise ValueError(f"attn_impl {attn_impl!r}")
        for layer in self.gpt.decoder.layers:
            layer.self_attn.attn_impl = attn_impl
        self.gpt.config.attn_impl = attn_impl

    def forward(self, input_ids, position_ids=None, cache=None):
        """Logits ``[B, L, V]``, or ``(logits, new_cache)`` when given a
        ``cache`` (:meth:`GPTModel.gen_cache`)."""
        out = self.gpt(input_ids, position_ids, cache=cache)
        h, new_cache = out if cache is not None else (out, None)
        logits = matmul(h, self.gpt.word_embeddings.weight, transpose_y=True)
        return logits if cache is None else (logits, new_cache)

    def generate(self, input_ids, max_length: int = 32,
                 decode_strategy: str = "greedy", top_k: int = 1,
                 temperature: float = 1.0, eos_token_id=None,
                 use_cache=True):
        """See :func:`_gpt_generate`."""
        return _gpt_generate(self, input_ids, max_length, decode_strategy,
                             top_k, temperature, eos_token_id, use_cache)


class GPTPretrainingCriterion(Layer):
    """Shifted next-token cross entropy: the logits at position ``t``
    predict ``labels[:, t + 1]``, mean over the ``B * (S - 1)`` targets."""

    def forward(self, logits, labels):
        v = logits.shape[-1]
        return cross_entropy(logits[:, :-1, :].reshape(-1, v),
                             labels[:, 1:].reshape(-1))


# -- tensor-parallel plan -----------------------------------------------------

_TP_RULES = (
    # Megatron split: qkv + ffn-in are column-parallel (shard output dim),
    # attn-out + ffn-out are row-parallel (shard input dim), the word
    # embedding (and so the tied LM head) is sharded on the vocab dim
    (r"\.(q_proj|k_proj|v_proj|linear1)\.weight$", (None, "mp")),
    (r"\.(q_proj|k_proj|v_proj|linear1)\.bias$", ("mp",)),
    (r"\.(out_proj|linear2)\.weight$", ("mp", None)),
    (r"word_embeddings\.weight$", ("mp", None)),
)


def tp_partition_specs(model) -> Dict[str, tuple]:
    """Per-parameter ``PartitionSpec`` axes (tuples; ``()`` replicated)
    for tensor parallelism over the ``mp`` mesh axis, by parameter name
    (the JAX package's rules, which name the same parameters)."""
    specs = {}
    for name, _ in model.named_parameters():
        spec = ()
        for pat, sp in _TP_RULES:
            if re.search(pat, name):
                spec = sp
                break
        specs[name] = spec
    return specs


#: tokens between the host-side "has every row hit eos?" probes: each
#: probe is a device-to-host sync, and frozen rows keep emitting eos, so
#: a late stop costs only trimmed-off work, never a wrong token
_EOS_CHECK_EVERY = 8


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _trim_generated(gen: np.ndarray, eos_token_id) -> int:
    """Columns of the generated block to keep: the step at which every
    row had emitted eos, plus one. Rows that never emit eos keep the
    whole budget."""
    if eos_token_id is None or gen.shape[1] == 0:
        return gen.shape[1]
    hits = gen == eos_token_id
    if not hits.any(axis=1).all():
        return gen.shape[1]
    return int(hits.argmax(axis=1).max()) + 1


def _sampling(model, b: int, decode_strategy, top_k, temperature,
              eos_token_id, max_length):
    """``(max_top_k, per-row sampling vectors, generator)``: ``top_k ==
    1`` counts as greedy, and greedy draws nothing, so its generator is
    None."""
    from ..serving.llm.decode import SamplingParams, pack_sampling
    do_sample = decode_strategy == "sampling" and top_k != 1
    samp = SamplingParams(
        do_sample=do_sample, temperature=float(temperature),
        top_k=int(top_k) if do_sample else 0, eos_token_id=eos_token_id,
        max_new_tokens=int(max_length))
    max_top_k = int(top_k) if do_sample and top_k else 0
    gen = default_generator(model.device) if do_sample else None
    return max_top_k, pack_sampling([samp] * b, model.device), gen


class _StaticState:
    """What ``generate``'s static-slot lane keeps between calls of one
    model and shape: the KV cache its compiled programs are bound to and
    the per-step static buffers, so a second call replays them, and the
    lock that makes concurrent calls on them take turns."""

    def __init__(self, dec, b: int, max_seq: int, svecs):
        dev = dec.device
        self.lock = threading.Lock()
        self.kv = dec.new_kv(b, max_seq)
        self.finished = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.last = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.svecs = type(svecs)(*(v.clone() for v in svecs))
        self.slots = torch.arange(b, dtype=torch.int32, device=dev)


#: generate's static-slot states per model, the newest few shapes each
_STATIC_STATES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_STATIC_STATES_LOCK = threading.Lock()
_STATIC_STATES_PER_MODEL = 4


def _static_state(model, dec, b, max_seq, svecs, gen) -> _StaticState:
    """The model's static-slot state for ``b`` rows of ``max_seq``, the
    sampling bound and generator, and the weights where they lie (moved
    weights make a new state; the old one ages out), made on first use;
    the newest :data:`_STATIC_STATES_PER_MODEL` are kept."""
    key = (b, max_seq, dec.max_top_k, gen is None,
           tuple(p.data_ptr() for p in model.parameters()))
    with _STATIC_STATES_LOCK:
        states = _STATIC_STATES.setdefault(model, OrderedDict())
        st = states.get(key)
        if st is None:
            st = states[key] = _StaticState(dec, b, max_seq, svecs)
            while len(states) > _STATIC_STATES_PER_MODEL:
                states.popitem(last=False)
        states.move_to_end(key)
        return st


def _decode_static(dec, st, ids, lin, lp, max_length, svecs, gen,
                   eos_token_id):
    """The prefill and decode loop of :func:`_gpt_generate_static` on the
    state's cache and buffers; returns ``(tokens [B, max_length], steps
    taken)``."""
    b, dev = int(ids.shape[0]), ids.device
    kv = st.kv
    params = dec.params()
    for dst, src in zip(st.svecs, svecs):
        dst.copy_(src)
    padded = torch.zeros((b, lp), dtype=torch.int32, device=dev)
    padded[:, :lin] = ids
    st.finished.zero_()
    nxt, finished = dec.prefill(
        kv, params, padded,
        torch.full((b,), lin, dtype=torch.int32, device=dev), st.slots,
        st.finished, st.svecs, gen)
    out = torch.zeros((b, int(max_length)), dtype=torch.int32, device=dev)
    out[:, 0] = nxt
    st.finished.copy_(finished)
    st.last.copy_(nxt)
    steps = 1
    for t in range(1, int(max_length)):
        nxt, finished = dec.decode_step(kv, params, st.finished, st.last,
                                        st.svecs, gen)
        out[:, t] = nxt
        st.finished.copy_(finished)
        st.last.copy_(nxt)
        steps = t + 1
        if (eos_token_id is not None and t % _EOS_CHECK_EVERY == 0
                and bool(st.finished.all())):
            break
    return out, steps


def _gpt_generate_static(model, ids, max_length, decode_strategy, top_k,
                         temperature, eos_token_id):
    """Static-slot decode through the decoder's compiled programs
    (``prefill_fn``/``decode_fn``): prefill the prompts into a
    :class:`~paddle_tpu_torch.serving.llm.StaticKVCache` of pow2-rounded
    ``max_seq``, then one decode step a token, with no host sync but the
    eos probe every :data:`_EOS_CHECK_EVERY` tokens. The cache and the
    step's buffers are the model's for that shape (:func:`_static_state`),
    so a second call at the same rows and ``max_seq`` replays the graphs
    the first captured. Token for token the concat lane's (same math,
    same :func:`_sample`, the same draws)."""
    from ..serving.llm.decode import GPTStaticDecoder
    b, lin = int(ids.shape[0]), int(ids.shape[1])
    max_seq = min(_next_pow2(lin + int(max_length)),
                  model.gpt.config.max_position_embeddings)
    lp = min(_next_pow2(lin), max_seq)
    max_top_k, svecs, gen = _sampling(model, b, decode_strategy, top_k,
                                      temperature, eos_token_id, max_length)
    dec = GPTStaticDecoder(model, max_top_k=max_top_k)
    st = _static_state(model, dec, b, max_seq, svecs, gen)
    with st.lock:
        out, steps = _decode_static(dec, st, ids, lin, lp, max_length, svecs,
                                    gen, eos_token_id)
    gen_h = out[:, :steps].cpu().numpy()
    keep = _trim_generated(gen_h, eos_token_id)
    return torch.cat([ids, out[:, :keep]], dim=1)


@torch.no_grad()
def _gpt_generate(model, input_ids, max_length=32, decode_strategy="greedy",
                  top_k=1, temperature=1.0, eos_token_id=None,
                  use_cache=True):
    """Autoregressive decoding: greedy, or temperature + top-k sampling
    from the port's generator of the model's device
    (``paddle_tpu_torch.seed`` fixes it). ``input_ids``: ``[B, L]`` numpy
    or torch ints.

    ``use_cache=True`` decodes through the static-slot KV cache when the
    model runs without dropout and ``L + max_length`` fits the position
    table, and through the concat cache otherwise; ``"concat"`` grows the
    ``MultiHeadAttention.Cache`` a token at a time; ``False`` recomputes
    the whole sequence at every step (through the flash kernel where the
    model's attention takes it). All three give the same tokens. A row
    that emits ``eos_token_id`` is frozen to it, and the output stops at
    the step where every row has. Returns int32 ``[B, L + n]`` on the
    model's device, ``n <= max_length``."""
    if decode_strategy not in ("greedy", "sampling"):
        raise ValueError(
            f"decode_strategy {decode_strategy!r} not in "
            f"('greedy', 'sampling'); beam search = "
            f"nn.BeamSearchDecoder + dynamic_decode")
    dev = model.device
    ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(
        input_ids, torch.Tensor) else input_ids).to(dev, torch.int32)
    c = model.gpt.config
    if use_cache is True:
        dropout_off = (not model.training) or (
            c.hidden_dropout_prob == 0.0 and c.attention_dropout_prob == 0.0)
        if dropout_off and ids.shape[1] + int(max_length) <= \
                c.max_position_embeddings and int(max_length) >= 1:
            return _gpt_generate_static(model, ids, max_length,
                                        decode_strategy, top_k, temperature,
                                        eos_token_id)
        use_cache = "concat"
    from ..serving.llm.decode import _sample
    b = ids.shape[0]
    max_top_k, svecs, gen = _sampling(model, b, decode_strategy, top_k,
                                      temperature, eos_token_id, max_length)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    cache = model.gpt.gen_cache(ids) if use_cache else None
    step_input = ids
    n_steps = int(max_length)
    step = -1
    for step in range(n_steps):
        if use_cache:
            logits, cache = model(step_input, cache=cache)
        else:
            logits = model(ids)
        lraw = logits[:, -1, :].float()
        nxt = _sample(lraw, svecs.temperature, svecs.top_k, svecs.do_sample,
                      gen, max_top_k)
        if eos_token_id is not None:
            nxt = torch.where(finished, torch.full_like(nxt, eos_token_id),
                              nxt)
            finished = finished | (nxt == eos_token_id)
        ids = torch.cat([ids, nxt[:, None]], dim=1)
        step_input = nxt[:, None]
        if (eos_token_id is not None
                and step % _EOS_CHECK_EVERY == _EOS_CHECK_EVERY - 1
                and bool(finished.all())):
            break
    if eos_token_id is not None and n_steps > 0:
        lin = ids.shape[1] - (step + 1)
        keep = _trim_generated(ids[:, lin:].cpu().numpy(), eos_token_id)
        return ids[:, :lin + keep]
    return ids
