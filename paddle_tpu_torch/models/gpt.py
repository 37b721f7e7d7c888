"""GPT: the decoder-only causal language model (counterpart of
``paddle_tpu/models/gpt.py``: ``GPTConfig``, ``GPTModel`` and
``GPTForCausalLM``).

Pre-norm transformer blocks, a final LayerNorm and an LM head tied to the
word embedding (``logits = h @ tok.T``). Parameter names match the JAX
package's state dict 1:1, so weights carry over with
``load_state_dict(framework_io.state_dict_from_reference(...))``.
Construction puts the parameters on ``device`` and draws them from a
``torch.Generator`` on that device seeded with ``seed``; the concat-grown
incremental cache, ``generate`` and the parallel plans are not ported
yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from ..nn.layers_common import Dropout, Embedding, LayerNorm, reset_parameters
from ..nn.transformer import (CAUSAL_MASK, TransformerEncoder,
                              TransformerEncoderLayer)


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


class GPTModel(nn.Module):
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

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            seq_len = input_ids.shape[1]
            position_ids = torch.arange(
                seq_len, device=input_ids.device).expand(
                    input_ids.shape[0], seq_len)
        h = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids))
        h = self.embedding_dropout(h)
        return self.decoder(h, src_mask=CAUSAL_MASK)


class GPTForCausalLM(nn.Module):
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

    def forward(self, input_ids, position_ids=None):
        h = self.gpt(input_ids, position_ids)
        return torch.matmul(h, self.gpt.word_embeddings.weight.t())
