"""BERT encoder family (counterpart of ``paddle_tpu/models/bert.py``:
``BertConfig``, ``BertEmbeddings``, ``BertPooler``, ``BertModel``,
``BertForSequenceClassification`` and the ``Ernie*`` aliases; BASELINE
config 3).

Post-norm ``TransformerEncoder`` blocks (GELU, ``nn/transformer.py``)
over learned token, position and token-type embeddings with a LayerNorm
and dropout, and a tanh pooler over the first token. A ``[B, L]`` 1/0
``attention_mask`` becomes the additive ``[B, 1, 1, L]`` mask ``(1 - m)
* -1e4`` (``:82-85``), which sends attention down the dense lane, as
does attention dropout in training; with no mask, in eval or with no
attention dropout, the attention takes the flash kernels B1-B3 on the
card (``MultiHeadAttention``'s ``"auto"``), at BERT-base's head dim
64. Parameter names match the JAX package 1:1
(``embeddings.word_embeddings.weight``,
``encoder.layers.{i}.self_attn.q_proj.weight``, ``pooler.dense.bias``).
Parameters are drawn on ``device`` from a generator seeded with ``seed``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from ..nn import (Dropout, Embedding, LayerNorm, Linear, Tanh,
                  TransformerEncoder, TransformerEncoderLayer)
from ..nn.layers_common import reset_parameters

__all__ = ["BertConfig", "BertEmbeddings", "BertPooler", "BertModel",
           "BertForSequenceClassification", "ErnieConfig", "ErnieModel",
           "ErnieForSequenceClassification"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig, *, device: DeviceLike = None):
        super().__init__()
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size,
                                         device=device)
        self.position_embeddings = Embedding(c.max_position_embeddings,
                                             c.hidden_size, device=device)
        self.token_type_embeddings = Embedding(c.type_vocab_size,
                                               c.hidden_size, device=device)
        self.layer_norm = LayerNorm(c.hidden_size, device=device)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, seq_len = input_ids.shape[0], input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(
                seq_len, dtype=torch.int32,
                device=input_ids.device).unsqueeze(0).expand(b, seq_len)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        h = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(h))


class BertPooler(nn.Module):
    def __init__(self, c: BertConfig, *, device: DeviceLike = None):
        super().__init__()
        self.dense = Linear(c.hidden_size, c.hidden_size, device=device)
        self.activation = Tanh()

    def forward(self, h):
        return self.activation(self.dense(h[:, 0]))


class BertModel(nn.Module):
    """``forward`` returns ``(sequence_output [B, L, hidden],
    pooled_output [B, hidden])``."""

    def __init__(self, config: BertConfig, *, device: DeviceLike = None,
                 seed: Optional[int] = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = c = config
        self.embeddings = BertEmbeddings(c, device=dev)
        layer = TransformerEncoderLayer(
            c.hidden_size, c.num_heads, c.intermediate_size,
            dropout=c.hidden_dropout_prob, activation="gelu",
            attn_dropout=c.attention_dropout_prob, normalize_before=False,
            device=dev)
        self.encoder = TransformerEncoder(layer, c.num_layers)
        self.pooler = BertPooler(c, device=dev)
        if seed is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            reset_parameters(self, gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        h = self.embeddings(input_ids, token_type_ids, position_ids)
        if attention_mask is not None:
            # [B, L] 1/0 -> additive [B, 1, 1, L]
            m = attention_mask[:, None, None, :]
            attention_mask = (1.0 - m.to(h.dtype)) * -1e4
        seq = self.encoder(h, src_mask=attention_mask)
        return seq, self.pooler(seq)


class BertForSequenceClassification(nn.Module):
    """The pooled output through dropout and a linear classifier."""

    def __init__(self, config: BertConfig, num_classes: int = 2, *,
                 device: DeviceLike = None, seed: Optional[int] = 0):
        super().__init__()
        dev = resolve_device(device)
        self.bert = BertModel(config, device=dev, seed=None)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, num_classes, device=dev)
        if seed is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            reset_parameters(self, gen)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        return self.classifier(self.dropout(pooled))


class ErnieConfig(BertConfig):
    """ERNIE-base (BASELINE config 3): the BERT encoder with the ERNIE 1.0
    vocabulary of 18000 (``:105``)."""

    def __init__(self, vocab_size=18000, **kw):
        super().__init__(vocab_size=vocab_size, **kw)


class ErnieModel(BertModel):
    def __init__(self, config: Optional[ErnieConfig] = None, *,
                 device: DeviceLike = None, seed: Optional[int] = 0):
        super().__init__(config or ErnieConfig(), device=device, seed=seed)


class ErnieForSequenceClassification(BertForSequenceClassification):
    def __init__(self, config: Optional[ErnieConfig] = None,
                 num_classes: int = 2, *, device: DeviceLike = None,
                 seed: Optional[int] = 0):
        super().__init__(config or ErnieConfig(), num_classes, device=device,
                         seed=seed)
