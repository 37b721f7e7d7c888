"""Transformer encoder layers (counterpart of ``paddle_tpu/nn/transformer.py``:
``CAUSAL_MASK``, ``MultiHeadAttention``, ``TransformerEncoderLayer`` and
``TransformerEncoder``).

``MultiHeadAttention.attn_impl`` picks the attention core: ``"dense"``
(matmul, additive mask, softmax, matmul), ``"flash"`` (the flash kernel,
``ops/flash_attention.py``) for every eligible call, and ``"auto"``, which
in this port also takes the flash route for every eligible call. The JAX
package's ``FLASH_CROSSOVER = 4096`` and its ``head_dim % 8`` gate are TPU
measurements and are not carried over; the port's own crossover is to be
measured on the H100. A call is eligible when it needs no attention
weights, drops no attention probabilities, has no mask or the
``CAUSAL_MASK`` sentinel, and its head dim is one the kernel takes.
"""
from __future__ import annotations

import copy
import math
from typing import Optional

import torch
from torch import nn

from ..core.device import DeviceLike
from ..ops.flash_attention import SUPPORTED_HEAD_DIMS, flash_attention
from . import functional as F
from .layers_common import Dropout, LayerNorm, Linear


class _CausalMask:
    """Sentinel ``attn_mask`` meaning "standard causal mask": the flash
    path applies causality inside the kernel and the dense path builds
    the additive triu lazily."""

    def __repr__(self):
        return "<causal attention mask>"


CAUSAL_MASK = _CausalMask()


def _convert_attention_mask(attn_mask, dtype):
    """bool mask -> additive ``(m - 1) * 1e9``; float masks pass through."""
    if attn_mask is None:
        return None
    if attn_mask.dtype == torch.bool:
        return (attn_mask.to(dtype) - 1.0) * 1e9
    return attn_mask.to(dtype)


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim: Optional[int] = None, vdim: Optional[int] = None,
                 need_weights: bool = False, attn_impl: str = "auto", *,
                 device: DeviceLike = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        if attn_impl not in ("auto", "dense", "flash"):
            raise ValueError(f"attn_impl {attn_impl!r} not in "
                             "('auto', 'dense', 'flash')")
        self.attn_impl = attn_impl
        self.q_proj = Linear(embed_dim, embed_dim, device=device)
        self.k_proj = Linear(self.kdim, embed_dim, device=device)
        self.v_proj = Linear(self.vdim, embed_dim, device=device)
        self.out_proj = Linear(embed_dim, embed_dim, device=device)

    def _flash_eligible(self, attn_mask) -> bool:
        if self.attn_impl == "dense":
            return False
        if self.need_weights or (self.dropout and self.training):
            return False
        if not (attn_mask is None or isinstance(attn_mask, _CausalMask)):
            return False           # arbitrary additive masks: dense only
        return self.head_dim in SUPPORTED_HEAD_DIMS

    def _split_heads(self, x):
        b, l = x.shape[0], x.shape[1]
        return x.reshape(b, l, self.num_heads, self.head_dim).permute(
            0, 2, 1, 3)                                     # [B, H, L, D]

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = key if value is None else value
        if self._flash_eligible(attn_mask):
            b, lq = query.shape[0], query.shape[1]
            shape = (b, -1, self.num_heads, self.head_dim)
            out, _ = flash_attention(
                self.q_proj(query).reshape(shape),
                self.k_proj(key).reshape(shape),
                self.v_proj(value).reshape(shape),
                causal=isinstance(attn_mask, _CausalMask))
            return self.out_proj(out.reshape(b, lq, self.embed_dim))
        q = self._split_heads(self.q_proj(query))
        k = self._split_heads(self.k_proj(key))
        v = self._split_heads(self.v_proj(value))
        if isinstance(attn_mask, _CausalMask):
            lq, lk = q.shape[2], k.shape[2]
            attn_mask = torch.triu(
                torch.full((lq, lk), -1e9, dtype=q.dtype, device=q.device),
                lk - lq + 1)
        mask = _convert_attention_mask(attn_mask, q.dtype)
        scale = 1.0 / math.sqrt(self.head_dim)
        product = torch.matmul(q * scale, k.transpose(-1, -2))
        if mask is not None:
            product = product + mask
        weights = F.softmax(product)
        if self.dropout:
            weights = F.dropout(weights, self.dropout, self.training)
        out = torch.matmul(weights, v).permute(0, 2, 1, 3)  # [B, L, H, D]
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        return (out, weights) if self.need_weights else out


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, attn_impl: str = "auto", *,
                 device: DeviceLike = None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, attn_impl=attn_impl,
            device=device)
        self.linear1 = Linear(d_model, dim_feedforward, device=device)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, device=device)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        if activation == "gelu":
            self.activation = F.gelu
        elif activation == "relu":
            self.activation = torch.relu
        else:
            raise ValueError(f"activation {activation!r} not in "
                             "('relu', 'gelu')")

    def forward(self, src, src_mask=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = residual + self.dropout1(self.self_attn(src, src, src,
                                                      src_mask))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(nn.Module):
    """``num_layers`` deep copies of ``encoder_layer`` plus an optional
    final norm (the copies start equal; re-draw them with
    :func:`~paddle_tpu_torch.nn.layers_common.reset_parameters`)."""

    def __init__(self, encoder_layer: TransformerEncoderLayer,
                 num_layers: int, norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        output = src
        for mod in self.layers:
            output = mod(output, src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output
