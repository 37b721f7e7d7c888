"""Transformer layers (counterpart of ``paddle_tpu/nn/transformer.py``:
``CAUSAL_MASK``, ``MultiHeadAttention`` with its ``Cache`` and
``StaticCache``, ``TransformerEncoderLayer``, ``TransformerEncoder``,
``TransformerDecoderLayer``, ``TransformerDecoder`` and ``Transformer``).

``MultiHeadAttention.attn_impl`` picks the attention core: ``"dense"``
(matmul, additive mask, softmax, matmul), ``"flash"`` (the flash kernel,
``ops/flash_attention.py``) for every eligible call, and ``"auto"``, which
in this port also takes the flash route for every eligible call. The JAX
package's ``FLASH_CROSSOVER = 4096`` and its ``head_dim % 8`` gate are TPU
measurements and are not carried over; the port's own crossover is to be
measured on the H100. A call is eligible when it needs no attention
weights, drops no attention probabilities, has no incremental cache, has
no mask or the ``CAUSAL_MASK`` sentinel, and its head dim is one the
kernel takes.

Incremental decoding: ``gen_cache`` seeds a ``Cache`` with no rows (each
call concatenates the new K/V on the sequence axis and returns the grown
``Cache``) or computes a ``StaticCache`` once from the encoder memory
(cross-attention reuses it as given). Two differences from the JAX
package, both Paddle's own behaviour: ``TransformerDecoderLayer`` returns
``(incremental, static)`` as its new cache (the JAX package returns the
incremental cache alone, so its cache cannot be fed back for a second
step), and ``TransformerDecoder.gen_cache(do_zip=True)`` zips the
per-layer pairs (the JAX package ignores ``do_zip``). ``weight_attr`` and
``bias_attr`` other than None raise (ROADMAP.md queue A2).
"""
from __future__ import annotations

import collections
import copy
import math
from typing import Optional

import torch
from torch import nn

from ..core.device import DeviceLike
from ..ops.flash_attention import SUPPORTED_HEAD_DIMS, flash_attention
from ..ops.math import matmul
from . import functional as F
from .layers_common import Dropout, LayerNorm, Linear, _check_attr


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


def _activation(name: str):
    if name == "gelu":
        return F.gelu
    if name == "relu":
        return torch.relu
    raise ValueError(f"activation {name!r} not in ('relu', 'gelu')")


def _check_attrs(weight_attr, bias_attr, what: str):
    _check_attr(weight_attr, f"{what} weight_attr")
    _check_attr(bias_attr, f"{what} bias_attr")


class MultiHeadAttention(nn.Module):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim: Optional[int] = None, vdim: Optional[int] = None,
                 need_weights: bool = False, weight_attr=None,
                 bias_attr=None, attn_impl: str = "auto", *,
                 device: DeviceLike = None):
        super().__init__()
        _check_attrs(weight_attr, bias_attr, "MultiHeadAttention")
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

    def _flash_eligible(self, attn_mask, cache) -> bool:
        if self.attn_impl == "dense":
            return False
        if (self.need_weights or cache is not None
                or (self.dropout and self.training)):
            return False
        if not (attn_mask is None or isinstance(attn_mask, _CausalMask)):
            return False           # arbitrary additive masks: dense only
        return self.head_dim in SUPPORTED_HEAD_DIMS

    def _split_heads(self, x):
        b, l = x.shape[0], x.shape[1]
        return x.reshape(b, l, self.num_heads, self.head_dim).permute(
            0, 2, 1, 3)                                     # [B, H, L, D]

    def compute_kv(self, key, value):
        """The ``StaticCache`` of ``key``/``value`` (``[B, H, L, D]``)."""
        return self.StaticCache(self._split_heads(self.k_proj(key)),
                                self._split_heads(self.v_proj(value)))

    def gen_cache(self, key, value=None, type=None):
        """``type=StaticCache``: K/V of ``key``/``value`` computed once.
        Otherwise an incremental ``Cache`` with no rows, ``[B, H, 0, D]``
        in ``key``'s type and device."""
        if type == MultiHeadAttention.StaticCache:
            return self.compute_kv(key, key if value is None else value)
        k = torch.zeros((key.shape[0], self.num_heads, 0, self.head_dim),
                        dtype=key.dtype, device=key.device)
        return self.Cache(k, k)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        """``out``; with ``need_weights`` also the attention weights, and
        with a ``Cache`` also the grown ``Cache``, in that order (a tuple
        when there is more than ``out``)."""
        key = query if key is None else key
        value = key if value is None else value
        if self._flash_eligible(attn_mask, cache):
            b, lq = query.shape[0], query.shape[1]
            shape = (b, -1, self.num_heads, self.head_dim)
            out, _ = flash_attention(
                self.q_proj(query).reshape(shape),
                self.k_proj(key).reshape(shape),
                self.v_proj(value).reshape(shape),
                causal=isinstance(attn_mask, _CausalMask))
            return self.out_proj(out.reshape(b, lq, self.embed_dim))
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=2)
                v = torch.cat([cache.v, v], dim=2)
                cache = self.Cache(k, v)
        if isinstance(attn_mask, _CausalMask):
            # with an incremental cache lq < lk: query row i sits at
            # absolute position lk - lq + i, so the triu shifts by the
            # cached prefix (offset 1 when lq == lk)
            lq, lk = q.shape[2], k.shape[2]
            # made in float32, then cast: -inf in float16, as the JAX
            # package's creation.full(-1e9, float16) gives
            attn_mask = torch.triu(
                torch.full((lq, lk), -1e9, device=q.device).to(q.dtype),
                lk - lq + 1)
        mask = _convert_attention_mask(attn_mask, q.dtype)
        scale = 1.0 / math.sqrt(self.head_dim)
        product = matmul(q * scale, k, transpose_y=True)
        if mask is not None:
            product = product + mask
        weights = F.softmax(product)
        if self.dropout:
            weights = F.dropout(weights, self.dropout, self.training)
        out = matmul(weights, v).permute(0, 2, 1, 3)        # [B, L, H, D]
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(weights)
        if isinstance(cache, self.Cache):
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, attn_impl: str = "auto", *,
                 device: DeviceLike = None):
        super().__init__()
        _check_attrs(weight_attr, bias_attr, "TransformerEncoderLayer")
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
        self.activation = _activation(activation)

    def forward(self, src, src_mask=None, cache=None):
        """``src``, or ``(src, new_cache)`` when given a ``cache``."""
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


def _clones(layer: nn.Module, n: int) -> nn.ModuleList:
    """``layer`` and ``n - 1`` deep copies of it (the copies start equal;
    re-draw them with
    :func:`~paddle_tpu_torch.nn.layers_common.reset_parameters`)."""
    return nn.ModuleList([layer] + [copy.deepcopy(layer)
                                    for _ in range(n - 1)])


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer`` plus an optional final
    norm."""

    def __init__(self, encoder_layer: TransformerEncoderLayer,
                 num_layers: int, norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = _clones(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        """``output``, or ``(output, new_caches)`` (one per layer) when
        given per-layer caches."""
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    """Self-attention (incremental ``Cache``), cross-attention over the
    encoder memory (``StaticCache``) and the feed-forward block, each
    with its own norm (``norm1``..``norm3``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, *, device: DeviceLike = None):
        super().__init__()
        _check_attrs(weight_attr, bias_attr, "TransformerDecoderLayer")
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            device=device)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             device=device)
        self.linear1 = Linear(d_model, dim_feedforward, device=device)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, device=device)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = _activation(activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        """``tgt``, or ``(tgt, (incremental, static))`` when given a
        ``cache`` from :meth:`gen_cache`."""
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                              cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask,
                              None if cache is None else cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental, cache[1]))

    def gen_cache(self, memory):
        """``(incremental Cache with no rows, StaticCache of memory)``."""
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(nn.Module):
    """``num_layers`` copies of ``decoder_layer`` plus an optional final
    norm."""

    def __init__(self, decoder_layer: TransformerDecoderLayer,
                 num_layers: int, norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = _clones(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip: bool = False):
        """One ``(incremental, static)`` pair per layer; ``do_zip=True``
        gives ``[incrementals, statics]`` instead."""
        cache = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*cache)) if do_zip else cache


class Transformer(nn.Module):
    """Encoder-decoder transformer; with ``normalize_before`` both stacks
    end in a LayerNorm."""

    def __init__(self, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, custom_encoder=None, custom_decoder=None,
                 *, device: DeviceLike = None):
        super().__init__()
        _check_attrs(weight_attr, bias_attr, "Transformer")
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, device=device)
            enc_norm = (LayerNorm(d_model, device=device)
                        if normalize_before else None)
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, device=device)
            dec_norm = (LayerNorm(d_model, device=device)
                        if normalize_before else None)
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length: int):
        """``[length, length]`` float32: 0 on and below the diagonal,
        -inf above, on the model's device."""
        dev = next(self.parameters()).device
        return torch.triu(torch.full((length, length), float("-inf"),
                                     dtype=torch.float32, device=dev), 1)
