"""Dense KV helpers the paged path uses (counterpart of the parts of
``paddle_tpu/serving/llm/kvcache.py`` it needs: ``valid_mask``, the layer
view and ``kv_nbytes``). The static-slot cache and int8 KV come later."""
from __future__ import annotations

import torch


class SlotsExhausted(RuntimeError):
    """alloc() called with every slot in use (callers gate on
    ``free_slots`` instead of catching this)."""


def kv_layer_view(buf: torch.Tensor, li: int) -> torch.Tensor:
    """Layer ``li``'s slice of a whole-cache buffer, ``[N, L, ...] ->
    [N, ...]``. A strided view: writing into it writes the buffer."""
    return buf[:, li]


def kv_nbytes(buf: torch.Tensor) -> int:
    """Device bytes of a KV buffer."""
    return buf.numel() * buf.element_size()


def valid_mask(lengths: torch.Tensor, max_seq: int,
               dtype=torch.float32) -> torch.Tensor:
    """Additive mask ``[S, 1, 1, max_seq]``: 0 where the row index is <=
    the slot's current position (the just-written token sees itself), and
    -1e9 beyond, whose softmax weight underflows to exactly 0 in f32."""
    idx = torch.arange(max_seq, device=lengths.device)[None, :]
    ok = idx <= lengths.long()[:, None]
    zero = torch.zeros((), dtype=dtype, device=lengths.device)
    neg = torch.full((), -1e9, dtype=dtype, device=lengths.device)
    return torch.where(ok, zero, neg)[:, None, None, :]
