"""Normalisation (counterpart of ``paddle_tpu/nn/functional/norm.py``,
``layer_norm``)."""
from __future__ import annotations

import torch


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """Mean and biased variance over the trailing ``normalized_shape``
    axes, ``(x - mean) * rsqrt(var + eps) * w + b``, with the statistics
    in float32 for lower-precision inputs — the JAX package's formula
    (``nn/functional/norm.py``, ``serving/llm/decode.py::_layer_norm``)."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    xf = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
    mean = xf.mean(dim=dims, keepdim=True)
    var = xf.var(dim=dims, unbiased=False, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.to(out.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.to(x.dtype)
