"""Normalisation (counterpart of ``paddle_tpu/nn/functional/norm.py``:
``batch_norm`` and ``layer_norm``). Under AMP both are normalisation ops:
bfloat16 inputs pass through (the statistics are float32 inside), float16
ones come back to float32 (``paddle_tpu_torch/amp``)."""
from __future__ import annotations

import torch

from ... import amp


def _stat_dtype(x):
    """Statistics accumulate in float32 for lower-precision inputs."""
    return torch.float32 if x.dtype in (torch.float16, torch.bfloat16) \
        else x.dtype


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, data_format: str = "NCHW",
               use_global_stats=None, name=None):
    """paddle's batch norm over every axis but the channel axis (1 for
    ``NC*`` layouts, else the last).

    With batch statistics (``training`` and not ``use_global_stats``)
    the output uses the batch mean and biased variance, and the running
    statistics are updated in place with paddle's convention,
    ``running = momentum * running + (1 - momentum) * batch``, biased
    variance included (reference: batch_norm_op.cc; torch's own
    convention weights the other way and uses the unbiased variance).
    Otherwise the running statistics normalise, through
    ``torch.nn.functional.batch_norm`` (cuDNN on the card)."""
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    if not training or use_global_stats:
        x, running_mean, running_var, weight, bias = amp.cast_inputs(
            "batch_norm", x, running_mean, running_var, weight, bias)
        if ch != 1:
            x = torch.movedim(x, ch, 1)
        out = torch.nn.functional.batch_norm(
            x, running_mean, running_var, weight, bias, training=False,
            eps=epsilon)
        return torch.movedim(out, 1, ch) if ch != 1 else out
    # the running statistics are updated in place: not cast
    x, weight, bias = amp.cast_inputs("batch_norm", x, weight, bias)
    axes = tuple(i for i in range(x.dim()) if i != ch)
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    xf = x.to(_stat_dtype(x))
    mean = xf.mean(dim=axes)
    var = xf.var(dim=axes, unbiased=False)
    out = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                    + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape).to(out.dtype)
    if bias is not None:
        out = out + bias.reshape(shape).to(out.dtype)
    if running_mean is not None:
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean
                               + (1.0 - momentum) * mean.detach())
            running_var.copy_(momentum * running_var
                              + (1.0 - momentum) * var.detach())
    return out.to(x.dtype)


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """Mean and biased variance over the trailing ``normalized_shape``
    axes, ``(x - mean) * rsqrt(var + eps) * w + b``, with the statistics
    in float32 for lower-precision inputs — the JAX package's formula
    (``nn/functional/norm.py``, ``serving/llm/decode.py::_layer_norm``)."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    x, weight, bias = amp.cast_inputs("layer_norm", x, weight, bias)
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
