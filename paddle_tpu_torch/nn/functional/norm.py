"""Normalisation (counterpart of ``paddle_tpu/nn/functional/norm.py``, all
of it: ``batch_norm``, ``layer_norm``, ``instance_norm``, ``group_norm``,
``local_response_norm`` and ``normalize``). Under AMP the first four are
normalisation ops: bfloat16 inputs pass through (the statistics are
float32 inside, :func:`_stat_dtype`, the reference's ``:21``), float16
ones come back to float32 (``paddle_tpu_torch/amp``)."""
from __future__ import annotations

import torch

from ...ops.dispatch import apply


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
    if not training or use_global_stats:
        return apply("batch_norm", _bn_global, x, running_mean, running_var,
                     weight, bias, epsilon=epsilon, data_format=data_format)
    # the running statistics are updated in place: not cast
    return apply("batch_norm", _bn_batch, x, weight, bias,
                 running_mean=running_mean, running_var=running_var,
                 momentum=momentum, epsilon=epsilon, data_format=data_format)


def _bn_global(x, running_mean, running_var, weight, bias, epsilon,
               data_format):
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    if ch != 1:
        x = torch.movedim(x, ch, 1)
    out = torch.nn.functional.batch_norm(
        x, running_mean, running_var, weight, bias, training=False,
        eps=epsilon)
    return torch.movedim(out, 1, ch) if ch != 1 else out


def _bn_batch(x, weight, bias, running_mean, running_var, momentum, epsilon,
              data_format):
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
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
               epsilon: float = 1e-5, name=None):
    """Mean and biased variance over the trailing ``normalized_shape``
    axes, ``(x - mean) * rsqrt(var + eps) * w + b``, with the statistics
    in float32 for lower-precision inputs — the JAX package's formula
    (``nn/functional/norm.py``, ``serving/llm/decode.py::_layer_norm``)."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return apply("layer_norm", _layer_norm, x, weight, bias,
                 n_norm=len(normalized_shape), epsilon=epsilon)


def _layer_norm(x, weight, bias, n_norm, epsilon):
    dims = tuple(range(x.dim() - n_norm, x.dim()))
    xf = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
    mean = xf.mean(dim=dims, keepdim=True)
    var = xf.var(dim=dims, unbiased=False, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.to(out.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.to(x.dtype)


def _norm_affine(out, weight, bias, ch_shape):
    if weight is not None:
        out = out * weight.reshape(ch_shape).to(out.dtype)
    if bias is not None:
        out = out + bias.reshape(ch_shape).to(out.dtype)
    return out


def _instance_norm(x, weight, bias, eps):
    dims = tuple(range(2, x.dim()))            # per sample, per channel
    xf = x.to(_stat_dtype(x))
    mean = xf.mean(dim=dims, keepdim=True)
    var = xf.var(dim=dims, unbiased=False, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = _norm_affine(out, weight, bias, [1, x.shape[1]] + [1] * (x.dim()
                                                                  - 2))
    return out.to(x.dtype)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Normalise each sample's channel over its spatial axes (reference:
    operators/instance_norm_op.cc; the running statistics are not read or
    updated, as in the JAX package)."""
    return apply("instance_norm", _instance_norm, x, weight, bias, eps=eps)


def _group_norm(x, weight, bias, num_groups, epsilon):
    n, c = x.shape[0], x.shape[1]
    g = x.to(_stat_dtype(x)).reshape((n, num_groups, c // num_groups)
                                     + tuple(x.shape[2:]))
    dims = tuple(range(2, g.dim()))
    mean = g.mean(dim=dims, keepdim=True)
    var = g.var(dim=dims, unbiased=False, keepdim=True)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    out = _norm_affine(out, weight, bias, [1, c] + [1] * (x.dim() - 2))
    return out.to(x.dtype)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Normalise each sample over groups of channels (reference:
    operators/group_norm_op.cc)."""
    return apply("group_norm", _group_norm, x, weight, bias,
                 num_groups=num_groups, epsilon=epsilon)


def _lrn(a, size, alpha, beta, k):
    half = size // 2
    pad = [0, 0] * (a.dim() - 2) + [half, size - half - 1]
    padded = torch.nn.functional.pad(a * a, pad)
    acc = torch.zeros_like(a)
    for i in range(size):
        acc = acc + padded[:, i:i + a.shape[1]]
    return a / torch.pow(k + alpha * acc, beta)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * sum of x² over size channels) ** beta``
    (reference: operators/lrn_op.cc, the JAX package's window: ``size //
    2`` channels before, the rest after)."""
    return apply("lrn", _lrn, x, size=size, alpha=alpha, beta=beta, k=k)


def _normalize(a, p, axis, epsilon):
    n = torch.pow(torch.sum(torch.pow(torch.abs(a), p), dim=axis,
                            keepdim=True), 1.0 / p)
    return a / torch.clamp_min(n, epsilon)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x`` over its ``p``-norm along ``axis`` (at least ``epsilon``)."""
    return apply("normalize", _normalize, x, p=p, axis=axis,
                 epsilon=epsilon)
