"""Linear, LayerNorm, Embedding, Dropout, Conv2D, BatchNorm1D/2D,
Upsample, the pooling layers (``MaxPool1D/2D``, ``AvgPool1D/2D``,
``AdaptiveAvgPool1D/2D``) and ``Flatten`` as ``torch.nn.Module``s
(counterpart of the same classes in ``paddle_tpu/nn/layers_common.py``).

Parameter names and layouts are paddle's, so state dicts carry 1:1
between the packages: ``Linear.weight`` is ``[in, out]`` and the layer
computes ``x @ W + b`` (not ``torch.nn.Linear``'s ``[out, in]``);
``Conv2D.weight`` is OIHW; ``BatchNorm1D``/``2D`` keep their running
statistics in the buffers ``_mean`` and ``_variance``. Parameters are created on an
explicit device and drawn from an explicit ``torch.Generator`` by
:meth:`reset_parameters`, with paddle's default initialisers:
Xavier-uniform weights and zero biases for ``Linear``, ``Normal(0,
std)`` for ``Embedding``, ones and zeros for ``LayerNorm`` and
``BatchNorm2D``, ``Uniform(+-sqrt(1/fan_in))`` weights and biases for
``Conv2D``. A ``ParamAttr`` other than ``None`` or ``False`` (no
parameter) is not ported yet (ROADMAP.md queue A2, ``nn/initializer``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from ..ops.manipulation import flatten
from . import functional as F


class Linear(nn.Module):
    """``y = x @ W + b`` with ``W`` of shape ``[in_features, out_features]``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            (in_features, out_features), device=dev, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(
            (out_features,), device=dev, dtype=dtype)) if bias else None

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        fan_in, fan_out = self.weight.shape
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        self.weight.uniform_(-limit, limit, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.weight.shape[0]}, "
                f"out_features={self.weight.shape[1]}")


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon: float = 1e-5, *,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.ones(
            self._normalized_shape, device=dev, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(
            self._normalized_shape, device=dev, dtype=dtype))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, *, init_std: float = 1.0,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__()
        self._padding_idx = padding_idx
        self._init_std = float(init_std)
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            (num_embeddings, embedding_dim), device=dev, dtype=dtype))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.weight.normal_(0.0, self._init_std, generator=generator)
        if self._padding_idx is not None:
            self.weight[self._padding_idx].zero_()

    def forward(self, x):
        return F.embedding(x, self.weight, self._padding_idx)


class Dropout(nn.Module):
    """paddle's Dropout (``upscale_in_train`` by default). Its mask comes
    from the port's seeded generator of the input's device
    (``core/generator.py``; :func:`paddle_tpu_torch.seed` fixes it), not
    from torch's global default generator. The layer holds no generator
    of its own, so the deep copies ``TransformerEncoder`` makes share
    one stream."""

    def __init__(self, p: float = 0.5, mode: str = "upscale_in_train"):
        super().__init__()
        self.p = float(p)
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.mode)

    def extra_repr(self):
        return f"p={self.p}, mode={self.mode}"


def _check_attr(attr, what: str):
    if attr is not None and attr is not False:
        raise NotImplementedError(
            f"{what}: ParamAttr is not ported yet: a later slice of the "
            f"port (ROADMAP.md queue A2, nn/initializer)")


class Conv2D(nn.Module):
    """paddle's Conv2D (the 2-D case of ``_ConvNd``): NCHW input, OIHW
    weight ``[out, in/groups, kH, kW]``, ``bias_attr=False`` for no bias.
    As in the JAX package, ``padding_mode`` is accepted and the padding
    is zeros."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 padding_mode: str = "zeros", weight_attr=None,
                 bias_attr=None, data_format: str = "NCHW", *,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__()
        _check_attr(weight_attr, "Conv2D weight_attr")
        _check_attr(bias_attr, "Conv2D bias_attr")
        ks = list(kernel_size) if isinstance(kernel_size, (list, tuple)) \
            else [kernel_size] * 2
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._fan_in = in_channels * ks[0] * ks[1] // groups
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            [out_channels, in_channels // groups] + ks, device=dev,
            dtype=dtype))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.empty((out_channels,), device=dev, dtype=dtype))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        limit = math.sqrt(1.0 / self._fan_in)
        self.weight.uniform_(-limit, limit, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-limit, limit, generator=generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups, data_format=self._data_format)

    def extra_repr(self):
        o, i, kh, kw = self.weight.shape
        return (f"{i * self._groups}, {o}, kernel_size=[{kh}, {kw}], "
                f"stride={self._stride}, padding={self._padding}")


class BatchNorm2D(nn.Module):
    """paddle's BatchNorm2D: ``weight``/``bias`` (ones/zeros, ``False``
    for none) and the buffers ``_mean``/``_variance`` (zeros/ones),
    updated in training mode as
    ``momentum * running + (1 - momentum) * batch``."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", use_global_stats=None,
                 name=None, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__()
        _check_attr(weight_attr, "BatchNorm2D weight_attr")
        _check_attr(bias_attr, "BatchNorm2D bias_attr")
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        dev = resolve_device(device)
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones((num_features,), device=dev, dtype=dtype))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros((num_features,), device=dev, dtype=dtype))
        self.register_buffer("_mean", torch.zeros(
            (num_features,), device=dev, dtype=torch.float32))
        self.register_buffer("_variance", torch.ones(
            (num_features,), device=dev, dtype=torch.float32))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if self.weight is not None:
            self.weight.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)


class BatchNorm1D(BatchNorm2D):
    """paddle's BatchNorm1D over ``[N, C]`` or ``[N, C, L]`` (``"NCL"``;
    ``"NLC"`` puts the channels last): BatchNorm2D's parameters, buffers
    and statistics."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCL", use_global_stats=None,
                 name=None, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name,
                         device=device, dtype=dtype)

    def extra_repr(self):
        return (f"num_features={self._mean.shape[0]}, "
                f"momentum={self._momentum}, epsilon={self._epsilon}")


class Upsample(nn.Module):
    """Resize through :func:`~paddle_tpu_torch.nn.functional.interpolate`
    (``"nearest"`` only, so far)."""

    def __init__(self, size=None, scale_factor=None, mode: str = "nearest",
                 align_corners: bool = False, align_mode: int = 0,
                 data_format: str = "NCHW", name=None):
        super().__init__()
        self._kw = dict(size=size, scale_factor=scale_factor, mode=mode,
                        align_corners=align_corners, align_mode=align_mode,
                        data_format=data_format)

    def forward(self, x):
        return F.interpolate(x, **self._kw)


class _PoolNd(nn.Module):
    """A pooling functional with its arguments fixed at construction, as
    the JAX package's ``_PoolNd`` (``:335``) passes them."""

    def __init__(self, fn, *args):
        super().__init__()
        self._fn = fn
        self._args = args

    def forward(self, x):
        return self._fn(x, *self._args)


class MaxPool1D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__(F.max_pool1d, kernel_size, stride, padding,
                         return_mask, ceil_mode)


class MaxPool2D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__(F.max_pool2d, kernel_size, stride, padding,
                         return_mask, ceil_mode, data_format)


class AvgPool1D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(F.avg_pool1d, kernel_size, stride, padding,
                         exclusive, ceil_mode)


class AvgPool2D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(F.avg_pool2d, kernel_size, stride, padding,
                         ceil_mode, exclusive, divisor_override, data_format)


class AdaptiveAvgPool1D(_PoolNd):
    def __init__(self, output_size, name=None):
        super().__init__(F.adaptive_avg_pool1d, output_size)


class AdaptiveAvgPool2D(_PoolNd):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(F.adaptive_avg_pool2d, output_size, data_format)


class Flatten(nn.Module):
    """Merge axes ``start_axis..stop_axis`` (``:488``)."""

    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self._start, self._stop = start_axis, stop_axis

    def forward(self, x):
        return flatten(x, self._start, self._stop)


def reset_parameters(module: nn.Module,
                     generator: Optional[torch.Generator] = None):
    """Re-draw every parameter of ``module`` from ``generator``, layer by
    layer in registration order (so one seed fixes the whole model)."""
    for m in module.modules():
        if isinstance(m, (Linear, LayerNorm, Embedding, Conv2D,
                          BatchNorm2D)):
            m.reset_parameters(generator)
