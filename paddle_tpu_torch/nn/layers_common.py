"""The common layers (``Layer``, the port's ``torch.nn.Module``;
counterpart of ``paddle_tpu/nn/layers_common.py``): ``Linear``, the
convolutions (``Conv1D``/``2D``/``3D`` and their transposes), the norms
(``BatchNorm``/``1D``/``2D``/``3D``, ``SyncBatchNorm``, ``LayerNorm``,
``GroupNorm``, ``InstanceNorm1D``-``3D``, ``LocalResponseNorm``,
``SpectralNorm``), the pools (max, average, adaptive average and
adaptive max, 1-D to 3-D), ``Embedding``, the dropouts (``Dropout``,
``Dropout2D``/``3D``, ``AlphaDropout``), ``Flatten``, ``Upsample``,
``UpsamplingBilinear2D``/``Nearest2D``, ``PixelShuffle``, the pads
(``Pad1D``-``3D``, ``ZeroPad2D``), ``CosineSimilarity``, ``Bilinear``
and ``Unfold``.

Parameter names and layouts are paddle's, so state dicts carry 1:1
between the packages: ``Linear.weight`` is ``[in, out]`` and the layer
computes ``x @ W + b`` (not ``torch.nn.Linear``'s ``[out, in]``); a
convolution's weight is ``[out, in/groups, *k]``, a transposed one's
``[in, out/groups, *k]``; the batch norms keep their running statistics
in the buffers ``_mean`` and ``_variance``; ``SpectralNorm`` keeps its
power-iteration vectors in the parameters ``weight_u`` and ``weight_v``
(no gradient). Every parameter is drawn at construction, as in the
reference, from the port's seeded generator of its device
(``core/generator.py``; ``paddle.seed`` fixes it), with the attribute's
initializer or else the reference's default: Xavier-uniform weights and
zero biases for ``Linear``, ``Bilinear`` and ``HSigmoidLoss``,
``Uniform(+-sqrt(1/fan_in))`` weights and biases for the convolutions,
``Normal(0, 1)`` for ``Embedding`` (its padding row zero), ones and
zeros for the norms, ``Constant(init)`` for ``PReLU``, ``Normal(0, 1)``
for ``SpectralNorm``'s vectors. ``weight_attr``/``bias_attr`` take a
``ParamAttr``, an initializer or ``False`` (no parameter), and the
attribute's learning-rate scale, regularizer, ``trainable`` and
``need_clip`` go on the ``Parameter``. Each layer that owns parameters
has ``reset_parameters(generator)``, which draws them again from
``generator`` (the attribute's initializer, else the default);
:func:`reset_parameters` runs it for every sublayer of a model in
registration order, so one seed fixes the whole model.

``SyncBatchNorm`` in one process is ``BatchNorm``, as the reference's
eager mode is; statistics across ranks are the second slice of
ROADMAP.md queue A10.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from ..ops.dispatch import apply
from ..ops.manipulation import flatten, pixel_shuffle
from . import functional as F
from . import initializer as I
from .layer_base import Layer, ParamAttr, make_parameter


def _param(layer, name, shape, attr, device, dtype, default):
    """Register parameter ``name`` made as ``attr`` says (None for
    ``False``), drawn at once from the attribute's initializer, else from
    ``default``, on ``device``'s default generator; the initializer goes
    in ``layer._inits`` for :func:`_reset`."""
    a = ParamAttr._to_attr(attr)
    if a is not False:
        layer.__dict__.setdefault("_inits", {})[name] = \
            a.initializer or default
    p = make_parameter(shape, a, dtype, default_initializer=default,
                       device=device)
    setattr(layer, name, p)
    return p


@torch.no_grad()
def _reset(layer, generator: Optional[torch.Generator] = None):
    """A layer's ``reset_parameters``: every parameter made by
    :func:`_param` drawn again from ``generator``, in the order they were
    made."""
    for name, init in layer.__dict__.get("_inits", {}).items():
        p = getattr(layer, name)
        if p is not None:
            p.copy_(init(list(p.shape), p.dtype, p.device, generator))


class Linear(Layer):
    """``y = x @ W + b`` with ``W`` of shape ``[in_features, out_features]``."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        _param(self, "weight", [in_features, out_features], weight_attr,
               dev, dtype, I.XavierUniform())
        _param(self, "bias", [out_features], bias_attr, dev, dtype,
               I.Constant(0.0))

    reset_parameters = _reset

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.weight.shape[0]}, "
                f"out_features={self.weight.shape[1]}")


# -- convolutions -----------------------------------------------------------

class _ConvNd(Layer):
    """paddle's ``_ConvNd`` (reference ``:39``): the ``n``-D convolution
    or, with ``transpose``, its transpose, over channels-first input (or
    channels-last with ``data_format``). As in the JAX package,
    ``padding_mode`` is accepted and the padding is zeros."""

    def __init__(self, n, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transpose=False, output_padding=0, *,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__()
        ks = list(kernel_size) if isinstance(kernel_size, (list, tuple)) \
            else [kernel_size] * n
        self._n = n
        self._in, self._out = in_channels, out_channels
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._transpose = transpose
        self._output_padding = output_padding
        self._fan_in = in_channels * int(np.prod(ks)) // groups
        shape = [in_channels, out_channels // groups] if transpose else \
            [out_channels, in_channels // groups]
        limit = math.sqrt(1.0 / self._fan_in)
        dev = resolve_device(device)
        _param(self, "weight", shape + ks, weight_attr, dev, dtype,
               I.Uniform(-limit, limit))
        _param(self, "bias", [out_channels], bias_attr, dev, dtype,
               I.Uniform(-limit, limit))

    reset_parameters = _reset

    def forward(self, x):
        if self._transpose:
            fn = {1: F.conv1d_transpose, 2: F.conv2d_transpose,
                  3: F.conv3d_transpose}[self._n]
            return fn(x, self.weight, self.bias, stride=self._stride,
                      padding=self._padding,
                      output_padding=self._output_padding,
                      groups=self._groups, dilation=self._dilation,
                      data_format=self._data_format)
        fn = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[self._n]
        return fn(x, self.weight, self.bias, stride=self._stride,
                  padding=self._padding, dilation=self._dilation,
                  groups=self._groups, data_format=self._data_format)

    def extra_repr(self):
        return (f"{self._in}, {self._out}, kernel_size="
                f"{list(self.weight.shape[2:])}, stride={self._stride}, "
                f"padding={self._padding}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         dtype=dtype)


class Conv2D(_ConvNd):
    """paddle's Conv2D: NCHW input, OIHW weight ``[out, in/groups, kH,
    kW]``, ``bias_attr=False`` for no bias."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         dtype=dtype)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         dtype=dtype)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, True, output_padding,
                         device=device, dtype=dtype)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, True, output_padding,
                         device=device, dtype=dtype)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, True, output_padding,
                         device=device, dtype=dtype)


# -- norms ------------------------------------------------------------------

class _BatchNormBase(Layer):
    """paddle's batch norm (reference ``:139``): ``weight``/``bias``
    (ones/zeros, ``False`` for none) and the buffers ``_mean``/
    ``_variance`` (zeros/ones), updated in training mode as
    ``momentum * running + (1 - momentum) * batch``; the channel axis is
    1 for an ``NC*`` ``data_format``, else the last."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", use_global_stats=None,
                 name=None, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        dev = resolve_device(device)
        _param(self, "weight", [num_features], weight_attr, dev, dtype,
               I.Constant(1.0))
        _param(self, "bias", [num_features], bias_attr, dev, dtype,
               I.Constant(0.0))
        self.register_buffer("_mean", torch.zeros(
            (num_features,), device=dev, dtype=torch.float32))
        self.register_buffer("_variance", torch.ones(
            (num_features,), device=dev, dtype=torch.float32))

    reset_parameters = _reset

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, epsilon={self._epsilon}")


class BatchNorm(_BatchNormBase):
    """fluid's BatchNorm: any rank, channel axis 1."""


class BatchNorm1D(_BatchNormBase):
    """Over ``[N, C]`` or ``[N, C, L]`` (``"NCL"``; ``"NLC"`` puts the
    channels last)."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCL", use_global_stats=None,
                 name=None, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name,
                         device=device, dtype=dtype)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCDHW", use_global_stats=None,
                 name=None, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name,
                         device=device, dtype=dtype)


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose statistics would span the ranks; in one process
    it is ``BatchNorm``, as the reference's eager mode is (reference
    ``:191-214``)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm under it (not ``layer``
        itself) replaced by a ``SyncBatchNorm`` holding its values."""
        for name, sub in list(layer._modules.items()):
            if isinstance(sub, _BatchNormBase) and \
                    not isinstance(sub, SyncBatchNorm):
                sync = SyncBatchNorm(
                    sub._num_features, sub._momentum, sub._epsilon,
                    weight_attr=None if sub.weight is not None else False,
                    bias_attr=None if sub.bias is not None else False,
                    data_format=sub._data_format,
                    use_global_stats=sub._use_global_stats,
                    device=sub._mean.device)
                sync.set_state_dict(sub.state_dict())
                sync.train(sub.training)
                setattr(layer, name, sync)
            elif isinstance(sub, nn.Module):
                cls.convert_sync_batchnorm(sub)
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        dev = resolve_device(device)
        _param(self, "weight", self._normalized_shape, weight_attr, dev,
               dtype, I.Constant(1.0))
        _param(self, "bias", self._normalized_shape, bias_attr, dev, dtype,
               I.Constant(0.0))

    reset_parameters = _reset

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        dev = resolve_device(device)
        _param(self, "weight", [num_channels], weight_attr, dev, dtype,
               I.Constant(1.0))
        _param(self, "bias", [num_channels], bias_attr, dev, dtype,
               I.Constant(0.0))

    reset_parameters = _reset

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm1D(Layer):
    """Each sample's channel normalised over its spatial axes, with a
    per-channel ``weight``/``bias``; ``momentum`` and ``data_format`` are
    taken and not read, as in the reference (no running statistics)."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__()
        self._epsilon = epsilon
        dev = resolve_device(device)
        _param(self, "weight", [num_features], weight_attr, dev, dtype,
               I.Constant(1.0))
        _param(self, "bias", [num_features], bias_attr, dev, dtype,
               I.Constant(0.0))

    reset_parameters = _reset

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, name, device=device,
                         dtype=dtype)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, name, device=device,
                         dtype=dtype)


class LocalResponseNorm(Layer):
    """``F.local_response_norm`` over channel axis 1 (``data_format`` is
    taken and not read, as in the reference)."""

    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self._args = (size, alpha, beta, k)

    def forward(self, x):
        return F.local_response_norm(x, *self._args)


def _spectral(w, u, v, dim, iters, eps):
    mat = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
    for _ in range(iters):
        v = mat.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = mat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return w / (u @ mat @ v)


class SpectralNorm(Layer):
    """``weight / sigma``, ``sigma`` from ``power_iters`` power
    iterations started at ``weight_u``/``weight_v`` (``Normal(0, 1)``,
    no gradient), over ``weight`` as a ``[shape[dim], -1]`` matrix
    (reference: operators/spectral_norm_op.cc); as in the JAX package the
    iterations run on copies, so the stored vectors do not move; op
    ``spectral_norm``."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        dev = resolve_device(device)
        _param(self, "weight_u", [h], None, dev, dtype, I.Normal(0.0, 1.0))
        _param(self, "weight_v", [w], None, dev, dtype, I.Normal(0.0, 1.0))
        self.weight_u.stop_gradient = True
        self.weight_v.stop_gradient = True

    reset_parameters = _reset

    def forward(self, weight):
        return apply("spectral_norm", _spectral, weight, self.weight_u,
                     self.weight_v, dim=self._dim, iters=self._power_iters,
                     eps=self._eps)


# -- pooling ----------------------------------------------------------------

class _PoolNd(Layer):
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


class MaxPool3D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCDHW",
                 name=None):
        super().__init__(F.max_pool3d, kernel_size, stride, padding,
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


class AvgPool3D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(F.avg_pool3d, kernel_size, stride, padding,
                         ceil_mode, exclusive, divisor_override, data_format)


class AdaptiveAvgPool1D(_PoolNd):
    def __init__(self, output_size, name=None):
        super().__init__(F.adaptive_avg_pool1d, output_size)


class AdaptiveAvgPool2D(_PoolNd):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(F.adaptive_avg_pool2d, output_size, data_format)


class AdaptiveAvgPool3D(_PoolNd):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(F.adaptive_avg_pool3d, output_size, data_format)


class AdaptiveMaxPool1D(_PoolNd):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool1d, output_size, return_mask)


class AdaptiveMaxPool2D(_PoolNd):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool2d, output_size, return_mask)


class AdaptiveMaxPool3D(_PoolNd):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool3d, output_size, return_mask)


# -- embedding, dropout and the rest -----------------------------------------

class Embedding(Layer):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 weight_attr=None, name=None, *, init_std: float = 1.0,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__()
        self._padding_idx = padding_idx
        self._init_std = float(init_std)
        dev = resolve_device(device)
        _param(self, "weight", [num_embeddings, embedding_dim], weight_attr,
               dev, dtype, I.Normal(0.0, self._init_std))
        self._zero_padding_row()

    @torch.no_grad()
    def _zero_padding_row(self):
        if self._padding_idx is not None:
            self.weight[self._padding_idx].zero_()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _reset(self, generator)
        self._zero_padding_row()

    def forward(self, x):
        return F.embedding(x, self.weight, self._padding_idx)


class Dropout(Layer):
    """paddle's Dropout (``upscale_in_train`` by default; ``axis`` drops
    whole slices). Its mask comes from the port's seeded generator of the
    input's device (``core/generator.py``; :func:`paddle_tpu_torch.seed`
    fixes it), not from torch's global default generator. The layer holds
    no generator of its own, so the deep copies ``TransformerEncoder``
    makes share one stream."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train", name=None):
        super().__init__()
        self.p = float(p)
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, self.training, self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, self.training, self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, self.training)


class Flatten(Layer):
    """Merge axes ``start_axis..stop_axis`` (``:488``)."""

    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self._start, self._stop = start_axis, stop_axis

    def forward(self, x):
        return flatten(x, self._start, self._stop)


class Upsample(Layer):
    """Resize through :func:`~paddle_tpu_torch.nn.functional.interpolate`."""

    def __init__(self, size=None, scale_factor=None, mode: str = "nearest",
                 align_corners: bool = False, align_mode: int = 0,
                 data_format: str = "NCHW", name=None):
        super().__init__()
        self._kw = dict(size=size, scale_factor=scale_factor, mode=mode,
                        align_corners=align_corners, align_mode=align_mode,
                        data_format=data_format)

    def forward(self, x):
        return F.interpolate(x, **self._kw)


class UpsamplingBilinear2D(Upsample):
    """``Upsample`` in ``"bilinear"`` mode with ``align_corners``."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self._r = upscale_factor
        self._fmt = data_format

    def forward(self, x):
        return pixel_shuffle(x, self._r, self._fmt)


class _PadNd(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW"):
        super().__init__()
        self._padding = padding
        self._mode = mode
        self._value = value
        self._fmt = data_format

    def forward(self, x):
        return F.pad(x, self._padding, self._mode, self._value, self._fmt)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    """``Pad2D`` (the reference's, which takes the same arguments)."""


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self._axis, self._eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self._axis, self._eps)


class Bilinear(Layer):
    """``x1^T W_o x2 + b_o`` for each output ``o``: ``weight``
    ``[out, in1, in2]`` (Xavier-uniform), ``bias`` ``[1, out]``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        _param(self, "weight", [out_features, in1_features, in2_features],
               weight_attr, dev, dtype, I.XavierUniform())
        _param(self, "bias", [1, out_features], bias_attr, dev, dtype,
               I.Constant(0.0))

    reset_parameters = _reset

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self._args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self._args)


def reset_parameters(module: nn.Module,
                     generator: Optional[torch.Generator] = None):
    """Re-draw every parameter of ``module`` from ``generator``: each
    sublayer that has ``reset_parameters`` (``module`` too), in
    registration order, so one seed fixes the whole model."""
    for m in module.modules():
        if isinstance(m, Layer) and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
