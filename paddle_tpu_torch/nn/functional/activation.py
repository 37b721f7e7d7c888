"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``,
all of it). Each runs through the dispatch funnel (``ops/dispatch.py``)
under the reference's op name (``hard_swish``, ``hard_sigmoid``,
``brelu`` for ``hardtanh``, ``hard_shrink``, ``tanh_shrink``,
``logsigmoid``, ...), where AMP casts its input, with the JAX package's
formula where torch's parts from it (``hardsigmoid``'s slope 1/6 to
seven places, ``softplus``'s threshold on ``x * beta``, ``selu`` and
``celu`` written out). ``rrelu`` in training and ``gumbel_softmax``
draw from the port's seeded generator of the input's device through
:func:`~paddle_tpu_torch.core.generator.draw`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dtypes import convert_dtype
from ...core.generator import default_generator, draw
from ...ops.dispatch import apply

__all__ = [
    "relu", "relu_", "relu6", "gelu", "sigmoid", "tanh", "softmax",
    "log_softmax", "leaky_relu", "elu", "selu", "celu", "silu", "swish",
    "mish", "hardswish", "hardsigmoid", "hardtanh", "hardshrink",
    "softshrink", "tanhshrink", "softplus", "softsign", "prelu", "rrelu",
    "maxout", "thresholded_relu", "log_sigmoid", "glu", "gumbel_softmax",
]


def relu(x, name=None):
    """``max(x, 0)`` (``:25``); op ``relu`` under AMP."""
    return apply("relu", torch.relu, x)


def relu_(x, name=None):
    x._swap_payload(relu(x))
    return x


def _relu6(a):
    return torch.clamp(a, 0.0, 6.0)


def relu6(x, name=None):
    return apply("relu6", _relu6, x)


def gelu(x, approximate: bool = False, name=None):
    """GELU; exact (erf) by default, as the JAX package's
    ``jax.nn.gelu(approximate=False)``."""
    return apply("gelu", TF.gelu, x,
                 approximate="tanh" if approximate else "none")


def sigmoid(x, name=None):
    return apply("sigmoid", torch.sigmoid, x)


def tanh(x, name=None):
    """``tanh(x)`` (``:46``); op ``tanh`` under AMP."""
    return apply("tanh", torch.tanh, x)


def _softmax(x, axis, dtype):
    return torch.softmax(x, dim=axis, dtype=dtype)


def softmax(x, axis: int = -1, dtype=None, name=None):
    return apply("softmax", _softmax, x, axis=axis,
                 dtype=convert_dtype(dtype))


def _log_softmax(x, axis, dtype):
    return torch.log_softmax(x, dim=axis, dtype=dtype)


def log_softmax(x, axis: int = -1, dtype=None, name=None):
    return apply("log_softmax", _log_softmax, x, axis=axis,
                 dtype=convert_dtype(dtype))


def leaky_relu(x, negative_slope: float = 0.01, name=None):
    return apply("leaky_relu", TF.leaky_relu, x,
                 negative_slope=negative_slope)


def elu(x, alpha=1.0, name=None):
    return apply("elu", TF.elu, x, alpha=alpha)


def _selu(a, scale, alpha):
    return scale * torch.where(a > 0, a, alpha * torch.expm1(a))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply("selu", _selu, x, scale=scale, alpha=alpha)


def _celu(a, alpha):
    return torch.where(a > 0, a, alpha * torch.expm1(a / alpha))


def celu(x, alpha=1.0, name=None):
    return apply("celu", _celu, x, alpha=alpha)


def silu(x, name=None):
    return apply("silu", TF.silu, x)


def swish(x, name=None):
    return silu(x)


def _mish(a):
    return a * torch.tanh(TF.softplus(a))


def mish(x, name=None):
    return apply("mish", _mish, x)


def _hardswish(a):
    return a * torch.clamp(a + 3.0, 0.0, 6.0) / 6.0


def hardswish(x, name=None):
    return apply("hard_swish", _hardswish, x)


def _hardsigmoid(a, slope, offset):
    return torch.clamp(a * slope + offset, 0.0, 1.0)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return apply("hard_sigmoid", _hardsigmoid, x, slope=slope, offset=offset)


def _hardtanh(a, lo, hi):
    return torch.clamp(a, lo, hi)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply("brelu", _hardtanh, x, lo=min, hi=max)


def _hardshrink(a, threshold):
    return torch.where(torch.abs(a) > threshold, a, torch.zeros_like(a))


def hardshrink(x, threshold=0.5, name=None):
    return apply("hard_shrink", _hardshrink, x, threshold=threshold)


def _softshrink(a, threshold):
    zero = torch.zeros_like(a)
    return torch.where(a > threshold, a - threshold,
                       torch.where(a < -threshold, a + threshold, zero))


def softshrink(x, threshold=0.5, name=None):
    return apply("softshrink", _softshrink, x, threshold=threshold)


def _tanhshrink(a):
    return a - torch.tanh(a)


def tanhshrink(x, name=None):
    return apply("tanh_shrink", _tanhshrink, x)


def _softplus(a, beta, threshold):
    return torch.where(a * beta > threshold, a,
                       TF.softplus(a * beta) / beta)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply("softplus", _softplus, x, beta=beta, threshold=threshold)


def _softsign(a):
    return a / (1 + torch.abs(a))


def softsign(x, name=None):
    return apply("softsign", _softsign, x)


def _prelu(a, w, data_format):
    if w.numel() == 1:
        return torch.where(a > 0, a, w.reshape(()) * a)
    shape = [1] * a.dim()
    shape[1 if data_format.startswith("NC") else a.dim() - 1] = w.numel()
    return torch.where(a > 0, a, w.reshape(shape) * a)


def prelu(x, weight, data_format="NCHW", name=None):
    return apply("prelu", _prelu, x, weight, data_format=data_format)


def _rrelu(a, lower, upper, training):
    if not training:
        return torch.where(a >= 0, a, a * ((lower + upper) / 2.0))
    g = default_generator(a.device)
    slope = draw(lambda: torch.empty_like(a).uniform_(lower, upper,
                                                      generator=g))
    return torch.where(a >= 0, a, a * slope)


def rrelu(x, lower=0.125, upper=0.3333333, training=False, name=None):
    """Leaky ReLU with a slope drawn from ``U(lower, upper)`` per entry
    while training, their mean otherwise."""
    return apply("rrelu", _rrelu, x, lower=lower, upper=upper,
                 training=training)


def _maxout(a, groups, axis):
    axis %= a.dim()
    s = list(a.shape)
    new = s[:axis] + [s[axis] // groups, groups] + s[axis + 1:]
    return torch.amax(a.reshape(new), dim=axis + 1)


def maxout(x, groups, axis=1, name=None):
    return apply("maxout", _maxout, x, groups=groups, axis=axis)


def _thresholded_relu(a, threshold):
    return torch.where(a > threshold, a, torch.zeros_like(a))


def thresholded_relu(x, threshold=1.0, name=None):
    return apply("thresholded_relu", _thresholded_relu, x,
                 threshold=threshold)


def log_sigmoid(x, name=None):
    return apply("logsigmoid", TF.logsigmoid, x)


def _glu(a, axis):
    return TF.glu(a, dim=axis)


def glu(x, axis=-1, name=None):
    return apply("glu", _glu, x, axis=axis)


def _gumbel_softmax(a, temperature, hard, axis):
    g = default_generator(a.device)
    u = draw(lambda: torch.empty_like(a).uniform_(generator=g))
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(a.dtype).tiny)))
    y = torch.softmax((a + gumbel) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = (y_hard - y).detach() + y      # forward one-hot, backward soft
    return y


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """``softmax((x + g) / temperature)`` with Gumbel noise ``g``; with
    ``hard`` the forward is the one-hot of its argmax and the gradient
    the soft one's."""
    return apply("gumbel_softmax", _gumbel_softmax, x,
                 temperature=temperature, hard=hard, axis=axis)
