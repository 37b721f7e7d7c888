"""Linear, LayerNorm, Embedding and Dropout as ``torch.nn.Module``s
(counterpart of the same classes in ``paddle_tpu/nn/layers_common.py``).

Parameter names and layouts are paddle's, so state dicts carry 1:1
between the packages: ``Linear.weight`` is ``[in, out]`` and the layer
computes ``x @ W + b`` (not ``torch.nn.Linear``'s ``[out, in]``).
Parameters are created on an explicit device and drawn from an explicit
``torch.Generator`` by :meth:`reset_parameters`, with paddle's default
initialisers: Xavier-uniform weights and zero biases for ``Linear``,
``Normal(0, std)`` for ``Embedding``, ones and zeros for ``LayerNorm``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
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
    from the device's default generator: the serving path runs with
    dropout off, and a generator per layer would not survive the deep
    copies ``TransformerEncoder`` makes."""

    def __init__(self, p: float = 0.5, mode: str = "upscale_in_train"):
        super().__init__()
        self.p = float(p)
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.mode)

    def extra_repr(self):
        return f"p={self.p}, mode={self.mode}"


def reset_parameters(module: nn.Module,
                     generator: Optional[torch.Generator] = None):
    """Re-draw every parameter of ``module`` from ``generator``, layer by
    layer in registration order (so one seed fixes the whole model)."""
    for m in module.modules():
        if isinstance(m, (Linear, LayerNorm, Embedding)):
            m.reset_parameters(generator)
