"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``,
the part the GPT, YOLOv3, ResNet and BERT paths use). Each consults the
AMP hook under the reference's op name first (``paddle_tpu_torch/amp``)."""
from __future__ import annotations

import torch

from ... import amp


def relu(x, name=None):
    """``max(x, 0)`` (``:25``); op ``relu`` under AMP."""
    (x,) = amp.cast_inputs("relu", x)
    return torch.relu(x)


def tanh(x, name=None):
    """``tanh(x)`` (``:46``); op ``tanh`` under AMP."""
    (x,) = amp.cast_inputs("tanh", x)
    return torch.tanh(x)


def gelu(x, approximate: bool = False):
    """GELU; exact (erf) by default, as the JAX package's
    ``jax.nn.gelu(approximate=False)``."""
    (x,) = amp.cast_inputs("gelu", x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def softmax(x, axis: int = -1, dtype=None):
    (x,) = amp.cast_inputs("softmax", x)
    return torch.softmax(x, dim=axis, dtype=dtype)


def leaky_relu(x, negative_slope: float = 0.01):
    (x,) = amp.cast_inputs("leaky_relu", x)
    return torch.nn.functional.leaky_relu(x, negative_slope)
