"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``,
the part the GPT and YOLOv3 paths use)."""
from __future__ import annotations

import torch


def gelu(x, approximate: bool = False):
    """GELU; exact (erf) by default, as the JAX package's
    ``jax.nn.gelu(approximate=False)``."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def softmax(x, axis: int = -1, dtype=None):
    return torch.softmax(x, dim=axis, dtype=dtype)


def leaky_relu(x, negative_slope: float = 0.01):
    return torch.nn.functional.leaky_relu(x, negative_slope)
