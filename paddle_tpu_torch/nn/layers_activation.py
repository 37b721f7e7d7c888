"""Activations as layers (counterpart of
``paddle_tpu/nn/layers_activation.py``, the part the YOLOv3 path uses)."""
from __future__ import annotations

from torch import nn

from . import functional as F


class LeakyReLU(nn.Module):
    def __init__(self, negative_slope: float = 0.01, name=None):
        super().__init__()
        self._slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._slope)

    def extra_repr(self):
        return f"negative_slope={self._slope}"
