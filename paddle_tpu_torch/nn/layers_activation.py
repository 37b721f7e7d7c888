"""Activations and loss layers (counterpart of
``paddle_tpu/nn/layers_activation.py``, the part the YOLOv3, ResNet and
BERT paths use: ``ReLU``, ``Tanh``, ``LeakyReLU`` and
``CrossEntropyLoss``)."""
from __future__ import annotations

from torch import nn

from . import functional as F


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class Tanh(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanh(x)


class LeakyReLU(nn.Module):
    def __init__(self, negative_slope: float = 0.01, name=None):
        super().__init__()
        self._slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._slope)

    def extra_repr(self):
        return f"negative_slope={self._slope}"


class CrossEntropyLoss(nn.Module):
    """:func:`~paddle_tpu_torch.nn.functional.cross_entropy` with the
    keywords fixed at construction (``:254``)."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self._kw = dict(weight=weight, ignore_index=ignore_index,
                        reduction=reduction, soft_label=soft_label,
                        axis=axis, use_softmax=use_softmax)

    def forward(self, input, label):
        return F.cross_entropy(input, label, **self._kw)
