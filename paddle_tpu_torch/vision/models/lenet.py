"""LeNet (counterpart of ``paddle_tpu/vision/models/lenet.py``, BASELINE
config 1's MNIST model): two conv + ReLU + 2x2 max-pool stages and three
linears, names as the JAX package's (``features.0.weight``,
``fc.2.bias``). Parameters are drawn on ``device`` from a generator
seeded with ``seed``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.device import DeviceLike, resolve_device
from ...nn import Conv2D, Linear, MaxPool2D, ReLU, Sequential
from ...nn.layers_common import reset_parameters
from ...ops.manipulation import flatten

__all__ = ["LeNet"]


class LeNet(nn.Module):
    def __init__(self, num_classes=10, *, device: DeviceLike = None,
                 seed: Optional[int] = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, device=dev), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, device=dev), ReLU(),
            MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = Sequential(
                Linear(400, 120, device=dev), Linear(120, 84, device=dev),
                Linear(84, num_classes, device=dev))
        if seed is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            reset_parameters(self, gen)

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = flatten(x, 1)
            x = self.fc(x)
        return x
