"""VGG family (counterpart of ``paddle_tpu/vision/models/vgg.py``: ``VGG``,
``make_layers`` and ``vgg11/13/16/19``, with or without BatchNorm; the
same configurations and names, ``features.{i}.*`` and
``classifier.{i}.*``). An adaptive average pool to 7x7 sits before the
classifier, so inputs of other sizes than 224 reach it through
non-uniform bins. Parameters are drawn on ``device`` from a generator
seeded with ``seed``. ``pretrained=True`` raises (no network)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.device import DeviceLike, resolve_device
from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Linear,
                   MaxPool2D, ReLU, Sequential)
from ...nn.layers_common import reset_parameters
from ...ops.manipulation import flatten

__all__ = ["VGG", "make_layers", "vgg11", "vgg13", "vgg16", "vgg19"]


class VGG(nn.Module):
    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 device: DeviceLike = None, seed: Optional[int] = 0):
        super().__init__()
        dev = resolve_device(device)
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(512 * 7 * 7, 4096, device=dev), ReLU(), Dropout(),
                Linear(4096, 4096, device=dev), ReLU(), Dropout(),
                Linear(4096, num_classes, device=dev))
        if seed is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            reset_parameters(self, gen)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = flatten(x, 1)
            x = self.classifier(x)
        return x


def make_layers(cfg, batch_norm=False, *, device: DeviceLike = None):
    """The feature stack of ``cfg``: 3x3 convs (with BN when asked) and
    ReLU, ``"M"`` a 2x2 max pool."""
    dev = resolve_device(device)
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(kernel_size=2, stride=2))
        else:
            conv2d = Conv2D(in_channels, v, 3, padding=1, device=dev)
            if batch_norm:
                layers += [conv2d, BatchNorm2D(v, device=dev), ReLU()]
            else:
                layers += [conv2d, ReLU()]
            in_channels = v
    return Sequential(*layers)


cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _vgg(cfg, batch_norm, pretrained, device: DeviceLike = None, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights require network access")
    return VGG(make_layers(cfgs[cfg], batch_norm=batch_norm, device=device),
               device=device, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
