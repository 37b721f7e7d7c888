"""ResNet family (counterpart of ``paddle_tpu/vision/models/resnet.py``:
``BasicBlock``, ``BottleneckBlock``, ``ResNet`` with its depth table,
``resnet18/34/50/101/152`` and ``wide_resnet50_2/101_2``).

The same blocks and names as the JAX package, NCHW: Conv2D (no bias) +
BatchNorm2D + ReLU, a 1x1 projection (``downsample``, a ``Sequential``
of conv and BN) where the shape changes, a 7x7 stem and a 3x3 max pool,
an adaptive average pool to 1x1 and the ``fc`` head; parameter and
buffer names match 1:1 (``layer1.0.conv1.weight``,
``layer2.0.downsample.1._mean``, ``fc.weight``), so state dicts carry
between the packages. The convolutions run on cuDNN with TF32 off
(``core/device.py``); BatchNorm in training mode is the port's plain
composition (``nn/functional/norm.py``). Parameters are drawn on
``device`` from a generator seeded with ``seed``. ``pretrained=True``
raises, as the JAX package's does (no network); a checkpoint path waits
for ``convert_reference_checkpoint`` (ROADMAP.md queue A11).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.device import DeviceLike, resolve_device
from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear, MaxPool2D,
                   ReLU, Sequential)
from ...nn.layers_common import reset_parameters
from ...ops.manipulation import flatten

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "wide_resnet50_2",
           "wide_resnet101_2"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None, *,
                 device: DeviceLike = None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock only supports groups=1, "
                             "base_width=64")
        self.conv1 = Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                            bias_attr=False, device=device)
        self.bn1 = norm_layer(planes, device=device)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            device=device)
        self.bn2 = norm_layer(planes, device=device)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None, *,
                 device: DeviceLike = None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False,
                            device=device)
        self.bn1 = norm_layer(width, device=device)
        self.conv2 = Conv2D(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation,
                            bias_attr=False, device=device)
        self.bn2 = norm_layer(width, device=device)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, device=device)
        self.bn3 = norm_layer(planes * self.expansion, device=device)
        self.relu = ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    """The depth table of the JAX package (``:71``); ``block`` overrides
    the depth's block type, ``width`` is the bottleneck's base width (128
    for the wide variants)."""

    _depth_cfg = {
        18: (BasicBlock, [2, 2, 2, 2]),
        34: (BasicBlock, [3, 4, 6, 3]),
        50: (BottleneckBlock, [3, 4, 6, 3]),
        101: (BottleneckBlock, [3, 4, 23, 3]),
        152: (BottleneckBlock, [3, 8, 36, 3]),
    }

    def __init__(self, block=None, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, *, device: DeviceLike = None,
                 seed: Optional[int] = 0):
        super().__init__()
        dev = resolve_device(device)
        if block is None:
            block, layer_cfg = self._depth_cfg[depth]
        else:
            layer_cfg = self._depth_cfg[depth][1]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.groups = groups
        self.base_width = width
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, device=dev)
        self.bn1 = BatchNorm2D(self.inplanes, device=dev)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layer_cfg[0], dev)
        self.layer2 = self._make_layer(block, 128, layer_cfg[1], dev,
                                       stride=2)
        self.layer3 = self._make_layer(block, 256, layer_cfg[2], dev,
                                       stride=2)
        self.layer4 = self._make_layer(block, 512, layer_cfg[3], dev,
                                       stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, device=dev)
        if seed is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            reset_parameters(self, gen)

    def _make_layer(self, block, planes, blocks, dev, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, device=dev),
                BatchNorm2D(planes * block.expansion, device=dev))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, device=dev)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, device=dev))
        return Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = flatten(x, 1)
            x = self.fc(x)
        return x


def _resnet(depth, pretrained=False, **kwargs):
    """The JAX package's ``_resnet`` (``:140-153``): ``pretrained=True``
    needs the network and raises; a reference-format checkpoint path is
    loaded there by ``convert_reference_checkpoint``, not ported yet."""
    if pretrained:
        if not isinstance(pretrained, str):
            raise RuntimeError(
                "pretrained=True needs network access; pass "
                "pretrained='/path/to/resnet.pdparams' (reference-format "
                "checkpoint)")
        raise NotImplementedError(
            "pretrained='<path>': convert_reference_checkpoint is not "
            "ported yet: a later slice of the port (ROADMAP.md queue A11)")
    return ResNet(depth=depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(50, pretrained, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(101, pretrained, **kwargs)
