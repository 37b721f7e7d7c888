"""MobileNet V1, V2 and V3 (counterpart of
``paddle_tpu/vision/models/mobilenet.py``; V3 is BASELINE config 2's
PaddleClas MobileNetV3): ``MobileNetV1``, ``MobileNetV2``,
``MobileNetV3Large``/``Small`` and ``mobilenet_v1``, ``mobilenet_v2``,
``mobilenet_v3_large``, ``mobilenet_v3_small``.

The same blocks, widths (``_make_divisible``) and names as the JAX
package, NCHW: ``ConvBNLayer`` (Conv2D without bias, BatchNorm2D, an
activation), depthwise convolutions as ``Conv2D`` with ``groups`` equal
to the channels (cuDNN's grouped kernels on the card), V3's squeeze and
excite (``SqueezeExcite``: pool, 1x1 conv, ReLU, 1x1 conv,
``Hardsigmoid`` with the reference's slope), ``Hardswish``, and a
``Dropout(0.2)`` classifier head, so state dicts carry 1:1
(``features.1.block.0._conv.weight``, ``classifier.3.bias``).
Parameters are drawn on ``device`` from a generator seeded with
``seed``, as the port's other models are. ``pretrained=True`` raises, as
the JAX package's does (no network).
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.device import DeviceLike, resolve_device
from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                   Hardsigmoid, Hardswish, Linear, ReLU, ReLU6, Sequential)
from ...nn.layer_base import Layer
from ...nn.layers_common import reset_parameters
from ...ops.manipulation import flatten

__all__ = ["MobileNetV1", "MobileNetV2", "MobileNetV3Large",
           "MobileNetV3Small", "mobilenet_v1", "mobilenet_v2",
           "mobilenet_v3_large", "mobilenet_v3_small"]


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _seeded(model, dev, seed):
    if seed is not None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        reset_parameters(model, gen)


class ConvBNLayer(Layer):
    def __init__(self, in_c, out_c, kernel, stride=1, groups=1, act=ReLU,
                 *, device: DeviceLike = None):
        super().__init__()
        self._conv = Conv2D(in_c, out_c, kernel, stride=stride,
                            padding=(kernel - 1) // 2, groups=groups,
                            bias_attr=False, device=device)
        self._bn = BatchNorm2D(out_c, device=device)
        self._act = act() if act is not None else None

    def forward(self, x):
        x = self._bn(self._conv(x))
        return self._act(x) if self._act is not None else x


class DepthwiseSeparable(Layer):
    def __init__(self, in_c, out_c1, out_c2, num_groups, stride, scale, *,
                 device: DeviceLike = None):
        super().__init__()
        self._depthwise = ConvBNLayer(in_c, int(out_c1 * scale), 3,
                                      stride=stride,
                                      groups=int(num_groups * scale),
                                      device=device)
        self._pointwise = ConvBNLayer(int(out_c1 * scale),
                                      int(out_c2 * scale), 1, device=device)

    def forward(self, x):
        return self._pointwise(self._depthwise(x))


class MobileNetV1(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device: DeviceLike = None, seed: Optional[int] = 0):
        super().__init__()
        dev = resolve_device(device)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = ConvBNLayer(3, int(32 * scale), 3, stride=2,
                                 device=dev)
        cfg = [  # in, c1, c2, groups, stride
            (32, 32, 64, 32, 1), (64, 64, 128, 64, 2),
            (128, 128, 128, 128, 1), (128, 128, 256, 128, 2),
            (256, 256, 256, 256, 1), (256, 256, 512, 256, 2),
            (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1), (512, 512, 1024, 512, 2),
            (1024, 1024, 1024, 1024, 1),
        ]
        self.blocks = Sequential(*[
            DepthwiseSeparable(int(i * scale), c1, c2, g, s, scale,
                               device=dev) for i, c1, c2, g, s in cfg])
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(int(1024 * scale), num_classes, device=dev)
        _seeded(self, dev, seed)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


class InvertedResidual(Layer):
    def __init__(self, inp, oup, stride, expand_ratio, *,
                 device: DeviceLike = None):
        super().__init__()
        self.stride = stride
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res_connect = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden_dim, 1, act=ReLU6,
                                      device=device))
        layers += [
            ConvBNLayer(hidden_dim, hidden_dim, 3, stride=stride,
                        groups=hidden_dim, act=ReLU6, device=device),
            ConvBNLayer(hidden_dim, oup, 1, act=None, device=device),
        ]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res_connect else out


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device: DeviceLike = None, seed: Optional[int] = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.with_pool = with_pool
        input_channel = _make_divisible(32 * scale)
        cfg = [  # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        features = [ConvBNLayer(3, input_channel, 3, stride=2, act=ReLU6,
                                device=dev)]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, out_c, s if i == 0 else 1, t,
                    device=dev))
                input_channel = out_c
        self.last_channel = _make_divisible(1280 * max(1.0, scale))
        features.append(ConvBNLayer(input_channel, self.last_channel, 1,
                                    act=ReLU6, device=dev))
        self.features = Sequential(*features)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.2), Linear(self.last_channel, num_classes,
                                     device=dev))
        _seeded(self, dev, seed)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


class SqueezeExcite(Layer):
    def __init__(self, channels, reduction=4, *, device: DeviceLike = None):
        super().__init__()
        mid = _make_divisible(channels // reduction)
        self.pool = AdaptiveAvgPool2D((1, 1))
        self.fc1 = Conv2D(channels, mid, 1, device=device)
        self.relu = ReLU()
        self.fc2 = Conv2D(mid, channels, 1, device=device)
        self.hsig = Hardsigmoid()

    def forward(self, x):
        return x * self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))


class _V3Block(Layer):
    def __init__(self, inp, hidden, out, kernel, stride, use_se, act, *,
                 device: DeviceLike = None):
        super().__init__()
        self.use_res = stride == 1 and inp == out
        layers = []
        if hidden != inp:
            layers.append(ConvBNLayer(inp, hidden, 1, act=act,
                                      device=device))
        layers.append(ConvBNLayer(hidden, hidden, kernel, stride=stride,
                                  groups=hidden, act=act, device=device))
        if use_se:
            layers.append(SqueezeExcite(hidden, device=device))
        layers.append(ConvBNLayer(hidden, out, 1, act=None, device=device))
        self.block = Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


_V3_LARGE = [  # kernel, hidden, out, se, act, stride
    (3, 16, 16, False, ReLU, 1), (3, 64, 24, False, ReLU, 2),
    (3, 72, 24, False, ReLU, 1), (5, 72, 40, True, ReLU, 2),
    (5, 120, 40, True, ReLU, 1), (5, 120, 40, True, ReLU, 1),
    (3, 240, 80, False, Hardswish, 2), (3, 200, 80, False, Hardswish, 1),
    (3, 184, 80, False, Hardswish, 1), (3, 184, 80, False, Hardswish, 1),
    (3, 480, 112, True, Hardswish, 1), (3, 672, 112, True, Hardswish, 1),
    (5, 672, 160, True, Hardswish, 2), (5, 960, 160, True, Hardswish, 1),
    (5, 960, 160, True, Hardswish, 1),
]

_V3_SMALL = [
    (3, 16, 16, True, ReLU, 2), (3, 72, 24, False, ReLU, 2),
    (3, 88, 24, False, ReLU, 1), (5, 96, 40, True, Hardswish, 2),
    (5, 240, 40, True, Hardswish, 1), (5, 240, 40, True, Hardswish, 1),
    (5, 120, 48, True, Hardswish, 1), (5, 144, 48, True, Hardswish, 1),
    (5, 288, 96, True, Hardswish, 2), (5, 576, 96, True, Hardswish, 1),
    (5, 576, 96, True, Hardswish, 1),
]


class MobileNetV3(Layer):
    def __init__(self, cfg, last_channels, scale=1.0, num_classes=1000,
                 with_pool=True, *, device: DeviceLike = None,
                 seed: Optional[int] = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_c = _make_divisible(16 * scale)
        layers = [ConvBNLayer(3, in_c, 3, stride=2, act=Hardswish,
                              device=dev)]
        for k, hidden, out, se, act, s in cfg:
            h = _make_divisible(hidden * scale)
            o = _make_divisible(out * scale)
            layers.append(_V3Block(in_c, h, o, k, s, se, act, device=dev))
            in_c = o
        last_conv = _make_divisible(cfg[-1][1] * scale)
        layers.append(ConvBNLayer(in_c, last_conv, 1, act=Hardswish,
                                  device=dev))
        self.features = Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(last_conv, last_channels, device=dev), Hardswish(),
                Dropout(0.2), Linear(last_channels, num_classes,
                                     device=dev))
        _seeded(self, dev, seed)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device: DeviceLike = None, seed: Optional[int] = 0):
        super().__init__(_V3_LARGE, 1280, scale, num_classes, with_pool,
                         device=device, seed=seed)


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device: DeviceLike = None, seed: Optional[int] = 0):
        super().__init__(_V3_SMALL, 1024, scale, num_classes, with_pool,
                         device=device, seed=seed)


def _no_pretrained(pretrained):
    if pretrained:
        raise RuntimeError("pretrained weights require network access")


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)
