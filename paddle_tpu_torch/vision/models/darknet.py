"""DarkNet-53 backbone for YOLOv3 (counterpart of
``paddle_tpu/vision/models/darknet.py``).

Conv2D (no bias) + BatchNorm2D + LeakyReLU(0.1) blocks in NCHW; stages
of [1, 2, 8, 8, 4] residual blocks at [64, 128, 256, 512, 1024]
channels, each opened by a stride-2 3x3 conv. ``width_mult`` scales
every channel count (at least 8) for small test configs without
changing the topology. Parameter names match the JAX package 1:1
(``stem.conv.weight``, ``stage2.3.conv1.bn._mean``, ...).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.device import DeviceLike, resolve_device
from ...nn import BatchNorm2D, Conv2D, LeakyReLU, Sequential
from ...nn.layers_common import reset_parameters

__all__ = ["ConvBNLayer", "BasicBlock", "DarkNet", "darknet53"]


class ConvBNLayer(nn.Module):
    def __init__(self, in_ch, out_ch, kernel=3, stride=1, padding=None, *,
                 device: DeviceLike = None):
        super().__init__()
        if padding is None:
            padding = (kernel - 1) // 2
        self.conv = Conv2D(in_ch, out_ch, kernel, stride=stride,
                           padding=padding, bias_attr=False, device=device)
        self.bn = BatchNorm2D(out_ch, device=device)
        self.act = LeakyReLU(0.1)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    """1x1 squeeze + 3x3 expand with a residual add (YOLOv3 paper fig. 1)."""

    def __init__(self, ch, *, device: DeviceLike = None):
        super().__init__()
        self.conv1 = ConvBNLayer(ch, ch // 2, kernel=1, device=device)
        self.conv2 = ConvBNLayer(ch // 2, ch, kernel=3, device=device)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class DarkNet(nn.Module):
    """The 53-layer config; ``forward`` returns the C3/C4/C5 pyramid
    (stride 8/16/32 feature maps) the YOLO head takes. Parameters are
    drawn on ``device`` from a generator seeded with ``seed``."""

    _stage_blocks = {53: [1, 2, 8, 8, 4]}

    def __init__(self, depth=53, width_mult=1.0, num_stages=5, *,
                 device: DeviceLike = None, seed: Optional[int] = 0):
        super().__init__()
        if depth not in self._stage_blocks:
            raise ValueError(f"DarkNet: unsupported depth {depth}")
        dev = resolve_device(device)
        blocks = self._stage_blocks[depth][:num_stages]

        def ch(c):
            return max(int(c * width_mult), 8)

        self.stem = ConvBNLayer(3, ch(32), kernel=3, device=dev)
        self.stages = []
        in_ch = ch(32)
        for i, n in enumerate(blocks):
            out_ch = ch(64 * (2 ** i))
            stage = Sequential(
                ConvBNLayer(in_ch, out_ch, kernel=3, stride=2, device=dev),
                *[BasicBlock(out_ch, device=dev) for _ in range(n)])
            self.add_module(f"stage{i}", stage)
            self.stages.append(stage)
            in_ch = out_ch
        self.out_channels = [ch(64 * (2 ** i))
                             for i in range(max(len(blocks) - 3, 0),
                                            len(blocks))]
        if seed is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            reset_parameters(self, gen)

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats[-3:]           # C3, C4, C5


def darknet53(width_mult=1.0, **kwargs):
    return DarkNet(depth=53, width_mult=width_mult, **kwargs)
