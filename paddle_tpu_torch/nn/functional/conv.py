"""2-D convolution (counterpart of ``conv2d`` in
``paddle_tpu/nn/functional/conv.py``).

The JAX package lowers every convolution to ``lax.conv_general_dilated``
outside any Pallas kernel; the port's counterpart is
``torch.nn.functional.conv2d`` (cuDNN on the card, with TF32 off: see
``core/device.py``). Layout follows paddle: NCHW input (or NHWC with
``data_format``), OIHW kernel. Padding takes paddle's forms: an int, one
value per spatial dim, per-side pairs ``[top, bottom, left, right]``,
``"SAME"`` (XLA's: output ``ceil(in / stride)``, the odd pixel on the
high side) or ``"VALID"``. conv1d/3d and the transposed convolutions are
not ported yet (ROADMAP.md queue A9).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import amp

__all__ = ["conv2d"]


def _tuplize(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == n:
            return tuple(int(x) for x in v)
        return tuple(int(v[0]) for _ in range(n))
    return tuple(int(v) for _ in range(n))


def _pads(padding, n, in_sizes, kernel, stride, dilation):
    """Per spatial dim (low, high) zero padding."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * n
        if mode != "SAME":
            raise ValueError(f"padding {padding!r}: 'SAME' or 'VALID'")
        pads = []
        for size, k, s, d in zip(in_sizes, kernel, stride, dilation):
            out = -(-size // s)
            total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    if isinstance(padding, (list, tuple)) and len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    return [(p, p) for p in _tuplize(padding, n)]


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """``x`` ``[N, C, H, W]`` (``[N, H, W, C]`` with ``data_format="NHWC"``)
    convolved with ``weight`` ``[O, C/groups, kH, kW]``, plus ``bias``
    ``[O]``; op ``conv2d`` under AMP."""
    x, weight, bias = amp.cast_inputs("conv2d", x, weight, bias)
    channel_last = data_format == "NHWC"
    if channel_last:
        x = x.permute(0, 3, 1, 2)
    stride = _tuplize(stride, 2)
    dilation = _tuplize(dilation, 2)
    pads = _pads(padding, 2, x.shape[2:], weight.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        (top, bottom), (left, right) = pads
        x = F.pad(x, (left, right, top, bottom))
        sym = (0, 0)
    out = F.conv2d(x, weight, bias, stride, sym, dilation, groups)
    return out.permute(0, 2, 3, 1) if channel_last else out
