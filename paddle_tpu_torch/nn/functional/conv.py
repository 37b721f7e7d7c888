"""Convolutions (counterpart of ``paddle_tpu/nn/functional/conv.py``):
``conv1d``, ``conv2d``, ``conv3d``, ``conv1d_transpose``,
``conv2d_transpose``, ``conv3d_transpose`` and ``deformable_conv``.

The JAX package lowers every convolution to ``lax.conv_general_dilated``
outside any Pallas kernel; the port's counterparts are
``torch.nn.functional.conv{1,2,3}d`` and ``conv_transpose{1,2,3}d``
(cuDNN on the card, with TF32 off: see ``core/device.py``). Layout
follows paddle: channels first (``NCL``, ``NCHW``, ``NCDHW``) or last
with ``data_format`` (``NLC``, ``NHWC``, ``NDHWC``), and a kernel
``[out, in/groups, *k]`` whatever the layout; a transposed convolution's
kernel is ``[in, out/groups, *k]`` in both packages. Padding takes
paddle's forms: an int, one value per spatial dim, per-side pairs
``[lo0, hi0, lo1, hi1, ...]``, ``"SAME"`` (XLA's: output
``ceil(in / stride)``, the odd pixel on the high side) or ``"VALID"``;
a transposed convolution takes no string, as in the JAX package, and
adds ``output_padding`` on the high side. ``output_size``, which the
JAX package takes and never reads, raises for any value but None.

``deformable_conv`` (v1, and v2 with ``mask``) is the JAX package's
bilinear sampling (a corner outside the image counts zero, a sample
point at or beyond a pixel outside counts zero) followed by one
contraction with the kernel, in plain torch. Each function runs through
the funnel under the reference's op name (``conv1d``,
``conv2d_transpose``, ``deformable_conv``, ...).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.dispatch import apply

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose", "deformable_conv"]

_CHANNEL_LAST = ("NLC", "NWC", "NHWC", "NDHWC")
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


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


def _flat_pads(pads):
    """``F.pad``'s argument for per-dim (low, high) pads: the last dim
    first."""
    return [v for lo_hi in reversed(pads) for v in lo_hi]


def _conv(n, name, x, weight, bias, stride, padding, dilation, groups,
          data_format):
    return apply(name, _conv_nd, x, weight, bias, n=n, stride=stride,
                 padding=padding, dilation=dilation, groups=groups,
                 channel_last=data_format in _CHANNEL_LAST)


def _conv_nd(x, weight, bias, n, stride, padding, dilation, groups,
             channel_last):
    if channel_last:
        x = torch.movedim(x, -1, 1)
    stride = _tuplize(stride, n)
    dilation = _tuplize(dilation, n)
    pads = _pads(padding, n, x.shape[2:], weight.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        x = F.pad(x, _flat_pads(pads))
        sym = (0,) * n
    out = _CONV[n](x, weight, bias, stride, sym, dilation, groups)
    return torch.movedim(out, 1, -1) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """``x`` ``[N, C, L]`` (``[N, L, C]`` with ``"NLC"``) convolved with
    ``weight`` ``[O, C/groups, k]``, plus ``bias`` ``[O]``; op
    ``conv1d``."""
    return _conv(1, "conv1d", x, weight, bias, stride, padding, dilation,
                 groups, data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """``x`` ``[N, C, H, W]`` (``[N, H, W, C]`` with ``data_format="NHWC"``)
    convolved with ``weight`` ``[O, C/groups, kH, kW]``, plus ``bias``
    ``[O]``; op ``conv2d``."""
    return _conv(2, "conv2d", x, weight, bias, stride, padding, dilation,
                 groups, data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    """``x`` ``[N, C, D, H, W]`` convolved with ``weight``
    ``[O, C/groups, kD, kH, kW]``; op ``conv3d``."""
    return _conv(3, "conv3d", x, weight, bias, stride, padding, dilation,
                 groups, data_format)


def _conv_t(n, x, weight, bias, stride, padding, output_padding, groups,
            dilation, output_size, data_format):
    if output_size is not None:
        raise NotImplementedError(
            f"conv{n}d_transpose(output_size=...): the JAX package takes it "
            f"and never reads it; give padding and output_padding instead")
    if isinstance(padding, str):
        raise ValueError("string padding not supported for conv_transpose")
    return apply(f"conv{n}d_transpose", _conv_t_nd, x, weight, bias, n=n,
                 stride=stride, padding=padding,
                 output_padding=output_padding, groups=groups,
                 dilation=dilation,
                 channel_last=data_format in _CHANNEL_LAST)


def _conv_t_nd(x, weight, bias, n, stride, padding, output_padding, groups,
               dilation, channel_last):
    if channel_last:
        x = torch.movedim(x, -1, 1)
    stride = _tuplize(stride, n)
    dilation = _tuplize(dilation, n)
    opad = _tuplize(output_padding, n)
    pads = _pads(padding, n, None, None, None, None)
    if all(lo == hi for lo, hi in pads) and all(
            o < max(s, d) for o, s, d in zip(opad, stride, dilation)):
        out = _CONV_T[n](x, weight, bias, stride,
                         tuple(lo for lo, _ in pads), opad, groups,
                         dilation)
    else:
        # the full transposed convolution, then each dim cut by its low
        # pad and cut (or zero-extended) at the high side
        out = _CONV_T[n](x, weight, None, stride, 0, 0, groups, dilation)
        for i, ((lo, hi), o) in enumerate(zip(pads, opad)):
            size = out.shape[2 + i]
            end = size - hi + o
            if end > size:
                widths = [0, 0] * n
                widths[2 * (n - 1 - i) + 1] = end - size
                out = F.pad(out, widths)
            out = out.narrow(2 + i, lo, end - lo)
        if bias is not None:
            out = out + bias.reshape((1, -1) + (1,) * n)
    return torch.movedim(out, 1, -1) if channel_last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCL", name=None):
    """The transposed convolution of ``x`` ``[N, C, L]`` with ``weight``
    ``[C, O/groups, k]``; op ``conv1d_transpose``."""
    return _conv_t(1, x, weight, bias, stride, padding, output_padding,
                   groups, dilation, output_size, data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCHW", name=None):
    """The transposed convolution of ``x`` ``[N, C, H, W]`` with
    ``weight`` ``[C, O/groups, kH, kW]``; op ``conv2d_transpose``."""
    return _conv_t(2, x, weight, bias, stride, padding, output_padding,
                   groups, dilation, output_size, data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCDHW", name=None):
    """The transposed convolution of ``x`` ``[N, C, D, H, W]`` with
    ``weight`` ``[C, O/groups, kD, kH, kW]``; op ``conv3d_transpose``."""
    return _conv_t(3, x, weight, bias, stride, padding, output_padding,
                   groups, dilation, output_size, data_format)


def _deformable(a, off, w, mask, bias, stride, dilation, pads, dg, groups):
    B, C, H, W = a.shape
    Ho, Wo = off.shape[2], off.shape[3]
    kh, kw = int(w.shape[2]), int(w.shape[3])
    K = kh * kw
    (sh, sw), (dh, dw), ((pt, _), (pl, _)) = stride, dilation, pads
    f32 = dict(dtype=torch.float32, device=a.device)
    oy = torch.arange(Ho, **f32) * sh - pt
    ox = torch.arange(Wo, **f32) * sw - pl
    yy = torch.arange(kh, **f32)[:, None, None] * dh + oy[None, :, None]
    xx = torch.arange(kw, **f32)[:, None, None] * dw + ox[None, None, :]
    grid_y = yy[:, None].expand(kh, kw, Ho, Wo).reshape(K, Ho, Wo)
    grid_x = xx[None].expand(kh, kw, Ho, Wo).reshape(K, Ho, Wo)
    off_r = off.reshape(B, dg, K, 2, Ho, Wo)
    sy = grid_y + off_r[:, :, :, 0]                 # [B, dg, K, Ho, Wo]
    sx = grid_x + off_r[:, :, :, 1]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = (sy - y0)[:, :, None], (sx - x0)[:, :, None]
    valid = (sy > -1) & (sy < H) & (sx > -1) & (sx < W)
    a_g = a.reshape(B, dg, C // dg, H * W)

    def tap(yi, xi):
        # a corner outside the image counts zero (not the edge pixel)
        ok = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        lin = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
        idx = lin.reshape(B, dg, 1, K * Ho * Wo).expand(
            B, dg, C // dg, K * Ho * Wo)
        vals = torch.gather(a_g, 3, idx).reshape(B, dg, C // dg, K, Ho, Wo)
        return vals * ok[:, :, None]

    sampled = (tap(y0, x0) * (1 - wy) * (1 - wx)
               + tap(y0, x0 + 1) * (1 - wy) * wx
               + tap(y0 + 1, x0) * wy * (1 - wx)
               + tap(y0 + 1, x0 + 1) * wy * wx)
    sampled = torch.where(valid[:, :, None], sampled,
                          torch.zeros((), dtype=sampled.dtype,
                                      device=a.device))
    if mask is not None:
        sampled = sampled * mask.reshape(B, dg, 1, K, Ho, Wo)
    sampled = sampled.reshape(B, C, K, Ho, Wo)
    wk = w.reshape(w.shape[0], C // groups, K)
    if groups == 1:
        out = torch.einsum("bckhw,ock->bohw", sampled, wk)
    else:
        sp = sampled.reshape(B, groups, C // groups, K, Ho, Wo)
        wg = wk.reshape(groups, w.shape[0] // groups, C // groups, K)
        out = torch.einsum("bgckhw,gock->bgohw", sp, wg).reshape(
            B, w.shape[0], Ho, Wo)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def deformable_conv(x, offset, weight, mask=None, bias=None, stride=1,
                    padding=0, dilation=1, deformable_groups=1, groups=1,
                    im2col_step=None, name=None):
    """``x`` ``[B, C, H, W]`` sampled at the kernel taps moved by
    ``offset`` ``[B, 2·dg·kh·kw, Ho, Wo]`` (y, x interleaved per tap),
    scaled by ``mask`` ``[B, dg·kh·kw, Ho, Wo]`` (v2), then contracted
    with ``weight`` ``[O, C/groups, kh, kw]``; op ``deformable_conv``."""
    if isinstance(padding, (list, tuple)) and len(padding) == 4:
        pads = [(int(padding[0]), int(padding[1])),
                (int(padding[2]), int(padding[3]))]
    else:
        pads = [(p, p) for p in _tuplize(padding, 2)]
    return apply("deformable_conv", _deformable, x, offset, weight, mask,
                 bias, stride=_tuplize(stride, 2),
                 dilation=_tuplize(dilation, 2), pads=pads,
                 dg=int(deformable_groups), groups=int(groups))
