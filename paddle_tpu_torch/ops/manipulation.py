"""Shape and layout ops (counterpart of ``paddle_tpu/ops/manipulation.py``,
all of it): ``reshape``, ``transpose``, ``concat``/``stack``/``split``
and their kin, ``squeeze``/``unsqueeze``, ``tile``/``expand``/the
broadcasts, ``flip``/``rot90``/``roll``, ``slice``/``strided_slice``/
``crop``/``pad``, ``repeat_interleave``, the pixel and channel shuffles,
``unfold``, ``shard_index``, ``cast``, the complex views, ``tensordot``,
``einsum`` and ``tolist``.

Each op runs through the funnel under the reference's op name
(``reshape2``, ``transpose2``, ``squeeze2``, ``unsqueeze2``,
``expand_v2``, ``expand_as_v2``, ``crop_tensor``, ``pad3d``, ...), the
tensors the reference passes positionally passed positionally (where
AMP may cast them) and every shape, axis and count as an attribute.
Shapes, sections and pads given as Tensors are read on the host, as in
the JAX package. A negative ``strided_slice`` stride flips the axis and
slices with the positive stride (torch slices take none); the ``pad``
modes other than constant gather along each padded axis with an index
made on the device, so both stay capturable.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core import dtypes as _dt
from ..core.tensor import Tensor
from .dispatch import apply

__all__ = ["reshape", "reshape_", "transpose", "t", "moveaxis", "swapaxes",
           "concat", "stack", "hstack", "vstack", "split", "chunk",
           "unstack", "unbind", "squeeze", "squeeze_", "unsqueeze",
           "unsqueeze_", "flatten", "tile", "expand", "expand_as",
           "broadcast_to", "broadcast_tensors", "broadcast_shape", "flip",
           "rot90", "roll", "slice", "strided_slice", "crop", "pad",
           "repeat_interleave", "pixel_shuffle", "pixel_unshuffle",
           "shuffle_channel", "space_to_depth", "unfold", "shard_index",
           "cast", "as_complex", "as_real", "tensordot", "einsum", "tolist"]

_slice = builtins.slice


def _int(v):
    return int(v.item() if isinstance(v, (Tensor, torch.Tensor)) else v)


def _shape_list(shape):
    if isinstance(shape, (Tensor, torch.Tensor)):
        return [int(s) for s in shape.tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [_int(s) for s in shape]


def _ndim(x):
    return (x._data if isinstance(x, Tensor) else x).dim()


def reshape(x, shape, name=None):
    return apply("reshape2", torch.reshape, x, shape=_shape_list(shape))


def reshape_(x, shape, name=None):
    x._swap_payload(reshape(x, shape))
    return x


def transpose(x, perm, name=None):
    return apply("transpose2", torch.permute, x,
                 dims=[_int(i) for i in perm])


def _t(a):
    return a if a.dim() < 2 else a.t()


def t(x, name=None):
    """0-D and 1-D pass through, 2-D transposes, more dims raise (the
    reference's ``Tensor.t`` contract)."""
    if _ndim(x) > 2:
        raise ValueError(
            f"t() expects a tensor with <= 2 dims, got {_ndim(x)} "
            f"(reference Tensor.t contract); use transpose")
    return apply("t", _t, x)


def moveaxis(x, source, destination, name=None):
    return apply("moveaxis", torch.movedim, x, source=source,
                 destination=destination)


def swapaxes(x, axis0, axis1, name=None):
    return apply("swapaxes", torch.swapaxes, x, axis0=axis0, axis1=axis1)


def _concat(xs, axis):
    return torch.cat(xs, dim=axis)


def concat(x, axis=0, name=None):
    return apply("concat", _concat, list(x), axis=_int(axis))


def _stack(xs, axis):
    return torch.stack(xs, dim=axis)


def stack(x, axis=0, name=None):
    return apply("stack", _stack, list(x), axis=axis)


def hstack(x, name=None):
    return apply("hstack", torch.hstack, list(x))


def vstack(x, name=None):
    return apply("vstack", torch.vstack, list(x))


def _split(a, sections, axis):
    if isinstance(sections, int):
        n = a.shape[axis]
        if n % sections:
            raise ValueError(f"split: axis {axis} of size {n} does not "
                             f"divide into {sections} equal sections")
        return list(torch.split(a, n // sections, dim=axis))
    if -1 in sections:
        known = builtins.sum(s for s in sections if s != -1)
        sections = [s if s != -1 else a.shape[axis] - known
                    for s in sections]
    return list(torch.split(a, sections, dim=axis))


def split(x, num_or_sections, axis=0, name=None):
    """``x`` cut along ``axis`` into ``num_or_sections`` equal parts, or
    into parts of the listed sizes (one may be -1: the rest; Tensors are
    read on the host)."""
    secs = num_or_sections if isinstance(num_or_sections, int) else \
        [_int(s) for s in num_or_sections]
    return apply("split", _split, x, sections=secs, axis=_int(axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis, name)


def _unstack(a, axis):
    return list(torch.unbind(a, dim=axis))


def unstack(x, axis=0, num=None, name=None):
    return apply("unstack", _unstack, x, axis=axis)


def unbind(input, axis=0):
    return unstack(input, axis)


def _squeeze(a, axis):
    if axis is None:
        return torch.squeeze(a)
    axes = tuple(ax % a.dim() for ax in axis if a.shape[ax % a.dim()] == 1)
    return torch.squeeze(a, axes) if axes else a


def squeeze(x, axis=None, name=None):
    if axis is not None:
        axis = [_int(v) for v in (axis if isinstance(axis, (list, tuple))
                                  else [axis])]
    return apply("squeeze2", _squeeze, x, axis=axis)


def squeeze_(x, axis=None, name=None):
    x._swap_payload(squeeze(x, axis))
    return x


def _unsqueeze(a, axes):
    for ax in sorted(axes):
        a = torch.unsqueeze(a, ax)
    return a


def unsqueeze(x, axis, name=None):
    axes = axis.tolist() if isinstance(axis, (Tensor, torch.Tensor)) else \
        axis
    axes = [_int(v) for v in (axes if isinstance(axes, (list, tuple))
                              else [axes])]
    return apply("unsqueeze2", _unsqueeze, x, axes=axes)


def unsqueeze_(x, axis, name=None):
    x._swap_payload(unsqueeze(x, axis))
    return x


def _flatten(x, start_axis, stop_axis):
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis % x.dim(), stop_axis % x.dim())


def flatten(x, start_axis: int = 0, stop_axis: int = -1, name=None):
    """``x`` with axes ``start_axis..stop_axis`` merged into one (negative
    axes count from the end); op ``flatten_contiguous_range``."""
    return apply("flatten_contiguous_range", _flatten, x,
                 start_axis=start_axis, stop_axis=stop_axis)


def tile(x, repeat_times, name=None):
    return apply("tile", torch.tile, x, dims=_shape_list(repeat_times))


def _expand(a, shape):
    off = len(shape) - a.dim()
    tgt = [a.shape[i - off] if s == -1 else s for i, s in enumerate(shape)]
    return torch.broadcast_to(a, tgt)


def expand(x, shape, name=None):
    """``x`` broadcast to ``shape`` (-1 keeps an axis); op ``expand_v2``."""
    return apply("expand_v2", _expand, x, shape=_shape_list(shape))


def _expand_as(a, b):
    return torch.broadcast_to(a, b.shape)


def expand_as(x, y, name=None):
    return apply("expand_as_v2", _expand_as, x, y)


def broadcast_to(x, shape, name=None):
    return expand(x, shape, name)


def _broadcast_tensors(xs):
    return list(torch.broadcast_tensors(*xs))


def broadcast_tensors(input, name=None):
    return apply("broadcast_tensors", _broadcast_tensors, list(input))


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def flip(x, axis, name=None):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return apply("flip", torch.flip, x, dims=[_int(v) for v in axes])


def _rot90(a, k, axes):
    return torch.rot90(a, k, list(axes))


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply("rot90", _rot90, x, k=k, axes=tuple(axes))


def _roll(a, shifts, axis):
    if axis is None:
        return torch.roll(a, shifts)
    return torch.roll(a, shifts, axis)


def roll(x, shifts, axis=None, name=None):
    return apply("roll", _roll, x, shifts=shifts, axis=axis)


def _strided(a, axes, starts, ends, strides):
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        n = a.shape[ax]
        if sd > 0:
            idx = [_slice(None)] * a.dim()
            idx[ax] = _slice(st, en, sd)
            a = a[tuple(idx)]
            continue
        r = range(*_slice(st, en, sd).indices(n))
        a = torch.flip(a, [ax])
        idx = [_slice(None)] * a.dim()
        first = n - 1 - r.start if len(r) else 0
        idx[ax] = _slice(first, first + len(r) * -sd, -sd)
        a = a[tuple(idx)]
    return a


def slice(input, axes, starts, ends):
    """``input[starts:ends]`` along each of ``axes`` (reference:
    operators/slice_op.cc)."""
    axes = [_int(a) for a in axes]
    return apply("slice", _strided, input, axes=axes,
                 starts=[_int(s) for s in starts],
                 ends=[_int(e) for e in ends], strides=[1] * len(axes))


def strided_slice(x, axes, starts, ends, strides, name=None):
    return apply("strided_slice", _strided, x, axes=[_int(a) for a in axes],
                 starts=[_int(s) for s in starts],
                 ends=[_int(e) for e in ends],
                 strides=[_int(s) for s in strides])


def _crop(a, shape, offsets):
    idx = tuple(_slice(o, o + (d if d != -1 else a.shape[i] - o))
                for i, (o, d) in enumerate(zip(offsets, shape)))
    return a[idx]


def crop(x, shape=None, offsets=None, name=None):
    s = _shape_list(shape)
    offs = [0] * len(s) if offsets is None else [_int(o) for o in offsets]
    return apply("crop_tensor", _crop, x, shape=s, offsets=offs)


def _pad_index(n, lo, hi, mode, device):
    """Source positions along an axis of size ``n`` padded by
    ``(lo, hi)``: NumPy's ``reflect`` (no edge repeat), ``edge`` and
    ``wrap``."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return torch.remainder(i, n)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


def _pad(a, widths, mode, value):
    if mode == "constant":
        flat = []
        for lo, hi in reversed(widths):
            flat += [lo, hi]
        return torch.nn.functional.pad(a, flat, value=value)
    for ax, (lo, hi) in enumerate(widths):
        if lo or hi:
            a = torch.index_select(a, ax, _pad_index(a.shape[ax], lo, hi,
                                                     mode, a.device))
    return a


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """paddle's pad (reference: operators/pad3d_op.cc): ``pad`` holds a
    ``(before, after)`` pair per axis when it has two per dim, else pairs
    for the trailing spatial axes, the last axis first; modes
    ``constant``, ``reflect``, ``replicate``, ``circular``."""
    if isinstance(pad, (Tensor, torch.Tensor)):
        pad = pad.tolist()
    pad = [_int(p) for p in pad]
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise KeyError(mode)
    nd = _ndim(x)
    if len(pad) == 2 * nd:
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        widths = [(0, 0)] * nd
        spatial = list(range(2, nd)) if data_format.startswith("NC") else \
            list(range(1, nd - 1))
        for i in range(len(pad) // 2):
            widths[spatial[len(spatial) - 1 - i]] = (pad[2 * i],
                                                     pad[2 * i + 1])
    return apply("pad3d", _pad, x, widths=widths, mode=mode, value=value)


def _repeat_interleave(a, *r, repeats, axis):
    return torch.repeat_interleave(a, r[0] if r else repeats, dim=axis)


def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, (Tensor, torch.Tensor)):
        return apply("repeat_interleave", _repeat_interleave, x, repeats,
                     repeats=None, axis=axis)
    return apply("repeat_interleave", _repeat_interleave, x,
                 repeats=repeats, axis=axis)


def _pixel_shuffle(a, r, data_format):
    if data_format == "NCHW":
        n, c, h, w = a.shape
        a = a.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return a.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = a.shape
    a = a.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return a.reshape(n, h * r, w * r, c // (r * r))


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return apply("pixel_shuffle", _pixel_shuffle, x, r=upscale_factor,
                 data_format=data_format)


def _pixel_unshuffle(a, r):
    n, c, h, w = a.shape
    a = a.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    return a.reshape(n, c * r * r, h // r, w // r)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return apply("pixel_unshuffle", _pixel_unshuffle, x, r=downscale_factor)


def _shuffle_channel(a, group):
    n, c, h, w = a.shape
    return a.reshape(n, group, c // group, h, w).transpose(1, 2) \
        .reshape(n, c, h, w)


def shuffle_channel(x, group):
    return apply("shuffle_channel", _shuffle_channel, x, group=group)


def _space_to_depth(a, b):
    n, c, h, w = a.shape
    a = a.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return a.reshape(n, c * b * b, h // b, w // b)


def space_to_depth(x, blocksize, name=None):
    return apply("space_to_depth", _space_to_depth, x, b=blocksize)


def _pair(v, n=2):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


def _unfold(a, ks, st, pd, dl):
    n, c = a.shape[:2]
    a = torch.nn.functional.pad(a, [pd[2], pd[3], pd[0], pd[1]])
    oh = (a.shape[2] - (dl[0] * (ks[0] - 1) + 1)) // st[0] + 1
    ow = (a.shape[3] - (dl[1] * (ks[1] - 1) + 1)) // st[1] + 1
    patches = []
    for i in range(ks[0]):
        for j in range(ks[1]):
            di, dj = i * dl[0], j * dl[1]
            patches.append(a[:, :, di:di + oh * st[0]:st[0],
                             dj:dj + ow * st[1]:st[1]])
    return torch.stack(patches, dim=2).reshape(n, c * ks[0] * ks[1],
                                               oh * ow)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col (reference: operators/unfold_op.cc): ``[N, C*kh*kw, L]``."""
    pd = _pair(paddings)
    if len(pd) == 2:
        pd = [pd[0], pd[0], pd[1], pd[1]]
    return apply("unfold", _unfold, x, ks=_pair(kernel_sizes),
                 st=_pair(strides), pd=pd, dl=_pair(dilations))


def _shard_index(i, index_num, nshards, shard_id, ignore_value):
    size = (index_num + nshards - 1) // nshards
    lo, hi = shard_id * size, (shard_id + 1) * size
    return torch.where((i >= lo) & (i < hi), i - lo,
                       torch.full_like(i, ignore_value))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """reference: operators/shard_index_op.cc (model-parallel embedding
    helper)."""
    return apply("shard_index", _shard_index, input, index_num=index_num,
                 nshards=nshards, shard_id=shard_id,
                 ignore_value=ignore_value)


def _cast(x, dtype):
    return x.to(dtype)


def cast(x, dtype):
    return apply("cast", _cast, x, dtype=_dt.convert_dtype(dtype))


def _as_complex(a):
    return torch.complex(a[..., 0], a[..., 1])


def as_complex(x, name=None):
    return apply("as_complex", _as_complex, x)


def _as_real(a):
    return torch.stack([a.real, a.imag], -1)


def as_real(x, name=None):
    return apply("as_real", _as_real, x)


def _tensordot(a, b, axes):
    return torch.tensordot(a, b, dims=axes)


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, (list, tuple)) and axes and isinstance(
            axes[0], (list, tuple)):
        axes = [list(a) for a in axes]
    return apply("tensordot", _tensordot, x, y, axes=axes)


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return apply("einsum", lambda *ops: torch.einsum(equation, *ops),
                 *operands)


def tolist(x):
    """A nested list of ``x``'s values, read on the host."""
    return (x._data if isinstance(x, Tensor) else x).detach().cpu().tolist()
