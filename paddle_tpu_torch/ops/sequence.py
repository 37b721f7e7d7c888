"""Sequence ops over the padded-plus-lengths convention (counterpart of
``paddle_tpu/ops/sequence.py``; reference: operators/sequence_ops/).

A ragged batch is ``data [B, T, ...]`` padded to ``T`` with ``lengths
[B]``, the JAX package's convention for the reference's LoDTensor. Every
op runs on the device, except where the output's shape depends on the
lengths: ``sequence_mask`` and ``sequence_pad`` without ``maxlen``,
``sequence_unpad`` and ``sequence_expand`` read the lengths on the host,
as the JAX package does (one sync each), and raise inside a CUDA graph
capture. ``sequence_pad`` with ``maxlen`` and ``sequence_concat`` find
their offsets on the device and can be captured. ``ops.sequence_mask``
is this module's: without ``maxlen`` it takes the lengths' maximum;
``nn.functional.sequence_mask`` is another function (as wide as its
input's last axis), as in the JAX package.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.dtypes import convert_dtype
from ..core.tensor import _raw
from . import dispatch as _dispatch
from .dispatch import apply

__all__ = ["sequence_mask", "sequence_pad", "sequence_unpad",
           "sequence_pool", "sequence_first_step", "sequence_last_step",
           "sequence_softmax", "sequence_reverse", "sequence_expand",
           "sequence_expand_as", "sequence_concat", "sequence_slice",
           "sequence_enumerate", "sequence_erase", "sequence_conv",
           "im2sequence"]


def _host(op, x):
    """The lengths ``x`` read on the host (refused in a capture)."""
    return _dispatch.host_array(op, "the lengths", x)


def _trail(mask, nd):
    """``mask [B, T]`` with ``nd - 2`` trailing unit axes."""
    return mask.reshape(tuple(mask.shape) + (1,) * (nd - 2))


def _valid(lens, T, device):
    return torch.arange(T, device=device)[None, :] < lens[:, None]


def _mask(lens, ml, dtype):
    return (torch.arange(ml, device=lens.device)[None, :]
            < lens[..., None]).to(dtype)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """Lengths ``[B]`` to a mask ``[B, maxlen]`` (sequence_mask_op.cc);
    without ``maxlen``, the lengths' maximum, read on the host."""
    ml = int(maxlen) if maxlen is not None else \
        int(_host("sequence_mask", x).max())
    return apply("sequence_mask", _mask, x, ml=ml,
                 dtype=convert_dtype(dtype))


def _pad(flat, pv, lens, T):
    offs = torch.cumsum(lens, 0) - lens
    idx = offs[:, None] + torch.arange(T, device=flat.device)[None, :]
    rows = flat[torch.clamp(idx, max=flat.shape[0] - 1)]       # [B, T, ...]
    pv = pv.to(rows.dtype) if isinstance(pv, torch.Tensor) else \
        torch.full((), pv, dtype=rows.dtype, device=rows.device)
    return torch.where(_trail(_valid(lens, T, flat.device), rows.dim()),
                       rows, pv)


def sequence_pad(x, pad_value, maxlen=None, length=None, name=None):
    """Flat values ``[N, ...]`` and lengths ``[B]`` to ``([B, T, ...],
    lengths)`` (sequence_pad_op.cc); ``T`` is ``maxlen``, or the longest
    length read on the host."""
    T = int(maxlen) if maxlen is not None else \
        int(_host("sequence_pad", length).max())
    out = apply("sequence_pad", _pad, x, pad_value, length, T=T)
    return out, length


def _unpad(padded, lens, keep):
    flat = padded.reshape((-1,) + tuple(padded.shape[2:]))
    return flat[keep.to(flat.device)]


def sequence_unpad(x, length, name=None):
    """Padded ``[B, T, ...]`` and lengths to flat ``[sum(lengths), ...]``
    (sequence_unpad_op.cc); the lengths are read on the host."""
    lens = _host("sequence_unpad", length)
    T = int(_raw(x).shape[1])
    keep = torch.from_numpy(np.concatenate(
        [np.arange(int(n)) + i * T for i, n in enumerate(lens)]
        + [np.zeros(0, np.int64)]).astype(np.int64))
    return apply("sequence_unpad", _unpad, x, length, keep=keep)


def _pool(data, *rest, pt):
    lens = rest[0] if rest else None
    T = data.shape[1]
    col = (-1,) + (1,) * (data.dim() - 2)
    if lens is None:
        mask = torch.ones(data.shape[:2], dtype=torch.bool,
                          device=data.device)
        lensf = torch.full((data.shape[0],), float(T), device=data.device)
    else:
        mask = _valid(lens, T, data.device)
        lensf = torch.clamp(lens.to(torch.float32), min=1.0)
    m = _trail(mask, data.dim())
    if pt in ("sum", "average", "sqrt"):
        s = torch.sum(torch.where(m, data, 0), dim=1)
        if pt == "sum":
            return s
        div = lensf if pt == "average" else torch.sqrt(lensf)
        return s / div.reshape(col)
    if pt == "max":
        return torch.amax(torch.where(m, data, -torch.inf), dim=1)
    if pt == "min":
        return torch.amin(torch.where(m, data, torch.inf), dim=1)
    if pt == "first":
        return data[:, 0]
    if pt == "last":
        if lens is None:
            return data[:, -1]
        i = torch.clamp(lens - 1, min=0).reshape((-1, 1) + col[1:])
        return torch.take_along_dim(data, i, dim=1).squeeze(1)
    raise ValueError(f"bad pool_type {pt}")


def sequence_pool(x, pool_type="sum", lengths=None, pad_value=0.0,
                  name=None):
    """sum / average / sqrt / max / min / first / last over each row's
    valid prefix (sequence_pool_op.cc)."""
    args = (x,) + ((lengths,) if lengths is not None else ())
    return apply("sequence_pool", _pool, *args, pt=pool_type.lower())


def sequence_first_step(x, lengths=None):
    return sequence_pool(x, "first", lengths)


def sequence_last_step(x, lengths=None):
    return sequence_pool(x, "last", lengths)


def _softmax(data, *rest):
    logits = data
    if rest:
        logits = torch.where(_valid(rest[0], data.shape[1], data.device),
                             data, -torch.inf)
    out = torch.softmax(logits, dim=1)
    return torch.where(torch.isfinite(logits), out, 0.0)


def sequence_softmax(x, lengths=None, name=None):
    """Softmax over each valid prefix, 0 on the padding
    (sequence_softmax_op.cc)."""
    args = (x,) + ((lengths,) if lengths is not None else ())
    return apply("sequence_softmax", _softmax, *args)


def _reverse(data, *rest):
    T = data.shape[1]
    r = torch.arange(T, device=data.device)
    if not rest:
        idx = r.flip(0).expand(data.shape[:2])
    else:
        lens = rest[0]
        idx = torch.where(r[None, :] < lens[:, None],
                          lens[:, None] - 1 - r[None, :], r[None, :])
    return torch.take_along_dim(data, _trail(idx.long(), data.dim()), dim=1)


def sequence_reverse(x, lengths=None, name=None):
    """Reverse each valid prefix; the padding stays where it is
    (sequence_reverse_op.cc)."""
    args = (x,) + ((lengths,) if lengths is not None else ())
    return apply("sequence_reverse", _reverse, *args)


def _take_rows(data, lens, idx):
    return data[idx.to(data.device)]


def sequence_expand(x, y_lengths, ref_level=0, name=None):
    """Row ``i`` of ``x`` repeated ``y_lengths[i]`` times along axis 0
    (sequence_expand_op.cc); the counts are read on the host."""
    reps = _host("sequence_expand", y_lengths).astype(np.int64)
    idx = torch.from_numpy(np.repeat(np.arange(reps.shape[0]), reps))
    return apply("sequence_expand", _take_rows, x, y_lengths, idx=idx)


def _expand_as(data, _, rep):
    return torch.repeat_interleave(data, rep, dim=0)


def sequence_expand_as(x, y, name=None):
    """Each row of ``x`` repeated ``len(y) // len(x)`` times
    (sequence_expand_as_op.cc)."""
    n, b = int(_raw(y).shape[0]), int(_raw(x).shape[0])
    if n % b != 0:
        raise ValueError(f"cannot expand {b} rows to {n}")
    return apply("sequence_expand_as", _expand_as, x, y, rep=n // b)


def _concat(*args, k, T_out):
    datas, ls = args[:k], args[k:]
    B = datas[0].shape[0]
    dev = datas[0].device
    total = ls[0]
    for n in ls[1:]:
        total = total + n
    out = torch.zeros((B, T_out) + tuple(datas[0].shape[2:]),
                      dtype=datas[0].dtype, device=dev)
    offset = torch.zeros((B,), dtype=torch.long, device=dev)
    b_idx = torch.arange(B, device=dev)[:, None]
    for d, n in zip(datas, ls):
        t = torch.arange(d.shape[1], device=dev)[None, :]
        valid = t < n[:, None]
        dest = torch.where(valid, offset[:, None] + t, T_out - 1)
        contrib = torch.where(_trail(valid, d.dim()), d, 0)
        out = out.index_put((b_idx.expand_as(dest), dest), contrib,
                            accumulate=True)
        offset = offset + n.long()
    return out, total


def sequence_concat(xs: Sequence, lengths: Sequence, name=None):
    """Row ``b`` of the result is ``x1[b][:l1[b]] ++ x2[b][:l2[b]] ++
    ...``, padded to the summed widths (sequence_concat_op.cc); returns
    ``(data, lengths)``."""
    k = len(xs)
    T_out = sum(int(_raw(x).shape[1]) for x in xs)
    return apply("sequence_concat", _concat, *(list(xs) + list(lengths)),
                 k=k, T_out=T_out)


def _slice(data, off, ln):
    T = data.shape[1]
    t = torch.arange(T, device=data.device)[None, :]
    src = torch.clamp(off[:, None] + t, 0, T - 1)
    got = torch.take_along_dim(data, _trail(src.long(), data.dim()), dim=1)
    return torch.where(_trail(t < ln[:, None], data.dim()), got, 0), ln


def sequence_slice(x, offset, length, name=None):
    """Per-row ``[offset, offset + length)``, packed to the left
    (sequence_slice_op.cc); returns ``(data, lengths)``."""
    return apply("sequence_slice", _slice, x, offset, length)


def _enumerate(ids, *rest, w, pad_value):
    T = ids.shape[1]
    t = torch.arange(T, device=ids.device)[:, None] + \
        torch.arange(w, device=ids.device)[None, :]          # [T, w]
    limit = rest[0][:, None, None] if rest else T
    vals = ids[:, torch.clamp(t, max=T - 1)]                 # [B, T, w]
    return torch.where(t[None] < limit, vals,
                       torch.full((), pad_value, dtype=ids.dtype,
                                  device=ids.device))


def sequence_enumerate(x, win_size, pad_value=0, lengths=None, name=None):
    """Sliding windows of ids, ``[B, T]`` to ``[B, T, win_size]``
    (sequence_enumerate_op.cc)."""
    args = (x,) + ((lengths,) if lengths is not None else ())
    return apply("sequence_enumerate", _enumerate, *args, w=int(win_size),
                 pad_value=pad_value)


def _erase(ids, *rest, toks):
    B, T = ids.shape
    lens = rest[0] if rest else None
    valid = _valid(lens, T, ids.device) if lens is not None else \
        torch.ones((B, T), dtype=torch.bool, device=ids.device)
    keep = valid & ~torch.isin(ids, toks.to(ids.device, ids.dtype))
    new_len = keep.sum(dim=1).to(lens.dtype if lens is not None
                                 else torch.int64)
    dest = torch.where(keep, torch.cumsum(keep.long(), dim=1) - 1, T - 1)
    out = torch.zeros_like(ids).scatter_reduce(
        1, dest, torch.where(keep, ids, 0), "amax")
    return out, new_len


def sequence_erase(x, tokens, lengths=None, name=None):
    """Drop the listed token ids from each row, packing the rest to the
    left; returns ``(data, lengths)`` at the padded shape
    (sequence_erase_op.cc)."""
    toks = torch.from_numpy(np.asarray(tokens).reshape(-1).astype(np.int64))
    args = (x,) + ((lengths,) if lengths is not None else ())
    return apply("sequence_erase", _erase, *args, toks=toks)


def _conv(data, w, *rest, has_bias, has_lens, cl, cs):
    it = iter(rest)
    b = next(it) if has_bias else None
    lens = next(it) if has_lens else None
    B, T, D = data.shape
    r = torch.arange(T, device=data.device)
    cols = []
    for k in range(cl):
        t = r + cs + k
        ok = ((t >= 0) & (t < T))[None, :]
        if lens is not None:
            ok = ok & (t[None, :] < lens[:, None])
        vals = data[:, torch.clamp(t, 0, T - 1), :]
        cols.append(torch.where(ok.expand(B, T)[..., None], vals, 0.0))
    out = torch.cat(cols, dim=-1) @ w                        # [B, T, H]
    if b is not None:
        out = out + b
    if lens is not None:
        out = torch.where((r[None, :] < lens[:, None])[..., None], out, 0.0)
    return out


def sequence_conv(x, weight, bias=None, context_length=3, context_start=None,
                  context_stride=1, lengths=None, name=None):
    """Context-window projection (sequence_conv_op.cc): each step's rows
    ``[t + start, t + start + length)`` (zeros outside the valid prefix)
    concatenated and multiplied by ``weight [length * D, H]``."""
    cl = int(context_length)
    cs = int(context_start) if context_start is not None else \
        -((cl - 1) // 2)
    args = [x, weight] + ([bias] if bias is not None else []) + \
        ([lengths] if lengths is not None else [])
    return apply("sequence_conv", _conv, *args, has_bias=bias is not None,
                 has_lens=lengths is not None, cl=cl, cs=cs)


def _im2seq(img, kernels, strides, paddings):
    p = torch.nn.functional.pad(img, (paddings[2], paddings[3],
                                      paddings[0], paddings[1]))
    B, C = p.shape[:2]
    cols = torch.nn.functional.unfold(p, tuple(kernels),
                                      stride=tuple(strides))
    return cols.transpose(1, 2).reshape(-1, C * kernels[0] * kernels[1])


def im2sequence(x, kernels, strides=(1, 1), paddings=(0, 0, 0, 0),
                name=None):
    """NCHW image to patch rows ``[B * out_h * out_w, kh * kw * C]``
    (im2sequence_op.cc), channel-major within a row."""
    return apply("im2sequence", _im2seq, x, kernels=tuple(kernels),
                 strides=tuple(strides), paddings=tuple(paddings))
