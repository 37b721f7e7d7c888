"""Pooling (counterpart of ``paddle_tpu/nn/functional/pooling.py``:
``max_pool1d/2d/3d``, ``avg_pool1d/2d/3d``, ``adaptive_avg_pool1d/2d/3d``
and ``adaptive_max_pool1d/2d/3d``).

The JAX package pools with ``lax.reduce_window`` outside any Pallas
kernel; the port's counterparts are ``torch.nn.functional`` pooling
calls (cuDNN or ATen's kernels on the card). Layout NCL, NCHW or NCDHW,
or channels last with ``data_format``. Padding takes the JAX package's
forms (``_pool_nd``, ``:25-66``): an int, one value per spatial dim,
``2n`` per-side pads ``[lo0, hi0, lo1, hi1, ...]``, or
``"SAME"``/``"VALID"`` (XLA's: output ``ceil(in / stride)``, the odd
pixel on the high side). ``ceil_mode`` widens each high pad by
``stride - 1``, as the JAX package does, so a window may lie wholly in
the padding, where torch's own ``ceil_mode`` would drop it. Max pooling
pads with ``-inf``; average pooling sums zeros, then divides by the
window's size (``exclusive=False``) or by the count of its elements that
are not padding (``exclusive``, the default; the JAX package divides by
the window's size when there is no padding at all). Where the pads are
symmetric, at most half the window, and not widened by ``ceil_mode``,
torch's own ``padding`` computes exactly that and the input is not
copied; otherwise the input is padded first.

The maximum's gradient goes to the first maximal element of each window
in row-major order, as ``reduce_window``'s (``select_and_scatter`` with
``>=``) does. Adaptive bins are ``[floor(i * in / out),
ceil((i + 1) * in / out))`` (the JAX package's ``_adaptive_bounds``),
torch's own. ``max_pool2d(return_mask=True)`` also returns the JAX
package's index (``_max_pool_indices``, ``:109-134``): per window the
position ``h * W + w`` in the unpadded input of its first maximum, -1
where the window holds nothing above ``-inf``. Among equal maxima the
first is the JAX package's as XLA evaluates it: in row-major order, but
in column-major order in a window two wide with padding at its sides.
Like the JAX package's, it pads by ``padding`` alone (``ceil_mode`` does
not widen it). The JAX package takes ``return_mask`` of the other max pools and
``divisor_override`` and never reads them: here they raise for any value
but their default. Each function runs through the funnel under the
reference's op name (``pool2d_max``, ``pool3d_avg``,
``adaptive_pool2d_max``, ``max_pool2d_index``, ...).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.dispatch import apply
from .conv import _flat_pads, _pads, _tuplize

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d"]

_MAX = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _never_read(what: str):
    return NotImplementedError(
        f"{what}: the JAX package takes it and never reads it")


def _pool(n, kind, x, kernel_size, stride, padding, ceil_mode,
          exclusive=True, channel_last=False):
    return apply(f"pool{n}d_{kind}", _pool_nd, x, n=n, kind=kind,
                 kernel_size=kernel_size, stride=stride, padding=padding,
                 ceil_mode=ceil_mode, exclusive=exclusive,
                 channel_last=channel_last)


def _pool_nd(x, n, kind, kernel_size, stride, padding, ceil_mode,
             exclusive, channel_last):
    """The JAX package's ``_pool_nd``; a 1-D pool runs as a 2-D one over
    a height of 1."""
    ks = _tuplize(kernel_size, n)
    st = _tuplize(stride if stride is not None else kernel_size, n)
    if channel_last:
        x = torch.movedim(x, -1, 1)
    pads = _pads(padding, n, x.shape[2:], ks, st, (1,) * n)
    if ceil_mode and not isinstance(padding, str):
        pads = [(lo, hi + s - 1) for (lo, hi), s in zip(pads, st)]
    m = n
    if n == 1:
        x, ks, st, pads, m = x.unsqueeze(2), (1,) + ks, (1,) + st, \
            [(0, 0)] + pads, 2
    native = all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, ks))
    sym = tuple(lo for lo, _ in pads)
    if kind == "max":
        out = _MAX[m](x, ks, st, sym) if native else \
            _MAX[m](F.pad(x, _flat_pads(pads), value=float("-inf")), ks, st)
    elif not exclusive or all(p == (0, 0) for p in pads):
        # the JAX package divides by the window's size
        out = _AVG[m](x, ks, st, sym, count_include_pad=True) \
            if native else _AVG[m](F.pad(x, _flat_pads(pads)), ks, st)
    elif native:
        out = _AVG[m](x, ks, st, sym, count_include_pad=False)
    else:
        # the window's sum over the count of its elements that are not pads
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        out = (_AVG[m](F.pad(x, _flat_pads(pads)), ks, st,
                       divisor_override=1)
               / _AVG[m](F.pad(ones, _flat_pads(pads)), ks, st,
                         divisor_override=1))
    if n == 1:
        out = out.squeeze(2)
    return torch.movedim(out, 1, -1) if channel_last else out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    """Max over windows of ``[N, C, L]``; op ``pool1d_max``."""
    if return_mask:
        raise _never_read("max_pool1d(return_mask=True)")
    return _pool(1, "max", x, kernel_size, stride, padding, ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """Max over windows of ``[N, C, H, W]`` (``:73``); op ``pool2d_max``;
    with ``return_mask`` also the maxima's index (module docstring), op
    ``max_pool2d_index``."""
    channel_last = data_format == "NHWC"
    out = _pool(2, "max", x, kernel_size, stride, padding, ceil_mode,
                channel_last=channel_last)
    if not return_mask:
        return out
    return out, apply("max_pool2d_index", _max_pool_indices, x,
                      kernel_size=kernel_size, stride=stride,
                      padding=padding, channel_last=channel_last)


def _max_pool_indices(x, kernel_size, stride, padding, channel_last):
    ks = _tuplize(kernel_size, 2)
    st = _tuplize(stride if stride is not None else kernel_size, 2)
    if channel_last:
        x = torch.movedim(x, -1, 1)
    h, w = x.shape[2], x.shape[3]
    pads = [(0, 0)] * 2 if isinstance(padding, str) else \
        _pads(padding, 2, x.shape[2:], ks, st, (1, 1))
    win = F.pad(x.detach(), _flat_pads(pads), value=float("-inf")) \
        .unfold(2, ks[0], st[0]).unfold(3, ks[1], st[1])
    # the JAX package keeps the first maximum it meets (a strict ``>``);
    # XLA meets a window's elements in row-major order, but column by
    # column in a window two wide with padding on its sides
    by_col = ks[1] == 2 and pads[1][0] > 0
    if by_col:
        win = win.transpose(4, 5)
    top, pos = win.flatten(4).max(dim=4)    # torch.max: the first maximum
    dev = x.device
    oy = torch.arange(win.shape[2], device=dev) * st[0] - pads[0][0]
    ox = torch.arange(win.shape[3], device=dev) * st[1] - pads[1][0]
    inner = ks[0] if by_col else ks[1]
    major, minor = torch.div(pos, inner, rounding_mode="floor"), pos % inner
    row = oy[:, None] + (minor if by_col else major)
    col = ox[None, :] + (major if by_col else minor)
    idx = torch.where(top > float("-inf"), row * w + col,
                      torch.full_like(pos, -1))
    return torch.movedim(idx, 1, -1) if channel_last else idx


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    """Max over windows of ``[N, C, D, H, W]``; op ``pool3d_max``."""
    if return_mask:
        raise _never_read("max_pool3d(return_mask=True)")
    return _pool(3, "max", x, kernel_size, stride, padding, ceil_mode,
                 channel_last=data_format == "NDHWC")


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    """Mean over windows of ``[N, C, L]``; op ``pool1d_avg``."""
    return _pool(1, "avg", x, kernel_size, stride, padding, ceil_mode,
                 exclusive=exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """Mean over windows of ``[N, C, H, W]`` (``:95``); op
    ``pool2d_avg``."""
    if divisor_override is not None:
        raise _never_read("avg_pool2d(divisor_override=...)")
    return _pool(2, "avg", x, kernel_size, stride, padding, ceil_mode,
                 exclusive=exclusive, channel_last=data_format == "NHWC")


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    """Mean over windows of ``[N, C, D, H, W]``; op ``pool3d_avg``."""
    if divisor_override is not None:
        raise _never_read("avg_pool3d(divisor_override=...)")
    return _pool(3, "avg", x, kernel_size, stride, padding, ceil_mode,
                 exclusive=exclusive, channel_last=data_format == "NDHWC")


_ADAPTIVE = {("avg", 1): F.adaptive_avg_pool1d,
             ("avg", 2): F.adaptive_avg_pool2d,
             ("avg", 3): F.adaptive_avg_pool3d,
             ("max", 1): F.adaptive_max_pool1d,
             ("max", 2): F.adaptive_max_pool2d,
             ("max", 3): F.adaptive_max_pool3d}


def _adaptive(n, kind, x, output_size, channel_last=False):
    return apply(f"adaptive_pool{n}d_{kind}", _adaptive_nd, x, n=n,
                 kind=kind, output_size=output_size,
                 channel_last=channel_last)


def _adaptive_nd(x, n, kind, output_size, channel_last):
    if channel_last:
        x = torch.movedim(x, -1, 1)
    out = _ADAPTIVE[kind, n](x, _tuplize(output_size, n))
    return torch.movedim(out, 1, -1) if channel_last else out


def adaptive_avg_pool1d(x, output_size, name=None):
    """Mean over ``output_size`` adaptive bins of ``[N, C, L]``; op
    ``adaptive_pool1d_avg``."""
    return _adaptive(1, "avg", x, output_size)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Mean over ``output_size`` adaptive bins of ``[N, C, H, W]``
    (``:183``); op ``adaptive_pool2d_avg``."""
    return _adaptive(2, "avg", x, output_size,
                     channel_last=data_format == "NHWC")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    """Mean over adaptive bins of ``[N, C, D, H, W]``; op
    ``adaptive_pool3d_avg``."""
    return _adaptive(3, "avg", x, output_size,
                     channel_last=data_format == "NDHWC")


def _adaptive_max(n, x, output_size, return_mask):
    if return_mask:
        raise _never_read(f"adaptive_max_pool{n}d(return_mask=True)")
    return _adaptive(n, "max", x, output_size)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    """Max over adaptive bins of ``[N, C, L]``; op
    ``adaptive_pool1d_max``."""
    return _adaptive_max(1, x, output_size, return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    """Max over adaptive bins of ``[N, C, H, W]``; op
    ``adaptive_pool2d_max``."""
    return _adaptive_max(2, x, output_size, return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    """Max over adaptive bins of ``[N, C, D, H, W]``; op
    ``adaptive_pool3d_max``."""
    return _adaptive_max(3, x, output_size, return_mask)
