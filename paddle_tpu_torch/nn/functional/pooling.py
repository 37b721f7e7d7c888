"""Pooling (counterpart of ``paddle_tpu/nn/functional/pooling.py``:
``max_pool1d/2d``, ``avg_pool1d/2d`` and ``adaptive_avg_pool1d/2d``).

The JAX package pools with ``lax.reduce_window`` outside any Pallas
kernel; the port's counterparts are ``torch.nn.functional`` pooling
calls (cuDNN or ATen's kernels on the card). Layout NCHW (NCL for 1-D),
or NHWC with ``data_format``. Padding takes the JAX package's forms
(``_pool_nd``, ``:25-66``): an int, one value per spatial dim, ``2n``
per-side pads ``[lo0, hi0, lo1, hi1]``, or ``"SAME"``/``"VALID"`` (XLA's:
output ``ceil(in / stride)``, the odd pixel on the high side).
``ceil_mode`` widens each high pad by ``stride - 1``, as the JAX package
does, so a window may lie wholly in the padding, where torch's own
``ceil_mode`` would drop it. Max pooling pads with ``-inf``; average
pooling sums zeros, then divides by the window's size
(``exclusive=False``) or by the count of its elements that are not
padding (``exclusive``, the default; the JAX package divides by the
window's size when there is no padding at all). Where the pads are
symmetric, at most half the window, and not widened by ``ceil_mode``,
torch's own ``padding`` computes exactly that and the input is not
copied; otherwise the input is padded first.

The maximum's gradient goes to the first maximal element of each window
in row-major order, as ``reduce_window``'s (``select_and_scatter`` with
``>=``) does. ``adaptive_avg_pool`` bins are ``[floor(i * in / out),
ceil((i + 1) * in / out))`` (the JAX package's ``_adaptive_bounds``),
torch's own. ``return_mask=True`` (the argmax indices) and
``divisor_override`` are not ported yet (ROADMAP.md queue A3); the JAX
package accepts ``divisor_override`` and never reads it, so it raises
here rather than be ignored. Each function consults the AMP hook under
the reference's op name first (``pool2d_max``, ``pool2d_avg``,
``adaptive_pool2d_avg``, ...).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import amp
from .conv import _pads, _tuplize

__all__ = ["max_pool1d", "max_pool2d", "avg_pool1d", "avg_pool2d",
           "adaptive_avg_pool1d", "adaptive_avg_pool2d"]


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: a later slice of the port (ROADMAP.md "
        f"queue A3)")


def _padded(x, pads, value):
    """``x`` padded with ``value`` on its last two dims."""
    (top, bottom), (left, right) = pads
    return F.pad(x, (left, right, top, bottom), value=value)


def _pool_nd(n, kind, x, kernel_size, stride, padding, ceil_mode,
             exclusive=True, channel_last=False):
    """The JAX package's ``_pool_nd`` for n = 1, 2; a 1-D pool runs as a
    2-D one over a height of 1."""
    (x,) = amp.cast_inputs(f"pool{n}d_{kind}", x)
    ks = _tuplize(kernel_size, n)
    st = _tuplize(stride if stride is not None else kernel_size, n)
    if channel_last:
        x = torch.movedim(x, -1, 1)
    pads = _pads(padding, n, x.shape[2:], ks, st, (1,) * n)
    if ceil_mode and not isinstance(padding, str):
        pads = [(lo, hi + s - 1) for (lo, hi), s in zip(pads, st)]
    if n == 1:
        x, ks, st, pads = x.unsqueeze(2), (1,) + ks, (1,) + st, \
            [(0, 0)] + pads
    native = all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, ks))
    sym = tuple(lo for lo, _ in pads)
    if kind == "max":
        out = F.max_pool2d(x, ks, st, sym) if native else \
            F.max_pool2d(_padded(x, pads, float("-inf")), ks, st)
    elif not exclusive or all(p == (0, 0) for p in pads):
        # the JAX package divides by the window's size
        out = F.avg_pool2d(x, ks, st, sym, count_include_pad=True) \
            if native else F.avg_pool2d(_padded(x, pads, 0.0), ks, st)
    elif native:
        out = F.avg_pool2d(x, ks, st, sym, count_include_pad=False)
    else:
        # the window's sum over the count of its elements that are not pads
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        out = (F.avg_pool2d(_padded(x, pads, 0.0), ks, st,
                            divisor_override=1)
               / F.avg_pool2d(_padded(ones, pads, 0.0), ks, st,
                              divisor_override=1))
    if n == 1:
        out = out.squeeze(2)
    return torch.movedim(out, 1, -1) if channel_last else out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    """Max over windows of ``[N, C, L]``; op ``pool1d_max``."""
    if return_mask:
        raise _not_ported("max_pool1d(return_mask=True)")
    return _pool_nd(1, "max", x, kernel_size, stride, padding, ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """Max over windows of ``[N, C, H, W]`` (``:73``); op ``pool2d_max``."""
    if return_mask:
        raise _not_ported("max_pool2d(return_mask=True)")
    return _pool_nd(2, "max", x, kernel_size, stride, padding, ceil_mode,
                    channel_last=data_format == "NHWC")


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    """Mean over windows of ``[N, C, L]``; op ``pool1d_avg``."""
    return _pool_nd(1, "avg", x, kernel_size, stride, padding, ceil_mode,
                    exclusive=exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """Mean over windows of ``[N, C, H, W]`` (``:95``); op
    ``pool2d_avg``."""
    if divisor_override is not None:
        raise _not_ported("avg_pool2d(divisor_override=...), which the JAX "
                          "package accepts and ignores,")
    return _pool_nd(2, "avg", x, kernel_size, stride, padding, ceil_mode,
                    exclusive=exclusive, channel_last=data_format == "NHWC")


def _adaptive(n, x, output_size, channel_last=False):
    (x,) = amp.cast_inputs(f"adaptive_pool{n}d_avg", x)
    if channel_last:
        x = torch.movedim(x, -1, 1)
    pool = F.adaptive_avg_pool1d if n == 1 else F.adaptive_avg_pool2d
    out = pool(x, _tuplize(output_size, n))
    return torch.movedim(out, 1, -1) if channel_last else out


def adaptive_avg_pool1d(x, output_size, name=None):
    """Mean over ``output_size`` adaptive bins of ``[N, C, L]``; op
    ``adaptive_pool1d_avg``."""
    return _adaptive(1, x, output_size)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Mean over ``output_size`` adaptive bins of ``[N, C, H, W]``
    (``:183``); op ``adaptive_pool2d_avg``."""
    return _adaptive(2, x, output_size, channel_last=data_format == "NHWC")
