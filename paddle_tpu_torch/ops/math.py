"""Math ops (counterpart of ``paddle_tpu/ops/math.py``, all of it): the
unary and binary elementwise tables, ``pow``, ``scale``, ``clip``,
``lerp``, ``stanh``, the matrix products, the reductions, search and
sort, indexing, gather and scatter, ``bincount``/``histogram``/
``unique``, the comparisons of whole tensors, the norms and the tail
(``increment`` ... ``unflatten``).

Each op runs through the funnel (``ops/dispatch.py``) under the
reference's op name (each table op under its own name, ``reduce_*``,
``matmul_v2``, ``arg_max``, ``top_k_v2``, ``p_norm``, ...): the tensors
the reference passes positionally go positionally, where AMP may cast
them; axes, counts and flags go as attributes. The binary ops take a
Python number on either side with the weak typing of both packages
(``x + 2`` keeps ``x``'s float type). Integer results are int64 where
the JAX package's are int32 (JAX runs without 64-bit types); ``mean`` of
an integer tensor is the default float type, as there.

Where torch's defaults part from what the JAX package returns, the
JAX package's results are kept: ``sort``/``argsort`` descending flip a
stable ascending sort (the last of equal entries first); ``topk`` and
``kthvalue`` take the lower index first on ties (a stable sort, not
``torch.topk``, whose tie order is not defined); ``median`` averages the
two middle values; ``mode`` is the smallest value of the longest run at
its first index; ``cummin`` returns the earliest index of each running
minimum and ``cummax`` its values only; reductions split the gradient
evenly over tied extremes (``amax``/``amin``), and ``maximum``/
``minimum`` give each side half at a tie. ``cross``'s default axis 9
means the first axis of size 3; ``gather`` flattens a 2-D index;
``scatter(overwrite=False)`` zeroes the rows it adds into.

The ops whose output shape depends on the data (``nonzero``,
``where(cond)``, ``masked_select``, ``unique``, ``unique_consecutive``,
``bincount``, ``where_index``) run on the device and return device
tensors, where the JAX package computes them on the host in NumPy; they
wait for the device and cannot be captured in a CUDA graph. Their input
goes to the funnel as an attribute, so AMP never casts it (the JAX
package runs them outside its funnel).
"""
from __future__ import annotations

import math as _pymath
import operator
import sys

import torch

from ..core import dtypes as _dt
from ..core.tensor import Tensor
from .dispatch import apply

_this = sys.modules[__name__]


def _num(v):
    return isinstance(v, (bool, int, float, complex))


def _as_tensor(v, like):
    """A Python number as a 0-d tensor of ``like``'s device whose type
    follows the weak typing of both packages."""
    return torch.full((), v, dtype=torch.result_type(like, v),
                      device=like.device)


def _two(f, promote=False):
    """``f`` over two operands, either of which may be a Python number;
    with ``promote`` both are cast to their common type first."""
    def impl(a, b):
        if _num(a):
            a = _as_tensor(a, b)
        elif _num(b):
            b = _as_tensor(b, a)
        if promote:
            d = torch.result_type(a, b)
            a, b = a.to(d), b.to(d)
        return f(a, b)
    return impl


def _logical(f):
    def impl(a, b):
        return f(torch.as_tensor(a), torch.as_tensor(b))
    return impl


def _floordiv(a, b):
    """``a // b``; for floats with a gradient, its values with the zero
    gradient of ``floor(a / b)`` (torch's floor division has none)."""
    out = a // b
    if out.is_floating_point() and (
            getattr(a, "requires_grad", False)
            or getattr(b, "requires_grad", False)):
        smooth = torch.floor(a / b)
        return smooth + (out - smooth).detach()
    return out


def _heaviside(a, b):
    """JAX's ``where(a < 0, 0, where(a > 0, 1, b))`` (torch's has no
    gradient)."""
    return torch.where(a < 0, torch.zeros_like(a),
                       torch.where(a > 0, torch.ones_like(a), b))


def _frac(x):
    return x - torch.trunc(x)


def _reciprocal(x):
    return 1.0 / x


def _real(x):
    return x.real if x.is_complex() else x


def _imag(x):
    return x.imag if x.is_complex() else torch.zeros_like(x)


def _round(x):
    return torch.round(x) if x.is_floating_point() else x


# reference: activation_op.cc and the per-op .cc files, one line each
_UNARY = {
    "abs": torch.abs, "exp": torch.exp, "expm1": torch.expm1,
    "log": torch.log, "log2": torch.log2, "log10": torch.log10,
    "log1p": torch.log1p, "sqrt": torch.sqrt, "rsqrt": torch.rsqrt,
    "square": torch.square, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "asin": torch.asin, "acos": torch.acos,
    "atan": torch.atan, "sinh": torch.sinh, "cosh": torch.cosh,
    "tanh": torch.tanh, "asinh": torch.asinh, "acosh": torch.acosh,
    "atanh": torch.atanh, "floor": torch.floor, "ceil": torch.ceil,
    "round": _round, "trunc": torch.trunc, "sign": torch.sign,
    "reciprocal": _reciprocal, "erf": torch.erf, "erfinv": torch.erfinv,
    "lgamma": torch.lgamma, "digamma": torch.digamma,
    "sigmoid": torch.sigmoid,
    "logsigmoid": torch.nn.functional.logsigmoid, "neg": torch.neg,
    "conj": torch.conj, "angle": torch.angle, "real": _real,
    "imag": _imag, "isnan": torch.isnan, "isinf": torch.isinf,
    "isfinite": torch.isfinite, "logical_not": torch.logical_not,
    "bitwise_not": torch.bitwise_not, "frac": _frac,
}

# reference: operators/elementwise/elementwise_*_op.cc; Python's
# operators where they exist, so a number works on either side
_BINARY = {
    "add": operator.add, "subtract": operator.sub,
    "multiply": operator.mul, "divide": operator.truediv,
    "floor_divide": _floordiv, "mod": operator.mod,
    "remainder": operator.mod, "floor_mod": operator.mod,
    "pow_t": operator.pow,
    "maximum": _two(torch.maximum), "minimum": _two(torch.minimum),
    "fmax": _two(torch.fmax), "fmin": _two(torch.fmin),
    "atan2": _two(torch.atan2), "hypot": _two(torch.hypot, True),
    "logical_and": _logical(torch.logical_and),
    "logical_or": _logical(torch.logical_or),
    "logical_xor": _logical(torch.logical_xor),
    "bitwise_and": operator.and_, "bitwise_or": operator.or_,
    "bitwise_xor": operator.xor,
    "equal": operator.eq, "not_equal": operator.ne,
    "greater_than": operator.gt, "greater_equal": operator.ge,
    "less_than": operator.lt, "less_equal": operator.le,
    "nextafter": _two(torch.nextafter, True),
    "copysign": _two(torch.copysign, True),
    "heaviside": _two(_heaviside, True), "gcd": _two(torch.gcd),
    "lcm": _two(torch.lcm), "logaddexp": _two(torch.logaddexp, True),
}


def _make1(nm, f):
    def op(x, name=None):
        return apply(nm, f, x)
    op.__name__ = nm
    return op


def _make2(nm, f):
    def op(x, y, name=None):
        return apply(nm, f, x, y)
    op.__name__ = nm
    return op


for _name, _fn in _UNARY.items():
    setattr(_this, _name, _make1(_name, _fn))
for _name, _fn in _BINARY.items():
    setattr(_this, _name, _make2(_name, _fn))


def pow(x, y, name=None):
    return apply("pow", operator.pow, x, y)


def _scale(a, s, bias, bias_after_scale):
    return a * s + bias if bias_after_scale else (a + bias) * s


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """``x * scale + bias`` (or ``(x + bias) * scale``); ``scale`` may be
    a Tensor (reference: operators/scale_op.cc)."""
    out = apply("scale", _scale, x, scale, bias=bias,
                bias_after_scale=bias_after_scale)
    if act is not None:
        out = getattr(_this, act)(out)
    return out


def _clip(a, lo, hi):
    if lo is None and hi is None:
        return a.clone()
    return torch.clamp(a, lo, hi)


def clip(x, min=None, max=None, name=None):
    """``x`` clamped into ``[min, max]`` (either may be None or a
    Tensor)."""
    return apply("clip", _clip, x, min, max)


def _lerp(a, b, *w, weight):
    w = w[0] if w else weight
    return a + w * (b - a)


def lerp(x, y, weight, name=None):
    if isinstance(weight, (Tensor, torch.Tensor)):
        return apply("lerp", _lerp, x, y, weight, weight=None)
    return apply("lerp", _lerp, x, y, weight=weight)


def _stanh(a, scale_a, scale_b):
    return scale_b * torch.tanh(scale_a * a)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply("stanh", _stanh, x, scale_a=scale_a, scale_b=scale_b)


# -- matrix ops (reference: matmul_v2_op.cc, bmm_op.cc, addmm_op.cc, mv_op.cc,
# dot_op.cc, kron_op.cc, cross_op.cc, multiplex_op.cc) -------------------------

def _matmul(x, y, transpose_x, transpose_y):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def matmul(x, y, transpose_x: bool = False, transpose_y: bool = False,
           name=None):
    """``x @ y`` with paddle's transpose flags (each swaps the last two
    axes of a factor of two or more dims); op ``matmul_v2``."""
    return apply("matmul_v2", _matmul, x, y, transpose_x=transpose_x,
                 transpose_y=transpose_y)


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    return apply("bmm", torch.matmul, x, y)


def mv(x, vec, name=None):
    return apply("mv", torch.matmul, x, vec)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def dot(x, y, name=None):
    return apply("dot", _dot, x, y)


def _addmm(i, a, b, beta, alpha):
    return beta * i + alpha * torch.matmul(a, b)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply("addmm", _addmm, input, x, y, beta=beta, alpha=alpha)


def _outer(a, b):
    return torch.outer(a.reshape(-1), b.reshape(-1))


def outer(x, y, name=None):
    return apply("outer", _outer, x, y)


def inner(x, y, name=None):
    return apply("inner", torch.inner, x, y)


def kron(x, y, name=None):
    return apply("kron", torch.kron, x, y)


def _cross(a, b, axis):
    if axis == 9:
        axis = next(i for i, s in enumerate(a.shape) if s == 3)
    return torch.linalg.cross(a, b, dim=axis)


def cross(x, y, axis=9, name=None):
    """The cross product along ``axis``; the default 9 means the first
    axis of size 3 (reference: cross_op.cc)."""
    return apply("cross", _cross, x, y, axis=axis)


def _multiplex(idx, *xs):
    rows = torch.arange(xs[0].shape[0], device=idx.device)
    return torch.stack(xs, 0)[idx.reshape(-1).long(), rows]


def multiplex(inputs, index, name=None):
    """Row ``i`` of ``inputs[index[i]]`` (reference: multiplex_op.cc)."""
    return apply("multiplex", _multiplex, index, *inputs)


# -- reductions (reference: operators/reduce_ops/) -----------------------------

def _axes(axis, ndim):
    """torch's ``dim`` for paddle's ``axis``: every axis for None."""
    if isinstance(axis, (Tensor, torch.Tensor)):
        axis = axis.tolist()
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def _reduce(f, a, axis, keepdim):
    """``f`` over ``axis`` (every axis for None: torch's full reduction
    unless the dims are kept)."""
    if not a.dim():
        return a.clone()
    if axis is None and not keepdim:
        return f(a)
    return f(a, dim=_axes(axis, a.dim()), keepdim=keepdim)


def _over_last(f, a, axis, keepdim):
    """``f`` reducing the last axis, over ``axis`` moved to the end and
    merged into one (for the reductions torch takes one axis at a
    time); ``f``'s leading output axes (``quantile``'s q) stay first."""
    nd = a.dim()
    axes = sorted(ax % nd for ax in _axes(axis, nd)) if nd else []
    rest = [d for d in range(nd) if d not in axes]
    moved = a.permute(rest + axes).reshape(
        [a.shape[d] for d in rest] + [-1])
    out = f(moved)
    if keepdim:
        lead = list(out.shape[:out.dim() - len(rest)])
        out = out.reshape(lead + [1 if d in axes else a.shape[d]
                                  for d in range(nd)])
    return out


def _float(a):
    return a if a.is_floating_point() or a.is_complex() else \
        a.to(_dt.get_default_dtype())


def _sum(a, axis, keepdim, dtype):
    out = _reduce(torch.sum, a, axis, keepdim)
    return out.to(dtype) if dtype is not None else out


def _mean(a, axis, keepdim):
    return _reduce(torch.mean, _float(a), axis, keepdim)


def _amax(a, axis, keepdim):
    return _reduce(torch.amax, a, axis, keepdim)


def _amin(a, axis, keepdim):
    return _reduce(torch.amin, a, axis, keepdim)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    return apply("reduce_sum", _sum, x, axis=axis, keepdim=keepdim,
                 dtype=_dt.convert_dtype(dtype))


def mean(x, axis=None, keepdim=False, name=None):
    return apply("reduce_mean", _mean, x, axis=axis, keepdim=keepdim)


def _prod(a, axis, keepdim, dtype):
    out = _over_last(lambda m: torch.prod(m, -1), a, axis, keepdim)
    return out.to(dtype) if dtype is not None else out


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    return apply("reduce_prod", _prod, x, axis=axis, keepdim=keepdim,
                 dtype=_dt.convert_dtype(dtype))


def max(x, axis=None, keepdim=False, name=None):
    """The largest entries over ``axis``; the gradient splits evenly over
    tied maxima, as JAX's."""
    return apply("reduce_max", _amax, x, axis=axis, keepdim=keepdim)


def min(x, axis=None, keepdim=False, name=None):
    return apply("reduce_min", _amin, x, axis=axis, keepdim=keepdim)


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def _all(a, axis, keepdim):
    return _reduce(torch.all, a, axis, keepdim).to(torch.bool)


def _any(a, axis, keepdim):
    return _reduce(torch.any, a, axis, keepdim).to(torch.bool)


def all(x, axis=None, keepdim=False, name=None):
    return apply("reduce_all", _all, x, axis=axis, keepdim=keepdim)


def any(x, axis=None, keepdim=False, name=None):
    return apply("reduce_any", _any, x, axis=axis, keepdim=keepdim)


def _std(a, axis, unbiased, keepdim):
    return torch.std(_float(a), dim=_axes(axis, a.dim()) if a.dim() else
                     None, correction=1 if unbiased else 0, keepdim=keepdim)


def _var(a, axis, unbiased, keepdim):
    return torch.var(_float(a), dim=_axes(axis, a.dim()) if a.dim() else
                     None, correction=1 if unbiased else 0, keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply("std", _std, x, axis=axis, unbiased=unbiased,
                 keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply("var", _var, x, axis=axis, unbiased=unbiased,
                 keepdim=keepdim)


def _quantile(a, q, axis, keepdim, how, nan):
    f = torch.nanquantile if nan else torch.quantile
    a = _float(a)
    qt = q if not isinstance(q, (list, tuple)) else torch.tensor(
        q, dtype=a.dtype, device=a.device)
    return _over_last(lambda m: f(m, qt, dim=-1, interpolation=how), a,
                      axis, keepdim)


def median(x, axis=None, keepdim=False, name=None):
    """The median over ``axis``, the mean of the two middle values for an
    even count (``torch.median`` takes the lower)."""
    return apply("median", _quantile, x, q=0.5, axis=axis, keepdim=keepdim,
                 how="midpoint", nan=False)


def nanmedian(x, axis=None, keepdim=False, name=None):
    return apply("nanmedian", _quantile, x, q=0.5, axis=axis,
                 keepdim=keepdim, how="midpoint", nan=True)


def _nansum(a, axis, keepdim):
    return _reduce(torch.nansum, a, axis, keepdim)


def _nanmean(a, axis, keepdim):
    return _reduce(torch.nanmean, _float(a), axis, keepdim)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return apply("nansum", _nansum, x, axis=axis, keepdim=keepdim)


def nanmean(x, axis=None, keepdim=False, name=None):
    return apply("nanmean", _nanmean, x, axis=axis, keepdim=keepdim)


def quantile(x, q, axis=None, keepdim=False, name=None):
    if isinstance(q, (Tensor, torch.Tensor)):
        q = q.tolist()
    return apply("quantile", _quantile, x, q=q, axis=axis, keepdim=keepdim,
                 how="linear", nan=False)


def _logsumexp(a, axis, keepdim):
    a = _float(a)
    if not a.dim():
        return a.clone()
    return torch.logsumexp(a, dim=_axes(axis, a.dim()), keepdim=keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return apply("logsumexp", _logsumexp, x, axis=axis, keepdim=keepdim)


def _along(a, axis):
    """``a`` and the axis to scan: the flattened input for None."""
    return (a.reshape(-1), 0) if axis is None else (a, axis)


def _cumsum(a, axis, dtype):
    a, ax = _along(a, axis)
    out = torch.cumsum(a, ax)
    return out.to(dtype) if dtype is not None else out


def cumsum(x, axis=None, dtype=None, name=None):
    return apply("cumsum", _cumsum, x, axis=axis,
                 dtype=_dt.convert_dtype(dtype))


def _cumprod(a, axis, dtype):
    a, ax = _along(a, axis)
    out = torch.cumprod(a, ax)
    return out.to(dtype) if dtype is not None else out


def cumprod(x, dim=None, dtype=None, name=None):
    return apply("cumprod", _cumprod, x, axis=dim,
                 dtype=_dt.convert_dtype(dtype))


def _cummax(a, axis):
    a, ax = _along(a, axis)
    return torch.cummax(a, ax).values


def cummax(x, axis=None, dtype="int64", name=None):
    """The running maximum along ``axis`` (values only, as the JAX
    package returns)."""
    return apply("cummax", _cummax, x, axis=axis)


def _count_nonzero(a, axis, keepdim):
    axes = _axes(axis, a.dim())
    out = torch.count_nonzero(a, dim=axes) if a.dim() else \
        (a != 0).to(torch.int64)
    if keepdim:
        for ax in sorted(x % a.dim() for x in axes):
            out = out.unsqueeze(ax)
    return out


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return apply("count_nonzero", _count_nonzero, x, axis=axis,
                 keepdim=keepdim)


# -- search and sort (reference: arg_max_op.cc, argsort_op.cc, top_k_v2_op.cc,
# index_select_op.cc, masked_select_op.cc, where_op.cc, ...) ------------------

def _arg(f, a, axis, keepdim, dtype):
    if axis is None:
        return f(a.reshape(-1)).to(dtype)
    return f(a, dim=axis, keepdim=keepdim).to(dtype)


def _argmax(a, axis, keepdim, dtype):
    return _arg(torch.argmax, a, axis, keepdim, dtype)


def _argmin(a, axis, keepdim, dtype):
    return _arg(torch.argmin, a, axis, keepdim, dtype)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return apply("arg_max", _argmax, x, axis=axis, keepdim=keepdim,
                 dtype=_dt.convert_dtype(dtype))


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return apply("arg_min", _argmin, x, axis=axis, keepdim=keepdim,
                 dtype=_dt.convert_dtype(dtype))


def _argsort(a, axis, descending):
    idx = torch.sort(a, dim=axis, stable=True).indices
    return torch.flip(idx, [axis]) if descending else idx


def argsort(x, axis=-1, descending=False, name=None):
    """Indices of a stable ascending sort along ``axis``, flipped when
    ``descending`` (the last of equal entries first, as the JAX
    package's)."""
    return apply("argsort", _argsort, x, axis=axis, descending=descending)


def _sort(a, axis, descending):
    out = torch.sort(a, dim=axis, stable=True).values
    return torch.flip(out, [axis]) if descending else out


def sort(x, axis=-1, descending=False, name=None):
    return apply("sort", _sort, x, axis=axis, descending=descending)


def _topk(a, k, axis, largest):
    ax = a.dim() - 1 if axis is None else axis % a.dim()
    vals, idx = torch.sort(a, dim=ax, descending=largest, stable=True)
    return vals.narrow(ax, 0, k), idx.narrow(ax, 0, k)


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    """The ``k`` largest (or smallest) entries along ``axis`` (the last
    by default), sorted, and their int64 indices, the lower index first
    on ties; op ``top_k_v2``."""
    k = int(k.item() if isinstance(k, (Tensor, torch.Tensor)) else k)
    vals, idx = apply("top_k_v2", _topk, x, k=k, axis=axis, largest=largest)
    return vals, idx


def _kthvalue(a, k, axis, keepdim):
    vals, idx = torch.sort(a, dim=axis, stable=True)
    vals, idx = vals.select(axis, k - 1), idx.select(axis, k - 1)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    return apply("kthvalue", _kthvalue, x, k=int(k), axis=axis,
                 keepdim=keepdim)


def _mode(a, axis, keepdim):
    moved = torch.movedim(a, axis, -1)
    s = torch.sort(moved, dim=-1, stable=True).values
    n = s.shape[-1]
    start = torch.ones_like(s, dtype=torch.bool)
    start[..., 1:] = s[..., 1:] != s[..., :-1]
    grp = torch.cumsum(start.long(), -1) - 1
    counts = torch.zeros(s.shape[:-1] + (n,), dtype=torch.long,
                         device=a.device).scatter_add_(-1, grp,
                                                       torch.ones_like(grp))
    best = torch.argmax(counts, -1, keepdim=True)     # the first longest run
    pos = torch.argmax((grp == best).long(), -1, keepdim=True)
    val = torch.gather(s, -1, pos)
    idx = torch.argmax((moved == val).long(), -1, keepdim=True)
    vals = torch.gather(moved, -1, idx)               # gradient to idx
    vals, idx = vals.squeeze(-1), idx.squeeze(-1)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest among equally
    frequent ones) and the index of its first occurrence."""
    return apply("mode", _mode, x, axis=axis, keepdim=keepdim)


def _where(c, x, y):
    return torch.where(c.bool(), x, y)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=False)
    return apply("where", _where, condition, x, y)


def _nonzero(x, as_tuple):
    nz = torch.nonzero(x)
    return tuple(nz.unbind(1)) if as_tuple else nz


def nonzero(x, as_tuple=False):
    """The int64 coordinates ``[n, ndim]`` of the nonzero entries (a tuple
    of ``ndim`` vectors with ``as_tuple``), on ``x``'s device; the
    output shape depends on the data (module docstring)."""
    return apply("where_index", _nonzero, x=x, as_tuple=as_tuple)


def _masked_select(x, mask):
    return x[mask.bool().expand_as(x)]


def masked_select(x, mask, name=None):
    return apply("masked_select", _masked_select, x=x, mask=mask)


def _masked_fill(a, m, *v, value):
    v = v[0].to(a.dtype) if v else torch.full((), value, dtype=a.dtype,
                                              device=a.device)
    return torch.where(m.bool(), v, a)


def masked_fill(x, mask, value, name=None):
    if isinstance(value, (Tensor, torch.Tensor)):
        return apply("masked_fill", _masked_fill, x, mask, value, value=None)
    return apply("masked_fill", _masked_fill, x, mask, value=value)


def _take(a, i, axis):
    """``jnp.take`` along ``axis``: the index's shape replaces the axis."""
    axis = axis % a.dim()
    out = torch.index_select(a, axis, i.reshape(-1).long())
    return out.reshape(a.shape[:axis] + i.shape + a.shape[axis + 1:])


def index_select(x, index, axis=0, name=None):
    return apply("index_select", _take, x, index, axis=axis)


def _gather_along(a, i, axis):
    axis = axis % a.dim()
    shape = list(torch.broadcast_shapes(
        tuple(1 if d == axis else s for d, s in enumerate(a.shape)),
        tuple(1 if d == axis else s for d, s in enumerate(i.shape))))
    ishape = list(shape)
    ishape[axis] = i.shape[axis]
    ashape = list(shape)
    ashape[axis] = a.shape[axis]
    return torch.gather(a.expand(ashape), axis, i.long().expand(ishape))


def index_sample(x, index):
    """Per-row gather (reference: operators/index_sample_op.cc)."""
    return apply("index_sample", _gather_along, x, index, axis=1)


def take_along_axis(arr, indices, axis, name=None):
    return apply("take_along_axis", _gather_along, arr, indices, axis=axis)


def _put_along(a, i, *v, values, axis, reduce):
    v = (v[0] if v else torch.as_tensor(values, device=a.device)).to(a.dtype)
    i = i.long()
    v = v.expand(i.shape) if v.shape != i.shape else v
    if reduce == "assign":
        return torch.scatter(a, axis, i, v)
    if reduce == "add":
        return torch.scatter_add(a, axis, i, v)
    if reduce in ("mul", "multiply"):
        return torch.scatter_reduce(a, axis, i, v, "prod")
    raise ValueError(reduce)


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    if isinstance(values, (Tensor, torch.Tensor)):
        return apply("put_along_axis", _put_along, arr, indices, values,
                     values=None, axis=axis, reduce=reduce)
    return apply("put_along_axis", _put_along, arr, indices, values=values,
                 axis=axis, reduce=reduce)


def _gather(a, i, axis):
    return _take(a, i.reshape(-1) if i.dim() > 1 else i, axis)


def gather(x, index, axis=0, name=None):
    """Slices of ``x`` along ``axis`` at ``index`` (a 2-D index is
    flattened, as the reference's)."""
    axis = int(axis.item() if isinstance(axis, (Tensor, torch.Tensor))
               else axis)
    return apply("gather", _gather, x, index, axis=axis)


def _nd_index(i):
    return tuple(i.long().unbind(-1))


def _gather_nd(a, i):
    return a[_nd_index(i)]


def gather_nd(x, index, name=None):
    return apply("gather_nd", _gather_nd, x, index)


def _scatter(a, i, u, overwrite):
    i = (i.reshape(-1).long(),)
    u = u.to(a.dtype)
    if overwrite:
        return torch.index_put(a, i, u)
    z = torch.index_put(a, i, torch.zeros_like(u))
    return torch.index_put(z, i, u, accumulate=True)


def scatter(x, index, updates, overwrite=True, name=None):
    """``x`` with rows ``index`` replaced by ``updates`` or, with
    ``overwrite=False``, zeroed and then summed into (duplicate indices
    accumulate; with ``overwrite`` their winner is not defined)."""
    return apply("scatter", _scatter, x, index, updates, overwrite=overwrite)


def _scatter_nd_add(a, i, u):
    return torch.index_put(a, _nd_index(i), u.to(a.dtype), accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    return apply("scatter_nd_add", _scatter_nd_add, x, index, updates)


def _scatter_nd(i, u, shape):
    return torch.index_put(torch.zeros(shape, dtype=u.dtype,
                                       device=u.device), _nd_index(i), u,
                           accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    return apply("scatter_nd", _scatter_nd, index, updates,
                 shape=[int(s) for s in (shape.tolist() if isinstance(
                     shape, (Tensor, torch.Tensor)) else shape)])


def _bincount(x, weights, minlength):
    return torch.bincount(x, weights, minlength)


def bincount(x, weights=None, minlength=0, name=None):
    return apply("bincount", _bincount, x=x, weights=weights,
                 minlength=minlength)


def _histogram(a, bins, lo, hi):
    return torch.histc(_float(a), bins=bins, min=lo, max=hi).long()


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts in ``bins`` equal bins over ``[min, max]`` (the data's range
    when both are 0), the last bin closed."""
    return apply("histogram", _histogram, input, bins=bins, lo=min, hi=max)


def _unique(x, return_index, return_inverse, return_counts, axis):
    vals, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    out = [vals]
    if return_index:
        flat = inv.reshape(-1)
        first = torch.full((vals.shape[0] if axis is not None
                            else vals.numel(),), flat.numel(),
                           dtype=torch.int64, device=x.device)
        out.append(first.scatter_reduce(
            0, flat, torch.arange(flat.numel(), device=x.device), "amin"))
    if return_inverse:
        out.append(inv)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """The sorted unique entries (rows along ``axis``) and, as asked, the
    first index of each, the inverse (in ``x``'s shape for ``axis``
    None, as NumPy's) and the counts."""
    return apply("unique", _unique, x=x, return_index=return_index,
                 return_inverse=return_inverse, return_counts=return_counts,
                 axis=axis)


def _unique_consecutive(x, return_inverse, return_counts, axis):
    if axis is None:
        x = x.reshape(-1)
    vals, inv, counts = torch.unique_consecutive(
        x, return_inverse=True, return_counts=True, dim=axis)
    out = [vals]
    if return_inverse:
        out.append(inv)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, name=None):
    return apply("unique_consecutive", _unique_consecutive, x=x,
                 return_inverse=return_inverse, return_counts=return_counts,
                 axis=axis)


def _isclose(a, b, rtol, atol, equal_nan):
    return torch.isclose(a, b.to(a.dtype) if b.dtype != a.dtype else b,
                         rtol=rtol, atol=atol, equal_nan=equal_nan)


def _allclose(a, b, rtol, atol, equal_nan):
    return _isclose(a, b, rtol, atol, equal_nan).all()


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply("allclose", _allclose, x, y, rtol=rtol, atol=atol,
                 equal_nan=equal_nan)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply("isclose", _isclose, x, y, rtol=rtol, atol=atol,
                 equal_nan=equal_nan)


def _equal_all(a, b):
    if a.shape != b.shape:
        return torch.zeros((), dtype=torch.bool, device=a.device)
    return (a == b).all()


def equal_all(x, y, name=None):
    return apply("equal_all", _equal_all, x, y)


def _is_empty(x):
    return torch.full((), x.numel() == 0, dtype=torch.bool, device=x.device)


def is_empty(x, name=None):
    return apply("is_empty", _is_empty, x=x)


def _searchsorted(s, v, right, out_int32):
    return torch.searchsorted(s, v, right=right, out_int32=out_int32)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return apply("searchsorted", _searchsorted, sorted_sequence, values,
                 right=right, out_int32=out_int32)


# -- norms (reference: p_norm_op.cc, frobenius_norm_op.cc,
# squared_l2_norm_op.cc, clip_by_norm_op.cc, dist_op.cc) -----------------------

def _p_norm(a, p, axis, keepdim):
    if p == "fro" and axis is None:
        return torch.sqrt(torch.sum(a * a))
    dims = _axes(axis, a.dim())
    if p == "fro":
        return torch.sqrt(torch.sum(a * a, dim=dims, keepdim=keepdim))
    if p in (_pymath.inf, "inf"):
        return torch.amax(torch.abs(a), dim=dims, keepdim=keepdim)
    if p in (-_pymath.inf, "-inf"):
        return torch.amin(torch.abs(a), dim=dims, keepdim=keepdim)
    if p == 0:
        return torch.sum((a != 0).to(a.dtype), dim=dims, keepdim=keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(a), p), dim=dims,
                               keepdim=keepdim), 1.0 / p)


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    return apply("p_norm", _p_norm, x, p=p, axis=axis, keepdim=keepdim)


def _dist(a, b, p):
    d = torch.abs(a - b)
    if p == 0:
        return torch.sum((d != 0).to(a.dtype))
    if p == _pymath.inf:
        return torch.amax(d)
    if p == -_pymath.inf:
        return torch.amin(d)
    return torch.pow(torch.sum(torch.pow(d, p)), 1.0 / p)


def dist(x, y, p=2, name=None):
    return apply("dist", _dist, x, y, p=p)


def _clip_by_norm(a, max_norm):
    n = torch.sqrt(torch.sum(a * a))
    return torch.where(n > max_norm, a * (max_norm / n), a)


def clip_by_norm(x, max_norm, name=None):
    return apply("clip_by_norm", _clip_by_norm, x, max_norm=max_norm)


def _squared_l2_norm(a):
    return torch.sum(a * a)


def squared_l2_norm(x):
    return apply("squared_l2_norm", _squared_l2_norm, x)


def _trace(a, offset, axis1, axis2):
    return torch.diagonal(a, offset, axis1, axis2).sum(-1)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply("trace", _trace, x, offset=offset, axis1=axis1,
                 axis2=axis2)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply("nan_to_num", torch.nan_to_num, x, nan=nan, posinf=posinf,
                 neginf=neginf)


def _increment(a, value):
    return a + value


def increment(x, value=1.0, name=None):
    """``x += value`` in place (the Tensor adopts the result, recorded by
    autograd); a torch tensor gets the sum back."""
    out = apply("increment", _increment, x, value=value)
    if isinstance(x, Tensor):
        x._swap_payload(out)
        return x
    return out


# -- the tail (reference: activation_op.cc, cum_op.cc, cos_sim_op.cc,
# renorm_op.cc, l1_norm_op.cc, where_index_op.cc, ...) -------------------------

def _logit(a, eps):
    z = torch.clamp(a, eps, 1.0 - eps) if eps is not None else a
    return torch.log(z / (1.0 - z))


def logit(x, eps=None, name=None):
    return apply("logit", _logit, x, eps=eps)


def _rad2deg(a):
    return a * (180.0 / _pymath.pi)


def _deg2rad(a):
    return a * (_pymath.pi / 180.0)


def rad2deg(x, name=None):
    return apply("rad2deg", _rad2deg, x)


def deg2rad(x, name=None):
    return apply("deg2rad", _deg2rad, x)


def _ldexp(a, b):
    return a * torch.pow(2.0, b.to(torch.float32))


def ldexp(x, y, name=None):
    return apply("ldexp", _ldexp, x, y)


def _diff(a, *extra, n, axis, has_pre, has_app):
    it = iter(extra)
    ends = []
    for has in (has_pre, has_app):
        e = next(it) if has else None
        if e is not None and e.dim() < a.dim():   # a scalar: one slice
            shape = list(a.shape)
            shape[axis] = 1
            e = e.to(a.dtype).expand(shape)
        ends.append(e)
    return torch.diff(a, n=n, dim=axis, prepend=ends[0], append=ends[1])


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    """The ``n``-th forward difference along ``axis``, after ``prepend``
    and before ``append`` (a scalar counts as one slice)."""
    args = [x] + [t for t in (prepend, append) if t is not None]
    return apply("diff", _diff, *args, n=n, axis=axis,
                 has_pre=prepend is not None, has_app=append is not None)


def _cummin(a, axis, dtype):
    a, ax = _along(a, axis)
    n = a.shape[ax]
    pos = torch.arange(n, device=a.device).reshape(
        [-1 if d == ax % a.dim() else 1 for d in range(a.dim())])
    vals = torch.cummin(a, ax).values
    prev = torch.cat([vals.narrow(ax, 0, 1), vals.narrow(ax, 0, n - 1)], ax)
    new = (pos == 0) | (a < prev)       # strict: the earliest index holds
    idx = torch.cummax(torch.where(new, pos, torch.zeros_like(pos)), ax) \
        .values
    return torch.gather(a, ax, idx), idx.to(dtype)


def cummin(x, axis=None, dtype="int64", name=None):
    """The running minimum along ``axis`` and the index where each was
    set (the earliest on ties; reference: cum_op.cc)."""
    return apply("cummin", _cummin, x, axis=axis,
                 dtype=_dt.convert_dtype(dtype))


def _logcumsumexp(a, axis):
    a, ax = _along(a, axis)
    return torch.logcumsumexp(a, ax)


def logcumsumexp(x, axis=None, dtype=None, name=None):
    return apply("logcumsumexp", _logcumsumexp, x, axis=axis)


def _vander(a, n, increasing):
    out = torch.linalg.vander(a, N=n)
    return out if increasing else torch.flip(out, [-1])


def vander(x, n=None, increasing=False, name=None):
    return apply("vander", _vander, x, n=n, increasing=increasing)


def _cov(a, *ws, rowvar, ddof, has_f, has_a):
    it = iter(ws)
    fw = next(it) if has_f else None
    aw = next(it) if has_a else None
    if not rowvar and a.dim() > 1:
        a = a.t()
    return torch.cov(a, correction=1 if ddof else 0, fweights=fw,
                     aweights=aw)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    args = [x] + [w for w in (fweights, aweights) if w is not None]
    return apply("cov", _cov, *args, rowvar=rowvar, ddof=ddof,
                 has_f=fweights is not None, has_a=aweights is not None)


def _corrcoef(a, rowvar):
    return torch.corrcoef(a if rowvar or a.dim() < 2 else a.t())


def corrcoef(x, rowvar=True, name=None):
    return apply("corrcoef", _corrcoef, x, rowvar=rowvar)


def _bucketize(a, s, right, out_int32):
    return torch.bucketize(a, s, right=right, out_int32=out_int32)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return apply("bucketize", _bucketize, x, sorted_sequence, right=right,
                 out_int32=out_int32)


digitize = bucketize


def _take_flat(a, idx, mode):
    flat = a.reshape(-1)
    n = flat.shape[0]
    ii = torch.remainder(idx, n) if mode == "wrap" else \
        torch.clamp(idx, -n, n - 1)
    ii = torch.where(ii < 0, ii + n, ii)
    return flat[ii.long()]


def take(x, index, mode="raise", name=None):
    """Entries of the flattened ``x`` at ``index``; ``wrap`` wraps, and
    ``raise`` and ``clip`` clamp (no host assert, as the JAX package's)."""
    return apply("take", _take_flat, x, index, mode=mode)


def _index_add(a, idx, v, axis):
    return torch.index_add(a, axis, idx.long(), v.to(a.dtype))


def index_add(x, index, axis, value, name=None):
    return apply("index_add", _index_add, x, index, value, axis=axis)


def _index_put(a, *rest, accumulate):
    *idxs, v = rest
    idxs = tuple(i if i.dtype == torch.bool else i.long() for i in idxs)
    return torch.index_put(a, idxs, v.to(a.dtype), accumulate=accumulate)


def index_put(x, indices, value, accumulate=False, name=None):
    return apply("index_put", _index_put, x, *list(indices), value,
                 accumulate=accumulate)


def _index_fill(a, idx, axis, fill_value):
    return torch.index_fill(a, axis, idx.long(), fill_value)


def index_fill(x, index, axis, fill_value, name=None):
    return apply("index_fill", _index_fill, x, index, axis=axis,
                 fill_value=fill_value)


def _renorm(a, p, axis, max_norm):
    moved = torch.movedim(a, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = torch.pow(torch.sum(torch.pow(torch.abs(flat), p), dim=1),
                      1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return torch.movedim((flat * factor[:, None]).reshape(moved.shape), 0,
                         axis)


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along ``axis`` scaled to a ``p``-norm of at most
    ``max_norm`` (reference: operators/renorm_op.cc)."""
    return apply("renorm", _renorm, x, p=p, axis=axis, max_norm=max_norm)


def _cos_sim(a, b):
    a2 = a.reshape(a.shape[0], -1)
    b2 = b.reshape(b.shape[0], -1).expand(a.shape[0], a2.shape[1])
    num = torch.sum(a2 * b2, dim=1)
    den = torch.sqrt(torch.sum(a2 * a2, dim=1)) * torch.sqrt(
        torch.sum(b2 * b2, dim=1))
    return (num / torch.clamp_min(den, 1e-12))[:, None]


def cos_sim(X, Y, name=None):
    """Row-wise cosine similarity ``[N, 1]`` (reference:
    operators/cos_sim_op.cc)."""
    return apply("cos_sim", _cos_sim, X, Y)


def _l1_norm(a):
    return torch.sum(torch.abs(a))


def l1_norm(x, name=None):
    return apply("l1_norm", _l1_norm, x)


def _frobenius_norm(a, axis, keepdim):
    if axis is None:
        return torch.sqrt(torch.sum(a * a, dim=tuple(range(a.dim())),
                                    keepdim=keepdim)) if keepdim else \
            torch.sqrt(torch.sum(a * a))
    return torch.sqrt(torch.sum(a * a, dim=_axes(axis, a.dim()),
                                keepdim=keepdim))


def frobenius_norm(x, axis=None, keepdim=False, name=None):
    return apply("frobenius_norm", _frobenius_norm, x, axis=axis,
                 keepdim=keepdim)


def where_index(condition, name=None):
    """The int64 coordinates of ``condition``'s nonzero entries
    (reference: operators/where_index_op.cc), on its device."""
    return nonzero(condition)


def _unflatten(a, axis, shape):
    ax = axis % a.dim()
    return a.reshape(a.shape[:ax] + tuple(shape) + a.shape[ax + 1:])


def unflatten(x, axis, shape, name=None):
    return apply("unflatten", _unflatten, x, axis=axis,
                 shape=[int(s) for s in shape])


__all__ = sorted(
    [n for n in (list(_UNARY) + list(_BINARY))] +
    ["pow", "scale", "clip", "lerp", "stanh", "matmul", "mm", "bmm", "mv",
     "dot", "addmm", "outer", "inner", "kron", "cross", "multiplex", "sum",
     "mean", "prod", "max", "min", "amax", "amin", "all", "any", "std",
     "var", "median", "nanmedian", "nansum", "nanmean", "quantile",
     "logsumexp", "cumsum", "cumprod", "cummax", "count_nonzero", "argmax",
     "argmin", "argsort", "sort", "topk", "kthvalue", "mode", "where",
     "nonzero", "masked_select", "masked_fill", "index_select",
     "index_sample", "take_along_axis", "put_along_axis", "gather",
     "gather_nd", "scatter", "scatter_nd_add", "scatter_nd", "bincount",
     "histogram", "unique", "unique_consecutive", "allclose", "isclose",
     "equal_all", "is_empty", "searchsorted", "norm", "dist",
     "clip_by_norm", "squared_l2_norm", "trace", "nan_to_num", "increment",
     "logit", "rad2deg", "deg2rad", "ldexp", "diff", "cummin",
     "logcumsumexp", "vander", "cov", "corrcoef", "bucketize", "digitize",
     "take", "index_add", "index_put", "index_fill", "renorm", "cos_sim",
     "l1_norm", "frobenius_norm", "where_index", "unflatten"])
