"""Tensor creation (counterpart of ``paddle_tpu/ops/creation.py``, all of
it): ``to_tensor``, the fills and their ``*_like`` forms, ``empty``,
``arange``, ``linspace``, ``eye``, the diagonals, ``meshgrid``,
``tril``/``triu``, ``assign``, ``clone``, ``numel``, ``one_hot``, the
random ops and the in-place ``uniform_``/``normal_``/``zero_``/``fill_``.

Each op runs through the funnel under the reference's op name
(``fill_constant``, ``fill_zeros_like``, ``fill_ones_like``,
``fill_any_like``, ``range``, ``linspace``, ``eye``, ``diag_v2``,
``tril_triu``, ``one_hot_v2``, ``size``, ``uniform_random``,
``gaussian_random``, ``truncated_gaussian_random``, ...). The ops that take
no tensor make a Tensor on the device entry points run on
(:func:`set_device`'s, else CUDA, which raises where it is absent); the
others follow their input, a Tensor giving a Tensor and a torch tensor a
torch tensor. float64 host data takes the default dtype, as in the JAX
package; integers stay int64 (the JAX package narrows them to int32
because JAX runs without 64-bit types).

The random ops draw from the port's seeded generator of the op's device
(``core/generator.py``; ``paddle.seed`` fixes it) through
:func:`~paddle_tpu_torch.core.generator.draw`, so a recomputed block
reuses its forward's draws. Their bits are not the JAX package's
(threefry keys); a ``seed`` argument other than 0 draws from a generator
of its own, seeded with it. ``empty`` leaves its memory as torch gives
it (the JAX package's is zeros).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtypes as _dt
from ..core.device import resolve_device
from ..core.generator import default_generator, draw
from ..core.tensor import Tensor
from .dispatch import apply, apply_raw

__all__ = ["to_tensor", "zeros", "ones", "full", "empty", "zeros_like",
           "ones_like", "full_like", "empty_like", "arange", "linspace",
           "eye", "diag", "diagflat", "diag_embed", "meshgrid", "tril",
           "triu", "assign", "clone", "numel", "one_hot", "uniform", "rand",
           "normal", "randn", "standard_normal", "randint", "randperm",
           "bernoulli", "multinomial", "truncated_normal", "uniform_",
           "normal_", "zero_", "fill_"]


def _shape_list(shape):
    if isinstance(shape, (Tensor, torch.Tensor)):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(s.item() if isinstance(s, (Tensor, torch.Tensor)) else s)
            for s in shape]


def _dtype_or_default(dtype):
    d = _dt.convert_dtype(dtype)
    return d if d is not None else _dt.get_default_dtype()


def _scalar(v):
    return v.item() if isinstance(v, (Tensor, torch.Tensor)) else v


def _raw(x):
    return x._data if isinstance(x, Tensor) else x


def _made(out):
    """A Tensor over the output of an op that took no tensor."""
    return Tensor._wrap(out) if isinstance(out, torch.Tensor) else out


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor``: a new Tensor holding a copy of ``data`` (host
    data, a Tensor or a torch tensor) on ``place`` (by default where
    entry points run; a tensor's own device when ``data`` is one)."""
    if isinstance(data, (Tensor, torch.Tensor)):
        t = data._data if isinstance(data, Tensor) else data
        data = t.detach().clone()
    return Tensor(data, dtype=dtype, place=place,
                  stop_gradient=stop_gradient)


def _fill(shape, value, dtype, device):
    return torch.full(shape, value, dtype=dtype, device=device)


def _fill_from(value, shape, dtype):
    return value.reshape(()).to(dtype).expand(shape).clone()


def zeros(shape, dtype=None, name=None):
    return full(shape, 0, _dtype_or_default(dtype))


def ones(shape, dtype=None, name=None):
    return full(shape, 1, _dtype_or_default(dtype))


def full(shape, fill_value, dtype=None, name=None):
    d = _dt.convert_dtype(dtype)
    shape = _shape_list(shape)
    if isinstance(fill_value, Tensor):
        fd = fill_value.dtype
        if d is None:
            d = (fd if fd == torch.bool else torch.int64
                 if not fd.is_floating_point else _dt.get_default_dtype())
        return apply("fill_constant", _fill_from, value=fill_value,
                     shape=shape, dtype=d)
    if d is None:
        d = (torch.bool if isinstance(fill_value, bool) else torch.int64
             if isinstance(fill_value, int) else _dt.get_default_dtype())
    return _made(apply("fill_constant", _fill, shape=shape,
                       value=fill_value, dtype=d, device=resolve_device()))


def _empty(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


def empty(shape, dtype=None, name=None):
    """An uninitialised Tensor of ``shape`` (held by shape and dtype only;
    the JAX package's is zeros)."""
    return _made(apply("fill_constant", _empty, shape=_shape_list(shape),
                       dtype=_dtype_or_default(dtype),
                       device=resolve_device()))


def _zeros_like(x, dtype):
    return torch.zeros_like(x, dtype=dtype)


def _ones_like(x, dtype):
    return torch.ones_like(x, dtype=dtype)


def _full_like(x, fill_value, dtype):
    return torch.full_like(x, fill_value, dtype=dtype)


def _empty_like(x, dtype):
    return torch.empty_like(x, dtype=dtype)


def zeros_like(x, dtype=None, name=None):
    return apply("fill_zeros_like", _zeros_like, x,
                 dtype=_dt.convert_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    return apply("fill_ones_like", _ones_like, x,
                 dtype=_dt.convert_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return apply("fill_any_like", _full_like, x, fill_value=fill_value,
                 dtype=_dt.convert_dtype(dtype))


def empty_like(x, dtype=None, name=None):
    return apply("fill_zeros_like", _empty_like, x,
                 dtype=_dt.convert_dtype(dtype))


def _arange(start, end, step, dtype, device):
    return torch.arange(start, end, step, dtype=dtype, device=device)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    if end is None:
        start, end = 0, start
    start, end, step = (_scalar(v) for v in (start, end, step))
    d = _dt.convert_dtype(dtype)
    if d is None:
        d = (torch.int64 if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step))
             else _dt.get_default_dtype())
    return _made(apply("range", _arange, start=start, end=end, step=step,
                       dtype=d, device=resolve_device()))


def _linspace(start, stop, num, dtype, device):
    if not (dtype.is_floating_point or dtype.is_complex):
        return torch.linspace(start, stop, num, dtype=torch.float64,
                              device=device).floor().to(dtype)
    return torch.linspace(start, stop, num, dtype=dtype, device=device)


def linspace(start, stop, num, dtype=None, name=None):
    return _made(apply("linspace", _linspace, start=_scalar(start),
                       stop=_scalar(stop), num=int(_scalar(num)),
                       dtype=_dtype_or_default(dtype),
                       device=resolve_device()))


def _eye(n, m, dtype, device):
    return torch.eye(n, n if m is None else m, dtype=dtype, device=device)


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return _made(apply("eye", _eye, n=int(num_rows), m=num_columns,
                       dtype=_dtype_or_default(dtype),
                       device=resolve_device()))


def _diag(a, offset, padding_value):
    out = torch.diag(a, offset)
    if a.dim() == 1 and padding_value != 0:
        mask = torch.diag(torch.ones_like(a, dtype=torch.bool), offset)
        out = torch.where(mask, out, torch.full_like(out, padding_value))
    return out


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D input on the ``offset`` diagonal of a square matrix filled
    with ``padding_value``, or a 2-D input's ``offset`` diagonal; op
    ``diag_v2``."""
    return apply("diag_v2", _diag, x, offset=offset,
                 padding_value=padding_value)


def diagflat(x, offset=0, name=None):
    return apply("diagflat", torch.diagflat, x, offset=offset)


def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return apply("diag_embed", torch.diag_embed, x, offset=offset,
                 dim1=dim1, dim2=dim2)


def _meshgrid(*xs):
    return list(torch.meshgrid(*xs, indexing="ij"))


def meshgrid(*args, **kwargs):
    tensors = args[0] if len(args) == 1 and isinstance(
        args[0], (list, tuple)) else args
    return apply("meshgrid", _meshgrid, *tensors)


def tril(x, diagonal=0, name=None):
    return apply("tril_triu", torch.tril, x, diagonal=diagonal)


def triu(x, diagonal=0, name=None):
    return apply("tril_triu", torch.triu, x, diagonal=diagonal)


def assign(x, output=None):
    """A copy of ``x`` (a Tensor, torch tensor or host data; a gradient
    flows through it), written into ``output`` when given."""
    src = x if isinstance(x, (Tensor, torch.Tensor)) else to_tensor(
        np.asarray(x))
    out = apply("assign", torch.clone, src)
    if output is not None:
        output._swap_payload(out)
        return output
    return out


def clone(x, name=None):
    return apply("clone", torch.clone, x)


def _numel(x):
    return torch.full((), x.numel(), dtype=torch.int64, device=x.device)


def numel(x, name=None):
    """The element count as a 0-d int64 tensor on ``x``'s device; op
    ``size``."""
    return apply("size", _numel, x)


def _one_hot(x, num_classes, dtype):
    classes = torch.arange(num_classes, device=x.device)
    return (x.unsqueeze(-1) == classes).to(dtype)


def one_hot(x, num_classes, name=None):
    """``x``'s ids as one-hot rows of the default float type; ids outside
    ``[0, num_classes)`` give a row of zeros, as ``jax.nn.one_hot``; op
    ``one_hot_v2``."""
    return apply("one_hot_v2", _one_hot, x, num_classes=int(num_classes),
                 dtype=_dt.get_default_dtype())


# -- random ------------------------------------------------------------------

def _gen(device, seed=0, generator=None):
    """The generator a random op draws from: ``generator`` when given,
    else the port's seeded one of ``device``, or a fresh one seeded with
    ``seed`` when it is not 0."""
    if generator is not None:
        return generator
    if seed:
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        return g
    return default_generator(device)


def _uniform(shape, dtype, lo, hi, seed, device, generator=None):
    g = _gen(device, seed, generator)
    return draw(lambda: torch.empty(shape, dtype=dtype, device=device)
                .uniform_(lo, hi, generator=g))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    return _made(apply_raw("uniform_random", _uniform,
                           shape=_shape_list(shape),
                           dtype=_dtype_or_default(dtype), lo=float(min),
                           hi=float(max), seed=seed,
                           device=resolve_device()))


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, 0.0, 1.0)


def _normal_draw(shape, dtype, mean, std, device, generator=None):
    """``normal_(mean, std)`` into a new tensor: the draw an in-place
    ``normal_`` of the same generator makes."""
    g = _gen(device, 0, generator)
    return draw(lambda: torch.empty(shape, dtype=dtype, device=device)
                .normal_(mean, std, generator=g))


def _std_normal(shape, dtype, device, seed=0, generator=None):
    g = _gen(device, seed, generator)
    return draw(lambda: torch.randn(shape, dtype=dtype, device=device,
                                    generator=g))


def _normal_t(*ms, mean, std, shape, dtype):
    it = iter(ms)
    m = next(it) if mean is None else mean
    s = next(it) if std is None else std
    dev = ms[0].device
    return _std_normal(shape, dtype, dev) * s + m


def _normal(shape, dtype, mean, std, device):
    return _std_normal(shape, dtype, device) * std + mean


def normal(mean=0.0, std=1.0, shape=None, name=None):
    """Gaussian draws; ``mean``/``std`` may be Tensors, whose shape the
    output takes (the JAX package's ``gaussian_random``)."""
    d = _dt.get_default_dtype()
    if isinstance(mean, (Tensor, torch.Tensor)) or isinstance(
            std, (Tensor, torch.Tensor)):
        like = mean if isinstance(mean, (Tensor, torch.Tensor)) else std
        tens = [t for t in (mean, std)
                if isinstance(t, (Tensor, torch.Tensor))]
        return apply_raw(
            "gaussian_random", _normal_t, *tens,
            mean=None if isinstance(mean, (Tensor, torch.Tensor)) else mean,
            std=None if isinstance(std, (Tensor, torch.Tensor)) else std,
            shape=list(_raw(like).shape), dtype=d)
    return _made(apply_raw("gaussian_random", _normal,
                           shape=_shape_list(shape), dtype=d, mean=mean,
                           std=std, device=resolve_device()))


def randn(shape, dtype=None, name=None):
    return _made(apply_raw("gaussian_random", _std_normal,
                           shape=_shape_list(shape),
                           dtype=_dtype_or_default(dtype),
                           device=resolve_device()))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype, name)


def _randint(low, high, shape, dtype, device):
    g = _gen(device)
    return draw(lambda: torch.randint(low, high, shape, generator=g,
                                      dtype=dtype, device=device))


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return _made(apply_raw("randint", _randint, low=int(low), high=int(high),
                           shape=_shape_list(shape),
                           dtype=_dt.convert_dtype(dtype) or torch.int64,
                           device=resolve_device()))


def _randperm(n, dtype, device):
    g = _gen(device)
    return draw(lambda: torch.randperm(n, generator=g, device=device)
                .to(dtype))


def randperm(n, dtype="int64", name=None):
    return _made(apply_raw("randperm", _randperm, n=int(n),
                           dtype=_dt.convert_dtype(dtype),
                           device=resolve_device()))


def _bernoulli(p):
    g = _gen(p.device)
    return draw(lambda: torch.bernoulli(p, generator=g))


def bernoulli(x, name=None):
    """0/1 draws with the probabilities ``x``, in ``x``'s type."""
    return apply_raw("bernoulli", _bernoulli, x)


def _multinomial(probs, num_samples, replacement):
    g = _gen(probs.device)
    return draw(lambda: torch.multinomial(probs.float(), num_samples,
                                          replacement, generator=g))


def multinomial(x, num_samples=1, replacement=False, name=None):
    """``num_samples`` int64 class draws per row of the probabilities
    ``x`` (without replacement by default)."""
    return apply_raw("multinomial", _multinomial, x,
                     num_samples=int(num_samples), replacement=replacement)


# the standard normal's CDF at -2 and 2: draws are kept within 2 std
_PHI_LO = 0.022750131948179195
_PHI_HI = 0.9772498680518208


def _truncated(shape, dtype, mean, std, device, generator=None):
    g = _gen(device, generator=generator)

    def make():
        u = torch.empty(shape, dtype=torch.float32, device=device) \
            .uniform_(_PHI_LO, _PHI_HI, generator=g)
        z = torch.erfinv(2.0 * u - 1.0) * 2.0 ** 0.5
        return z.clamp_(-2.0, 2.0).to(dtype)
    return draw(make) * std + mean


def truncated_normal(shape, mean=0.0, std=1.0, dtype=None, name=None):
    """Gaussian draws cut to ``mean ± 2 std`` (inverse-CDF sampling)."""
    return _made(apply_raw("truncated_gaussian_random", _truncated,
                           shape=_shape_list(shape),
                           dtype=_dtype_or_default(dtype), mean=mean,
                           std=std, device=resolve_device()))


def uniform_(x, min=-1.0, max=1.0, seed=0):
    t = _raw(x)
    x.set_value(apply_raw("uniform_random", _uniform, shape=list(t.shape),
                          dtype=t.dtype, lo=float(min), hi=float(max),
                          seed=seed, device=t.device))
    return x


def normal_(x, mean=0.0, std=1.0):
    t = _raw(x)
    x.set_value(apply_raw("gaussian_random", _normal, shape=list(t.shape),
                          dtype=t.dtype, mean=mean, std=std,
                          device=t.device))
    return x


def zero_(x):
    x.set_value(zeros_like(x))
    return x


def fill_(x, value):
    x.set_value(full_like(x, value))
    return x
