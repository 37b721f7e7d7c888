"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer``):
``Constant``, ``Uniform``, ``Normal``, ``TruncatedNormal``,
``XavierUniform``/``XavierNormal``, ``KaimingUniform``/``KaimingNormal``,
``Assign``, ``Bilinear``, ``Orthogonal``, ``Dirac``, ``calculate_gain``
and the fluid-era aliases.

An initializer is a callable ``init(shape, dtype=None, device=None,
generator=None)`` returning a new torch tensor of ``shape`` on
``device`` (:func:`~paddle_tpu_torch.core.device.resolve_device`'s when
None), in ``dtype`` (the default float type when None), with the JAX
package's formulas: fans from paddle's layouts (``[in, out]`` for a
matrix, ``[out, in, *k]`` for a kernel), ``TruncatedNormal`` within 2
std, ``Orthogonal`` from the QR of a Gaussian matrix with ``R``'s signs
folded in. The random ones draw from ``generator``, by default the
port's seeded generator of the device (``paddle.seed`` fixes it),
through :func:`~paddle_tpu_torch.core.generator.draw`; their bits are
not the JAX package's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core import dtypes as _dt
from ...core.device import resolve_device
from ...ops import creation as _creation

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "XavierUniform", "XavierNormal", "KaimingUniform",
           "KaimingNormal", "Assign", "Bilinear", "Orthogonal", "Dirac",
           "calculate_gain", "ConstantInitializer", "UniformInitializer",
           "NormalInitializer", "TruncatedNormalInitializer",
           "XavierInitializer", "MSRAInitializer", "NumpyArrayInitializer"]


class Initializer:
    """The base: ``__call__(shape, dtype=None, device=None,
    generator=None)`` returns a new tensor."""

    def __call__(self, shape, dtype=None, device=None, generator=None):
        raise NotImplementedError

    @staticmethod
    def _dtype(dtype):
        d = _dt.convert_dtype(dtype)
        return d if d is not None else _dt.get_default_dtype()

    @staticmethod
    def _uniform(shape, dtype, device, generator, lo, hi):
        return _creation._uniform([int(s) for s in shape],
                                  Initializer._dtype(dtype), lo, hi, 0,
                                  resolve_device(device), generator)

    @staticmethod
    def _normal(shape, dtype, device, generator, mean, std):
        return _creation._normal_draw([int(s) for s in shape],
                                      Initializer._dtype(dtype), mean, std,
                                      resolve_device(device), generator)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=None, device=None, generator=None):
        return torch.full([int(s) for s in shape], self.value,
                          dtype=self._dtype(dtype),
                          device=resolve_device(device))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=None, device=None, generator=None):
        return self._uniform(shape, dtype, device, generator, self.low,
                             self.high)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, device=None, generator=None):
        return self._normal(shape, dtype, device, generator, self.mean,
                            self.std)


class TruncatedNormal(Initializer):
    """Gaussian draws cut to ``mean ± 2 std`` (inverse-CDF sampling, as
    ``paddle.truncated_normal``)."""

    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, device=None, generator=None):
        return _creation._truncated([int(s) for s in shape],
                                    self._dtype(dtype), self.mean, self.std,
                                    resolve_device(device), generator)


def _fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))       # kernels [out, in, *k]
    return shape[1] * receptive, shape[0] * receptive


class XavierUniform(Initializer):
    """``U(±gain·sqrt(6 / (fan_in + fan_out)))`` (reference:
    fluid/initializer.py XavierInitializer(uniform=True))."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fan(self, shape):
        fi, fo = _fans(list(shape))
        return (self.fan_in if self.fan_in is not None else fi,
                self.fan_out if self.fan_out is not None else fo)

    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, fo = self._fan(shape)
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return self._uniform(shape, dtype, device, generator, -limit, limit)


class XavierNormal(XavierUniform):
    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, fo = self._fan(shape)
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return self._normal(shape, dtype, device, generator, 0.0, std)


class KaimingUniform(Initializer):
    """``U(±gain·sqrt(3 / fan_in))`` (reference: fluid/initializer.py
    MSRAInitializer(uniform=True))."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain(self):
        if self.nonlinearity == "leaky_relu":
            return math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return math.sqrt(2.0) if self.nonlinearity == "relu" else 1.0

    def _fan(self, shape):
        return self.fan_in if self.fan_in is not None else \
            _fans(list(shape))[0]

    def __call__(self, shape, dtype=None, device=None, generator=None):
        limit = self._gain() * math.sqrt(3.0 / self._fan(shape))
        return self._uniform(shape, dtype, device, generator, -limit, limit)


class KaimingNormal(KaimingUniform):
    def __call__(self, shape, dtype=None, device=None, generator=None):
        std = self._gain() / math.sqrt(self._fan(shape))
        return self._normal(shape, dtype, device, generator, 0.0, std)


class Assign(Initializer):
    """The given values (a NumPy array, a list, a Tensor or a torch
    tensor), reshaped to ``shape`` where they differ (reference:
    NumpyArrayInitializer)."""

    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, shape, dtype=None, device=None, generator=None):
        v = getattr(self.value, "_data", self.value)
        if isinstance(v, torch.Tensor):
            t = v.detach()
        else:
            t = torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
        shape = [int(s) for s in shape]
        if list(t.shape) != shape:
            t = t.reshape(shape)
        return t.to(device=resolve_device(device), dtype=self._dtype(dtype),
                    copy=True)


class Bilinear(Initializer):
    """Bilinear upsampling kernels (reference: fluid/initializer.py
    BilinearInitializer)."""

    def __call__(self, shape, dtype=None, device=None, generator=None):
        shape = [int(s) for s in shape]
        weight = np.zeros(shape, np.float32)
        f = math.ceil(shape[-1] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape[-2:]))):
            x, y = i % shape[-1], i // shape[-1]
            weight[..., y, x] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return torch.from_numpy(weight).to(device=resolve_device(device),
                                           dtype=self._dtype(dtype))


class Orthogonal(Initializer):
    """``gain`` times an orthogonal matrix (rows or columns orthonormal,
    whichever are fewer), reshaped to ``shape``: the QR of a Gaussian
    square matrix with ``R``'s diagonal signs folded into ``Q``."""

    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def __call__(self, shape, dtype=None, device=None, generator=None):
        shape = [int(s) for s in shape]
        rows, cols = shape[0], int(np.prod(shape[1:]))
        n = max(rows, cols)
        a = self._normal((n, n), torch.float32, device, generator, 0.0, 1.0)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        return (self.gain * q[:rows, :cols]).reshape(shape).to(
            self._dtype(dtype))


class Dirac(Initializer):
    """Identity-preserving conv kernels: 1 at each group's channel pair's
    kernel centre."""

    def __init__(self, groups=1, name=None):
        self.groups = groups

    def __call__(self, shape, dtype=None, device=None, generator=None):
        shape = [int(s) for s in shape]
        w = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        per = oc // self.groups
        centers = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(min(per, ic)):
                w[(g * per + i, i) + centers] = 1.0
        return torch.from_numpy(w).to(device=resolve_device(device),
                                      dtype=self._dtype(dtype))


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0


# the fluid-era names (reference: fluid/initializer.py module tail)
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
XavierInitializer = XavierUniform
MSRAInitializer = KaimingNormal
NumpyArrayInitializer = Assign
