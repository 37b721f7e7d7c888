"""Quantization, QAT and PTQ (counterpart of
``paddle_tpu/quantization/__init__.py``: ``fake_quantize_abs_max``,
``fake_channel_wise_quantize_abs_max``, ``MovingAverageAbsMaxObserver``,
``quant_dequant_with_scale``, ``quantize_weight_int8``, ``_expand_scale``,
``Int8Linear``, ``Int8Conv2D``, ``_ObserverStateMixin``, ``QuantedLinear``,
``QuantedConv2D``, ``ImperativeQuantAware`` and ``ImperativePTQ``).

Two tiers, as in the JAX package:

- **Simulation (QAT)**: fake quantization with the straight-through
  estimator ``x + (quant(x) - x).detach()``, so autograd passes the
  gradient of ``x`` through unchanged. ``ImperativeQuantAware.quantize``
  swaps a model's ``Linear``/``Conv2D`` children for the wrappers in
  place.
- **Execution (PTQ ``convert``)**: the wrappers become :class:`Int8Linear`
  and :class:`Int8Conv2D`, whose weights are real ``torch.int8`` buffers
  with per-out-channel float32 scales. With a calibrated activation scale
  the linear multiplies int8 by int8 into int32 (:func:`int8_matmul`, on
  ``torch._int_mm``, as the JAX package's ``lax.dot_general`` with an
  int32 result, outside any Pallas kernel); without one its weight-only
  lane multiplies by the float codes and scales the product.

The arithmetic keeps the JAX package's order (``raw / scale``, then
``round``, which rounds half to even in both). Exporting a quantized
model (``save_quantized_model``, through ``jit.save``) is queue A11 of
ROADMAP.md and raises naming it.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..nn import functional as F

__all__ = ["fake_quantize_abs_max", "fake_channel_wise_quantize_abs_max",
           "MovingAverageAbsMaxObserver", "quant_dequant_with_scale",
           "quantize_weight_int8", "int8_matmul", "int8_matmul_plain",
           "Int8Linear", "Int8Conv2D", "QuantedLinear", "QuantedConv2D",
           "ImperativeQuantAware", "ImperativePTQ"]


def _ste(x, q):
    """The value of ``q`` with the gradient of ``x``."""
    return x + (q - x).detach()


def fake_quantize_abs_max(x, bit_length: int = 8):
    """Symmetric per-tensor quantize and dequantize with the
    straight-through gradient; returns ``(out, scale)``, ``scale`` the
    0-dim absmax."""
    qmax = float(2 ** (bit_length - 1) - 1)
    scale = x.detach().abs().amax()
    s = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(x.detach() / s * qmax) / qmax * s
    return _ste(x, q), scale


def fake_channel_wise_quantize_abs_max(x, bit_length: int = 8,
                                       quant_axis: int = 0):
    """Per-channel (``quant_axis``) variant for weights; returns
    ``(out, scales)`` with one absmax per channel."""
    qmax = float(2 ** (bit_length - 1) - 1)
    axes = tuple(i for i in range(x.dim()) if i != quant_axis)
    scale = x.detach().abs().amax(dim=axes, keepdim=True)
    s = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(x.detach() / s * qmax) / qmax * s
    return _ste(x, q), scale.reshape(-1)


class MovingAverageAbsMaxObserver:
    """The moving-average absmax state of an activation (``accum``,
    ``state``, ``scale``). ``scale`` starts at the first batch's absmax,
    then ``rate * scale + (1 - rate) * cur``; ``accum = rate * accum +
    cur`` and ``state = rate * state + 1`` are kept beside it so that a
    checkpoint of either key set round-trips. ``state_dict`` writes both
    the keys ``scale``/``accum``/``state`` and ``OutScale``/``InAccum``/
    ``InState``; ``set_state_dict`` reads either. Each ``observe`` reads
    one absmax back to the host: calibration is a cold path."""

    _KEYS = (("scale", "OutScale"), ("accum", "InAccum"),
             ("state", "InState"))

    def __init__(self, moving_rate: float = 0.9):
        self._rate = moving_rate
        self.scale: Optional[float] = None
        self._accum = 0.0
        self._state = 0.0

    def observe(self, x) -> float:
        cur = float(torch.as_tensor(x).detach().abs().amax())
        self._accum = self._rate * self._accum + cur
        self._state = self._rate * self._state + 1.0
        if self.scale is None:
            self.scale = cur
        else:
            self.scale = self._rate * self.scale + (1 - self._rate) * cur
        return self.scale

    def state_dict(self) -> Dict[str, np.ndarray]:
        vals = {"scale": 0.0 if self.scale is None else float(self.scale),
                "accum": float(self._accum), "state": float(self._state)}
        out = {}
        for key, ref_key in self._KEYS:
            arr = np.asarray(vals[key], np.float32)
            out[key] = arr
            out[ref_key] = arr
        return out

    def set_state_dict(self, state_dict):
        def pick(key, ref_key):
            for k in (key, ref_key):
                if k in state_dict:
                    v = state_dict[k]
                    if isinstance(v, torch.Tensor):
                        v = v.detach().cpu().numpy()
                    return float(np.asarray(v))
            return None
        accum = pick("accum", "InAccum")
        state = pick("state", "InState")
        scale = pick("scale", "OutScale")
        if accum is not None:
            self._accum = accum
        if state is not None:
            self._state = state
        if scale is not None:
            self.scale = scale if state is None or state > 0 else None
        elif self._state > 0:
            self.scale = self._accum / self._state
        return self

    load_state_dict = set_state_dict


def quant_dequant_with_scale(x, scale, bit_length: int = 8):
    """Simulated integer quantization with a FIXED scale (the PTQ
    inference form), straight-through gradient."""
    qmax = float(2 ** (bit_length - 1) - 1)
    s = max(float(scale), 1e-8)
    q = torch.clamp(torch.round(x.detach() / s * qmax), -qmax - 1,
                    qmax) / qmax * s
    return _ste(x, q)


# -- real int8 execution ------------------------------------------------------

def quantize_weight_int8(w, quant_axis: int = 1):
    """Per-channel symmetric int8 quantization: ``(q, scale)``, ``q`` int8
    and ``scale`` float32 ``[channels]`` with ``w ~ q * scale`` over
    ``quant_axis``; ``scale = absmax / 127`` per channel (1/127 for an
    all-zero channel)."""
    raw = torch.as_tensor(w).detach()
    axes = tuple(i for i in range(raw.dim()) if i != quant_axis)
    absmax = raw.abs().amax(dim=axes, keepdim=True)
    scale = torch.where(absmax > 0, absmax,
                        torch.ones_like(absmax)).float() / 127.0
    q = torch.clamp(torch.round(raw / scale), -127.0, 127.0).to(torch.int8)
    return q, scale.reshape(-1)


def _expand_scale(scale, ndim: int, quant_axis: int):
    shape = [1] * ndim
    shape[quant_axis] = -1
    return scale.reshape(shape)


def _pad_to(n: int, multiple: int, at_least: int = 0) -> int:
    return max(-(-n // multiple) * multiple, at_least)


def _column_major(b):
    """``b`` with the same shape and values, its columns contiguous."""
    if b.stride(0) == 1 and b.stride(1) == b.shape[0]:
        return b
    return b.t().contiguous().t()


def int8_matmul(a, b):
    """``a [M, K] int8 @ b [K, N] int8 -> [M, N] int32`` through
    ``torch._int_mm``, which on the card takes more than 16 rows, K and N
    in multiples of 8, and (cuBLASLt's int8 layout) ``a`` row-major and
    ``b`` column-major. Other shapes are padded with zero codes and the
    product sliced back: a zero code adds exactly 0, so the result is the
    exact integer product (:func:`int8_matmul_plain`) at every shape."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = _pad_to(m, 8, 24), _pad_to(k, 8), _pad_to(n, 8)
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a.contiguous(), _column_major(b))
    return out[:m, :n] if (mp, np_) != (m, n) else out


def int8_matmul_plain(a, b):
    """The exact integer product of two int8 matrices as int32, in
    float64 (every partial sum is an integer below 2^53, so exact on any
    device)."""
    return (a.double() @ b.double()).to(torch.int32)


class Int8Linear(nn.Module):
    """A linear whose weight is an int8 buffer ``weight_q`` ``[in, out]``
    (stored column-major, the layout :func:`int8_matmul` takes) with
    per-out-channel float32 scales ``w_scale``.

    With ``act_scale`` (a PTQ calibration) the input is quantized with
    that frozen scale and multiplied int8 by int8 into int32
    (:func:`int8_matmul`), then rescaled; without it the weight-only lane
    computes ``(x @ q.float()) * s``. ``weight`` is the dequantized
    float view (the storage stays int8)."""

    def __init__(self, weight_q, w_scale, bias=None,
                 act_scale: Optional[float] = None):
        super().__init__()
        self.register_buffer("weight_q", _column_major(
            torch.as_tensor(weight_q).to(torch.int8)))
        self.register_buffer("w_scale", torch.as_tensor(w_scale).to(
            dtype=torch.float32, device=self.weight_q.device))
        self.bias = bias
        self._act_scale = None if act_scale is None else float(act_scale)

    @classmethod
    def from_float(cls, weight, bias=None, act_scale=None):
        q, s = quantize_weight_int8(weight, quant_axis=1)
        return cls(q, s, bias=bias, act_scale=act_scale)

    @property
    def weight(self):
        return self.weight_q.float() * self.w_scale[None, :]

    def forward(self, x):
        q, s = self.weight_q, self.w_scale
        if self._act_scale is not None:
            sa = max(self._act_scale, 1e-8) / 127.0
            aq = torch.clamp(torch.round(x / sa), -127.0, 127.0).to(
                torch.int8)
            acc = int8_matmul(aq.reshape(-1, aq.shape[-1]), q)
            out = acc.reshape(*x.shape[:-1], q.shape[1]).float() * (sa * s)
        else:
            out = (x @ q.float()) * s
        if self.bias is not None:
            out = out + self.bias
        return out

    def extra_repr(self):
        return (f"in_features={self.weight_q.shape[0]}, out_features="
                f"{self.weight_q.shape[1]}, act_scale={self._act_scale}")


class Int8Conv2D(nn.Module):
    """A Conv2D whose OIHW weight is an int8 buffer with per-out-channel
    scales, dequantized into the float convolution (weight-only: int8
    activations are out of scope, as in the JAX package)."""

    def __init__(self, weight_q, w_scale, bias=None, stride=1, padding=0,
                 dilation=1, groups=1):
        super().__init__()
        self.register_buffer("weight_q", torch.as_tensor(weight_q).to(
            torch.int8))
        self.register_buffer("w_scale", torch.as_tensor(w_scale).to(
            dtype=torch.float32, device=self.weight_q.device))
        self.bias = bias
        self._cfg = {"_stride": stride, "_padding": padding,
                     "_dilation": dilation, "_groups": groups}

    @classmethod
    def from_float(cls, weight, bias=None, **cfg):
        q, s = quantize_weight_int8(weight, quant_axis=0)
        return cls(q, s, bias=bias, stride=cfg.get("_stride", 1),
                   padding=cfg.get("_padding", 0),
                   dilation=cfg.get("_dilation", 1),
                   groups=cfg.get("_groups", 1))

    @property
    def weight(self):
        return self.weight_q.float() * _expand_scale(
            self.w_scale, self.weight_q.dim(), 0)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias,
                        stride=self._cfg["_stride"],
                        padding=self._cfg["_padding"],
                        dilation=self._cfg["_dilation"],
                        groups=self._cfg["_groups"])


class _ObserverStateMixin:
    """The observer's ``accum``/``state``/``scale`` join the wrapper's
    state dict under ``_observer.`` (scale alone would lose the running
    average) and load back from it."""

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        for k, v in self._observer.state_dict().items():
            destination[f"{prefix}_observer.{k}"] = torch.from_numpy(v)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        tag = prefix + "_observer."
        obs = {k[len(tag):]: v for k, v in state_dict.items()
               if k.startswith(tag)}
        if obs:
            self._observer.set_state_dict(obs)
        rest = {k: v for k, v in state_dict.items() if not k.startswith(tag)}
        super()._load_from_state_dict(rest, prefix, local_metadata, strict,
                                      missing_keys, unexpected_keys,
                                      error_msgs)

    def set_state_dict(self, state_dict, strict: bool = True):
        return self.load_state_dict(state_dict, strict=strict)


class _Quanted(_ObserverStateMixin, nn.Module):
    def __init__(self, layer, weight_bits, activation_bits, moving_rate):
        super().__init__()
        # the wrapped layer shares its parameters; it is not registered,
        # so the state dict holds them once, as the JAX package's does
        object.__setattr__(self, "_inner", layer)
        self.weight = layer.weight
        self.bias = getattr(layer, "bias", None)
        self._wbits = weight_bits
        self._abits = activation_bits
        self._observer = MovingAverageAbsMaxObserver(moving_rate)

    def _fake(self, x, quant_axis):
        self._observer.observe(x)
        xq, _ = fake_quantize_abs_max(x, self._abits)
        wq, _ = fake_channel_wise_quantize_abs_max(
            self.weight, self._wbits, quant_axis=quant_axis)
        return xq, wq


class QuantedLinear(_Quanted):
    """A ``Linear`` with fake-quantized input and per-out-channel weight
    (the reference's ``QuantizedLinear``)."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9):
        super().__init__(layer, weight_bits, activation_bits, moving_rate)

    def forward(self, x):
        xq, wq = self._fake(x, 1)
        return F.linear(xq, wq, self.bias)


class QuantedConv2D(_Quanted):
    """A ``Conv2D`` with fake-quantized input and per-out-channel weight
    (the reference's ``QuantizedConv2D``)."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9):
        super().__init__(layer, weight_bits, activation_bits, moving_rate)
        self._cfg = {k: getattr(layer, k) for k in
                     ("_stride", "_padding", "_dilation", "_groups")
                     if hasattr(layer, k)}

    def forward(self, x):
        xq, wq = self._fake(x, 0)
        return F.conv2d(xq, wq, self.bias,
                        stride=self._cfg.get("_stride", 1),
                        padding=self._cfg.get("_padding", 0),
                        dilation=self._cfg.get("_dilation", 1),
                        groups=self._cfg.get("_groups", 1))


class ImperativeQuantAware:
    """The QAT entry point: ``quantize`` swaps every ``Linear``/``Conv2D``
    child of a model (recursively, by ``named_children``) for its
    quantized wrapper, in place."""

    def __init__(self, weight_bits=8, activation_bits=8, moving_rate=0.9,
                 quantizable_layer_type=("Conv2D", "Linear"), **kw):
        self._wbits = weight_bits
        self._abits = activation_bits
        self._rate = moving_rate
        self._types = set(quantizable_layer_type)

    def quantize(self, model: nn.Module):
        for name, sub in list(model.named_children()):
            cls = type(sub).__name__
            if cls == "Linear" and "Linear" in self._types:
                setattr(model, name, QuantedLinear(
                    sub, self._wbits, self._abits, self._rate))
            elif cls == "Conv2D" and "Conv2D" in self._types:
                setattr(model, name, QuantedConv2D(
                    sub, self._wbits, self._abits, self._rate))
            else:
                self.quantize(sub)
        return model

    def save_quantized_model(self, model, path, input_spec=None):
        raise NotImplementedError(
            "save_quantized_model exports through jit.save, which is not "
            "ported yet: a later slice of the port (ROADMAP.md queue A11)")


class ImperativePTQ:
    """Post-training quantization: wrap (``quantize``), run calibration
    batches, then ``convert`` the wrappers into real int8 layers."""

    def __init__(self, quant_config=None):
        self._cfg = quant_config or {}

    def quantize(self, model: nn.Module):
        return ImperativeQuantAware().quantize(model)

    def convert(self, model: nn.Module):
        """Each :class:`QuantedLinear` becomes an :class:`Int8Linear`
        (the observer's scale drives its int8 x int8 lane), each
        :class:`QuantedConv2D` an :class:`Int8Conv2D`; the float weights
        are dropped."""
        for name, sub in list(model.named_children()):
            if isinstance(sub, QuantedLinear):
                setattr(model, name, Int8Linear.from_float(
                    sub.weight, bias=sub.bias,
                    act_scale=sub._observer.scale))
            elif isinstance(sub, QuantedConv2D):
                setattr(model, name, Int8Conv2D.from_float(
                    sub.weight, bias=sub.bias, **sub._cfg))
            else:
                self.convert(sub)
        return model
