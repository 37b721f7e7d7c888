"""Functional image transforms on NumPy HWC arrays (counterpart of
``paddle_tpu/vision/transforms/functional.py``; reference:
python/paddle/vision/transforms/functional.py). PIL images are read as
arrays.

Everything here is NumPy: the transforms run in ``io.DataLoader``
workers, which never run torch (``io/__init__.py``). Only
:func:`to_tensor` makes a torch tensor, on the CPU (the loader moves
batches to the device). :func:`resize` is the JAX package's
``jax.image.resize`` bilinear, antialiased when it shrinks: the same
per-axis weight matrices the port's ``interpolate`` builds in torch
(``nn/functional/common.py::_resize_weights``), in NumPy float32, one
axis after the other, rounded and clipped for uint8 images.
"""
from __future__ import annotations

import numbers

import numpy as np

_F32_EPS = np.float32(1.1920928955078125e-07)


def _to_numpy(img):
    if isinstance(img, np.ndarray):
        return img
    # PIL.Image duck-type
    if hasattr(img, "convert") and hasattr(img, "size"):
        return np.asarray(img)
    from ...core.tensor import Tensor
    if isinstance(img, Tensor):
        return img.numpy()
    return np.asarray(img)


def to_tensor(pic, data_format="CHW"):
    """uint8 HWC [0, 255] -> float32 CHW [0, 1] as a CPU Tensor (uint8
    input is rescaled, float input passes through)."""
    import torch
    from ...core.tensor import Tensor
    arr = _to_numpy(pic)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    was_uint8 = arr.dtype == np.uint8
    arr = arr.astype(np.float32)
    if was_uint8:
        arr = arr / 255.0
    if data_format == "CHW":
        arr = arr.transpose(2, 0, 1)
    return Tensor._wrap(torch.from_numpy(np.ascontiguousarray(arr)))


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    arr = _to_numpy(img).astype(np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    shape = (-1, 1, 1) if data_format == "CHW" else (1, 1, -1)
    return (arr - mean.reshape(shape)) / std.reshape(shape)


def _resize_weights(src, t):
    """``jax.image.resize``'s ``[src, t]`` bilinear weight matrix of one
    axis (``compute_weight_mat``, antialiased), in float32."""
    inv = np.float32(src / t)
    sample = (np.arange(t, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    dist = np.abs(sample[None, :] - np.arange(src, dtype=np.float32)[:, None]
                  ) / np.float32(max(src / t, 1.0))
    w = np.maximum(np.float32(1.0) - np.abs(dist), np.float32(0.0))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * _F32_EPS,
                 w / np.where(total != 0, total, np.float32(1.0)),
                 np.float32(0.0)).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def _interp_resize(arr, h, w):
    """Bilinear resize of an HWC (or HW) image to ``(h, w)``."""
    out = arr.astype(np.float32)
    for axis, t in ((0, h), (1, w)):
        src = out.shape[axis]
        if src == t:
            continue
        out = np.moveaxis(np.tensordot(out, _resize_weights(src, t),
                                       axes=([axis], [0])), -1, axis)
    out = np.ascontiguousarray(out, dtype=np.float32)
    if arr.dtype == np.uint8:
        out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out


def resize(img, size, interpolation="bilinear"):
    arr = _to_numpy(img)
    h, w = arr.shape[:2]
    if isinstance(size, int):
        if h <= w:
            nh, nw = size, int(size * w / h)
        else:
            nh, nw = int(size * h / w), size
    else:
        nh, nw = size
    return _interp_resize(arr, nh, nw)


def crop(img, top, left, height, width):
    arr = _to_numpy(img)
    return arr[top:top + height, left:left + width]


def center_crop(img, output_size):
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    arr = _to_numpy(img)
    h, w = arr.shape[:2]
    th, tw = output_size
    top = int(round((h - th) / 2.0))
    left = int(round((w - tw) / 2.0))
    return crop(arr, top, left, th, tw)


def hflip(img):
    return _to_numpy(img)[:, ::-1]


def vflip(img):
    return _to_numpy(img)[::-1]


def pad(img, padding, fill=0, padding_mode="constant"):
    arr = _to_numpy(img)
    if isinstance(padding, int):
        padding = (padding, padding, padding, padding)  # l, t, r, b
    elif len(padding) == 2:
        padding = (padding[0], padding[1], padding[0], padding[1])
    left, top, right, bottom = padding
    pads = [(top, bottom), (left, right)] + [(0, 0)] * (arr.ndim - 2)
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if mode == "constant" else {}
    return np.pad(arr, pads, mode=mode, **kw)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """Rotation by inverse mapping with nearest sampling; ``expand=True``
    grows the canvas to hold the whole rotated image."""
    arr = _to_numpy(img)
    h, w = arr.shape[:2]
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None else \
        (center[1], center[0])
    rad = np.deg2rad(angle)
    cos, sin = np.cos(rad), np.sin(rad)
    if expand:
        oh = int(np.ceil(abs(h * cos) + abs(w * sin) - 1e-9))
        ow = int(np.ceil(abs(w * cos) + abs(h * sin) - 1e-9))
        ocy, ocx = (oh - 1) / 2.0, (ow - 1) / 2.0
    else:
        oh, ow, ocy, ocx = h, w, cy, cx
    yy, xx = np.meshgrid(np.arange(oh), np.arange(ow), indexing="ij")
    ys = (yy - ocy) * cos - (xx - ocx) * sin + cy
    xs = (yy - ocy) * sin + (xx - ocx) * cos + cx
    yi = np.clip(np.round(ys).astype(int), 0, h - 1)
    xi = np.clip(np.round(xs).astype(int), 0, w - 1)
    out = arr[yi, xi]
    out[(ys < 0) | (ys > h - 1) | (xs < 0) | (xs > w - 1)] = fill
    return out


def adjust_brightness(img, factor):
    return _clip_like(_to_numpy(img).astype(np.float32) * factor, img)


def adjust_contrast(img, factor):
    arr = _to_numpy(img).astype(np.float32)
    mean = arr.mean()
    return _clip_like(mean + factor * (arr - mean), img)


def adjust_saturation(img, factor):
    arr = _to_numpy(img).astype(np.float32)
    gray = arr.mean(axis=-1, keepdims=True)
    return _clip_like(gray + factor * (arr - gray), img)


def adjust_hue(img, factor):
    """``factor`` in [-0.5, 0.5]: the hue rotated in HSV space."""
    arr = _to_numpy(img)
    scale = 255.0 if arr.dtype == np.uint8 else 1.0
    x = arr.astype(np.float32) / scale
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx, mn = x.max(-1), x.min(-1)
    diff = mx - mn + 1e-12
    h = np.zeros_like(mx)
    m = mx == r
    h[m] = ((g - b)[m] / diff[m]) % 6
    m = mx == g
    h[m] = (b - r)[m] / diff[m] + 2
    m = mx == b
    h[m] = (r - g)[m] / diff[m] + 4
    h = (h / 6.0 + factor) % 1.0
    s = np.where(mx > 0, diff / (mx + 1e-12), 0)
    v = mx
    i = np.floor(h * 6)
    f = h * 6 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    i = i.astype(int) % 6
    out = np.stack([
        np.choose(i, [v, q, p, p, t, v]),
        np.choose(i, [t, v, v, q, p, p]),
        np.choose(i, [p, p, t, v, v, q])], axis=-1)
    return _clip_like(out * scale, img)


def to_grayscale(img, num_output_channels=1):
    arr = _to_numpy(img).astype(np.float32)
    gray = (0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2])
    gray = np.repeat(gray[..., None], num_output_channels, axis=-1)
    return _clip_like(gray, img)


def _clip_like(arr, ref):
    ref_arr = _to_numpy(ref)
    if ref_arr.dtype == np.uint8:
        return np.clip(np.round(arr), 0, 255).astype(np.uint8)
    return arr.astype(ref_arr.dtype)
