"""Common functionals (counterpart of ``paddle_tpu/nn/functional/common.py``):
``linear``, the dropouts, ``embedding``, ``one_hot``,
``interpolate``/``upsample``, ``grid_sample``, ``affine_grid``,
``bilinear``, ``pad``, ``temporal_shift``, ``npair_loss``,
``sequence_mask``, ``diag_embed`` and ``unfold``. Each runs through the
dispatch funnel (``ops/dispatch.py``) under the reference's op name,
where AMP casts its tensor inputs. The dropout masks come from the
port's seeded generator of the input's device through
:func:`~paddle_tpu_torch.core.generator.draw`.

``interpolate`` follows the JAX package's arithmetic, which is not
torch's: ``"nearest"`` takes source index ``floor(i * src / t)`` per
axis; with ``align_corners`` every other mode is linear interpolation at
``linspace(0, src - 1, t)`` per axis; otherwise ``"linear"``,
``"bilinear"``, ``"trilinear"`` and ``"area"`` are ``jax.image.resize``'s
triangle kernel and ``"bicubic"`` its Keys cubic (a = -0.5, where torch
takes -0.75), both widened by the shrink factor when shrinking
(``resize``'s default antialiasing): one weight matrix a resized axis
(sample point ``(i + 0.5) * src / t - 0.5``, weights normalised to sum
to one, zero where the point leaves ``[-0.5, src - 0.5]``), contracted
with the input. ``align_mode`` is never read, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.dtypes import convert_dtype
from ...core.generator import default_generator, draw
from ...core.tensor import Tensor
from ...ops.creation import diag_embed as _diag_embed
from ...ops.creation import one_hot as _one_hot
from ...ops.dispatch import apply
from ...ops.manipulation import pad as _pad
from ...ops.manipulation import unfold  # noqa: F401 (paddle exposes it here)

__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "one_hot", "interpolate", "upsample", "grid_sample",
           "affine_grid", "bilinear", "pad", "temporal_shift", "npair_loss",
           "sequence_mask", "diag_embed", "unfold"]


def linear(x, weight, bias=None, name=None):
    """``x @ W + b`` with paddle's ``[in, out]`` weight layout; op
    ``linear``."""
    return apply("linear", _linear, x, weight, bias)


def _linear(x, weight, bias):
    out = torch.matmul(x, weight)
    return out + bias if bias is not None else out


def dropout(x, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train", name=None,
            generator: Optional[torch.Generator] = None):
    """paddle's two dropout modes. ``upscale_in_train`` scales kept
    values by ``1/(1-p)`` while training and is the identity otherwise;
    ``downscale_in_infer`` keeps values while training and scales by
    ``1-p`` at inference. ``axis`` drops whole slices: the mask varies
    along those axes only. The mask is drawn from ``generator``, by
    default the port's seeded generator of ``x``'s device
    (:func:`~paddle_tpu_torch.core.generator.default_generator`), through
    :func:`~paddle_tpu_torch.core.generator.draw`, so a recomputed block
    reuses its forward's mask."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode {mode!r}")
    if (not training or p == 0.0) and not (
            mode == "downscale_in_infer" and not training):
        return x            # no op, as the reference's (AMP casts nothing)
    if axis is not None:
        axis = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    return apply("dropout", _dropout, x, p=p, axis=axis, training=training,
                 mode=mode, generator=generator)


def _dropout(x, p, axis, training, mode, generator):
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if generator is None:
        generator = default_generator(x.device)
    shape = x.shape if axis is None else [
        s if i in axis else 1 for i, s in enumerate(x.shape)]
    keep = draw(lambda: torch.rand(shape, generator=generator,
                                   device=x.device) < (1.0 - p))
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    return torch.where(keep, x, torch.zeros_like(x))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Whole channels dropped (the mask varies over batch and channel)."""
    return dropout(x, p, axis=[0, 1] if data_format == "NCHW" else [0, 3],
                   training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    return dropout(x, p, axis=[0, 1] if data_format == "NCDHW" else [0, 4],
                   training=training)


# SELU's constants: alpha dropout keeps a SELU network's mean and variance
_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def _alpha_dropout(a, p):
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    g = default_generator(a.device)
    keep = draw(lambda: torch.rand(a.shape, generator=g, device=a.device)
                < (1.0 - p))
    q = 1.0 - p
    coef_a = (q + alpha_p ** 2 * q * p) ** -0.5
    coef_b = -coef_a * alpha_p * p
    return coef_a * torch.where(keep, a, torch.full_like(a, alpha_p)) + \
        coef_b


def alpha_dropout(x, p=0.5, training=True, name=None):
    """Dropout that keeps a SELU network's statistics: dropped entries
    take SELU's negative saturation, then an affine correction."""
    if not training or p == 0.0:
        return x
    return apply("alpha_dropout", _alpha_dropout, x, p=p)


def embedding(x, weight, padding_idx: Optional[int] = None,
              sparse: bool = False, name=None):
    """Rows of ``weight`` at the ids ``x``, zero at ``padding_idx``; op
    ``lookup_table_v2`` (``sparse`` is accepted and ignored, as in the
    JAX package)."""
    return apply("lookup_table_v2", _embedding, x, weight,
                 padding_idx=padding_idx)


def _embedding(x, weight, padding_idx):
    if type(weight) is not torch.Tensor and _is_dtensor(weight):
        # a table laid out on a mesh is looked up where it lies
        # (indexing would gather it)
        from ...distributed.mesh import embedding
        out = embedding(x, weight)
    else:
        out = weight[x.long()]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None],
                          torch.zeros_like(out), out)
    return out


def _is_dtensor(t):
    from ...distributed.mesh import is_dtensor
    return is_dtensor(t)


def one_hot(x, num_classes, name=None):
    return _one_hot(x, num_classes)


def interpolate(x, size=None, scale_factor=None, mode: str = "nearest",
                align_corners: bool = False, align_mode: int = 0,
                data_format: str = "NCHW", name=None):
    """Resize the spatial axes (reference: interpolate_v2_op.cc) to
    ``size`` or ``scale_factor`` times their size, in ``mode``
    (``"nearest"``, ``"linear"``, ``"bilinear"``, ``"trilinear"``,
    ``"bicubic"`` or ``"area"``), with the JAX package's arithmetic
    (module docstring); op ``interpolate_v2``."""
    mode = mode.lower()
    if mode not in _RESIZE_KERNELS:
        raise ValueError(f"interpolate mode {mode!r}: one of "
                         f"{sorted(_RESIZE_KERNELS)}")
    if isinstance(size, Tensor):
        size = size.numpy().tolist()
    elif isinstance(size, (list, tuple)):
        size = [int(v.item()) if isinstance(v, (Tensor, torch.Tensor))
                else v for v in size]
    return apply("interpolate_v2", _interpolate, x, size=size,
                 scale_factor=scale_factor, mode=mode,
                 align_corners=align_corners, data_format=data_format)


def _target(x, off, size, scale_factor):
    spatial = x.shape[off:off + x.dim() - 2]
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        return [int(v) for v in (size if isinstance(size, (list, tuple))
                                 else [size])]
    sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
        else [scale_factor] * len(spatial)
    return [int(d * f) for d, f in zip(spatial, sf)]


def _triangle(t):
    return torch.clamp(1.0 - t.abs(), min=0.0)


def _keys_cubic(t):
    out = ((1.5 * t - 2.5) * t) * t + 1.0
    out = torch.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
    return torch.where(t >= 2.0, torch.zeros_like(t), out)


#: interpolate mode -> ``jax.image.resize``'s kernel (None: nearest)
_RESIZE_KERNELS = {"nearest": None, "linear": _triangle,
                   "bilinear": _triangle, "trilinear": _triangle,
                   "area": _triangle, "bicubic": _keys_cubic}


def _resize_weights(src, t, kernel, device):
    """``jax.image.resize``'s ``[src, t]`` weight matrix of one axis
    (``compute_weight_mat``, antialiased), in float32."""
    inv = src / t
    f32 = dict(dtype=torch.float32, device=device)
    sample = (torch.arange(t, **f32) + 0.5) * inv - 0.5
    dist = (sample[None, :] - torch.arange(src, **f32)[:, None]).abs() \
        / max(inv, 1.0)
    w = kernel(dist)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


_F32_EPS = 1.1920928955078125e-07


def _interpolate(x, size, scale_factor, mode, align_corners, data_format):
    channel_last = data_format in ("NHWC", "NWC", "NDHWC")
    off = 1 if channel_last else 2
    tgt = _target(x, off, size, scale_factor)
    out = x
    if mode == "nearest":
        for d, t in enumerate(tgt):
            src = x.shape[off + d]
            # float32 arange times the float32 step, as the JAX package's
            # weak-typed scale; a scalar, not a tensor from the host, so
            # a CUDA graph can capture it
            ii = torch.floor(torch.arange(t, dtype=torch.float32,
                                          device=x.device)
                             * (src / t)).long()
            out = torch.index_select(out, off + d, ii)
        return out
    if not out.is_floating_point():
        out = out.float()
    if align_corners:
        for d, t in enumerate(tgt):
            axis = off + d
            src = out.shape[axis]
            ramp = torch.arange(t, dtype=torch.float32, device=x.device)
            # jnp.linspace(0, src - 1, t): stop * (i / (t - 1))
            coords = ramp * 0.0 if t == 1 or src == 1 else \
                (ramp / (t - 1)) * (src - 1)
            i0 = torch.floor(coords).long()
            i1 = torch.clamp(i0 + 1, max=src - 1)
            shape = [1] * out.dim()
            shape[axis] = t
            w1 = (coords - i0).to(out.dtype).reshape(shape)
            out = torch.index_select(out, axis, i0) * (1 - w1) + \
                torch.index_select(out, axis, i1) * w1
        return out
    for d, t in enumerate(tgt):
        axis = off + d
        src = out.shape[axis]
        if src == t:
            continue        # resize skips an axis that keeps its size
        w = _resize_weights(src, t, _RESIZE_KERNELS[mode],
                            x.device).to(out.dtype)
        out = torch.movedim(torch.tensordot(out, w, dims=([axis], [0])),
                            -1, axis)
    return out


def upsample(x, size=None, scale_factor=None, mode: str = "nearest",
             align_corners: bool = False, align_mode: int = 0,
             data_format: str = "NCHW", name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format, name)


def _grid_sample(a, g, mode, padding_mode, align_corners):
    n, c, h, w = a.shape
    gx, gy = g[..., 0], g[..., 1]
    if align_corners:
        fx, fy = (gx + 1) * 0.5 * (w - 1), (gy + 1) * 0.5 * (h - 1)
    else:
        fx, fy = ((gx + 1) * w - 1) * 0.5, ((gy + 1) * h - 1) * 0.5
    bidx = torch.arange(n, device=a.device).reshape(n, 1, 1)

    def sample(ix, iy):
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        vals = a[bidx, :, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        vals = torch.movedim(vals, -1, 1)           # [N, C, Hg, Wg]
        if padding_mode == "zeros":
            vals = torch.where(inside[:, None], vals, torch.zeros_like(vals))
        return vals

    if mode == "nearest":
        return sample(torch.round(fx).long(), torch.round(fy).long())
    x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
    wx = (fx - x0).to(a.dtype)[:, None]
    wy = (fy - y0).to(a.dtype)[:, None]
    return (sample(x0, y0) * (1 - wx) * (1 - wy)
            + sample(x0 + 1, y0) * wx * (1 - wy)
            + sample(x0, y0 + 1) * (1 - wx) * wy
            + sample(x0 + 1, y0 + 1) * wx * wy)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``x`` ``[N, C, H, W]`` at ``grid`` ``[N, Hg, Wg, 2]`` (x, y
    in [-1, 1]), bilinear or nearest, zeros or border padding
    (reference: operators/grid_sampler_op.cc)."""
    return apply("grid_sampler", _grid_sample, x, grid, mode=mode,
                 padding_mode=padding_mode, align_corners=align_corners)


def _affine_grid(th, h, w, align_corners):
    if align_corners:
        xs = torch.linspace(-1, 1, w, dtype=th.dtype, device=th.device)
        ys = torch.linspace(-1, 1, h, dtype=th.dtype, device=th.device)
    else:
        xs = (torch.arange(w, dtype=th.dtype, device=th.device) * 2 + 1) \
            / w - 1
        ys = (torch.arange(h, dtype=th.dtype, device=th.device) * 2 + 1) \
            / h - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")      # [H, W]
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,njk->nhwj", base, th)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The sampling grid ``[N, H, W, 2]`` of the affine maps ``theta``
    ``[N, 2, 3]`` (reference: operators/affine_grid_op.cc)."""
    if isinstance(out_shape, (Tensor, torch.Tensor)):
        out_shape = out_shape.tolist()
    _, _, h, w = [int(v) for v in out_shape]
    return apply("affine_grid", _affine_grid, theta, h=h, w=w,
                 align_corners=align_corners)


def _bilinear(a, b, w, bias):
    out = torch.einsum("bi,oij,bj->bo", a, w, b)
    return out + bias if bias is not None else out


def bilinear(x1, x2, weight, bias=None, name=None):
    """``x1ᵀ W_o x2 + b_o`` for each output ``o`` (reference:
    operators/bilinear_tensor_product_op.cc)."""
    return apply("bilinear_tensor_product", _bilinear, x1, x2, weight, bias)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    return _pad(x, pad, mode, value, data_format, name)


def _temporal_shift(a, seg_num, shift_ratio):
    nt, c, h, w = a.shape
    v = a.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([v[:, 1:, :fold], torch.zeros_like(v[:, :1, :fold])], 1)
    right = torch.cat([torch.zeros_like(v[:, :1, fold:2 * fold]),
                       v[:, :-1, fold:2 * fold]], 1)
    return torch.cat([left, right, v[:, :, 2 * fold:]], 2).reshape(
        nt, c, h, w)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """Shift a ``shift_ratio`` of the channels one segment back and as
    many forward (reference: operators/temporal_shift_op.cc)."""
    return apply("temporal_shift", _temporal_shift, x, seg_num=seg_num,
                 shift_ratio=shift_ratio)


def _npair_loss(a, p, y, l2_reg):
    sim = torch.matmul(a, p.t())
    y = y.reshape(-1, 1)
    tgt = (y == y.t()).to(sim.dtype)
    tgt = tgt / torch.sum(tgt, dim=1, keepdim=True)
    ce = -torch.mean(torch.sum(tgt * torch.log_softmax(sim, dim=1), dim=1))
    reg = l2_reg * (torch.mean(torch.sum(a * a, 1))
                    + torch.mean(torch.sum(p * p, 1))) / 2
    return ce + reg


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    return apply("npair_loss", _npair_loss, anchor, positive, labels,
                 l2_reg=l2_reg)


def _sequence_mask(lens, maxlen, dtype):
    m = lens.shape[-1] if maxlen is None else int(maxlen)
    rng = torch.arange(m, device=lens.device)
    return (rng < lens[..., None]).to(dtype)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < x[...]`` for ``j < maxlen`` (reference:
    sequence_mask_op.cc). With no ``maxlen`` the mask is as wide as
    ``x``'s last axis, as the JAX package's (which traces the op, so it
    never reads the lengths; paddle takes their maximum)."""
    return apply("sequence_mask", _sequence_mask, x, maxlen=maxlen,
                 dtype=convert_dtype(dtype))


def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return _diag_embed(x, offset, dim1, dim2)
