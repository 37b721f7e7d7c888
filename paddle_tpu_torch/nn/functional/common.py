"""Linear, dropout, embedding and nearest interpolation (counterpart of
``paddle_tpu/nn/functional/common.py``, the part the GPT and YOLOv3
paths use). Each consults the AMP hook under the reference's op name
first (``paddle_tpu_torch/amp``)."""
from __future__ import annotations

from typing import Optional

import torch

from ... import amp
from ...core.generator import default_generator, draw


def linear(x, weight, bias=None):
    """``x @ W + b`` with paddle's ``[in, out]`` weight layout."""
    x, weight, bias = amp.cast_inputs("linear", x, weight, bias)
    out = torch.matmul(x, weight)
    return out + bias if bias is not None else out


def dropout(x, p: float = 0.5, training: bool = True,
            mode: str = "upscale_in_train",
            generator: Optional[torch.Generator] = None):
    """paddle's two dropout modes. ``upscale_in_train`` scales kept
    values by ``1/(1-p)`` while training and is the identity otherwise;
    ``downscale_in_infer`` keeps values while training and scales by
    ``1-p`` at inference. The mask is drawn from ``generator``, by default
    the port's seeded generator of ``x``'s device
    (:func:`~paddle_tpu_torch.core.generator.default_generator`), through
    :func:`~paddle_tpu_torch.core.generator.draw`, so a recomputed block
    reuses its forward's mask."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode {mode!r}")
    (x,) = amp.cast_inputs("dropout", x)
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if generator is None:
        generator = default_generator(x.device)
    keep = draw(lambda: torch.rand(x.shape, generator=generator,
                                   device=x.device) < (1.0 - p))
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    return torch.where(keep, x, torch.zeros_like(x))


def embedding(x, weight, padding_idx: Optional[int] = None):
    weight, x = amp.cast_inputs("lookup_table_v2", weight, x)
    out = weight[x.long()]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None],
                          torch.zeros_like(out), out)
    return out


def interpolate(x, size=None, scale_factor=None, mode: str = "nearest",
                align_corners: bool = False, align_mode: int = 0,
                data_format: str = "NCHW", name=None):
    """Resize the spatial axes (reference: interpolate_v2_op.cc). Only
    ``"nearest"`` is ported, with paddle's source index
    ``floor(i * src / t)`` per axis; the other modes raise
    (ROADMAP.md queue A9)."""
    if mode.lower() != "nearest":
        raise NotImplementedError(
            f"interpolate mode {mode!r} is not ported yet: a later slice "
            f"of the port (ROADMAP.md queue A9)")
    (x,) = amp.cast_inputs("interpolate_v2", x)
    channel_last = data_format in ("NHWC", "NWC", "NDHWC")
    off = 1 if channel_last else 2
    spatial = x.shape[off:off + x.dim() - 2]
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        tgt = [int(v) for v in (size if isinstance(size, (list, tuple))
                                else [size])]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * len(spatial)
        tgt = [int(d * f) for d, f in zip(spatial, sf)]
    out = x
    for d, t in enumerate(tgt):
        src = x.shape[off + d]
        # float32 arange times the float32 step, as the JAX package's
        # weak-typed scale; a scalar, not a tensor from the host, so a
        # CUDA graph can capture it
        ii = torch.floor(torch.arange(t, dtype=torch.float32,
                                      device=x.device) * (src / t)).long()
        out = torch.index_select(out, off + d, ii)
    return out


def upsample(x, size=None, scale_factor=None, mode: str = "nearest",
             align_corners: bool = False, align_mode: int = 0,
             data_format: str = "NCHW", name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format, name)
