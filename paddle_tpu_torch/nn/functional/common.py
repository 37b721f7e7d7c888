"""Linear, dropout and embedding (counterpart of
``paddle_tpu/nn/functional/common.py``, the part the GPT path uses)."""
from __future__ import annotations

from typing import Optional

import torch

from ...core.generator import default_generator


def linear(x, weight, bias=None):
    """``x @ W + b`` with paddle's ``[in, out]`` weight layout."""
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
    (:func:`~paddle_tpu_torch.core.generator.default_generator`)."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if generator is None:
        generator = default_generator(x.device)
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < (1.0 - p)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    return torch.where(keep, x, torch.zeros_like(x))


def embedding(x, weight, padding_idx: Optional[int] = None):
    out = weight[x.long()]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None],
                          torch.zeros_like(out), out)
    return out
