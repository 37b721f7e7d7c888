"""Shape manipulation (counterpart of ``flatten`` in
``paddle_tpu/ops/manipulation.py``; the rest of that module is ROADMAP.md
queue A2)."""
from __future__ import annotations

import torch

from .. import amp

__all__ = ["flatten"]


def flatten(x, start_axis: int = 0, stop_axis: int = -1, name=None):
    """``x`` with axes ``start_axis..stop_axis`` merged into one (negative
    axes count from the end); op ``flatten_contiguous_range`` under
    AMP."""
    (x,) = amp.cast_inputs("flatten_contiguous_range", x)
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis % x.dim(), stop_axis % x.dim())
