"""Matrix product (counterpart of ``matmul`` in ``paddle_tpu/ops/math.py``;
the rest of that module is ROADMAP.md queue A2)."""
from __future__ import annotations

import torch

from .. import amp

__all__ = ["matmul"]


def matmul(x, y, transpose_x: bool = False, transpose_y: bool = False,
           name=None):
    """``x @ y`` with paddle's transpose flags (each swaps the last two
    axes of a factor of two or more dims); op ``matmul_v2`` under AMP."""
    x, y = amp.cast_inputs("matmul_v2", x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)
