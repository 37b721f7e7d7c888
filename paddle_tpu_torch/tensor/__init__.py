"""The ``paddle.tensor`` namespace (counterpart of
``paddle_tpu/tensor/__init__.py``): the op library under its
``paddle.tensor.*`` import path, ``linalg``, and ``rank``."""
import torch

from ..core.tensor import Tensor
from ..ops import *  # noqa: F401,F403
from ..ops import linalg  # noqa: F401
from ..ops.linalg import cholesky, inverse, matrix_power  # noqa: F401


def rank(input):
    """A 0-d int32 Tensor holding ``input``'s number of dims (reference:
    fluid/layers/nn.py rank), on ``input``'s device."""
    t = input._data if isinstance(input, Tensor) else input
    return Tensor(torch.tensor(t.dim(), dtype=torch.int32, device=t.device))
