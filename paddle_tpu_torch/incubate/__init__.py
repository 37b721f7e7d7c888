"""paddle.incubate (counterpart of ``paddle_tpu/incubate/__init__.py``):
``checkpoint`` (the sharded, async and epoch checkpoints), the
``optimizer`` wrappers ``LookAhead`` and ``ModelAverage``, the segment
reductions of ``ops.segment``, and ``LayerHelper``, which raises as the
reference's does."""
from . import checkpoint  # noqa: F401
from ..ops.segment import (segment_max, segment_mean, segment_min,
                           segment_pool, segment_sum)
from . import optimizer  # noqa: F401


class LayerHelper:
    """reference: fluid/layer_helper.py LayerHelper, the fluid-era
    program-building helper custom ops used to append ops by hand. There
    is no Program to append to; custom ops register through
    ``ops.custom.register_op`` or ``register_kernel_op``."""

    def __init__(self, *a, **k):
        raise RuntimeError(
            "LayerHelper is a fluid-era program builder; define custom "
            "computation with paddle_tpu_torch.ops.custom.register_op "
            "(host/numpy tier) or register_kernel_op (device kernel tier)")


__all__ = ["checkpoint", "optimizer", "LayerHelper", "segment_sum",
           "segment_mean", "segment_max", "segment_min", "segment_pool"]
