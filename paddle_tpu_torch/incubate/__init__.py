"""paddle.incubate (counterpart of ``paddle_tpu/incubate/__init__.py``):
the ``optimizer`` wrappers ``LookAhead`` and ``ModelAverage`` and the
segment reductions of ``ops.segment`` (reference ``:4-5``). The rest of
the reference's incubate (checkpointing, ``LayerHelper``) is not ported
yet (ROADMAP A8)."""
from ..ops.segment import (segment_max, segment_mean, segment_min,
                           segment_pool, segment_sum)
from . import optimizer  # noqa: F401

__all__ = ["optimizer", "segment_sum", "segment_mean", "segment_max",
           "segment_min", "segment_pool"]
