"""paddle.distributed (counterpart of ``paddle_tpu/distributed``): so far
``fleet.utils``'s activation recompute and gradient merge. Collectives,
the mesh, data, tensor, pipeline and sequence parallelism (ring-flash)
and the elastic runtime are ROADMAP.md queue A10."""
from . import fleet

__all__ = ["fleet"]
