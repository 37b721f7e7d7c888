"""paddle.distributed.fleet (counterpart of
``paddle_tpu/distributed/fleet``): so far ``utils`` (``recompute``,
``GradientMergeOptimizer``). The Fleet facade, ``DistributedStrategy``
and the parallel layers are ROADMAP.md queue A10."""
from . import utils

__all__ = ["utils"]
