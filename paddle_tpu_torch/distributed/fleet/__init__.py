"""paddle.distributed.fleet (counterpart of
``paddle_tpu/distributed/fleet``): so far ``utils`` (``recompute``,
``GradientMergeOptimizer``) and the datasets of
``distributed/dataset.py``. The Fleet facade, ``DistributedStrategy``
and the parallel layers are ROADMAP.md queue A10."""
from . import utils
from ..dataset import DatasetBase, InMemoryDataset, QueueDataset

__all__ = ["utils", "DatasetBase", "InMemoryDataset", "QueueDataset"]
