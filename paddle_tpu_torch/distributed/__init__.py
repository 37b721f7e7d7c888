"""paddle.distributed (counterpart of ``paddle_tpu/distributed``): so far
``fleet.utils``'s activation recompute and gradient merge, and the
bulk-ingestion datasets ``InMemoryDataset``/``QueueDataset`` in a world
of one (``distributed/dataset.py``, also under ``fleet``), and the
single-process half of the elastic contract (``distributed/elastic.py``:
``PreemptionGuard``, ``ChainedSignalHandler``, ``RestartBudget``, the
exit codes; ``distributed/elastic_runtime``: the step watchdog).
Collectives, the mesh, data, tensor, pipeline and sequence parallelism
(ring-flash) and the rest of the elastic runtime (the launcher, the
heartbeat plane, the cohort supervisor) are ROADMAP.md queue A10."""
from . import fleet
from .dataset import DatasetBase, InMemoryDataset, QueueDataset

__all__ = ["fleet", "DatasetBase", "InMemoryDataset", "QueueDataset"]
