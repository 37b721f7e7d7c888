"""paddle.distributed (counterpart of ``paddle_tpu/distributed``): the
process world (``env``, ``spawn``, ``launch``), the collectives, the
mesh, the hybrid topology, data parallelism, ZeRO sharding, ``fleet``
with its tensor-parallel layers and sequence parallelism (ring
attention, ring-flash on B1-B3), the bulk-ingestion datasets and the
elastic contract (``elastic``, ``elastic_runtime``).

The port runs one process per rank on ``torch.distributed``; the mesh is
a ``DeviceMesh`` and a sharded array a DTensor (``mesh.py``). Pipeline
parallelism, MoE, the sharded embedding, ``fs``, the cohort supervisor
and the heartbeat sender are the second slice of ROADMAP A10: their
names raise naming it.
"""
from . import env  # noqa: F401
from .env import (ParallelEnv, init_parallel_env, is_initialized,  # noqa: F401
                  device_count)
from .collective import get_rank, get_world_size  # noqa: F401
from .mesh import (build_mesh, set_mesh, get_mesh, ensure_mesh,  # noqa: F401
                   shard_tensor, replicate_tensor, constrain, sharding_for)
from .collective import (  # noqa: F401
    ReduceOp, Group, new_group, get_group, destroy_process_group,
    all_reduce, reduce, broadcast, all_gather, all_gather_object, scatter,
    reduce_scatter, alltoall, send, recv, p2p_exchange, barrier, wait,
    compressed_all_reduce, compressed_grad_sync,
    compressed_allreduce_wire_bytes, dense_allreduce_wire_bytes,
)
from .parallel import (DataParallel, sync_params_buffers,  # noqa: F401
                       shard_batch, build_global_batch)
from .elastic import (PreemptionGuard, PREEMPTION_EXIT_CODE,  # noqa: F401
                      HOST_LOST_EXIT_CODE, under_elastic_supervisor,
                      RestartBudget)
from . import elastic_runtime  # noqa: F401
from .elastic_runtime import StepWatchdog  # noqa: F401
from .topology import (CommunicateTopology,  # noqa: F401
                       HybridCommunicateGroup, set_hybrid_communicate_group,
                       get_hybrid_communicate_group)
from . import fleet  # noqa: F401
from . import sharding  # noqa: F401
from .dataset import DatasetBase, InMemoryDataset, QueueDataset  # noqa: F401
from .sharding import group_sharded_parallel  # noqa: F401
from .fleet.mp_layers import split  # noqa: F401
from .fleet import BoxPSDataset  # noqa: F401
from . import utils  # noqa: F401
from . import cloud_utils  # noqa: F401


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """reference: distributed/spawn.py:333: ``func(*args)`` in ``nprocs``
    processes with the PADDLE_* contract (``spawn_impl.py``)."""
    from .spawn_impl import spawn as _spawn
    return _spawn(func, args=args, nprocs=nprocs, join=join, daemon=daemon,
                  **options)


class ProbabilityEntry:
    """reference: entry_attr.py: sparse-feature admission by probability
    (a parameter-server accessor's config string; the JAX package's, a
    config object that nothing reads)."""

    def __init__(self, probability):
        if not 0.0 <= probability <= 1.0:
            raise ValueError("probability must be in [0, 1]")
        self.probability = float(probability)

    def attr(self):
        return f"probability_entry:{self.probability}"


class CountFilterEntry:
    """reference: entry_attr.py: sparse-feature admission by minimum
    occurrence count (a config object, as the JAX package's)."""

    def __init__(self, count_filter):
        if count_filter < 0:
            raise ValueError("count_filter must be >= 0")
        self.count_filter = int(count_filter)

    def attr(self):
        return f"count_filter_entry:{self.count_filter}"


def _slice26(name):
    def later(*a, **k):
        raise NotImplementedError(
            f"distributed.{name} is the second slice of ROADMAP A10 (the "
            f"cohort supervisor and the heartbeat sender), not ported yet")
    return later


HeartbeatPlane = _slice26("HeartbeatPlane")
CohortSupervisor = _slice26("CohortSupervisor")
