"""paddle.distributed.fleet, the unified entry of distributed training
(counterpart of ``paddle_tpu/distributed/fleet/__init__.py``; reference
``fleet/base/fleet_base.py:72`` ``Fleet``: ``init`` :139,
``distributed_optimizer`` :744, ``distributed_model``).

``init`` brings the process group up (``init_parallel_env``) and
compiles the ``DistributedStrategy`` into the global mesh and the hybrid
topology; ``distributed_model`` applies the model-side levers (amp,
recompute) and the parallel wrapper of the mode (``DataParallel`` in
``data`` mode; in ``model`` mode the model itself, its parameters laid
out by the caller or the parallel layers, the rest replicated);
``distributed_optimizer`` applies the optimizer-side ones (ZeRO states,
LARS/LAMB, LocalSGD, gradient merge) and points the optimizer at the
DTensor parameters that replaced the ones it was built with.

Pipeline parallelism (``PipelineLayer``, ``PipelineParallel``, the
``pipeline`` mode), ``moe``, ``sharded_embedding`` and ``fs`` are the
second slice of ROADMAP A10 and raise naming it.
"""
from __future__ import annotations

from typing import Optional

from .strategy import DistributedStrategy
from .mp_layers import (VocabParallelEmbedding, ColumnParallelLinear,  # noqa: F401
                        RowParallelLinear, ParallelCrossEntropy,
                        get_rng_state_tracker, model_parallel_random_seed)
from ..topology import (CommunicateTopology, HybridCommunicateGroup,  # noqa: F401
                        set_hybrid_communicate_group,
                        get_hybrid_communicate_group)
from ..env import get_rank, get_world_size, init_parallel_env
from . import utils  # noqa: F401 (recompute lives here)
from .sequence_parallel import (ring_attention, ring_flash_attention,  # noqa: F401
                                RingAttention, split_sequence,
                                gather_sequence)
from ..dataset import DatasetBase, InMemoryDataset, QueueDataset  # noqa: F401


def _slice26(what: str):
    return NotImplementedError(
        f"{what} is the second slice of ROADMAP A10 (pipeline, MoE, the "
        f"sharded embedding, fs), not ported yet")


class _FleetState:
    def __init__(self):
        self.strategy: Optional[DistributedStrategy] = None
        self.hcg: Optional[HybridCommunicateGroup] = None
        self.initialized = False


_F = _FleetState()


def _validate_strategy(st: DistributedStrategy):
    """Every documented flag takes effect or raises or warns here, as in
    the JAX package; the messages name the port's own reasons."""
    import warnings
    hc = st.hybrid_configs
    if st.dgc:
        raise NotImplementedError(
            "DGC (top-k gradient compression) is out of scope by the JAX "
            "package's ADR (docs/adr/0002-dgc.md); set "
            "strategy.compressed_allreduce = True for the dense-but-"
            "quantized exchange, or use localsgd / gradient_merge")
    if st.compressed_allreduce_dtype not in ("int8", "bf16"):
        raise ValueError(
            "compressed_allreduce_dtype must be 'int8' or 'bf16', got "
            f"{st.compressed_allreduce_dtype!r}")
    if st.compressed_allreduce and st.fp16_allreduce:
        warnings.warn(
            "both compressed_allreduce and fp16_allreduce are set; "
            "compressed_allreduce wins (fp16_allreduce is its bf16 "
            "special case without block scales)", UserWarning,
            stacklevel=2)
    if st.pipeline and int(hc.get("pp_degree", 1)) <= 1:
        raise ValueError(
            "strategy.pipeline=True requires hybrid_configs['pp_degree']>1 "
            "(the mesh needs a pp axis to pipeline over)")
    tp_deg = int(st.tensor_parallel_configs.get("tensor_parallel_degree", 1))
    if st.tensor_parallel and tp_deg <= 1 and int(hc.get("mp_degree", 1)) <= 1:
        raise ValueError(
            "strategy.tensor_parallel=True requires tensor_parallel_configs"
            "['tensor_parallel_degree']>1 or hybrid_configs['mp_degree']>1")
    if int(st.nccl_comm_num) != 1:
        warnings.warn(
            "nccl_comm_num has no effect: the port runs each collective on "
            "the caller's stream, one communicator a group", UserWarning,
            stacklevel=3)
    if not st.fuse_all_reduce_ops:
        warnings.warn(
            "fuse_all_reduce_ops=False cannot take effect: each gradient is "
            "reduced once, in the step (DataParallel)", UserWarning,
            stacklevel=3)
    if int(st.fuse_grad_size_in_MB) != 32:
        warnings.warn(
            "fuse_grad_size_in_MB has no effect: each gradient is reduced "
            "on its own, nothing is bucketed", UserWarning, stacklevel=3)
    if st.find_unused_parameters:
        warnings.warn(
            "find_unused_parameters is moot here: every replica runs the "
            "same program (see DataParallel)", UserWarning, stacklevel=3)


def init(role_maker=None, is_collective=False, strategy=None, *,
         device=None, backend=None):
    """reference: fleet_base.py:139. Collective mode only (the parameter-
    server world is out of scope, as in the JAX package). ``device`` and
    ``backend`` go to ``init_parallel_env``."""
    if role_maker is not None and not is_collective:
        raise NotImplementedError(
            "parameter-server role makers are out of scope (the JAX "
            "package's docs/adr/0001-parameter-server.md); use "
            "is_collective=True")
    if strategy is None:
        strategy = DistributedStrategy()
    _validate_strategy(strategy)
    _F.strategy = strategy
    init_parallel_env(backend=backend, device=device)
    hc = strategy.hybrid_configs
    mp_degree = int(hc.get("mp_degree", 1))
    if strategy.tensor_parallel and mp_degree <= 1:
        mp_degree = int(
            strategy.tensor_parallel_configs["tensor_parallel_degree"])
    _F.hcg = HybridCommunicateGroup(
        dp_degree=int(hc.get("dp_degree", 1)),
        mp_degree=mp_degree,
        pp_degree=int(hc.get("pp_degree", 1)),
        sharding_degree=int(hc.get("sharding_degree", 1)),
        sep_degree=int(hc.get("sep_degree", 1)))
    set_hybrid_communicate_group(_F.hcg)
    _F.initialized = True
    return _F


def get_hybrid_communicate_group_():
    return _F.hcg


def is_first_worker():
    return get_rank() == 0


def worker_index():
    return get_rank()


def worker_num():
    return get_world_size()


def barrier_worker():
    from ..collective import barrier
    barrier()


def distributed_model(model):
    """reference: fleet_base.py distributed_model (module docstring)."""
    hcg = _F.hcg
    if hcg is None:
        init()
        hcg = _F.hcg
    st = _F.strategy or DistributedStrategy()
    if st.amp:
        from ... import amp as _amp
        cfg = st.amp_configs
        if cfg.get("use_pure_fp16"):
            _amp.decorate(model, level="O2")
            _amp.enable_operator_amp(
                level="O2", custom_white_list=cfg.get("custom_white_list"),
                custom_black_list=cfg.get("custom_black_list"))
        else:
            _amp.enable_operator_amp(
                level="O1", custom_white_list=cfg.get("custom_white_list"),
                custom_black_list=cfg.get("custom_black_list"))
    if st.recompute:
        _apply_recompute(model, st.recompute_configs.get("checkpoints", []))
    mode = hcg.get_parallel_mode()
    if (st.fp16_allreduce or st.compressed_allreduce) and mode != "data":
        import warnings
        which = ("compressed_allreduce" if st.compressed_allreduce
                 else "fp16_allreduce")
        warnings.warn(
            f"{which} applies to the DataParallel gradient exchange only; "
            f"it has no effect in {mode!r} mode", UserWarning, stacklevel=2)
    if mode == "pipeline":
        raise _slice26("fleet.distributed_model in pipeline mode")
    if mode == "data":
        from ..parallel import DataParallel
        return DataParallel(
            model, bf16_allreduce=bool(st.fp16_allreduce),
            compressed_allreduce=bool(st.compressed_allreduce),
            compressed_allreduce_dtype=str(st.compressed_allreduce_dtype))
    # model (tensor) parallel: the parameters laid out already stay; the
    # rest are replicated (the reference broadcasts them across mp)
    from ..parallel import replicate_model, sync_params_buffers
    sync_params_buffers(model)
    return replicate_model(model)


def distributed_optimizer(optimizer, strategy=None):
    """reference: fleet_base.py:744 and the meta-optimizer stack."""
    from ..sharding import _rebind_optimizer, shard_optimizer_states
    st = strategy or _F.strategy or DistributedStrategy()
    if st is not _F.strategy:
        _validate_strategy(st)
    _F.strategy = st
    _rebind_optimizer(optimizer)
    if st.sharding:
        shard_optimizer_states(optimizer)
    if st.lars or st.lamb:
        optimizer = _swap_optimizer(optimizer, st)
    if st.localsgd:
        from .utils import LocalSGDOptimizer
        cfg = st.localsgd_configs
        optimizer = LocalSGDOptimizer(
            optimizer, k_steps=int(cfg["k_steps"]),
            begin_step=int(cfg["begin_step"]))
    if st.gradient_merge:
        # outside localsgd, so LocalSGD counts updates, not micro-steps
        from .utils import GradientMergeOptimizer
        optimizer = GradientMergeOptimizer(
            optimizer, k_steps=int(st.gradient_merge_configs["k_steps"]),
            avg=bool(st.gradient_merge_configs["avg"]))
    return optimizer


def _apply_recompute(model, checkpoints):
    """Strategy-driven recompute: each named sublayer's forward routed
    through ``fleet.utils.recompute``."""
    from . import utils as _utils
    names = set(checkpoints or ())
    if not names:
        import warnings
        warnings.warn(
            "strategy.recompute=True with empty recompute_configs"
            "['checkpoints']: nothing to wrap; name the sublayers to "
            "rematerialize (model.named_sublayers() keys)", UserWarning,
            stacklevel=2)
        return
    matched = set()
    for name, sub in model.named_sublayers():
        if name in names:
            matched.add(name)
            orig = sub.forward
            if getattr(orig, "_fleet_recompute", False):
                continue

            def wrapped(*a, __f=orig, **k):
                return _utils.recompute(__f, *a, **k)

            wrapped._fleet_recompute = True
            sub.forward = wrapped
    missing = names - matched
    if missing:
        raise ValueError(
            f"recompute checkpoints not found among sublayers: "
            f"{sorted(missing)}")


def _swap_optimizer(optimizer, st):
    """LARS/LAMB meta-optimizers: the update rule swapped, parameters
    and lr kept."""
    from ... import optimizer as optim
    params = optimizer._parameter_list
    lr = optimizer._learning_rate
    dev = optimizer._device
    if st.lamb:
        cfg = st.lamb_configs
        return optim.Lamb(learning_rate=lr, parameters=params,
                          lamb_weight_decay=float(cfg["lamb_weight_decay"]),
                          device=dev)
    cfg = st.lars_configs
    return optim.LarsMomentum(
        learning_rate=lr, parameters=params,
        momentum=getattr(optimizer, "_momentum", 0.9),
        lars_coeff=float(cfg["lars_coeff"]),
        lars_weight_decay=float(cfg["lars_weight_decay"]), device=dev)


def minimize(loss, startup_program=None, parameter_list=None,
             no_grad_set=None):
    """reference: fleet_base.py:1244: static-mode minimize (A11); in
    dygraph call ``optimizer.step()``."""
    raise RuntimeError("fleet.minimize requires a static-mode loss with an "
                       "optimizer; in dygraph call optimizer.step()")


class _Slice26:
    """A name of the second slice of A10: raises when used."""

    def __init__(self, name):
        self._name = name

    def __call__(self, *a, **k):
        raise _slice26(f"fleet.{self._name}")


PipelineLayer = _Slice26("PipelineLayer")
PipelineParallel = _Slice26("PipelineParallel")
LayerDesc = _Slice26("LayerDesc")
SharedLayerDesc = _Slice26("SharedLayerDesc")
ShardedEmbedding = _Slice26("ShardedEmbedding")
MoELayer = _Slice26("MoELayer")
moe_ffn = _Slice26("moe_ffn")
sparse_row_update = _Slice26("sparse_row_update")
make_row_state = _Slice26("make_row_state")


class meta_parallel:
    """reference: fleet.meta_parallel."""
    VocabParallelEmbedding = VocabParallelEmbedding
    ColumnParallelLinear = ColumnParallelLinear
    RowParallelLinear = RowParallelLinear
    ParallelCrossEntropy = ParallelCrossEntropy
    PipelineLayer = PipelineLayer
    PipelineParallel = PipelineParallel
    LayerDesc = LayerDesc
    SharedLayerDesc = SharedLayerDesc
    get_rng_state_tracker = staticmethod(get_rng_state_tracker)


class FileInstantDataset(QueueDataset):
    """reference: dataset.py FileInstantDataset: the QueueDataset that
    streams each file once; QueueDataset already streams files in
    order."""


class BoxPSDataset:
    """reference: dataset.py BoxPSDataset: BoxPS (GPU parameter-server)
    ingestion, out of scope as in the JAX package (its ADR 0001)."""

    def __init__(self, *a, **k):
        raise RuntimeError(
            "BoxPSDataset belongs to the brpc/BoxPS parameter-server "
            "stack, out of scope (the JAX package's ADR 0001); use "
            "InMemoryDataset/QueueDataset")


class MultiSlotDataGenerator:
    """reference: data_generator/__init__.py: the data generator that
    emits (slot_name, values) records in the slot text protocol the
    datasets ingest."""

    def generate_sample(self, line):
        raise NotImplementedError(
            "subclass MultiSlotDataGenerator and implement "
            "generate_sample(line) returning a zero-arg generator "
            "function whose iteration yields lists of (slot_name, "
            "values) pairs, the reference data_generator contract")

    def run_from_memory(self, lines):
        out = []
        for line in lines:
            for rec in self.generate_sample(line)():
                out.append(rec)
        return out

    def _format(self, rec):
        parts = []
        for name, values in rec:
            parts.append(f"{len(values)} " + " ".join(
                str(v) for v in values))
        return " ".join(parts)


class MultiSlotStringDataGenerator(MultiSlotDataGenerator):
    """String-slot variant (values kept as strings)."""


class Role:
    """reference: role_maker.py Role constants."""
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class PaddleCloudRoleMaker:
    """reference: role_maker.py PaddleCloudRoleMaker: the role from the
    PADDLE_* contract ``launch`` writes."""

    def __init__(self, is_collective=True, **kwargs):
        import os
        self._is_collective = is_collective
        self._rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._eps = [e for e in eps.split(",") if e]
        self._size = len(self._eps) or int(
            os.environ.get("PADDLE_TRAINERS_NUM", 1))

    def _is_worker(self):
        return True

    def _is_server(self):
        return False

    def _worker_index(self):
        return self._rank

    def _worker_num(self):
        return self._size

    def _get_trainer_endpoints(self):
        return list(self._eps)


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    """reference: role_maker.py UserDefinedRoleMaker: roles given, not
    read from the environment."""

    def __init__(self, is_collective=True, init_gloo=False, **kwargs):
        super().__init__(is_collective=is_collective)
        self._rank = int(kwargs.get("current_id", self._rank))
        self._eps = list(kwargs.get("worker_endpoints", self._eps))
        self._size = len(self._eps) or self._size


class UtilBase:
    """reference: util_base: small cross-worker helpers over the
    collectives. ``all_reduce`` takes a number, an array or a tensor and
    returns a NumPy array."""

    def all_reduce(self, input, mode="sum"):
        import numpy as np
        import torch
        from .. import collective as C
        from ..env import _rank_device, is_initialized
        op = {"sum": C.ReduceOp.SUM, "min": C.ReduceOp.MIN,
              "max": C.ReduceOp.MAX}[mode]
        t = torch.as_tensor(np.asarray(input))
        if is_initialized():
            t = t.to(_rank_device())
        C.all_reduce(t, op=op)
        return t.cpu().numpy()

    def barrier(self):
        from .. import collective as C
        C.barrier()


class Fleet:
    """reference: fleet/base/fleet_base.py Fleet: the module's functions
    bound as methods."""

    def __init__(self):
        self.util = UtilBase()

    def init(self, role_maker=None, is_collective=False, strategy=None,
             **kw):
        return init(role_maker, is_collective, strategy, **kw)

    def distributed_model(self, model):
        return distributed_model(model)

    def distributed_optimizer(self, optimizer, strategy=None):
        return distributed_optimizer(optimizer, strategy)

    def worker_index(self):
        return worker_index()

    def worker_num(self):
        return worker_num()

    def barrier_worker(self):
        return barrier_worker()


from ... import metric as metrics  # noqa: E402,F401
