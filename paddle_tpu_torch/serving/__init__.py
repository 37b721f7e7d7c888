"""Serving (counterpart of ``paddle_tpu/serving``): the dynamic-batching
:class:`Engine` for callable models, the LLM engine in
:mod:`paddle_tpu_torch.serving.llm`, the health-aware :class:`Router`
over :class:`Replica` workers, the fleet's control plane in
:mod:`paddle_tpu_torch.serving.fleet`, and their host-side plumbing.
``llm`` and ``fleet`` load on first access, as in the JAX package."""
from .batcher import Batch, DynamicBatcher
from .buckets import BucketSpec, pad_rows, pad_seq, pow2_buckets, unpad_rows
from .cache import ExecutableCache, default_cache, signature_of
from .engine import DrainableEngineBase, Engine, EngineConfig
from .queue import BatchQueue
from .replica import Replica
from .request import (PHASE_DECODE, PHASE_PREFILL, REPLICA_ROLES, Deadline,
                      DeadlineExceeded, EngineDraining, EngineKilled,
                      InferenceRequest, QueueFull, RequestTooLarge,
                      ServingError, TokenStreamDivergence)
from .router import (NoHealthyReplicas, Router, RouterConfig,
                     llm_replica_factory, predictor_replica_factory)

__all__ = ["Batch", "DynamicBatcher", "BucketSpec", "pad_rows", "pad_seq",
           "pow2_buckets", "unpad_rows", "ExecutableCache", "default_cache",
           "signature_of", "DrainableEngineBase", "Engine", "EngineConfig",
           "BatchQueue", "Deadline", "DeadlineExceeded", "EngineDraining",
           "EngineKilled", "InferenceRequest", "QueueFull",
           "RequestTooLarge", "ServingError", "TokenStreamDivergence",
           "PHASE_PREFILL", "PHASE_DECODE", "REPLICA_ROLES", "Replica",
           "Router", "RouterConfig", "NoHealthyReplicas",
           "llm_replica_factory", "predictor_replica_factory", "llm",
           "fleet"]


def __getattr__(name):
    if name in ("llm", "fleet"):
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
