"""Serving (counterpart of ``paddle_tpu/serving``): the dynamic-batching
:class:`Engine` for callable models, the LLM engine in
:mod:`paddle_tpu_torch.serving.llm`, and their host-side plumbing."""
from .batcher import Batch, DynamicBatcher
from .buckets import BucketSpec, pad_rows, pad_seq, pow2_buckets, unpad_rows
from .cache import ExecutableCache, default_cache, signature_of
from .engine import DrainableEngineBase, Engine, EngineConfig
from .queue import BatchQueue
from .request import (Deadline, DeadlineExceeded, EngineDraining,
                      EngineKilled, InferenceRequest, QueueFull,
                      RequestTooLarge, ServingError)

__all__ = ["Batch", "DynamicBatcher", "BucketSpec", "pad_rows", "pad_seq",
           "pow2_buckets", "unpad_rows", "ExecutableCache", "default_cache",
           "signature_of", "DrainableEngineBase", "Engine", "EngineConfig",
           "BatchQueue", "Deadline", "DeadlineExceeded", "EngineDraining",
           "EngineKilled", "InferenceRequest", "QueueFull",
           "RequestTooLarge", "ServingError"]
