"""Serving (counterpart of ``paddle_tpu/serving``): the LLM engine in
:mod:`paddle_tpu_torch.serving.llm` and its host-side plumbing."""
from .buckets import pow2_buckets
from .queue import BatchQueue
from .request import (Deadline, DeadlineExceeded, EngineDraining, QueueFull,
                      RequestTooLarge, ServingError)

__all__ = ["pow2_buckets", "BatchQueue", "Deadline", "DeadlineExceeded",
           "EngineDraining", "QueueFull", "RequestTooLarge",
           "ServingError"]
