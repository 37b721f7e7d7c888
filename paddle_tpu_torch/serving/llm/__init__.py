"""LLM serving (counterpart of ``paddle_tpu/serving/llm``): the
continuous-batching :class:`LLMEngine` over the paged KV cache."""
from .decode import GPTDecodeSpec, SamplingParams, pack_sampling
from .scheduler import (ContinuousBatcher, GenerationRequest, LLMEngine,
                        LLMEngineConfig)

__all__ = ["GPTDecodeSpec", "SamplingParams", "pack_sampling",
           "ContinuousBatcher", "GenerationRequest", "LLMEngine",
           "LLMEngineConfig"]
