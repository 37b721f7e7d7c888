"""LLM serving (counterpart of ``paddle_tpu/serving/llm``): the
continuous-batching :class:`LLMEngine` over the static-slot KV cache (the
default, :class:`GPTStaticDecoder` on a :class:`StaticKVCache`) or the
paged one (``paged/``). Prefix reuse and speculative decode are queue A6
in ROADMAP.md."""
from .decode import (GPTDecodeSpec, GPTStaticDecoder, SamplingParams,
                     extract_gpt_params, pack_sampling)
from .kvcache import StaticKVCache
from .scheduler import (ContinuousBatcher, GenerationRequest, LLMEngine,
                        LLMEngineConfig)

__all__ = ["StaticKVCache", "GPTDecodeSpec", "GPTStaticDecoder",
           "SamplingParams", "extract_gpt_params", "pack_sampling",
           "ContinuousBatcher", "GenerationRequest", "LLMEngine",
           "LLMEngineConfig"]
