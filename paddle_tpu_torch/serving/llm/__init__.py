"""LLM serving (counterpart of ``paddle_tpu/serving/llm``): the
continuous-batching :class:`LLMEngine` over the static-slot KV cache (the
default, :class:`GPTStaticDecoder` on a :class:`StaticKVCache`) or the
paged one (``paged/``), each with prefix K/V reuse
(:class:`PrefixStore`, ``prefix_cache=True``) and draft-model
speculative decoding (:class:`GPTSpecDecoder`, ``spec_k > 0``)."""
from .decode import (GPTDecodeSpec, GPTStaticDecoder, SamplingParams,
                     extract_gpt_params, pack_sampling)
from .kvcache import StaticKVCache
from .prefix import PrefixEntry, PrefixStore, chain_hashes
from .scheduler import (ContinuousBatcher, GenerationRequest, LLMEngine,
                        LLMEngineConfig)
from .spec import GPTSpecDecoder

__all__ = ["StaticKVCache", "GPTDecodeSpec", "GPTStaticDecoder",
           "SamplingParams", "extract_gpt_params", "pack_sampling",
           "PrefixEntry", "PrefixStore", "chain_hashes", "GPTSpecDecoder",
           "ContinuousBatcher", "GenerationRequest", "LLMEngine",
           "LLMEngineConfig"]
