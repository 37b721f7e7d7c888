"""Paged KV cache: the page pool and block tables, the paged
prefill/decode programs and page-granular admission (counterpart of
``paddle_tpu/serving/llm/paged``). Select with
``LLMEngineConfig(kv_layout="paged")``."""
from .batcher import PagedBatcher
from .decode import (GPTPagedDecoder, paged_decode_logits, paged_decode_step,
                     paged_prefill)
from .pool import (PagedKVCache, PagePool, PagesExhausted, paged_gather_rows,
                   paged_write_prompt_rows, paged_write_rows,
                   pages_for_tokens)

__all__ = ["PagedBatcher", "GPTPagedDecoder", "paged_decode_logits",
           "paged_decode_step", "paged_prefill", "PagedKVCache", "PagePool",
           "PagesExhausted", "paged_gather_rows", "paged_write_prompt_rows",
           "paged_write_rows", "pages_for_tokens"]
