"""Paged KV cache: the page pool and block tables, the paged
prefill/decode/tail-prefill programs, page-granular admission, prefix
sharing by page and speculative decoding over pages (counterpart of
``paddle_tpu/serving/llm/paged``). Select with
``LLMEngineConfig(kv_layout="paged")``."""
from .batcher import PagedBatcher
from .decode import (GPTPagedDecoder, paged_decode_logits, paged_decode_step,
                     paged_prefill, paged_tail_prefill)
from .pool import (PagedKVCache, PagePool, PagesExhausted, paged_gather_rows,
                   paged_write_prompt_rows, paged_write_rows,
                   pages_for_tokens)
from .prefix import PagedPrefixEntry, PagedPrefixStore
from .spec import GPTPagedSpecDecoder, paged_spec_step

__all__ = ["PagedBatcher", "GPTPagedDecoder", "paged_decode_logits",
           "paged_decode_step", "paged_prefill", "paged_tail_prefill",
           "PagedKVCache", "PagePool", "PagesExhausted", "paged_gather_rows",
           "paged_write_prompt_rows", "paged_write_rows", "pages_for_tokens",
           "PagedPrefixEntry", "PagedPrefixStore", "GPTPagedSpecDecoder",
           "paged_spec_step"]
