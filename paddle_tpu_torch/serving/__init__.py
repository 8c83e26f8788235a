"""Serving: paged KV cache (float, int8 or fp8 pools, key summaries),
the radix prefix cache, the LoRA adapter cache, scheduler, batcher, the
n-gram drafter and the engine."""
from .adapters import AdapterCache, make_random_adapter
from .batcher import SamplingConfig
from .draft import accept_length, accept_length_sampled, ngram_propose
from .engine import ServingEngine
from .kv_cache import KV_DTYPES, PagedKVCache
from .prefix_cache import RadixPrefixCache

__all__ = ["AdapterCache", "KV_DTYPES", "PagedKVCache",
           "RadixPrefixCache", "SamplingConfig", "ServingEngine",
           "accept_length", "accept_length_sampled", "make_random_adapter",
           "ngram_propose"]
