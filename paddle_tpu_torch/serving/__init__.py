"""Serving: paged KV cache (float, int8 or fp8 pools), scheduler,
batcher, the n-gram drafter and the engine."""
from .batcher import SamplingConfig
from .draft import accept_length, accept_length_sampled, ngram_propose
from .engine import ServingEngine
from .kv_cache import KV_DTYPES, PagedKVCache

__all__ = ["KV_DTYPES", "PagedKVCache", "SamplingConfig", "ServingEngine",
           "accept_length", "accept_length_sampled", "ngram_propose"]
