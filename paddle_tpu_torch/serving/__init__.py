"""Serving: paged KV cache (float, int8 or fp8 pools, key summaries),
the radix prefix cache, the LoRA adapter cache, scheduler, batcher
(with the frontend's tenant-fair `FairQueue`), the n-gram drafter, the
engine, the asyncio `ServingFrontend`, and `distributed` (the TP engine,
the replica router and the disaggregated fleet's KV transport)."""
from .adapters import AdapterCache, make_random_adapter
from .batcher import FairQueue, SamplingConfig
from .distributed import ReplicaRouter, TPServingEngine
from .draft import accept_length, accept_length_sampled, ngram_propose
from .engine import ServingEngine
from .frontend import ServingFrontend
from .kv_cache import KV_DTYPES, BlockAllocator, PagedKVCache
from .prefix_cache import RadixPrefixCache
from .scheduler import Request, Scheduler

__all__ = ["AdapterCache", "BlockAllocator", "FairQueue", "KV_DTYPES",
           "PagedKVCache", "RadixPrefixCache", "ReplicaRouter", "Request",
           "SamplingConfig", "Scheduler", "ServingEngine",
           "ServingFrontend", "TPServingEngine", "accept_length",
           "accept_length_sampled", "make_random_adapter", "ngram_propose"]
