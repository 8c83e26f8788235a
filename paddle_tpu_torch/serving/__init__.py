"""Serving: paged KV cache (float, int8 or fp8 pools, key summaries),
the radix prefix cache, the LoRA adapter cache, scheduler, batcher
(with the frontend's tenant-fair `FairQueue`), the n-gram drafter, the
engine, the asyncio `ServingFrontend`, `distributed` (the TP engine,
the replica router and the disaggregated fleet's KV transport), and the
observability plane: the serving metrics (`metrics`), request traces
and step flight recorders (`tracing`) and the SLO monitor (`slo`)."""
from . import metrics, slo, tracing
from .adapters import AdapterCache, make_random_adapter
from .batcher import FairQueue, SamplingConfig
from .distributed import ReplicaRouter, TPServingEngine
from .draft import accept_length, accept_length_sampled, ngram_propose
from .engine import ServingEngine
from .frontend import ServingFrontend
from .kv_cache import KV_DTYPES, BlockAllocator, PagedKVCache
from .prefix_cache import RadixPrefixCache
from .scheduler import Request, Scheduler
from .slo import SLOConfig, SLOMonitor
from .tracing import RequestTracer, StepFlightRecorder

__all__ = ["AdapterCache", "BlockAllocator", "FairQueue", "KV_DTYPES",
           "PagedKVCache", "RadixPrefixCache", "ReplicaRouter", "Request",
           "RequestTracer", "SLOConfig", "SLOMonitor", "SamplingConfig",
           "Scheduler", "ServingEngine", "ServingFrontend",
           "StepFlightRecorder", "TPServingEngine", "accept_length",
           "accept_length_sampled", "make_random_adapter", "metrics",
           "ngram_propose", "slo", "tracing"]
