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
from .fleet import (AutoscalerPolicy, FleetBundle, FleetController,
                    SLOAutoscaler, boot_engine_from_bundle, export_bundle,
                    rolling_upgrade, weights_from_bundle,
                    weights_from_model)
from .frontend import ServingFrontend
from .kv_cache import KV_DTYPES, BlockAllocator, PagedKVCache
from .prefix_cache import RadixPrefixCache
from .scheduler import Request, Scheduler
from .slo import SLOConfig, SLOMonitor
from .tracing import RequestTracer, StepFlightRecorder

__all__ = ["AdapterCache", "AutoscalerPolicy", "BlockAllocator",
           "FairQueue", "FleetBundle", "FleetController", "KV_DTYPES",
           "PagedKVCache", "RadixPrefixCache", "ReplicaRouter", "Request",
           "RequestTracer", "SLOAutoscaler", "SLOConfig", "SLOMonitor",
           "SamplingConfig",
           "Scheduler", "ServingEngine", "ServingFrontend",
           "StepFlightRecorder", "TPServingEngine", "accept_length",
           "accept_length_sampled", "boot_engine_from_bundle",
           "export_bundle", "fleet", "make_random_adapter", "metrics",
           "ngram_propose", "rolling_upgrade", "slo", "tracing",
           "weights_from_bundle", "weights_from_model"]
