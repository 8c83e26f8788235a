"""Multi-rank and multi-replica serving.

* `TPServingEngine` — the engine with its heads split over a
  tensor-parallel group and a MoE stack's experts over an
  expert-parallel one (TP x EP), over `torch.distributed`.
* `ReplicaRouter` — asyncio ingress over N `ServingFrontend` replicas:
  prefix-affinity dispatch (`ShadowRadixIndex`), queue-depth balancing,
  health probes (`ReplicaHealth`) and lossless failover, and the
  disaggregated prefill/decode fleet, whose replicas move paged KV
  blocks through a `KVTransport` (`InProcessTransport`) as
  `BlockChunk`s and `MigrationTicket`s.
"""
from .health import ReplicaHealth
from .router import NoReplicaAvailable, ReplicaRouter, ShadowRadixIndex
from .tp_engine import TPServingEngine
from .transport import (BlockChunk, InProcessTransport, KVTransport,
                        MigrationTicket)

__all__ = ["TPServingEngine", "ReplicaRouter", "ReplicaHealth",
           "ShadowRadixIndex", "NoReplicaAvailable", "KVTransport",
           "InProcessTransport", "MigrationTicket", "BlockChunk"]
