"""Serving: paged KV cache, scheduler, batcher and the engine."""
from .batcher import SamplingConfig
from .engine import ServingEngine

__all__ = ["SamplingConfig", "ServingEngine"]
