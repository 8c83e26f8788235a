"""Multi-rank serving over `torch.distributed`: `TPServingEngine`, the
engine with its heads split over a tensor-parallel group and a MoE
stack's experts over an expert-parallel one (TP x EP)."""
from .tp_engine import TPServingEngine

__all__ = ["TPServingEngine"]
