"""Models of the port."""
from .gpt import GPTForGeneration

__all__ = ["GPTForGeneration"]
