"""Gradient clipping, the port of `paddle_tpu/nn/clip.py`: the three
kinds an optimizer's `grad_clip` takes. Each holds its bounds; the
optimizer applies it inside its update, as the JAX package's fused step
does (`Optimizer._clip`)."""
from __future__ import annotations


class ClipGradByValue:
    """Every gradient element clipped into [min, max] (min defaults to
    -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)


class ClipGradByNorm:
    """Each gradient scaled by min(1, clip_norm / (||g|| + 1e-6))."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)


class ClipGradByGlobalNorm:
    """Every gradient scaled by min(1, clip_norm / (G + 1e-6)), G the
    norm of all gradients together."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)
