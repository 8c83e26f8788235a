"""`GELU` and `Tanh`, the port of `paddle_tpu/nn/layers/activation.py`'s
(torch's own layers compute the same functions)."""
from __future__ import annotations

import torch


class GELU(torch.nn.GELU):
    """Exact (erf) GELU by default; `approximate=True` the tanh form."""

    def __init__(self, approximate=False):
        super().__init__(approximate="tanh" if approximate else "none")


Tanh = torch.nn.Tanh
