"""`LayerNorm`, the port of `paddle_tpu/nn/layers/norm.py:LayerNorm`:
weight and bias [normalized_shape], computed in fp32 and cast back to
the input's dtype."""
from __future__ import annotations

import torch

from ..._device import resolve_device
from .. import functional as F


class LayerNorm(torch.nn.LayerNorm):

    def __init__(self, normalized_shape, epsilon=1e-5, *, device="cuda"):
        super().__init__(normalized_shape, eps=epsilon,
                         device=resolve_device(device))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.eps)
