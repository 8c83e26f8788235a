"""`layer_norm`, the port of `paddle_tpu/nn/functional/norm.py:183`:
statistics and affine in fp32, the result cast back to x's dtype."""
from __future__ import annotations

import torch.nn.functional as tF


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    out = tF.layer_norm(x.float(), list(normalized_shape),
                        None if weight is None else weight.float(),
                        None if bias is None else bias.float(), epsilon)
    return out.to(x.dtype)
