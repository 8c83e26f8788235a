"""Common functionals BERT calls: linear over paddle's [in, out]
weight, dropout in `upscale_in_train` mode (its masks from the port's
generators), embedding with `padding_idx`. The port of
`paddle_tpu/nn/functional/common.py` (those three only)."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...core.random import generator


def linear(x, weight, bias=None):
    """y = x @ W + b, with paddle's weight layout [in, out]; a bias of
    another float dtype is cast to x's, as in JAX."""
    if bias is not None and bias.dtype != x.dtype:
        bias = bias.to(x.dtype)
    return tF.linear(x, weight.t(), bias)


def dropout(x, p=0.5, training=True, mode="upscale_in_train"):
    """Inverted dropout: in training each element is kept with
    probability 1 - p, drawn from the generator of x's device
    (`core.random.generator`), and kept values are scaled by
    1 / (1 - p) in x's dtype, as JAX's `jnp.where(keep, a / (1 - p), 0)`;
    the identity otherwise. Its random bits are torch's, not JAX's."""
    if mode != "upscale_in_train":
        raise NotImplementedError(f"dropout: mode {mode!r} is not ported "
                                  "(only 'upscale_in_train')")
    if not training or p == 0.0:
        return x
    u = torch.rand(x.shape, generator=generator(x.device), device=x.device)
    return torch.where(u < 1.0 - p, x / (1.0 - p), 0.0)


def embedding(x, weight, padding_idx=None):
    """Rows of `weight` [num, dim] at the ids `x`; positions holding
    `padding_idx` give zeros, whatever that row holds."""
    out = tF.embedding(x, weight)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out
