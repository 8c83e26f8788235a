"""`Linear`, `Embedding` and `Dropout`, the port of
`paddle_tpu/nn/layers/common.py`'s, under paddle's parameter names and
shapes. Random initial values do not follow JAX's; weights are carried
across with `convert.load_jax_bert`."""
from __future__ import annotations

import torch

from ..._device import resolve_device
from .. import functional as F


class Linear(torch.nn.Module):
    """paddle.nn.Linear: weight [in_features, out_features], bias
    [out_features]; y = x @ weight + bias."""

    def __init__(self, in_features, out_features, *, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.weight = torch.nn.Parameter(
            torch.empty(in_features, out_features, device=dev))
        self.bias = torch.nn.Parameter(torch.zeros(out_features,
                                                   device=dev))
        torch.nn.init.xavier_uniform_(self.weight)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(torch.nn.Embedding):
    """paddle.nn.Embedding: weight [num_embeddings, embedding_dim]; ids
    equal to `padding_idx` embed to zeros."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, *,
                 device="cuda"):
        if padding_idx is not None and padding_idx < 0:
            padding_idx += num_embeddings
        super().__init__(num_embeddings, embedding_dim,
                         padding_idx=padding_idx,
                         device=resolve_device(device))

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)


# paddle.nn.Dropout in its default `upscale_in_train` mode is torch's
Dropout = torch.nn.Dropout
