"""Activation functionals of the port (`paddle_tpu/nn/functional/
activation.py`): those the Transformer encoder and BERT call."""
from __future__ import annotations

import torch
import torch.nn.functional as tF


relu = tF.relu
tanh = torch.tanh


def gelu(x, approximate=False):
    """Exact (erf) GELU by default, as `jax.nn.gelu(approximate=False)`;
    the tanh form with `approximate=True`."""
    return tF.gelu(x, approximate="tanh" if approximate else "none")
