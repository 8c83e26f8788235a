"""Carry a JAX `GPTForGeneration`'s parameters into the port.

The input is a `{name: np.ndarray}` dict in the order of the JAX
model's `_gen_tensors()`: `word_embeddings`, `position_embeddings`,
each decoder parameter under its `_PARAM_ORDER` name, `ln_f.weight`,
`ln_f.bias` and `lm_head.weight`. The caller builds it from the JAX
model (only code that imports both packages does); this module never
touches jax.
"""
from __future__ import annotations

import numpy as np
import torch

from .incubate.nn.fused_transformer import _PARAM_ORDER
from .models.gpt import GPTForGeneration

#: input name -> the port's state_dict key
JAX_GPT_NAMES = {"word_embeddings": "word_embeddings.weight",
                 "position_embeddings": "position_embeddings.weight",
                 **{n: f"decoder.{n}" for n in _PARAM_ORDER},
                 "ln_f.weight": "ln_f.weight",
                 "ln_f.bias": "ln_f.bias",
                 "lm_head.weight": "lm_head.weight"}


def load_jax_gpt(arrays, num_attention_heads, *, compute_dtype="float32",
                 device="cuda", dtype=torch.float32) -> GPTForGeneration:
    """A `GPTForGeneration` on `device`, its parameters stored as
    `dtype`, holding exactly `arrays`. Shapes follow from the arrays;
    the head count cannot, so it is given. Raises on a missing or
    unknown name or a shape that does not fit."""
    missing = sorted(set(JAX_GPT_NAMES) - set(arrays))
    unknown = sorted(set(arrays) - set(JAX_GPT_NAMES))
    if missing or unknown:
        raise ValueError(f"JAX GPT parameters: missing {missing}, "
                         f"unknown {unknown}")
    vocab, hidden = arrays["word_embeddings"].shape
    model = GPTForGeneration(
        vocab_size=vocab, hidden_size=hidden,
        num_layers=arrays["qkv_w"].shape[0],
        num_attention_heads=num_attention_heads,
        intermediate_size=arrays["ffn1_w"].shape[-1],
        max_position_embeddings=arrays["position_embeddings"].shape[0],
        compute_dtype=compute_dtype, device=device, dtype=dtype)
    # bf16 arrays arrive as ml_dtypes' bfloat16, which torch cannot
    # wrap: widen to fp32 first (exact), then copy_ casts to `dtype`
    state = {JAX_GPT_NAMES[n]: torch.tensor(np.asarray(a, np.float32))
             for n, a in arrays.items()}
    model.load_state_dict(state, strict=True)
    return model
