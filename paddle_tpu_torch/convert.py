"""Carry JAX models' parameters into the port.

* `load_jax_gpt`: a JAX `GPTForGeneration` (dense or MoE, float
  weights), given as a `{name: np.ndarray}` dict in the order of the
  JAX model's `_gen_tensors()`: `word_embeddings`,
  `position_embeddings`, each decoder parameter under its `_PARAM_ORDER`
  name, `ln_f.weight`, `ln_f.bias` and `lm_head.weight`.
* `load_jax_hybrid_gpt`: the JAX `HybridGPT` trainer's nested `params`
  (and optionally its zero_stage-0 `opt_state`), as `jax.device_get`
  returns them.

The caller builds the numpy inputs from the JAX side (only code that
imports both packages does); this module never touches jax.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .incubate.nn.fused_transformer import _PARAM_ORDER
from .models.gpt import GPTForGeneration
from .parallel.hybrid_gpt import param_shapes

_SCALE_NAMES = ("qkv_s", "out_s", "ffn1_s", "ffn2_s")
_HEAD_NAMES = {"word_embeddings": "word_embeddings.weight",
               "position_embeddings": "position_embeddings.weight",
               "ln_f.weight": "ln_f.weight", "ln_f.bias": "ln_f.bias",
               "lm_head.weight": "lm_head.weight"}


def jax_gpt_names(moe=False):
    """{input name: the port's state_dict key} of a float JAX
    `GPTForGeneration`, dense or (`moe`) MoE."""
    dec = [n for n in _PARAM_ORDER
           if n not in _SCALE_NAMES and (moe or n != "gate_w")]
    return {**_HEAD_NAMES, **{n: f"decoder.{n}" for n in dec}}


def load_jax_gpt(arrays, num_attention_heads, *, moe=None,
                 compute_dtype="float32", device="cuda",
                 dtype=torch.float32) -> GPTForGeneration:
    """A `GPTForGeneration` on `device`, its parameters stored as
    `dtype`, holding exactly `arrays`. Shapes follow from the arrays;
    the head count cannot, so it is given, and neither can a MoE stack's
    routing: pass the JAX model's `moe=dict(num_expert, top_k,
    capacity_factor)` for one. Raises on a missing or unknown name, a
    shape that does not fit, `gate_w` without `moe=` or `moe=` without
    `gate_w`, and any weight-only scale (`*_s`): pre-quantized stacks
    are not carried across yet."""
    scales = sorted(n for n in arrays if n in _SCALE_NAMES)
    if scales:
        raise ValueError(f"JAX GPT parameters: weight-only scales {scales}"
                         " are not supported; carry the float model "
                         "across and quantize the experts in the engine "
                         "(ServingEngine(moe_weight_dtype=...))")
    if ("gate_w" in arrays) != bool(moe):
        raise ValueError("JAX GPT parameters: a MoE stack needs both "
                         "`gate_w` and moe=dict(num_expert, top_k, "
                         f"capacity_factor); got gate_w "
                         f"{'present' if 'gate_w' in arrays else 'absent'}"
                         f" and moe={moe!r}")
    names = jax_gpt_names(bool(moe))
    missing = sorted(set(names) - set(arrays))
    unknown = sorted(set(arrays) - set(names))
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
        moe=moe, compute_dtype=compute_dtype, device=device, dtype=dtype)
    # bf16 arrays arrive as ml_dtypes' bfloat16, which torch cannot
    # wrap: widen to fp32 first (exact), then copy_ casts to `dtype`
    state = {names[n]: torch.tensor(np.asarray(a, np.float32))
             for n, a in arrays.items()}
    model.load_state_dict(state, strict=True)
    return model


def _as_tensor(a, device):
    # bf16 arrays arrive as ml_dtypes' bfloat16, which torch cannot wrap:
    # widen to fp32 (exact)
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _load_tree(tree, shapes, what, device):
    missing = sorted(set(shapes) - set(tree))
    unknown = sorted(set(tree) - set(shapes))
    if missing or unknown:
        raise ValueError(f"{what}: missing {missing}, unknown {unknown}")
    out = {}
    for name, want in shapes.items():
        if isinstance(want, dict):
            out[name] = _load_tree(tree[name], want, f"{what}[{name}]",
                                   device)
            continue
        a = tree[name]
        if tuple(np.shape(a)) != want:
            raise ValueError(f"{what}[{name}]: shape {tuple(np.shape(a))},"
                             f" expected {want}")
        out[name] = _as_tensor(a, device)
    return out


def load_jax_hybrid_gpt(params, opt_state=None, *, device="cuda"):
    """The JAX trainer's `params` as the port's fp32 parameter dict on
    `device` (`paddle_tpu_torch.parallel.hybrid_gpt`), and with
    `opt_state` given, `(params, opt_state)` with fp32 Adam moments.
    Widths follow from the arrays; raises on a missing or unknown name
    or a shape that does not fit them (MoE and ZeRO-flat layouts
    included)."""
    dev = resolve_device(device)
    try:
        V, d = np.shape(params["tok_emb"])
        S = np.shape(params["pos_emb"])[0]
        L, _, ff = np.shape(params["blocks"]["w_fc1"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"JAX HybridGPT parameters: cannot read the "
                         f"widths ({e!r})") from None
    shapes = param_shapes(V, S, d, ff, L)
    out = _load_tree(params, shapes, "JAX HybridGPT params", dev)
    if opt_state is None:
        return out

    def moments(sh):
        return {k: moments(v) if isinstance(v, dict) else
                {"m": v, "v": v} for k, v in sh.items()}
    return out, _load_tree(opt_state, moments(shapes),
                           "JAX HybridGPT opt_state", dev)
