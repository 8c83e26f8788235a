"""Carry JAX models' parameters into the port.

* `load_jax_gpt`: a JAX `GPTForGeneration` (dense or MoE, float or
  weight-only), given as a `{name: np.ndarray}` dict in the order of the
  JAX model's `_gen_tensors()`: `word_embeddings`,
  `position_embeddings`, each decoder parameter under its `_PARAM_ORDER`
  name (a weight-only stack's int8 weights and `*_s` scales included),
  `ln_f.weight`, `ln_f.bias` and `lm_head.weight`.
* `load_jax_hybrid_gpt`: the JAX `HybridGPT` trainer's nested `params`
  (and optionally its `opt_state`, per-parameter or ZeRO-flat), dense
  or MoE, as `jax.device_get` returns them; `shard_jax_hybrid_gpt`
  cuts them to one rank's shard of a (dp, pp, mp, ep) mesh. A state
  trained by JAX at mp = k (`jax_mp=k`) has its fused `w_qkv`, `b_qkv`
  and their moments put back from JAX's contiguous mp cut into the
  logical (3, H, Dh) layout, so the port computes what JAX's mp = k
  trainer computed.
* `load_jax_bert`: a JAX `BertModel`, `BertForPretraining` or
  `BertForSequenceClassification`, given as its `state_dict()`
  (`{name: np.ndarray}` under the JAX names).

The caller builds the numpy inputs from the JAX side (only code that
imports both packages does); this module never touches jax.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .incubate.nn.fused_transformer import _PARAM_ORDER, _SCALE_NAMES
from .models import bert as _bert
from .models.gpt import GPTForGeneration
from .parallel.hybrid_gpt import param_shapes, shard_state
from .parallel.mp_layers import logical_qkv

_HEAD_NAMES = {"word_embeddings": "word_embeddings.weight",
               "position_embeddings": "position_embeddings.weight",
               "ln_f.weight": "ln_f.weight", "ln_f.bias": "ln_f.bias",
               "lm_head.weight": "lm_head.weight"}


def jax_gpt_names(moe=False, weight_only=False):
    """{input name: the port's state_dict key} of a JAX
    `GPTForGeneration`, dense or (`moe`) MoE, float or weight-only."""
    dec = [n for n in _PARAM_ORDER
           if (weight_only or n not in _SCALE_NAMES)
           and (moe or n != "gate_w")]
    return {**_HEAD_NAMES, **{n: f"decoder.{n}" for n in dec}}


def load_jax_gpt(arrays, num_attention_heads, *, moe=None,
                 compute_dtype="float32", device="cuda",
                 dtype=torch.float32) -> GPTForGeneration:
    """A `GPTForGeneration` on `device`, its float parameters stored as
    `dtype`, holding exactly `arrays`. Shapes follow from the arrays;
    the head count cannot, so it is given, and neither can a MoE stack's
    routing: pass the JAX model's `moe=dict(num_expert, top_k,
    capacity_factor)` for one (with `moe_quant_bits=4` for packed int4
    experts). Any weight-only scale (`*_s`) makes a weight-only model:
    the four projections' int8 weights and their scales are taken as
    they are (fp32 scales; fp16 for packed int4 experts), at int8
    attention (`quant_bits` 8). Raises on a missing or unknown name, a
    shape or dtype that does not fit, `gate_w` without `moe=` or `moe=`
    without `gate_w`."""
    scales = sorted(n for n in arrays if n in _SCALE_NAMES)
    weight_only = bool(scales)
    if weight_only and len(scales) != len(_SCALE_NAMES):
        raise ValueError(f"JAX GPT parameters: weight-only scales {scales}"
                         f" without {sorted(set(_SCALE_NAMES) - set(scales))}"
                         ": a weight-only stack quantizes all four "
                         "projections")
    if ("gate_w" in arrays) != bool(moe):
        raise ValueError("JAX GPT parameters: a MoE stack needs both "
                         "`gate_w` and moe=dict(num_expert, top_k, "
                         f"capacity_factor); got gate_w "
                         f"{'present' if 'gate_w' in arrays else 'absent'}"
                         f" and moe={moe!r}")
    names = jax_gpt_names(bool(moe), weight_only)
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
        weight_only=weight_only, moe=moe, compute_dtype=compute_dtype,
        device=device, dtype=dtype)
    want = model.state_dict()
    state = {}
    for n, a in arrays.items():
        a = np.asarray(a)
        target = want[names[n]]
        if not target.is_floating_point() or n in _SCALE_NAMES:
            # quantized weights and their scales keep their bytes: the
            # dtype must be the stack's own
            got = torch.tensor(a)
            if got.dtype != target.dtype or got.shape != target.shape:
                raise ValueError(f"JAX GPT parameters[{n}]: {a.dtype} "
                                 f"{a.shape}, expected {target.dtype} "
                                 f"{tuple(target.shape)}")
            state[names[n]] = got
        else:
            # bf16 arrays arrive as ml_dtypes' bfloat16, which torch
            # cannot wrap: widen to fp32 first (exact), then copy_ casts
            # to `dtype`
            state[names[n]] = torch.tensor(np.asarray(a, np.float32))
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


def _load_moments(tree, shapes, what, device):
    """Adam moments, one {"m", "v"} per parameter, full-shaped: JAX's
    zero_stage 0 moments as they are, its ZeRO-flat ones (a flat vector
    padded to a multiple of its world) cut to the parameter's size and
    reshaped."""
    missing = sorted(set(shapes) - set(tree))
    unknown = sorted(set(tree) - set(shapes))
    if missing or unknown:
        raise ValueError(f"{what}: missing {missing}, unknown {unknown}")
    out = {}
    for name, want in shapes.items():
        if isinstance(want, dict):
            out[name] = _load_moments(tree[name], want, f"{what}[{name}]",
                                      device)
            continue
        if not isinstance(tree[name], dict) or set(tree[name]) != {"m",
                                                                   "v"}:
            raise ValueError(f"{what}[{name}]: expected {{'m', 'v'}}")
        n = int(np.prod(want))
        out[name] = {}
        for k, a in tree[name].items():
            shape = tuple(np.shape(a))
            if shape != want:
                if len(shape) != 1 or shape[0] < n:
                    raise ValueError(f"{what}[{name}][{k}]: shape {shape},"
                                     f" expected {want} or flat >= {n}")
                a = np.asarray(a, np.float32)[:n].reshape(want)
            out[name][k] = _as_tensor(a, device)
    return out


def load_jax_hybrid_gpt(params, opt_state=None, *, device="cuda", jax_mp=1,
                        n_heads=None):
    """The JAX trainer's `params` as the port's fp32 parameter dict on
    `device` (`paddle_tpu_torch.parallel.hybrid_gpt`), dense or MoE, and
    with `opt_state` given, `(params, opt_state)` with fp32 Adam moments
    shaped as their parameters (JAX's ZeRO-flat moments unflattened).
    Widths follow from the arrays; raises on a missing or unknown name
    or a shape that does not fit them. `jax_mp`: the mp of the JAX
    trainer the state comes from; above 1 (`n_heads` then needed) the
    fused qkv leaves and their moments are put back into the logical
    layout (JAX's trainer cuts them contiguously over mp, so at mp = k
    its rank r reads chunk r of the fused axis as (3, H / k, Dh))."""
    dev = resolve_device(device)
    try:
        V, d = np.shape(params["tok_emb"])
        S = np.shape(params["pos_emb"])[0]
        E = np.shape(params["blocks"]["gate"])[-1] \
            if "gate" in params["blocks"] else 0
        L, ff = (np.shape(params["blocks"]["w_fc1"])[i] for i in (0, -1))
    except (KeyError, TypeError, ValueError, IndexError) as e:
        raise ValueError(f"JAX HybridGPT parameters: cannot read the "
                         f"widths ({e!r})") from None
    shapes = param_shapes(V, S, d, ff, L, E)
    if jax_mp > 1 and not n_heads:
        raise ValueError("jax_mp > 1 needs n_heads")

    def logical(tree):
        for name in ("w_qkv", "b_qkv") if jax_mp > 1 else ():
            leaf = tree["blocks"][name]
            tree["blocks"][name] = (
                {k: logical_qkv(t, jax_mp, n_heads, d // n_heads)
                 for k, t in leaf.items()} if isinstance(leaf, dict)
                else logical_qkv(leaf, jax_mp, n_heads, d // n_heads))
        return tree
    out = logical(_load_tree(params, shapes, "JAX HybridGPT params", dev))
    if opt_state is None:
        return out
    return out, logical(_load_moments(opt_state, shapes,
                                      "JAX HybridGPT opt_state", dev))


def shard_jax_hybrid_gpt(params, opt_state=None, *, cfg, rank,
                         device="cuda", jax_mp=1):
    """`load_jax_hybrid_gpt`, cut to rank `rank`'s shard of `cfg`'s
    (dp, pp, mp, ep) mesh in its ZeRO layout (`hybrid_gpt.shard_state`):
    a JAX trainer's state at zero_stage 0 or 1, trained at any mp
    (`jax_mp`), starts the port at any mesh."""
    full = load_jax_hybrid_gpt(params, opt_state, device=device,
                               jax_mp=jax_mp, n_heads=cfg.n_heads)
    if opt_state is None:
        return shard_state(cfg, full, None, rank)
    return shard_state(cfg, *full, rank)


_BERT_HEADS = ("pretraining", "sequence_classification")


def load_jax_bert(arrays, config, *, head=None, device="cuda",
                  dtype=torch.float32):
    """The port's BERT on `device` holding exactly `arrays`, the JAX
    model's `state_dict()` as `{name: np.ndarray}`. `config` is the JAX
    `BertModel`'s keyword arguments; `head` None gives a `BertModel`,
    "pretraining" a `BertForPretraining` (its MLM decoder tied to the
    word embeddings, which JAX names once, as
    `bert.embeddings.word_embeddings.weight`) and
    "sequence_classification" a `BertForSequenceClassification` with as
    many classes as `classifier.weight` has columns. `dtype` casts
    every floating parameter, as `amp.decorate(level="O2")` does at
    bfloat16. Raises on a missing or unknown name, or a shape that does
    not fit."""
    if head is not None and head not in _BERT_HEADS:
        raise ValueError(f"load_jax_bert: head must be None or one of "
                         f"{_BERT_HEADS}, got {head!r}")
    model = _bert.BertModel(**config, device=device)
    if head == "pretraining":
        model = _bert.BertForPretraining(model)
    elif head == "sequence_classification":
        if "classifier.weight" not in arrays:
            raise ValueError("JAX BERT parameters: missing "
                             "['classifier.weight']")
        model = _bert.BertForSequenceClassification(
            model, num_classes=np.shape(arrays["classifier.weight"])[-1])
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    unknown = sorted(set(arrays) - set(params))
    if missing or unknown:
        raise ValueError(f"JAX BERT parameters: missing {missing}, "
                         f"unknown {unknown}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(np.shape(arrays[name])) != tuple(p.shape):
                raise ValueError(f"JAX BERT parameters[{name}]: shape "
                                 f"{tuple(np.shape(arrays[name]))}, "
                                 f"expected {tuple(p.shape)}")
            p.copy_(_as_tensor(arrays[name], p.device))
    return model.to(dtype)
