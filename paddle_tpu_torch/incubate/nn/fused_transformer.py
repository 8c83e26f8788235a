"""Fused transformer decoder stack — the serving model's core.

Port of the float-weight part of
`paddle_tpu/incubate/nn/fused_transformer.py`: the per-layer math
(`_ln`, `_mm`, `_qkv`, `_ffn_dense`, `_act`, and the MoE FFN
`_ffn_moe_tokens` / `_ffn_moe` over `_expert_matmuls`) as plain
functions on tensors, and `FusedMultiTransformer` /
`FusedMultiTransformerMoe` as `nn.Module`s holding each weight family
as ONE stacked `[num_layers, ...]` parameter under the JAX package's
`_PARAM_ORDER` names, so weights carry across unchanged
(`paddle_tpu_torch.convert`). Linear weights keep Paddle's `[in, out]`
layout: `x @ w`. The expert products run through
`ops.grouped_matmul.grouped_expert_matmul` (the Hopper kernels on a
card) on float, int8 or packed-int4 expert weights; the int8/int4
copies are made by the serving engine (`_quantize_expert_stack`).

Weight-only int8 attention weights, LoRA, tensor and expert
parallelism wait for later slices.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..._device import resolve_device
from ...ops.grouped_matmul import grouped_expert_matmul, \
    quantize_int4_experts
from ...parallel import moe_utils

#: the stacked decoder parameters, in the JAX package's order (a stack
#: holds those of its kind: `gate_w` only MoE; the `*_s` scales only
#: weight-only stacks)
_PARAM_ORDER = ("ln_s", "ln_b", "qkv_w", "qkv_b", "out_w", "out_b",
                "ffn_ln_s", "ffn_ln_b", "gate_w",
                "ffn1_w", "ffn1_b", "ffn2_w", "ffn2_b",
                "qkv_s", "out_s", "ffn1_s", "ffn2_s")


@dataclasses.dataclass(frozen=True)
class _MTConfig:
    num_layers: int
    num_heads: int
    head_dim: int
    dim_ff: int
    epsilon: float = 1e-5
    activation: str = "gelu"
    moe_quant_bits: int = 0        # expert weights: 0 float, 8 int8,
    #                                4 packed int4 (fp16 scales)
    num_experts: int = 0           # 0 = dense FFN
    moe_topk: int = 2
    capacity_factor: float = 1.25

    @property
    def embed_dim(self):
        return self.num_heads * self.head_dim


def _act(cfg, x):
    if cfg.activation == "relu":
        return F.relu(x)
    # exact (erf) gelu, as the JAX package's default
    return F.gelu(x, approximate="none")


def _ln(x, scale, bias, eps):
    """LayerNorm over the last axis, computed in fp32 and cast back."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def _mm(x, w):
    """x @ w with the weight cast to the activation dtype."""
    return torch.matmul(x, w.to(x.dtype))


def _qkv(cfg, pl, h):
    """h [B, S, D] -> q, k, v each [B, S, H, Dh] (views of one fused
    projection, not contiguous)."""
    B, S, _ = h.shape
    qkv = _mm(h, pl["qkv_w"]) + pl["qkv_b"].to(h.dtype)
    qkv = qkv.reshape(B, S, 3, cfg.num_heads, cfg.head_dim)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _ffn_dense(cfg, pl, h):
    f = _mm(h, pl["ffn1_w"]) + pl["ffn1_b"].to(h.dtype)
    f = _act(cfg, f)
    return _mm(f, pl["ffn2_w"]) + pl["ffn2_b"].to(h.dtype)


def _expert_matmuls(cfg, pl, expert_in):
    """The two stacked expert products on the [E, C, D] capacity buffers,
    weight-only dequant fused in: ffn1, its bias and the exact (erf)
    GELU, then ffn2 (its bias is the caller's). The port's attention
    weights are float, so the expert bits are `moe_quant_bits` alone
    (the JAX `_moe_bits` falls back to the stack-wide `quant_bits`)."""
    cd = expert_in.dtype
    bits = cfg.moe_quant_bits
    qmax = float(2 ** (bits - 1) - 1) if bits else 127.0
    f = grouped_expert_matmul(expert_in, pl["ffn1_w"], pl.get("ffn1_s"),
                              qmax=qmax, out_dtype=cd)
    f = _act(cfg, f + pl["ffn1_b"][:, None, :].to(cd))
    return grouped_expert_matmul(f, pl["ffn2_w"], pl.get("ffn2_s"),
                                 qmax=qmax, out_dtype=cd)


def _ffn_moe_tokens(cfg, pl, h, valid):
    """The MoE FFN on a flat [T, D] token axis: per-token top-k routing
    into fixed capacity slots (C from T, so no shape follows the
    routing), the index-based dispatch, the grouped expert products,
    ffn2's bias, and the gate-weighted combine. `valid` [T] bool (or
    None) masks padding tokens out of routing, capacity and statistics;
    a dropped (token, choice) contributes 0 and the layer's residual
    carries the token. Returns (out [T, D], stats {counts [E], dropped,
    aux})."""
    T, D = h.shape
    E = cfg.num_experts
    cd = h.dtype
    logits = torch.matmul(h.float(), pl["gate_w"].float())
    C = moe_utils.expert_capacity(T, E, cfg.moe_topk, cfg.capacity_factor)
    r = moe_utils.top_k_routing(logits, cfg.moe_topk, C, valid=valid,
                                dtype=cd)
    expert_in = moe_utils.dispatch_tokens_indexed(h, r.plan, E, C)
    eout = _expert_matmuls(cfg, pl, expert_in)
    eout = eout + pl["ffn2_b"][:, None, :].to(cd)
    out = moe_utils.combine_tokens_indexed(eout, r.plan)
    stats = {"counts": r.plan.counts, "dropped": r.plan.dropped,
             "aux": r.balance_loss}
    return out, stats


def _ffn_moe(cfg, pl, h):
    """The MoE FFN over h [B, S, D], every token routed (the scoring
    pass): returns (out [B, S, D], balance loss)."""
    B, S, D = h.shape
    out, stats = _ffn_moe_tokens(cfg, pl, h.reshape(B * S, D), None)
    return out.reshape(B, S, D), stats["aux"]


def _quantize_expert_stack(w, bits):
    """[L, E, In, Out] float -> (int8 [L, E, In, Out], fp32 scales
    [L, E, Out]) at symmetric per-out-channel amax scaling; `bits=4`
    gives the nibble-packed [L, E, In/2, Out] layout with fp16 scales
    (`quantize_int4_experts`). Dequant is `q * scale / qmax`."""
    if bits == 4:
        return quantize_int4_experts(w)
    qmax = float(2 ** (bits - 1) - 1)
    scale = w.abs().amax(dim=-2).clamp_min(1e-9)
    q = torch.clamp(torch.round(w / scale[:, :, None, :] * qmax), -qmax,
                    qmax).to(torch.int8)
    return q, scale.float()


class FusedMultiTransformer(nn.Module):
    """Multi-layer pre-LN GPT decoder stack with stacked parameters
    (`ln_s [L, D]`, `qkv_w [L, D, 3*H*Dh]`, `out_w [L, H*Dh, D]`,
    `ffn1_w [L, D, F]`, `ffn2_w [L, F, D]`, biases and LayerNorm
    parameters alongside). Initialised as the JAX stack is: unit
    LayerNorm scales, zero biases, N(0, 1/fan_in) weights."""

    def __init__(self, embed_dim, num_heads, dim_feedforward, *,
                 num_layers, activation="gelu", epsilon=1e-5,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim={embed_dim} is not a multiple "
                             f"of num_heads={num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dim_feedforward = dim_feedforward
        self.num_layers = num_layers
        self.activation = activation
        self.epsilon = epsilon
        shapes = self._shapes(num_layers, embed_dim, dim_feedforward)
        self.param_names = tuple(n for n in _PARAM_ORDER if n in shapes)
        dev = resolve_device(device)
        for name in self.param_names:
            self.register_parameter(name, nn.Parameter(
                torch.empty(shapes[name], device=dev, dtype=dtype),
                requires_grad=False))
        self.reset_parameters()

    @staticmethod
    def _shapes(L, D, Fd):
        return {"ln_s": (L, D), "ln_b": (L, D),
                "qkv_w": (L, D, 3 * D), "qkv_b": (L, 3 * D),
                "out_w": (L, D, D), "out_b": (L, D),
                "ffn_ln_s": (L, D), "ffn_ln_b": (L, D),
                "ffn1_w": (L, D, Fd), "ffn1_b": (L, Fd),
                "ffn2_w": (L, Fd, D), "ffn2_b": (L, D)}

    @torch.no_grad()
    def reset_parameters(self):
        for name in self.param_names:
            p = getattr(self, name)
            if name.endswith("_s"):
                p.fill_(1.0)
            elif name.endswith("_b"):
                p.zero_()
            else:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[-2]))

    def _cfg(self):
        return _MTConfig(num_layers=self.num_layers,
                         num_heads=self.num_heads,
                         head_dim=self.head_dim,
                         dim_ff=self.dim_feedforward,
                         epsilon=self.epsilon,
                         activation=self.activation)

    def layer_params(self, li, dtype=None):
        """Layer `li`'s parameters as a `{name: tensor}` dict (views of
        the stacked parameters, or copies cast to `dtype`)."""
        return {n: getattr(self, n)[li] if dtype is None
                else getattr(self, n)[li].to(dtype)
                for n in self.param_names}


class FusedMultiTransformerMoe(FusedMultiTransformer):
    """The stack with a top-`top_k` MoE FFN of `num_expert` experts in
    every layer: `gate_w [L, D, E]`, `ffn1_w [L, E, D, F]`,
    `ffn1_b [L, E, F]`, `ffn2_w [L, E, F, D]`, `ffn2_b [L, E, D]`.
    Experts are not sharded: `ep_size > 1` raises."""

    def __init__(self, embed_dim, num_heads, dim_feedforward, *,
                 num_layers, num_expert=4, top_k=2, capacity_factor=1.25,
                 ep_size=1, **kw):
        if ep_size != 1:
            raise ValueError(f"ep_size={ep_size}: expert parallelism is "
                             "not ported; build the full stack (ep_size=1)")
        # read by _shapes, which the base constructor calls
        self.num_expert = int(num_expert)
        self.top_k = int(top_k)
        self.capacity_factor = float(capacity_factor)
        super().__init__(embed_dim, num_heads, dim_feedforward,
                         num_layers=num_layers, **kw)

    def _shapes(self, L, D, Fd):
        E = self.num_expert
        return {**super()._shapes(L, D, Fd), "gate_w": (L, D, E),
                "ffn1_w": (L, E, D, Fd), "ffn1_b": (L, E, Fd),
                "ffn2_w": (L, E, Fd, D), "ffn2_b": (L, E, D)}

    def _cfg(self):
        return dataclasses.replace(super()._cfg(),
                                   num_experts=self.num_expert,
                                   moe_topk=self.top_k,
                                   capacity_factor=self.capacity_factor)
