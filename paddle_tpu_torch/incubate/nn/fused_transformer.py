"""Fused transformer decoder stack — the serving model's core.

Port of the dense, float-weight part of
`paddle_tpu/incubate/nn/fused_transformer.py`: the per-layer math
(`_ln`, `_mm`, `_qkv`, `_ffn_dense`, `_act`) as plain functions on
tensors, and `FusedMultiTransformer` as an `nn.Module` holding each
weight family as ONE stacked `[num_layers, ...]` parameter under the
JAX package's `_PARAM_ORDER` names, so weights carry across unchanged
(`paddle_tpu_torch.convert`). Linear weights keep Paddle's `[in, out]`
layout: `x @ w`.

Weight-only int8, MoE, LoRA and tensor parallelism wait for later
slices.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..._device import resolve_device

#: the stacked decoder parameters, in the JAX package's order
_PARAM_ORDER = ("ln_s", "ln_b", "qkv_w", "qkv_b", "out_w", "out_b",
                "ffn_ln_s", "ffn_ln_b", "ffn1_w", "ffn1_b", "ffn2_w",
                "ffn2_b")


@dataclasses.dataclass(frozen=True)
class _MTConfig:
    num_layers: int
    num_heads: int
    head_dim: int
    dim_ff: int
    epsilon: float = 1e-5
    activation: str = "gelu"

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
        L, D, Fd = num_layers, embed_dim, dim_feedforward
        shapes = {"ln_s": (L, D), "ln_b": (L, D),
                  "qkv_w": (L, D, 3 * D), "qkv_b": (L, 3 * D),
                  "out_w": (L, D, D), "out_b": (L, D),
                  "ffn_ln_s": (L, D), "ffn_ln_b": (L, D),
                  "ffn1_w": (L, D, Fd), "ffn1_b": (L, Fd),
                  "ffn2_w": (L, Fd, D), "ffn2_b": (L, D)}
        dev = resolve_device(device)
        for name in _PARAM_ORDER:
            self.register_parameter(name, nn.Parameter(
                torch.empty(shapes[name], device=dev, dtype=dtype),
                requires_grad=False))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self):
        for name in _PARAM_ORDER:
            p = getattr(self, name)
            if name.endswith("_s"):
                p.fill_(1.0)
            elif name.endswith("_b"):
                p.zero_()
            else:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]))

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
                for n in _PARAM_ORDER}
