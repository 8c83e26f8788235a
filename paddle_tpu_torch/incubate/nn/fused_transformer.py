"""Fused transformer decoder stack — the serving model's core.

Port of `paddle_tpu/incubate/nn/fused_transformer.py`: the per-layer
math (`_ln`, `_mm`, `_qkv`, `_ffn_dense`, `_act`, the multi-LoRA delta
`_lora_delta`, and the MoE FFN `_ffn_moe_tokens` / `_ffn_moe` over
`_expert_matmuls`) as plain functions on tensors, and
`FusedMultiTransformer` / `FusedMultiTransformerMoe` as `nn.Module`s
holding each weight family as ONE stacked `[num_layers, ...]` tensor
under the JAX package's `_PARAM_ORDER` names, so weights carry across
unchanged (`paddle_tpu_torch.convert`). Linear weights keep Paddle's
`[in, out]` layout: `x @ w`.

Weight-only stacks (`FusedMultiTransformerWeightOnly`,
`FusedMultiTransformerMoeWeightOnly`) hold the projections as int8
buffers with a scale for each output channel (`*_s`); `_mm` with a
scale runs `ops.grouped_matmul.weight_only_matmul`, the Hopper K4
kernel at one group on a card, so the weight crosses device memory as
int8. The expert products run through
`ops.grouped_matmul.grouped_expert_matmul` on float, int8 or
packed-int4 expert weights; the serving engine can also quantize a
float stack's experts itself (`_quantize_expert_stack`).

Under tensor parallelism (`serving.distributed.TPServingEngine`) the
functions run on one rank's shard: `cfg.num_heads` is the rank's heads,
and `cfg.mp_group` names the group over which the row-parallel products
(attention out, ffn2, each expert's ffn2) are all-reduced before their
bias. Under expert parallelism (`cfg.ep_size > 1`) a rank holds
`E / ep_size` experts, runs them on its rows of the dispatch table and
all-reduces its partial combine over `cfg.ep_group`.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..._device import resolve_device
from ...ops.grouped_matmul import (grouped_expert_matmul,
                                   quantize_int4_experts,
                                   weight_only_matmul)
from ...parallel import moe_utils

#: the stacked decoder parameters, in the JAX package's order (a stack
#: holds those of its kind: `gate_w` only MoE; the `*_s` scales only
#: weight-only stacks)
_PARAM_ORDER = ("ln_s", "ln_b", "qkv_w", "qkv_b", "out_w", "out_b",
                "ffn_ln_s", "ffn_ln_b", "gate_w",
                "ffn1_w", "ffn1_b", "ffn2_w", "ffn2_b",
                "qkv_s", "out_s", "ffn1_s", "ffn2_s")
#: the weight-only scales, one for each quantized projection
_SCALE_NAMES = ("qkv_s", "out_s", "ffn1_s", "ffn2_s")


@dataclasses.dataclass(frozen=True)
class _MTConfig:
    num_layers: int
    num_heads: int
    head_dim: int
    dim_ff: int
    epsilon: float = 1e-5
    activation: str = "gelu"
    quant_bits: int = 0            # 0 float weights, 8 weight-only int8
    moe_quant_bits: int = 0        # expert-stack override: 0 follows
    #                                quant_bits, 8 int8, 4 packed int4
    #                                (fp16 scales)
    num_experts: int = 0           # 0 = dense FFN
    moe_topk: int = 2
    capacity_factor: float = 1.25
    mp_group: object = None        # the TP group the row-parallel
    #                                products are all-reduced over
    ep_group: object = None        # the EP group of the MoE combine
    ep_size: int = 1
    ep_rank: int = 0

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


def _mm(cfg, x, w, scale=None):
    """x @ w with the weight cast to the activation dtype; with a scale
    (a weight-only int8 `w`, a scale for each output channel) x @
    (w * scale / qmax) at `qmax = 2**(quant_bits-1) - 1`, through
    `weight_only_matmul`: on a card the K4 kernel reads the int8 bytes
    and dequantizes in registers, on the CPU the plain formula."""
    if scale is None:
        return torch.matmul(x, w.to(x.dtype))
    qmax = float(2 ** (cfg.quant_bits - 1) - 1)
    return weight_only_matmul(x, w, scale, qmax=qmax)


def _maybe_all_reduce(cfg, x):
    """Sum x over the TP group in place (no-op without one): the
    counterpart of the JAX package's `_maybe_psum`. A failed collective
    raises; nothing is caught."""
    if cfg.mp_group is not None:
        dist.all_reduce(x, group=cfg.mp_group)
    return x


def _lora_delta(x, a, b, oh):
    """The multi-LoRA delta of one hooked projection (`serving/
    adapters.py`): x [..., d_in] with T rows in all, the slot tensors a
    [K, d_in, r] / b [K, r, d_out] (slot 0 the all-zero null adapter),
    oh [T, K] the per-token adapter one-hot. Returns x @ a[aid] @ b[aid]
    per token in x's dtype, computed in fp32 as JAX computes it: every
    slot's rank-r projection (`td,kdr->tkr`), selected through the
    one-hot, masked back to [T, K, r] and contracted over k and r at
    once. One-hot rows are exact {0, 1}, so a token's delta does not
    depend on the other slots, and the null slot's is exactly 0.0
    (alpha / r is folded into b when an adapter loads)."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1]).float()
    ohf = oh.float()
    ya = torch.einsum("td,kdr->tkr", xf, a.float())
    y = torch.einsum("tkr,tk->tr", ya, ohf)
    yk = y[:, None, :] * ohf[:, :, None]                   # [T, K, r]
    z = torch.einsum("tkr,krd->td", yk, b.float())
    return z.reshape(*lead, b.shape[-1]).to(x.dtype)


def _qkv(cfg, pl, h, lora_oh=None):
    """h [B, S, D] -> q, k, v each [B, S, H, Dh] (views of one fused
    projection, not contiguous). `lora_oh` [B*S, K] adds the multi-LoRA
    delta before the bias (the serving step, where `pl` holds the
    layer's `lora_qkv_a` / `lora_qkv_b`)."""
    B, S, _ = h.shape
    qkv = _mm(cfg, h, pl["qkv_w"], pl.get("qkv_s"))
    if lora_oh is not None and "lora_qkv_a" in pl:
        qkv = qkv + _lora_delta(h, pl["lora_qkv_a"], pl["lora_qkv_b"],
                                lora_oh)
    qkv = qkv + pl["qkv_b"].to(qkv.dtype)
    qkv = qkv.reshape(B, S, 3, cfg.num_heads, cfg.head_dim)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _ffn_dense(cfg, pl, h, lora_oh=None):
    f = _mm(cfg, h, pl["ffn1_w"], pl.get("ffn1_s"))
    if lora_oh is not None and "lora_ffn1_a" in pl:
        f = f + _lora_delta(h, pl["lora_ffn1_a"], pl["lora_ffn1_b"],
                            lora_oh)
    f = _act(cfg, f + pl["ffn1_b"].to(f.dtype))
    g = _mm(cfg, f, pl["ffn2_w"], pl.get("ffn2_s"))
    if lora_oh is not None and "lora_ffn2_a" in pl:
        # row-parallel under TP: the rank's A holds its F/tp rows, so the
        # delta is a partial sum that joins the base product's reduction
        g = g + _lora_delta(f, pl["lora_ffn2_a"], pl["lora_ffn2_b"],
                            lora_oh)
    return _maybe_all_reduce(cfg, g) + pl["ffn2_b"].to(g.dtype)


def _moe_bits(cfg):
    """The expert stack's weight-only bits: the `moe_quant_bits`
    override when set, else the stack-wide `quant_bits`."""
    return cfg.moe_quant_bits or cfg.quant_bits


def _expert_matmuls(cfg, pl, expert_in):
    """The two stacked expert products on the [E, C, D] capacity buffers,
    weight-only dequant fused in: ffn1, its bias and the exact (erf)
    GELU, then ffn2 (its bias is the caller's). The expert bits come
    from `_moe_bits`."""
    cd = expert_in.dtype
    bits = _moe_bits(cfg)
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
    carries the token.

    Expert parallelism (`cfg.ep_size` > 1): the token set and the routing
    are the same on every rank, so the training path's all-to-all is not
    needed: the rank gathers only its E/ep resident experts' rows of the
    dispatch table, runs them, reduces ffn2 over `cfg.mp_group` before
    the bias, combines their outputs alone and all-reduces the partial
    mixture over `cfg.ep_group`. The statistics are the same on every
    rank and are not reduced. Returns (out [T, D], stats {counts [E],
    dropped, aux})."""
    T, D = h.shape
    E = cfg.num_experts
    cd = h.dtype
    logits = torch.matmul(h.float(), pl["gate_w"].float())
    C = moe_utils.expert_capacity(T, E, cfg.moe_topk, cfg.capacity_factor)
    r = moe_utils.top_k_routing(logits, cfg.moe_topk, C, valid=valid,
                                dtype=cd)
    ep = cfg.ep_size
    E_loc = E // ep
    tos = moe_utils.dispatch_indices(r.plan, E, C)
    if ep > 1:
        tos = moe_utils.local_indices(tos, cfg.ep_rank, E_loc)
    expert_in = moe_utils.dispatch_tokens_indexed(h, r.plan, E_loc, C,
                                                  indices=tos)
    eout = _maybe_all_reduce(cfg, _expert_matmuls(cfg, pl, expert_in))
    eout = eout + pl["ffn2_b"][:, None, :].to(cd)
    out = moe_utils.combine_tokens_indexed(
        eout, r.plan, e_offset=cfg.ep_rank * E_loc, num_local=E_loc)
    if ep > 1:
        dist.all_reduce(out, group=cfg.ep_group)
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


def _quantize_stack(w, bits):
    """[L, In, Out] float -> (int8 [L, In, Out], fp32 scales [L, Out]):
    symmetric per-out-channel amax scaling, the JAX package's
    `_quantize_stack` (the same bytes on the same fp32 input). Dequant
    is `q * scale / qmax`."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = w.abs().amax(dim=-2).clamp_min(1e-9)
    q = torch.clamp(torch.round(w / scale[:, None, :] * qmax), -qmax,
                    qmax).to(torch.int8)
    return q, scale.float()


def _cast_param(name, t, dtype):
    """One decoder entry in the compute `dtype`, as the JAX engine casts
    its arrays: integer (quantized) weights stay as they are, and a
    weight-only scale is cast only from fp32 or fp64 (the int4 experts'
    fp16 scales stay fp16); every other float entry is cast."""
    if not t.is_floating_point() or (
            name in _SCALE_NAMES
            and t.dtype not in (torch.float32, torch.float64)):
        return t
    return t.to(dtype)


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
        # weight-only bits (0: float weights); the weight-only stacks set
        # them after quantizing
        self.quant_bits = 0
        self.moe_quant_bits = 0
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
                         activation=self.activation,
                         quant_bits=self.quant_bits,
                         moe_quant_bits=self.moe_quant_bits)

    def layer_params(self, li, dtype=None):
        """Layer `li`'s parameters as a `{name: tensor}` dict (views of
        the stacked tensors, or with `dtype` cast as `_cast_param`
        casts: integer weights never)."""
        return {n: getattr(self, n)[li] if dtype is None
                else _cast_param(n, getattr(self, n)[li], dtype)
                for n in self.param_names}

    def _quantize_param(self, name, quantize):
        """Replace the float parameter `name` (`qkv_w`, ...) by the int8
        buffer and the scale buffer (`qkv_s`, ...) that `quantize` makes
        of it."""
        q, s = quantize(getattr(self, name).detach().float())
        del self._parameters[name]
        self.register_buffer(name, q)
        self.register_buffer(name[:-2] + "_s", s)
        self.param_names = tuple(n for n in _PARAM_ORDER
                                 if hasattr(self, n))


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


class FusedMultiTransformerWeightOnly(FusedMultiTransformer):
    """The weight-only int8 stack (the JAX package's class of the same
    name): `qkv_w`, `out_w`, `ffn1_w`, `ffn2_w` are int8 buffers with
    per-out-channel fp32 scales `qkv_s`, `out_s`, `ffn1_s`, `ffn2_s`
    [L, Out], quantized at `quant_bits` from the float weights the
    constructor draws. Build one from a float stack with `from_float`."""

    def __init__(self, *args, quant_bits=8, **kw):
        super().__init__(*args, **kw)
        self.quant_bits = int(quant_bits)
        for name in ("qkv_w", "out_w", "ffn1_w", "ffn2_w"):
            self._quantize_param(
                name, lambda w: _quantize_stack(w, self.quant_bits))

    @classmethod
    def from_float(cls, model, quant_bits=8):
        """The weight-only twin of the float stack `model`: its LayerNorm
        parameters and biases as they are, its four projections
        quantized (`_quantize_stack`). A MoE stack is refused: build
        `FusedMultiTransformerMoeWeightOnly` directly."""
        if isinstance(model, FusedMultiTransformerMoe):
            raise TypeError("from_float on a MoE stack: build "
                            "FusedMultiTransformerMoeWeightOnly directly")
        new = cls(model.embed_dim, model.num_heads, model.dim_feedforward,
                  num_layers=model.num_layers, activation=model.activation,
                  epsilon=model.epsilon, device=model.ln_s.device,
                  dtype=model.ln_s.dtype, quant_bits=quant_bits)
        with torch.no_grad():
            for name in model.param_names:
                if name in ("qkv_w", "out_w", "ffn1_w", "ffn2_w"):
                    q, s = _quantize_stack(getattr(model, name).float(),
                                           quant_bits)
                    getattr(new, name).copy_(q)
                    getattr(new, name[:-2] + "_s").copy_(s)
                else:
                    getattr(new, name).copy_(getattr(model, name))
        return new


#: the reference's name for the weight-only stack
FusedMultiTransformerINT8 = FusedMultiTransformerWeightOnly


class FusedMultiTransformerMoeWeightOnly(FusedMultiTransformerMoe):
    """The MoE stack with weight-only attention and experts (the JAX
    package's class of the same name): `qkv_w` / `out_w` int8 at
    `quant_bits` with fp32 scales; the experts at `moe_quant_bits` (or
    `quant_bits` when it is None): 8 gives int8 [L, E, In, Out] with
    fp32 scales [L, E, Out], 4 the nibble-packed [L, E, In/2, Out] with
    fp16 scales (`_quantize_expert_stack`)."""

    def __init__(self, *args, quant_bits=8, moe_quant_bits=None, **kw):
        ebits = int(moe_quant_bits or 0) or int(quant_bits)
        if ebits not in (4, 8):
            raise ValueError(
                f"expert weight-only bits must be 4 or 8, got {ebits}")
        super().__init__(*args, **kw)
        self.quant_bits = int(quant_bits)
        self.moe_quant_bits = int(moe_quant_bits or 0)
        for name in ("qkv_w", "out_w"):
            self._quantize_param(
                name, lambda w: _quantize_stack(w, self.quant_bits))
        for name in ("ffn1_w", "ffn2_w"):
            self._quantize_param(
                name, lambda w: _quantize_expert_stack(w, ebits))


#: the reference's name for the weight-only MoE stack
FusedMultiTransformerMoeINT8 = FusedMultiTransformerMoeWeightOnly
