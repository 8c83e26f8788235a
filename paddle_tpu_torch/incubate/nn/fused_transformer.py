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

The dense-cache decoder (`_sdp`, `_sdp_chunked`, `_write_cache`,
`_layer_body`, `_decode_layer`, `_decode_stack`, `_run_stack`) is the
JAX package's `cache_kvs` / `time_step` protocol behind
`FusedMultiTransformer.forward` and `GenerationMixin.generate()`: one
fixed-shape cache of prompt + new tokens, written in place, with a
Python loop over the layers where JAX scans. The port keeps K and V in
one layout, `[L, B, H, S_max, Dh]` each (JAX splits `[.., Dh, S]` /
`[.., S, Dh]` for the TPU's tiles), and writes only the K new columns
a step (a slice or an indexed write), never the whole cache. Its
attention is plain torch on every device, as JAX's is XLA einsums.
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
    e_offset = cfg.ep_rank * E_loc
    choices = moe_utils.dispatch_choices(r.plan, E, C)
    if ep > 1:
        choices = moe_utils.local_indices(choices, cfg.ep_rank, E_loc)
    expert_in = moe_utils.dispatch_tokens_indexed(
        h, r.plan, E, C, choices=choices, e_offset=e_offset)
    eout = _maybe_all_reduce(cfg, _expert_matmuls(cfg, pl, expert_in))
    eout = eout + pl["ffn2_b"][:, None, :].to(cd)
    out = moe_utils.combine_tokens_indexed(
        eout, r.plan, e_offset=e_offset, num_local=E_loc)
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


# ---------------------------------------------------------------------------
# the dense-cache decoder (forward, prefill, decode / verify)
# ---------------------------------------------------------------------------

def _sdp(q, k, v, mask):
    """softmax(q k^T / sqrt(Dh) + mask) v with fp32 logits. q [B, Sq,
    H, Dh], k / v [B, Sk, H, Dh]; `mask` additive (-1e9 where a key is
    refused), broadcastable to [B, H, Sq, Sk], or None."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        logits = logits + mask.float()
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _sdp_chunked(q, k, v, mask, q_block=256):
    """`_sdp` a block of `q_block` queries at a time, so no [B, H, S, S]
    logits are held at once (long prefills); S a multiple of
    `q_block`."""
    S = q.shape[1]
    if mask is not None:
        mask = mask.expand(*mask.shape[:2], S, S)
    out = [_sdp(q[:, s:s + q_block], k, v,
                None if mask is None else mask[:, :, s:s + q_block])
           for s in range(0, S, q_block)]
    return torch.cat(out, dim=1)


def _causal_mask(S, device):
    """[1, 1, S, S] additive causal mask: 0 on and below the diagonal,
    -1e9 above."""
    i = torch.arange(S, device=device)
    return torch.where(i[None, :] <= i[:, None], 0.0, -1e9)[None, None]


def _write_cache(cache_l, k, v, start):
    """Write fresh k / v [B, S, H, Dh] into one layer's caches
    (k_cache, v_cache), each [B, H, S_max, Dh], at positions
    [start, start + S), in place."""
    ck, cv = cache_l
    S = k.shape[1]
    ck[:, :, start:start + S] = k.transpose(1, 2).to(ck.dtype)
    cv[:, :, start:start + S] = v.transpose(1, 2).to(cv.dtype)
    return ck, cv


def _ffn(cfg, pl, h):
    """The layer's FFN: (out, balance loss; 0 on a dense stack)."""
    if cfg.num_experts > 0:
        return _ffn_moe(cfg, pl, h)
    return _ffn_dense(cfg, pl, h), h.new_zeros((), dtype=torch.float32)


def _out_proj(cfg, pl, attn):
    out = _maybe_all_reduce(cfg, _mm(cfg, attn, pl["out_w"],
                                     pl.get("out_s")))
    return out + pl["out_b"].to(out.dtype)


def _layer_body(cfg, x, pl, cache_l, mode, seq_lens, attn_mask):
    """One pre-LN layer over whole sequences. mode "forward": causal
    attention (or `attn_mask`, additive, in its place); "prefill": the
    causal mask plus a key-validity mask from `seq_lens` [B] (and
    `attn_mask` added), the fresh K / V written into `cache_l` at
    [0, S). Returns (x, aux)."""
    residual = x
    h = _ln(x, pl["ln_s"], pl["ln_b"], cfg.epsilon)
    q, k, v = _qkv(cfg, pl, h)
    B, S = q.shape[0], q.shape[1]
    if mode == "forward":
        mask = _causal_mask(S, x.device) if attn_mask is None else attn_mask
        attn = _sdp(q, k, v, mask)
    else:
        mask = _causal_mask(S, x.device)
        if seq_lens is not None:
            key_valid = (torch.arange(S, device=x.device)[None, :]
                         < seq_lens[:, None])
            mask = mask + torch.where(key_valid, 0.0,
                                      -1e9)[:, None, None, :]
        if attn_mask is not None:
            mask = mask + attn_mask
        if S >= 512 and S % 256 == 0:
            attn = _sdp_chunked(q, k, v, mask)
        else:
            attn = _sdp(q, k, v, mask)
        _write_cache(cache_l, k, v, 0)
    x = residual + _out_proj(cfg, pl, attn.reshape(B, S, cfg.embed_dim))
    f, aux = _ffn(cfg, pl, _ln(x, pl["ffn_ln_s"], pl["ffn_ln_b"],
                               cfg.epsilon))
    return x + f, aux


def _decode_layer(cfg, x, pl, ckf, cvf, li, step, valid):
    """One decode (K = 1) or verify (K > 1) layer over the full stacked
    caches `ckf` / `cvf` [L, B, H, S_max, Dh]. x [B, K, D]; the K fresh
    columns land at positions step .. step + K - 1 of layer `li`, in
    place: `step` an int (every row at one position, a slice write) or
    a [B] tensor (each row at its own, an indexed write). `valid`
    [1 or B, K, S_max] says which keys each query sees. Returns (x,
    aux)."""
    B, K = x.shape[0], x.shape[1]
    residual = x
    h = _ln(x, pl["ln_s"], pl["ln_b"], cfg.epsilon)
    q, k, v = _qkv(cfg, pl, h)                        # [B, K, H, Dh]
    ck, cv = ckf[li], cvf[li]                         # [B, H, S_max, Dh]
    if isinstance(step, int):
        _write_cache((ck, cv), k, v, step)
    else:
        rows = torch.arange(B, device=x.device)[:, None]
        pos = step[:, None] + torch.arange(K, device=x.device)[None, :]
        # advanced indices around a slice land first: [B, K, H, Dh]
        ck[rows, :, pos] = k.to(ck.dtype)
        cv[rows, :, pos] = v.to(cv.dtype)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bkhd,bhsd->bhks", q, ck.to(q.dtype)).float()
    logits = (logits * scale).masked_fill(~valid[:, None], -1e9)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    attn = torch.einsum("bhks,bhsd->bkhd", p, cv.to(q.dtype))
    x = residual + _out_proj(cfg, pl, attn.reshape(B, K, cfg.embed_dim))
    f, aux = _ffn(cfg, pl, _ln(x, pl["ffn_ln_s"], pl["ffn_ln_b"],
                               cfg.epsilon))
    return x + f, aux


def _decode_stack(cfg, layers, x, cache, step):
    """The decode / verify stack: `_decode_layer` over every layer in
    turn, the caches written in place. Returns (x, cache, aux sum)."""
    ckf, cvf = cache
    K, S_max = x.shape[1], ckf.shape[-2]
    offs = torch.arange(K, device=x.device)
    keys = torch.arange(S_max, device=x.device)
    if isinstance(step, int):
        last = (step + offs)[None]                          # [1, K]
    else:
        last = step[:, None] + offs[None, :]                # [B, K]
    valid = keys[None, None, :] <= last[:, :, None]
    aux = x.new_zeros((), dtype=torch.float32)
    for li, pl in enumerate(layers):
        x, a = _decode_layer(cfg, x, pl, ckf, cvf, li, step, valid)
        aux = aux + a
    return x, cache, aux


def _run_stack(cfg, layers, x, cache, mode, step=None, seq_lens=None,
               attn_mask=None):
    """The stack over `layers` (one `{name: tensor}` dict a layer) in
    `mode` "forward", "prefill" or "decode"; `cache` the (k, v) pair of
    stacked caches (None in forward mode), written in place. Returns
    (x, cache, aux sum)."""
    if mode == "decode":
        return _decode_stack(cfg, layers, x, cache, step)
    aux = x.new_zeros((), dtype=torch.float32)
    for li, pl in enumerate(layers):
        cache_l = None if cache is None else (cache[0][li], cache[1][li])
        x, a = _layer_body(cfg, x, pl, cache_l, mode, seq_lens, attn_mask)
        aux = aux + a
    return x, cache, aux


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

    def gen_cache(self, batch_size, max_seq_len, dtype=None):
        """(k_cache, v_cache), zeros, each [L, B, H, S_max, Dh] in
        `dtype` (default float32) on the stack's device: the caches of
        `forward`'s prefill and decode modes. (The JAX package splits
        K as [.., Dh, S_max] for the TPU's tiles.)"""
        dt = getattr(torch, str(dtype or "float32"))
        shape = (self.num_layers, batch_size, self.num_heads, max_seq_len,
                 self.head_dim)
        dev = self.ln_s.device
        return (torch.zeros(shape, dtype=dt, device=dev),
                torch.zeros(shape, dtype=dt, device=dev))

    @torch.no_grad()
    def forward(self, src, attn_mask=None, caches=None, seq_lens=None,
                beam_offset=None, time_step=None):
        """The reference's `cache_kvs` / `time_step` protocol. src [B, S,
        D] in the compute dtype. Without `caches`: a causal pass (or
        `attn_mask`, additive, in the causal mask's place); returns
        [B, S, D]. With `caches` (`gen_cache`) and no `time_step`:
        prefill, the causal mask plus the key-validity mask of
        `seq_lens` [B] (and `attn_mask` added), K / V written at [0, S).
        With `time_step`: decode (S = 1) or verify (S > 1) at position
        `time_step`, an int or a one-element tensor for every row, or
        a [B] tensor a row; `seq_lens` [B], when given in decode, are
        the rows' positions. Cached modes write the caches in place and
        return (out, caches)."""
        if beam_offset is not None:
            raise NotImplementedError("beam_offset: use generate()'s "
                                      "batched beams instead")
        mode = "forward"
        if caches is not None:
            mode = "decode" if time_step is not None else "prefill"
        if mode == "decode":
            if attn_mask is not None:
                raise NotImplementedError(
                    "attn_mask in decode mode: the cache mask is derived "
                    "from positions - pass per-row positions via "
                    "time_step/seq_lens instead")
            if seq_lens is not None:
                # per-row current lengths are the write / attend positions
                time_step, seq_lens = seq_lens, None
            step = torch.as_tensor(time_step, device=src.device)
            step = (int(step.reshape(())) if step.numel() == 1
                    else step.to(torch.int64).reshape(-1))
        else:
            step = None
            if seq_lens is not None:
                seq_lens = torch.as_tensor(seq_lens, device=src.device)
        layers = [self.layer_params(li) for li in range(self.num_layers)]
        out, caches, _ = _run_stack(self._cfg(), layers, src, caches, mode,
                                    step, seq_lens, attn_mask)
        return out if caches is None else (out, caches)

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
