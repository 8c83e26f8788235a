"""GPT for generation — the serving model.

Port of `paddle_tpu/models/gpt.py:GPTForGeneration`: word and position
embeddings, the stacked `FusedMultiTransformer` decoder
(`FusedMultiTransformerMoe` with `moe=dict(num_expert, top_k,
capacity_factor)`; with `weight_only=True` the int8 stacks
`FusedMultiTransformerWeightOnly` and, with `moe=` (which may add
`moe_quant_bits`), `FusedMultiTransformerMoeWeightOnly`), a final
LayerNorm `ln_f` and a bias-free `lm_head` whose weight keeps Paddle's
`[in, out]` = `[D, V]` layout.

`forward` is the plain dense causal pass over whole sequences — the
scoring oracle the serving engine's paged path is checked against.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .._device import resolve_device
from ..incubate.nn.fused_transformer import (
    FusedMultiTransformer, FusedMultiTransformerMoe,
    FusedMultiTransformerMoeWeightOnly, FusedMultiTransformerWeightOnly,
    _ffn_dense, _ffn_moe, _ln, _mm, _qkv)


class _Head(nn.Module):
    """Bias-free projection holding its weight as `[in, out]`."""

    def __init__(self, d_in, d_out, *, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(d_in, d_out, device=device, dtype=dtype),
            requires_grad=False)


def _causal_attention(q, k, v):
    """softmax(q k^T / sqrt(Dh), causal) v with fp32 logits; q/k/v
    [B, S, H, Dh]."""
    S = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    logits = logits / math.sqrt(q.shape[-1])
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~causal, -1e9)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class GPTForGeneration(nn.Module):
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_attention_heads=12, intermediate_size=None,
                 max_position_embeddings=1024, weight_only=False, moe=None,
                 compute_dtype="float32", device="cuda",
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        d_ff = intermediate_size or 4 * hidden_size
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.compute_dtype = str(compute_dtype)
        fac = {"device": dev, "dtype": dtype}
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size, **fac)
        self.position_embeddings = nn.Embedding(max_position_embeddings,
                                                hidden_size, **fac)
        if moe:
            cls = (FusedMultiTransformerMoeWeightOnly if weight_only
                   else FusedMultiTransformerMoe)
            self.decoder = cls(hidden_size, num_attention_heads, d_ff,
                               num_layers=num_layers, activation="gelu",
                               **moe, **fac)
        else:
            self.decoder = FusedMultiTransformer(
                hidden_size, num_attention_heads, d_ff,
                num_layers=num_layers, activation="gelu", **fac)
            if weight_only:
                self.decoder = FusedMultiTransformerWeightOnly.from_float(
                    self.decoder)
        self.ln_f = nn.LayerNorm(hidden_size, eps=1e-5, **fac)
        self.lm_head = _Head(hidden_size, vocab_size, **fac)
        self.requires_grad_(False)
        with torch.no_grad():
            self.word_embeddings.weight.normal_(0.0, 0.02)
            self.position_embeddings.weight.normal_(0.0, 0.02)
            self.lm_head.weight.normal_(0.0, 1.0 / math.sqrt(hidden_size))

    def _embed(self, we, pe, ids, positions):
        """Token + position embeddings: positions clip to the table,
        the sum is taken in fp32 and cast to the compute dtype."""
        positions = positions.clamp(0, self.max_position_embeddings - 1)
        x = we[ids].float() + pe[positions].float()
        return x.to(getattr(torch, self.compute_dtype))

    @torch.no_grad()
    def forward(self, input_ids, dtype=None):
        """input_ids [B, S] -> logits [B, S, V], dense causal attention
        over the whole sequence (a MoE stack routes all B * S tokens at
        once, under that token count's capacity). Computes in `dtype`
        (default: the parameters' own dtype), independent of the compute
        dtype the serving engine uses."""
        dt = dtype or self.word_embeddings.weight.dtype
        B, S = input_ids.shape
        pos = torch.arange(S, device=input_ids.device)[None, :]
        positions = pos.clamp(0, self.max_position_embeddings - 1)
        x = (self.word_embeddings.weight[input_ids].float()
             + self.position_embeddings.weight[positions].float()).to(dt)
        dec = self.decoder
        cfg = dec._cfg()
        for li in range(cfg.num_layers):
            pl = dec.layer_params(li, dt)
            hn = _ln(x, pl["ln_s"], pl["ln_b"], cfg.epsilon)
            q, k, v = _qkv(cfg, pl, hn)
            attn = _causal_attention(q, k, v).reshape(B, S, cfg.embed_dim)
            x = x + _mm(cfg, attn, pl["out_w"], pl.get("out_s")) \
                + pl["out_b"]
            hn = _ln(x, pl["ffn_ln_s"], pl["ffn_ln_b"], cfg.epsilon)
            if cfg.num_experts:
                x = x + _ffn_moe(cfg, pl, hn)[0]
            else:
                x = x + _ffn_dense(cfg, pl, hn)
        x = _ln(x, self.ln_f.weight, self.ln_f.bias, 1e-5)
        return _mm(cfg, x, self.lm_head.weight)
