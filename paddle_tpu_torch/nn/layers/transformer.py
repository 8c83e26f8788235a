"""Transformer encoder layers, the port of
`paddle_tpu/nn/layers/transformer.py`: `MultiHeadAttention`,
`TransformerEncoderLayer` (post- or pre-norm) and `TransformerEncoder`,
under paddle's parameter names. Attention goes through
`F.scaled_dot_product_attention`, so a `[*, 1, 1, S]` bool key-padding
mask in eval reaches the segmented flash kernel. The decoder classes,
`Transformer` and the attention cache are not ported yet.
"""
from __future__ import annotations

import copy

import torch

from .. import functional as F
from ..container import LayerList
from ..functional.attention import _is_key_padding_mask
from .common import Dropout, Linear
from .norm import LayerNorm


def _convert_attention_mask(attn_mask):
    """None stays None; a bool key-padding mask stays bool (the kernel
    takes it as segment ids); any other bool mask becomes a 0 / -1e9
    fp32 bias; a float mask becomes fp32."""
    if attn_mask is None:
        return None
    if attn_mask.dtype == torch.bool:
        if _is_key_padding_mask(attn_mask):
            return attn_mask
        return torch.zeros(attn_mask.shape, dtype=torch.float32,
                           device=attn_mask.device).masked_fill(
                               ~attn_mask, -1e9)
    return attn_mask.float()


class MultiHeadAttention(torch.nn.Module):
    """paddle.nn.MultiHeadAttention over [batch, seq, embed_dim]."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, *, device="cuda"):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.q_proj = Linear(embed_dim, embed_dim, device=device)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, device=device)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, device=device)
        self.out_proj = Linear(embed_dim, embed_dim, device=device)

    def _shape(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if cache is not None:
            raise NotImplementedError("MultiHeadAttention: the cache "
                                      "(decoder) is not ported yet")
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        mask = _convert_attention_mask(attn_mask)
        if mask is not None and mask.dim() == 3:
            mask = mask[:, None]
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        return (out, None) if self.need_weights else out


class TransformerEncoderLayer(torch.nn.Module):
    """Self-attention and a feed-forward block, each with a residual
    and LayerNorm after it (before it with `normalize_before`)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, layer_norm_eps=1e-5, *,
                 device="cuda"):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            device=device)
        self.linear1 = Linear(d_model, dim_feedforward, device=device)
        self.linear2 = Linear(dim_feedforward, d_model, device=device)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, device=device)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError("TransformerEncoderLayer: the cache "
                                      "is not ported yet")
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = residual + self.dropout1(self.self_attn(src, src, src,
                                                      src_mask))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout_act(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(torch.nn.Module):
    """`num_layers` copies of `encoder_layer` (the first is the layer
    itself), then `norm` when given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer if i == 0 else copy.deepcopy(encoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError("TransformerEncoder: the cache is "
                                      "not ported yet")
        for layer in self.layers:
            src = layer(src, src_mask)
        return src if self.norm is None else self.norm(src)
