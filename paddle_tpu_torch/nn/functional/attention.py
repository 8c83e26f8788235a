"""Attention functionals: the port of
`paddle_tpu/nn/functional/attention.py`'s `scaled_dot_product_attention`
over [B, S, H, D] and the pieces it routes with.

`scaled_dot_product_attention` takes the segmented flash kernel (K1c,
`ops.flash_attention.splash_mha(kv_keep=)`) when attention dropout is 0,
q and kv share their length and heads, the mask is None or a
`[*, 1, 1, S]` bool key-padding mask, and `splash_supported(S, D)`:
S % 128 == 0, S >= 128, head_dim % 64 == 0. The mask becomes the
kernel's segment ids, so a real token attends only real tokens and a
padded one only padding. The gate is the same on every device: a CPU
tensor runs the kernel's plain version through the same route, a CUDA
tensor the kernel, which raises on a head_dim it does not take (192,
256, ...). Everything else takes `_xla_attention`, the additive path in
plain tensor code (fp32 logits, -1e30 masking), as JAX computes it
outside any Pallas kernel.

JAX also asks `_on_tpu` (its backend, `PADDLE_TPU_PALLAS_FLASH` and
`FLAGS_use_pallas_flash_attention`): switches that opt out to the
slower path. The port takes none of them.
"""
from __future__ import annotations

import math

import torch

from ...ops.flash_attention import splash_mha, splash_supported


def _xla_attention(q, k, v, bias=None, causal=False, scale=None,
                   dropout_p=0.0):
    """Plain attention over [B, S, H, D]: fp32 logits times `scale`
    plus the additive `bias`, -1e30 above the diagonal (aligned to the
    last key) when causal, softmax, dropout of the probabilities, and
    the output in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        s, t = logits.shape[-2:]
        keep = torch.ones(s, t, dtype=torch.bool,
                          device=q.device).tril(t - s)
        logits = logits.masked_fill(~keep, -1e30)
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        probs = torch.nn.functional.dropout(probs, dropout_p, training=True)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(q.dtype)


def _is_key_padding_mask(mask) -> bool:
    """A `[*, 1, 1, S]` bool mask: a per-key padding mask the segmented
    kernel takes as segment ids. Float masks are additive biases whose
    values must be kept, so they take the additive path."""
    return (mask.dtype == torch.bool and mask.dim() == 4
            and mask.shape[1] == 1 and mask.shape[2] == 1)


def _mask_to_keep(mask, batch):
    """[*, 1, 1, S] bool mask -> [B, S] int32 keep vector (1 = attend),
    broadcast over a size-1 mask batch."""
    flat = mask.reshape(mask.shape[0], mask.shape[-1])
    return flat.expand(batch, mask.shape[-1]).to(torch.int32)


def _bias_from_mask(mask):
    """Additive fp32 bias from a bool (0 / -1e30) or float mask."""
    if mask is None:
        return None
    if mask.dtype == torch.bool:
        return torch.zeros(mask.shape, dtype=torch.float32,
                           device=mask.device).masked_fill(~mask, -1e30)
    return mask.float()


def _attention_impl(q, k, v, bias, causal, scale, dropout_p, use_kernel):
    """`use_kernel`: the caller's attention dropout is 0 (then so is
    `dropout_p`, the dropout this call applies)."""
    if use_kernel \
            and q.shape[1] == k.shape[1] and q.shape[2] == k.shape[2] \
            and (bias is None or _is_key_padding_mask(bias)) \
            and splash_supported(q.shape[1], q.shape[-1]):
        kv_keep = None if bias is None else _mask_to_keep(bias, q.shape[0])
        out = splash_mha(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, scale=scale,
                         kv_keep=kv_keep)
        return out.transpose(1, 2)
    return _xla_attention(q, k, v, _bias_from_mask(bias), causal, scale,
                          dropout_p)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """[B, S, H, D] in and out, paddle 2.5+'s SDPA. As in JAX the
    kernel's gate reads `dropout_p` as given; the probabilities are
    dropped only in training."""
    return _attention_impl(query, key, value, attn_mask, is_causal, None,
                           dropout_p if training else 0.0,
                           dropout_p == 0.0)
