"""Ring attention — context parallelism over the sequence axis, the JAX
package's `paddle_tpu/parallel/ring_attention.py` over
`torch.distributed`.

Each rank of the cp group holds one [B, S / cp, H, D] block of q, k and
v (rank i the i-th block of the sequence). The K/V blocks rotate around
the group (rank i sends to i + 1 and receives from i - 1) while each
rank accumulates its queries' online-softmax partials over every block,
as JAX's `_ring_attention_local`; causal attention masks each (query
block, key block) pair by their places in the sequence. The rotation is
an autograd Function (its backward rotates the gradient the other way),
so gradients flow to q, k and v. The per-block attention is plain
torch, as JAX's is einsums: JAX has no Pallas kernel here. Under gloo a
CUDA block goes through host memory (`moe_utils.host_staged`).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .moe_utils import host_staged


def _block_attn(q, k, v, scale, mask):
    """Online-softmax partials of one (query block, key block) pair.
    q [B, Sq, H, D], k / v [B, Sk, H, D]; mask [Sq, Sk] bool or None.
    Returns (acc [B, Sq, H, D] fp32, m [B, H, Sq], l [B, H, Sq])."""
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask[None, None], s, torch.full((), -1e30,
                                                        device=s.device))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bhst,bthd->bshd", p.to(v.dtype).float(), v.float())
    return acc, m, p.sum(dim=-1)


def _shift(t, group, step):
    """`t` sent `step` places along the group's ring; returns what the
    rank `step` places back sent."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (i + step) % n)
    src = dist.get_global_rank(group, (i - step) % n)
    t = t.contiguous()
    out = t.cpu() if host_staged(t, group) else t
    buf = torch.empty_like(out)
    reqs = [dist.isend(out, dst, group=group),
            dist.irecv(buf, src, group=group)]
    for r in reqs:
        r.wait()
    return buf.to(t.device)


class _Rotate(torch.autograd.Function):
    """A block to the next rank of the ring; the backward sends the
    gradient back to the previous one."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _shift(t, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def ring_attention(q, k, v, group=None, causal=True, scale=None):
    """Attention of this rank's query block over the whole sequence, its
    K/V blocks rotating around `group` (the default group if None; no
    process group is one rank). q, k, v: this rank's [B, S / cp, H, D]
    blocks; returns its [B, S / cp, H, D] output block in q's dtype."""
    if dist.is_initialized():
        group = group or dist.group.WORLD
        cp, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        cp, rank = 1, 0
    B, Sl, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    m = torch.full((B, H, Sl), -math.inf, device=q.device)
    l = torch.zeros((B, H, Sl), device=q.device)
    acc = torch.zeros((B, Sl, H, D), device=q.device)
    pos = torch.arange(Sl, device=q.device)
    for i in range(cp):
        src = (rank - i) % cp            # where the current block started
        mask = None
        if causal:
            mask = (rank * Sl + pos)[:, None] >= (src * Sl + pos)[None, :]
        acc_i, m_i, l_i = _block_attn(q, k, v, scale, mask)
        m_new = torch.maximum(m, m_i)
        a1, a2 = torch.exp(m - m_new), torch.exp(m_i - m_new)
        l = l * a1 + l_i * a2
        acc = acc * a1.transpose(1, 2)[..., None] \
            + acc_i * a2.transpose(1, 2)[..., None]
        m = m_new
        if i + 1 < cp:
            k, v = _Rotate.apply(k, group), _Rotate.apply(v, group)
    return (acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]).to(q.dtype)
