"""Tensor- (x expert-) parallel layout of the serving engine's weights.

Port of the serving half of `paddle_tpu/parallel/mp_layers.py`: the
shard-major QKV permutation, the split rule of every decoder parameter
and adapter slot tensor, and the process groups of a TP x EP run over
`torch.distributed`. The JAX package writes a rule as a PartitionSpec
over a mesh; here it says which axis of the tensor splits over the
`mp` ranks, which over the `ep` ranks, and whether the axis is first
permuted shard-major. Axes count from the end, so one rule serves the
stacked `[L, ...]` tensor, one layer's slice and an adapter's host
payload (which lacks the slot axis) alike.

Ranks map as JAX's `tp_ep_mesh` lays its devices out
(`reshape(ep, tp)`): rank = ep_rank * tp + mp_rank.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class SplitRule(NamedTuple):
    """How one tensor splits: `mp` / `ep` the axis (negative, from the
    end) split into contiguous equal chunks over the mp / ep ranks, None
    where the tensor is replicated over them; `permute` the fused-QKV
    out axis goes shard-major (`shard_major_qkv`) before the mp split."""
    mp: int | None = None
    ep: int | None = None
    permute: bool = False


_REP = SplitRule()

#: decoder parameters of a dense stack. Column-parallel weights (qkv,
#: ffn1) split their out axis; row-parallel weights (attn out, ffn2)
#: their in axis, and the step all-reduces the partial products; norms,
#: the biases added after a reduction and the weight-only scales of the
#: row-parallel products are replicated.
SERVING_TP_SPECS = {
    "ln_s": _REP, "ln_b": _REP,
    "qkv_w": SplitRule(mp=-1, permute=True),
    "qkv_b": SplitRule(mp=-1, permute=True),
    "qkv_s": SplitRule(mp=-1, permute=True),
    "out_w": SplitRule(mp=-2),
    "out_b": _REP, "out_s": _REP,
    "ffn_ln_s": _REP, "ffn_ln_b": _REP,
    "ffn1_w": SplitRule(mp=-1),
    "ffn1_b": SplitRule(mp=-1),
    "ffn1_s": SplitRule(mp=-1),
    "ffn2_w": SplitRule(mp=-2),
    "ffn2_b": _REP, "ffn2_s": _REP,
}

#: MoE stacks: the gate is replicated (every rank routes the whole token
#: set alike); the expert-stacked FFN parameters split their expert axis
#: over ep and keep the dense mp split inside each expert. ffn2_b is per
#: expert, so it splits over ep (added once after the mp reduction). A
#: packed-int4 stack splits its packed in axis, whose bytes hold
#: adjacent pairs of rows, so a contiguous chunk is a chunk of rows.
SERVING_MOE_TP_SPECS = {
    "gate_w": _REP,
    "ffn1_w": SplitRule(mp=-1, ep=-3),
    "ffn1_b": SplitRule(mp=-1, ep=-2),
    "ffn1_s": SplitRule(mp=-1, ep=-2),
    "ffn2_w": SplitRule(mp=-2, ep=-3),
    "ffn2_b": SplitRule(ep=-2),
    "ffn2_s": SplitRule(ep=-2),
}

#: multi-LoRA adapter slot tensors `A [L, K, d_in, r]` / `B [L, K, r,
#: d_out]`: A of the column-parallel projections is replicated and B
#: splits its out axis (qkv's shard-major permuted, like qkv_w); A of the
#: row-parallel projections splits its in axis, so each rank's delta is a
#: partial sum that joins the base product's all-reduce, B replicated.
SERVING_LORA_TP_SPECS = {
    "lora_qkv_a": _REP,
    "lora_qkv_b": SplitRule(mp=-1, permute=True),
    "lora_out_a": SplitRule(mp=-2),
    "lora_out_b": _REP,
    "lora_ffn1_a": _REP,
    "lora_ffn1_b": SplitRule(mp=-1),
    "lora_ffn2_a": SplitRule(mp=-2),
    "lora_ffn2_b": _REP,
}


def serving_tp_spec(name, moe=False):
    """The split rule of one decoder parameter or adapter slot tensor
    under the TP (x EP when `moe`) serving engine. An unknown name raises,
    so a new stack variant fails loudly instead of replicating."""
    if name in SERVING_LORA_TP_SPECS:
        return SERVING_LORA_TP_SPECS[name]
    if moe and name in SERVING_MOE_TP_SPECS:
        return SERVING_MOE_TP_SPECS[name]
    try:
        return SERVING_TP_SPECS[name]
    except KeyError:
        raise ValueError(
            f"no tensor-parallel sharding rule for decoder param {name!r}"
            " — add it to parallel.mp_layers.SERVING_TP_SPECS") from None


def shard_major_qkv(t, tp, num_heads, head_dim):
    """Permute a fused-QKV last axis from `(3, H, Dh)` order into
    shard-major `(tp, 3, H/tp, Dh)` order, flat shape unchanged: each
    contiguous 1/tp chunk is then one rank's q, k and v head slice in the
    layout `_qkv` reads at `num_heads = H/tp`. Applies to `qkv_w`,
    `qkv_b`, the weight-only `qkv_s` and the adapters' `lora_qkv_b`."""
    tp = int(tp)
    flat = t.shape[-1]
    if flat != 3 * num_heads * head_dim:
        raise ValueError(
            f"fused-QKV axis {flat} != 3*{num_heads}*{head_dim}")
    if num_heads % tp:
        raise ValueError(f"num_heads={num_heads} not divisible by "
                         f"tensor_parallel={tp}")
    lead = t.shape[:-1]
    x = t.reshape(*lead, 3, tp, num_heads // tp, head_dim)
    return x.transpose(-4, -3).reshape(*lead, flat)


def _chunk(t, axis, parts, index):
    n = t.shape[axis]
    if n % parts:
        raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split "
                         f"into {parts} equal parts")
    return t.narrow(axis, index * (n // parts), n // parts)


def shard_tensor(t, rule, *, tp=1, mp_rank=0, ep=1, ep_rank=0,
                 num_heads=None, head_dim=None):
    """This rank's part of `t` under `rule` (a `SplitRule`, or a name for
    `serving_tp_spec`), as a contiguous copy: the kernels take contiguous
    operands (K4 also checks 16-byte row alignment), and a view would
    keep the whole tensor alive."""
    if isinstance(rule, str):
        rule = serving_tp_spec(rule)
    t = torch.as_tensor(t)
    if rule.permute and tp > 1:
        t = shard_major_qkv(t, tp, num_heads, head_dim)
    if rule.ep is not None and ep > 1:
        t = _chunk(t, rule.ep, ep, ep_rank)
    if rule.mp is not None and tp > 1:
        t = _chunk(t, rule.mp, tp, mp_rank)
    return t.contiguous()


def tp_groups(tp, ep=1):
    """The process groups of a `tp` x `ep` run over the initialised
    default group, the counterpart of JAX's `tp_mesh` / `tp_ep_mesh`:
    returns (mp_group, ep_group, mp_rank, ep_rank). Ranks e * tp ..
    e * tp + tp - 1 form ep row e's mp group, and ranks m, tp + m, ...
    mp column m's ep group; a group of one rank is None (nothing to
    reduce). Every rank creates every group, in the same order, as
    `dist.new_group` requires."""
    tp, ep = int(tp), int(ep)
    if tp < 1 or ep < 1:
        raise ValueError(f"tensor_parallel/expert_parallel must be >= 1, "
                         f"got {tp}/{ep}")
    if not dist.is_initialized():
        raise RuntimeError("tp_groups needs an initialised default process "
                           "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != tp * ep:
        raise ValueError(f"tensor_parallel={tp} x expert_parallel={ep} "
                         f"needs a world of {tp * ep} ranks, the default "
                         f"group has {world}")
    rank = dist.get_rank()
    mp_rank, ep_rank = rank % tp, rank // tp
    mp_group = ep_group = None
    if tp > 1:
        for e in range(ep):
            g = dist.new_group([e * tp + m for m in range(tp)])
            if e == ep_rank:
                mp_group = g
    if ep > 1:
        for m in range(tp):
            g = dist.new_group([e * tp + m for e in range(ep)])
            if m == mp_rank:
                ep_group = g
    return mp_group, ep_group, mp_rank, ep_rank
