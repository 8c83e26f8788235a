"""The `HybridGPT` train step of `paddle_tpu/parallel/hybrid_gpt.py`,
in PyTorch: the dense and the MoE GPT over a dp x ep mesh of
`torch.distributed` ranks, with ZeRO-1.

Ported function by function, under the JAX names: `GPTConfig`,
`init_params`, `_layer_norm`, `_attention`, `_dense_ffn`,
`_moe_data_axes`, `_zero_moe_stats`, `_moe_ffn`, `_block`,
`_stage_forward`, `_ce_sum_fused`, `_ce_sum`, `_vocab_parallel_ce`,
`_loss_fn`, `init_opt_state`, `_adam_update`, `_apply_updates`,
`collective_bytes_per_step` and `HybridGPT` with its step,
`loss_and_moe_stats`, `train_many` and the MoE and collective metrics.
Parameters are the same nested dict of tensors (`tok_emb`, `pos_emb`,
`ln_f_w`, `ln_f_b`, `head`, and `blocks` stacked on a leading [L] axis;
a MoE block adds `gate` [L, d, E] and holds its FFN as experts, `w_fc1`
[L, E, d, ff] ...), so `convert.load_jax_hybrid_gpt` carries a JAX
trainer's state across.

Attention runs through `ops.flash_attention.splash_mha` and the
residual-add + LayerNorm between attention and FFN through
`ops.layer_norm.add_ln`; with `qkv_kernel` (and a shape
`ops.qkv_proj.qkv_proj_supported` takes) the Q/K/V projection runs
through `ops.qkv_proj.qkv_proj`: on the card, hand-written kernels. The
rest is plain tensor code, as it was XLA's in JAX, the MoE expert
products included (JAX's `_moe_ffn` computes them with XLA einsums).

`remat_policy` is None (full per-block recompute) or
"save_splash_residuals" (bench_gpt's: every block still recomputes in
the backward, but the flash forward's (out, lse) are kept from the
forward, so attention's forward runs once a step instead of twice).

**The mesh.** The trainer runs as one process a rank over
`torch.distributed`: the caller's `init_process_group` picks the
backend, every rank builds the trainer with the same config and calls
it with the same arguments, and `dp * ep` must be the world size. One
process with dp = ep = 1 needs no process group. Rank `dp_i * ep +
ep_i` is JAX's mesh `(dp, pp, mp, ep)` at pp = mp = 1, and its data
shard is its rank (JAX's `P(("dp", "ep"))`, `shard_data`). Each rank
holds its E / ep experts of `w_fc1`, `b_fc1`, `w_fc2` and `b_fc2` and
every other parameter whole. Each rank differentiates its own loss; a
whole parameter's gradient is summed over the world, an expert's over
its dp group (its ep share arrives through the all-to-all's
backward), each scaled to JAX's mean over the dp x ep ranks. With
`zero_stage=1` each rank holds 1/n of every parameter's flat padded
Adam moments, n being the ranks that hold the parameter (the world, or
the dp group of an expert), updates its slice and all-gathers the
result; where n is 1 the moments stay shaped as the parameter. (JAX
shards its flat moments over the whole world: the layout differs, the
trained parameters do not.)

Not ported: pp, mp, sequence parallelism, micro_batches > 1, the
bucketed reduction and other named remat policies. They raise
`NotImplementedError` (ROADMAP, Queue 1).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from .._device import resolve_device
from ..ops.flash_attention import (SPLASH_RESIDUAL_NAME,
                                   save_only_these_names, splash_mha)
from ..ops.layer_norm import add_ln
from ..ops.qkv_proj import qkv_proj, qkv_proj_supported
from ..profiler import metrics as _metrics
from . import moe_utils

#: the named remat policies the port has (JAX also takes any name of
#: `jax.checkpoint_policies`)
REMAT_POLICIES = (None, "save_splash_residuals")
#: the MoE block's expert leaves, sharded over ep on their [E] axis
EXPERT_LEAVES = ("w_fc1", "b_fc1", "w_fc2", "b_fc2")
#: the per-block MoE statistics, in `_zero_moe_stats` order
MOE_STATS = ("balance", "z", "counts", "dropped")


def param_shapes(V, S, d, ff, L, E=0):
    """The parameters' shapes by name (nested as the parameters are),
    from vocab, seq_len, d_model, d_ff, n_layers and (MoE) experts."""
    blocks = {"ln1_w": (L, d), "ln1_b": (L, d),
              "w_qkv": (L, d, 3 * d), "b_qkv": (L, 3 * d),
              "w_o": (L, d, d), "b_o": (L, d),
              "ln2_w": (L, d), "ln2_b": (L, d)}
    if E:
        blocks.update({"gate": (L, d, E), "w_fc1": (L, E, d, ff),
                       "b_fc1": (L, E, ff), "w_fc2": (L, E, ff, d),
                       "b_fc2": (L, E, d)})
    else:
        blocks.update({"w_fc1": (L, d, ff), "b_fc1": (L, ff),
                       "w_fc2": (L, ff, d), "b_fc2": (L, d)})
    return {"tok_emb": (V, d), "pos_emb": (S, d), "ln_f_w": (d,),
            "ln_f_b": (d,), "head": (d, V), "blocks": blocks}


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    seq_len: int = 1024
    d_model: int = 2048
    n_heads: int = 16
    n_layers: int = 24
    d_ff: int = 0            # default 4*d_model
    # parallelism: dp x ep ranks (pp, mp, sequence parallelism and
    # micro-batches are not ported)
    dp: int = 1
    pp: int = 1
    mp: int = 1
    ep: int = 1              # experts sharded over ep; tokens over
                             # (dp, ep) jointly
    micro_batches: int = 1
    sequence_parallel: bool = False
    # MoE: top-k capacity-factor router. moe_num_experts is a
    # constructor-only alias (an InitVar, not a field), so
    # dataclasses.replace(cfg, moe_experts=0) gives a dense config
    moe_experts: int = 0     # 0 = dense (alias: moe_num_experts)
    moe_num_experts: dataclasses.InitVar[int] = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01   # load-balance loss weight
    moe_z_weight: float = 1e-3     # router z-loss weight
    # fused residual-add + LN kernel between attention and FFN
    fused_add_ln: bool = True
    remat: bool = True
    # None = full per-block recompute; "save_splash_residuals" keeps the
    # flash forward's (out, lse) across it
    remat_policy: Any = None
    ce_seq_chunks: int = 1
    fused_ce: bool = True
    qkv_kernel: bool = False
    # AMP-O2-style: differentiate wrt compute_dtype copies of the fp32
    # params; Adam still updates the fp32 masters
    bf16_grads: bool = False
    compute_dtype: Any = torch.bfloat16
    grad_bucket_bytes: int = 0
    # optimizer
    learning_rate: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    zero_stage: int = 1      # 0: whole Adam moments on every rank;
                             # >= 1: moments and update sharded (ZeRO-1)

    def __post_init__(self, moe_num_experts):
        if self.d_ff == 0:
            self.d_ff = 4 * self.d_model
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_heads {self.n_heads}")
        # the alias: two conflicting non-zero counts are refused
        if (self.moe_experts and moe_num_experts
                and self.moe_experts != moe_num_experts):
            raise ValueError(f"moe_experts={self.moe_experts} conflicts "
                             f"with moe_num_experts={moe_num_experts}")
        if moe_num_experts and not self.moe_experts:
            self.moe_experts = moe_num_experts
        if self.dp < 1 or self.ep < 1:
            raise ValueError(f"dp={self.dp} and ep={self.ep} must be >= 1")
        if self.moe_experts:
            if self.moe_experts % self.ep:
                raise ValueError("moe_experts must divide evenly over the "
                                 "ep axis")
            if not 1 <= self.moe_top_k <= self.moe_experts:
                raise ValueError(f"moe_top_k={self.moe_top_k} must be in "
                                 f"[1, {self.moe_experts}]")
        elif self.ep != 1:
            raise ValueError("ep > 1 needs a MoE config (dense models "
                             "scale over dp)")
        unported = dict(pp=1, mp=1, micro_batches=1,
                        sequence_parallel=False, grad_bucket_bytes=0)
        for name, want in unported.items():
            if getattr(self, name) != want:
                raise NotImplementedError(
                    f"GPTConfig.{name}={getattr(self, name)!r}: the port "
                    f"has the dp x ep mesh only ({name}={want!r}; "
                    "ROADMAP, Queue 1 item 2(d))")
        if self.remat_policy not in REMAT_POLICIES:
            raise NotImplementedError(
                f"GPTConfig.remat_policy={self.remat_policy!r}: the port "
                f"has {REMAT_POLICIES} (ROADMAP, Queue 1)")
        if not isinstance(self.compute_dtype, torch.dtype):
            raise TypeError(f"compute_dtype must be a torch dtype, got "
                            f"{self.compute_dtype!r}")


# --------------------------------------------------------------- params


def init_params(cfg: GPTConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Full parameters, fp32, with the JAX trainer's names, shapes and
    init: N(0, 0.02), output projections N(0, 0.02 / sqrt(2L)), unit
    LayerNorm scales, zero biases (the numbers differ: torch's generator
    is not JAX's)."""
    std = 0.02
    proj_std = std / math.sqrt(2 * cfg.n_layers)

    def init(name, shape):
        if name.startswith("ln") and name.endswith("_w"):
            return torch.ones(shape, device=device)
        if name.startswith(("b_", "ln")):
            return torch.zeros(shape, device=device)
        s = proj_std if name in ("w_o", "w_fc2") else std
        return (torch.randn(shape, generator=generator) * s).to(device)

    def build(shapes):
        return {n: build(sh) if isinstance(sh, dict) else init(n, sh)
                for n, sh in shapes.items()}
    return build(param_shapes(cfg.vocab_size, cfg.seq_len, cfg.d_model,
                              cfg.d_ff, cfg.n_layers, cfg.moe_experts))


# ----------------------------------------------------------------- mesh


@dataclasses.dataclass
class Mesh:
    """One rank's place in the dp x ep mesh and its process groups: the
    data group (the world: every rank holds a data shard), its ep group
    (the ranks of its dp index, which exchange tokens) and its dp group
    (the ranks of its ep index, which hold the same experts). A group of
    one rank is None."""
    rank: int = 0
    world: int = 1
    dp_rank: int = 0
    ep_rank: int = 0
    data_group: Any = None
    ep_group: Any = None
    dp_group: Any = None


def make_mesh(cfg: GPTConfig) -> Mesh:
    """The calling rank's `Mesh`. dp = ep = 1 is one rank, whatever
    process group exists; else the default group must hold dp * ep
    ranks, and every rank must call this in the same order (it makes
    the subgroups)."""
    n = cfg.dp * cfg.ep
    if n == 1:
        return Mesh()
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"dp={cfg.dp} x ep={cfg.ep} needs torch.distributed "
            f"initialised over {n} ranks (init_process_group), got "
            + (f"{dist.get_world_size()}" if dist.is_initialized()
               else "no process group"))
    rank = dist.get_rank()
    dp_rank, ep_rank = divmod(rank, cfg.ep)
    mesh = Mesh(rank=rank, world=n, dp_rank=dp_rank, ep_rank=ep_rank,
                data_group=dist.group.WORLD)
    for i in range(cfg.dp):                       # ep groups, by dp index
        g = dist.new_group([i * cfg.ep + j for j in range(cfg.ep)])
        if i == dp_rank and cfg.ep > 1:
            mesh.ep_group = g
    for j in range(cfg.ep):                       # dp groups, by ep index
        g = dist.new_group([i * cfg.ep + j for i in range(cfg.dp)])
        if j == ep_rank and cfg.dp > 1:
            mesh.dp_group = g
    return mesh


def _is_expert(cfg: GPTConfig, path):
    return bool(cfg.moe_experts) and path[0] == "blocks" \
        and path[-1] in EXPERT_LEAVES


def _holders(cfg: GPTConfig, mesh: Mesh, path):
    """(group, number of ranks, this rank's index) of the ranks that hold
    the parameter at `path`: the dp group for an expert leaf, the world
    for any other."""
    if _is_expert(cfg, path):
        return mesh.dp_group, cfg.dp, mesh.dp_rank
    return mesh.data_group, mesh.world, mesh.rank


def _zero_holders(cfg: GPTConfig, mesh: Mesh, path):
    """`_holders` where ZeRO shards the parameter's moments, else None:
    at zero_stage 0, and where one rank holds the parameter (ZeRO-1
    over one rank is the identity), the moments stay shaped as the
    parameter."""
    if cfg.zero_stage < 1:
        return None
    group, n, i = _holders(cfg, mesh, path)
    return (group, n, i) if n > 1 else None


def _zero_pad(n, holders):
    """n padded to a multiple of the holders (JAX's `zero.pad_len`)."""
    return -(-int(n) // int(holders)) * int(holders)


def _leaves(tree):
    """(path, tensor) of a nested dict in a fixed order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            for p, t in _leaves(tree[k]):
                yield (k,) + p, t
        else:
            yield (k,), tree[k]


def _tree_map(fn, tree, path=()):
    """fn(path, leaf) over a nested dict."""
    return {k: _tree_map(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def shard_state(cfg: GPTConfig, params, opt_state=None, rank=0):
    """Cut full parameters (and, given, full-shaped Adam moments, one
    {"m", "v"} per parameter) to rank `rank`'s shard under `cfg`'s mesh:
    the rank's E / ep experts of each expert leaf, every other leaf
    whole; moments in `cfg`'s layout (`init_opt_state`). Returns params,
    or (params, opt_state)."""
    dp_rank, ep_rank = divmod(int(rank), cfg.ep)
    E_loc = cfg.moe_experts // cfg.ep if cfg.moe_experts else 0
    mesh = Mesh(rank=int(rank), world=cfg.dp * cfg.ep, dp_rank=dp_rank,
                ep_rank=ep_rank)

    def cut(path, t):
        if _is_expert(cfg, path) and cfg.ep > 1:
            return t[:, ep_rank * E_loc:(ep_rank + 1) * E_loc].contiguous()
        return t

    local = _tree_map(cut, params)
    if opt_state is None:
        return local

    def moments(path, p):
        s = _get(opt_state, path)
        out = {}
        for name in ("m", "v"):
            t = cut(path, s[name]).float()
            held = _zero_holders(cfg, mesh, path)
            if held is not None:
                _, n, i = held
                chunk = _zero_pad(t.numel(), n) // n
                t = F.pad(t.reshape(-1), (0, chunk * n - t.numel()))
                t = t[i * chunk:(i + 1) * chunk].clone()
            out[name] = t
        return out
    return local, _tree_map(moments, params)


# ----------------------------------------------------------- model math


def _layer_norm(x, w, b, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, correction=0, keepdim=True)
    return ((xf - mu) / torch.sqrt(var + eps) * w + b).to(x.dtype)


def _attention(x, w_qkv, b_qkv, w_o, b_o, cfg: GPTConfig):
    """x [B, S, d]; causal self-attention through the flash kernel.
    Returns (out without its bias, b_o): the caller adds b_o."""
    B, S, d = x.shape
    h = cfg.n_heads
    hd = d // h
    cd = cfg.compute_dtype
    xc = x.to(cd)
    if cfg.qkv_kernel and qkv_proj_supported(h, S, h * hd, d):
        # the fused projection: one rounding of product + bias, stored
        # straight into [B, H, S, hd]
        q, k, v = qkv_proj(xc, w_qkv.to(cd), b_qkv.to(cd), h)
    else:
        wq, wk, wv = w_qkv.to(cd).split(d, dim=-1)
        bq, bk, bv = b_qkv.to(cd).split(d, dim=-1)

        def proj(w, b):                               # -> [B, H, S, hd]
            out = torch.einsum("bsd,dhe->bhse", xc, w.reshape(d, h, hd))
            return out + b.reshape(h, 1, hd)
        q, k, v = proj(wq, bq), proj(wk, bk), proj(wv, bv)
    ctx = splash_mha(q, k, v, causal=True, scale=1.0 / math.sqrt(hd),
                     save_residuals_for_remat=(
                         cfg.remat_policy == "save_splash_residuals"))
    out = torch.einsum("bhse,hed->bsd", ctx.to(cd),
                       w_o.to(cd).reshape(h, hd, d))
    return out, b_o


def _dense_ffn(x, w1, b1, w2, b2, cfg: GPTConfig):
    cd = cfg.compute_dtype
    hid = x.to(cd) @ w1.to(cd) + b1.to(cd)
    hid = F.gelu(hid, approximate="tanh")    # jax.nn.gelu's default
    return hid @ w2.to(cd), b2


def _moe_data_axes(cfg: GPTConfig, mesh: Mesh | None):
    """The process group the token batch is sharded over (None on one
    rank): the group MoE routing statistics are summed across, for
    balance and z losses that do not depend on the dp x ep sharding and
    global expert counts."""
    return None if mesh is None else mesh.data_group


def _zero_moe_stats(cfg: GPTConfig, device=None):
    """The per-block MoE statistics, zero (the sum's start)."""
    E = max(cfg.moe_experts, 1)
    z = functools.partial(torch.zeros, dtype=torch.float32, device=device)
    return {"balance": z(()), "z": z(()), "counts": z((E,)),
            "dropped": z(())}


def _moe_ffn(x, gate_w, w1, b1, w2, b2, cfg: GPTConfig, mesh=None):
    """Top-k capacity-factor MoE with expert parallelism over the ep
    group.

    x [B, S, d] local tokens. Experts: E in all, E / ep resident on each
    ep rank (w1 local [E_loc, d, ff]). The router and the index
    dispatch / combine come from `moe_utils` (serving's pair, whose
    backwards run in a fixed order); at ep > 1 the [E, C, d] dispatch
    buffers ride the all-to-all to the experts' owners and back.
    Capacity-overflowed (token, choice) pairs contribute 0: the block's
    residual is the drop path. Returns (out [B, S, d], stats per
    `_zero_moe_stats`): balance and z over the global token set, counts
    and dropped summed in fp32 over the data group (exact)."""
    cd = cfg.compute_dtype
    B, S, d = x.shape
    T = B * S
    E = cfg.moe_experts
    ep = cfg.ep
    group = _moe_data_axes(cfg, mesh)
    xt = x.reshape(T, d)
    logits = xt.float() @ gate_w.float()
    C = moe_utils.expert_capacity(T, E, cfg.moe_top_k,
                                  cfg.moe_capacity_factor)
    r = moe_utils.top_k_routing(logits, cfg.moe_top_k, C, dtype=cd,
                                group=group)
    dispatched = moe_utils.dispatch_tokens_indexed(xt.to(cd), r.plan, E, C)
    if ep > 1:
        expert_in = moe_utils.all_to_all_dispatch(dispatched,
                                                  mesh.ep_group, ep)
    else:
        expert_in = dispatched                   # [E (= E_loc), C, d]
    h = torch.bmm(expert_in, w1.to(cd)) + b1[:, None, :].to(cd)
    h = F.gelu(h, approximate="tanh")
    # b2 rides inside the expert buffer (each token's bias share is
    # gate-weighted per chosen expert), scaled by 1/mp as JAX's
    # row-parallel partial needs (mp = 1 here)
    eout = torch.bmm(h, w2.to(cd)) + (b2[:, None, :] / cfg.mp).to(cd)
    if ep > 1:
        eout = moe_utils.all_to_all_combine(eout, mesh.ep_group, ep)
    out = moe_utils.combine_tokens_indexed(eout, r.plan)
    counts, dropped = r.plan.counts, r.plan.dropped
    if group is not None:
        counts, dropped = counts.clone(), dropped.clone()
        dist.all_reduce(counts, group=group)
        dist.all_reduce(dropped, group=group)
    stats = {"balance": r.balance_loss, "z": r.z_loss, "counts": counts,
             "dropped": dropped}
    return out.reshape(B, S, d), stats


def _block(x, lp, cfg: GPTConfig, mesh=None):
    """One transformer block: [B, S, d] -> ([B, S, d], aux), aux the
    MoE statistics per `_zero_moe_stats` (None for a dense block: JAX's
    zeros only keep its scan's carry one structure)."""
    h = _layer_norm(x, lp["ln1_w"], lp["ln1_b"])
    attn, b_o = _attention(h, lp["w_qkv"], lp["b_qkv"], lp["w_o"],
                           lp["b_o"], cfg)
    attn = attn + b_o.to(attn.dtype)
    if cfg.fused_add_ln:
        h2, x = add_ln(x, attn.to(x.dtype), lp["ln2_w"], lp["ln2_b"])
    else:
        x = x + attn.to(x.dtype)
        h2 = _layer_norm(x, lp["ln2_w"], lp["ln2_b"])
    if cfg.moe_experts:
        ff, aux = _moe_ffn(h2, lp["gate"], lp["w_fc1"], lp["b_fc1"],
                           lp["w_fc2"], lp["b_fc2"], cfg, mesh)
        return x + ff.to(x.dtype), aux
    ff, b2 = _dense_ffn(h2, lp["w_fc1"], lp["b_fc1"], lp["w_fc2"],
                        lp["b_fc2"], cfg)
    return x + (ff + b2.to(ff.dtype)).to(x.dtype), None


def _stage_forward(x, blocks, cfg: GPTConfig, mesh=None):
    """All layers, a Python loop over the stacked layer axis; returns
    (x, the MoE statistics summed over layers, or None). With remat
    every block is recomputed in the backward; under
    "save_splash_residuals" a selective checkpoint keeps what
    `splash_mha` named (the flash forward's out and lse) and recomputes
    the rest. A MoE block's statistics are tensor outputs of its
    checkpoint, so the aux losses' gradient reaches the gate through the
    recompute (whose collectives every rank runs in the same order)."""
    names = list(blocks)
    kw = {}
    if cfg.remat_policy == "save_splash_residuals":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            save_only_these_names(SPLASH_RESIDUAL_NAME))
    # unbind (not indexing) so the backward stacks the per-layer grads
    # once instead of scattering each into a zero [L, ...] buffer
    per_layer = zip(*(blocks[n].unbind(0) for n in names))

    def block_fn(x, *leaves):
        y, aux = _block(x, dict(zip(names, leaves)), cfg, mesh)
        return y if aux is None else (y,) + tuple(aux[k] for k in MOE_STATS)

    total = _zero_moe_stats(cfg, x.device) if cfg.moe_experts else None
    for leaves in per_layer:
        if cfg.remat:
            out = checkpoint(block_fn, x, *leaves, use_reentrant=False,
                             **kw)
        else:
            out = block_fn(x, *leaves)
        if total is None:
            x = out
            continue
        x = out[0]
        total = {k: total[k] + a for k, a in zip(MOE_STATS, out[1:])}
    return x, total


class _FusedCE(torch.autograd.Function):
    """mp=1 fused softmax-CE (sum): logits in compute dtype, never
    saved; the fp32 logsumexp is. The backward recomputes the logits
    from (y, head) — the JAX package's `_ce_sum_fused` custom vjp."""

    @staticmethod
    def forward(ctx, y, head, labels, cd):
        logits = y.to(cd) @ head.to(cd)
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        tgt = lf.gather(-1, labels[..., None])[..., 0]
        ctx.cd = cd
        ctx.save_for_backward(y, head, lse, labels)
        return (lse - tgt).sum()

    @staticmethod
    def backward(ctx, g):
        y, head, lse, labels = ctx.saved_tensors
        cd = ctx.cd
        yc, hc = y.to(cd), head.to(cd)
        probs = torch.exp((yc @ hc).float() - lse[..., None])
        probs.scatter_add_(-1, labels[..., None],
                           -torch.ones_like(probs[..., :1]))
        dlogits = (g * probs).to(cd)              # softmax - onehot
        dy = dlogits @ hc.transpose(0, 1)
        dw = yc.reshape(-1, yc.shape[-1]).transpose(0, 1) \
            @ dlogits.reshape(-1, dlogits.shape[-1])
        return dy.to(y.dtype), dw.to(head.dtype), None, None


def _ce_sum_fused(y, head, labels, cfg: GPTConfig):
    return _FusedCE.apply(y, head, labels, cfg.compute_dtype)


def _ce_sum(y, head, labels, cfg: GPTConfig):
    """Sum (not mean) of token CE over y [B, S', d]."""
    if cfg.fused_ce:
        return _ce_sum_fused(y, head, labels, cfg)
    cd = cfg.compute_dtype
    logits = (y.to(cd) @ head.to(cd)).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels[..., None])[..., 0]
    return (lse - tgt).sum()


def _vocab_parallel_ce(y, head, labels, cfg: GPTConfig):
    """Mean token CE. ce_seq_chunks > 1 streams the head matmul + CE
    over sequence chunks, so the [B, S, V] logits never materialise at
    once; the unfused CE recomputes each chunk in the backward, as the
    JAX package's per-chunk checkpoint does (the fused CE needs no
    checkpoint: it saves no logits)."""
    B, S, _ = y.shape
    C = max(1, cfg.ce_seq_chunks)
    if C == 1 or S % C != 0:
        return _ce_sum(y, head, labels, cfg) / (B * S)
    Sc = S // C
    sums = []
    for c in range(C):
        yy, ll = y[:, c * Sc:(c + 1) * Sc], labels[:, c * Sc:(c + 1) * Sc]
        if cfg.fused_ce:
            sums.append(_ce_sum(yy, head, ll, cfg))
        else:
            sums.append(checkpoint(_ce_sum, yy, head, ll, cfg,
                                   use_reentrant=False))
    return torch.stack(sums).sum() / (B * S)


def _loss_fn(params, tokens, labels, cfg: GPTConfig, mesh=None,
             dp_mean=True):
    """Forward loss of one rank's data shard: embed, all blocks, final
    LN, vocab head and mean CE, plus (MoE) `moe_aux_weight` x the
    per-layer balance loss and `moe_z_weight` x the per-layer z-loss.
    With `dp_mean` the loss is the mean over the data ranks (an
    all-reduce); the trainer differentiates the rank's own loss
    (`dp_mean=False`) and reduces the gradients itself. MoE configs
    return (loss, stats): balance and z per-layer means, counts and
    dropped the global totals of the batch."""
    S = tokens.shape[1]
    cd = cfg.compute_dtype
    pos = params["pos_emb"][:S].to(cd)
    # F.embedding, not indexing: its backward sums each id's rows in a
    # fixed order on the CPU and the card, where indexing's backward (an
    # accumulating index_put_) sums in another order from run to run on
    # the CPU
    x = F.embedding(tokens, params["tok_emb"]).to(cd) + pos[None]
    y, stats = _stage_forward(x, params["blocks"], cfg, mesh)
    yl = _layer_norm(y, params["ln_f_w"], params["ln_f_b"])
    loss = _vocab_parallel_ce(yl, params["head"], labels, cfg)
    if cfg.moe_experts:
        per = cfg.n_layers                     # layers x micro-batches
        stats = dict(stats, balance=stats["balance"] / per,
                     z=stats["z"] / per)
        loss = loss + cfg.moe_aux_weight * stats["balance"] \
            + cfg.moe_z_weight * stats["z"]
    group = _moe_data_axes(cfg, mesh)
    if group is not None and dp_mean:
        loss = dist_fn.all_reduce(loss, group=group) / mesh.world
    if cfg.moe_experts:
        return loss, stats
    return loss


# ------------------------------------------------------------ optimizer


def init_opt_state(cfg: GPTConfig, params, mesh=None):
    """fp32 Adam moments, one {"m", "v"} per parameter of this rank's
    `params`: shaped as the parameter at zero_stage 0; at zero_stage >= 1
    this rank's 1/n of the flat moments padded to a multiple of n, the
    number of ranks that hold the parameter (`Mesh`), where n > 1, and
    shaped as the parameter where n = 1."""
    mesh = mesh or Mesh()

    def per_leaf(path, p):
        held = _zero_holders(cfg, mesh, path)
        if held is not None:
            n = held[1]
            shape = (_zero_pad(p.numel(), n) // n,)
        else:
            shape = p.shape
        return {k: torch.zeros(shape, dtype=torch.float32, device=p.device)
                for k in ("m", "v")}
    return _tree_map(per_leaf, params)


def _adam_update(cfg: GPTConfig, p, g, m, v, lr, t, wd):
    """One Adam step on fp32 tensors, the JAX arithmetic: eps outside the
    sqrt, bias correction from the float step t, decoupled weight decay.
    Updates p, m and v in place (JAX returned new arrays)."""
    b1, b2 = cfg.beta1, cfg.beta2
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    # JAX raises the fp32 betas to the fp32 step
    t = np.float32(t)
    mhat = m / float(1 - np.float32(b1) ** t)
    vhat = v / float(1 - np.float32(b2) ** t)
    upd = mhat / (vhat.sqrt() + cfg.eps)
    if wd:
        upd = upd + wd * p
    p.sub_(lr * upd)


def _all_gather(t, group, n):
    """The n ranks' equal-length flat `t`, concatenated in rank order."""
    if moe_utils.host_staged(t, group):
        parts = [torch.empty_like(t, device="cpu") for _ in range(n)]
        dist.all_gather(parts, t.cpu(), group=group)
        return torch.cat(parts).to(t.device)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def _apply_updates(cfg: GPTConfig, params, grads, opt_state, lr, t,
                   mesh=None):
    """Adam over every parameter, in place; no weight decay on vectors.
    `grads` lists the (reduced) gradients in `_leaves(params)` order.
    ZeRO (zero_stage >= 1): each rank updates its slice of a
    parameter's flat padded vector, and the slices are all-gathered, one
    all-gather for the whole leaves and one for the expert leaves."""
    mesh = mesh or Mesh()
    gather = {}                          # group key -> [(p, slice, n, i)]
    for (path, p), g in zip(_leaves(params), grads):
        s = _get(opt_state, path)
        wd = 0.0 if p.dim() <= 1 else cfg.weight_decay
        g = g.float()
        held = _zero_holders(cfg, mesh, path)
        if held is None:
            _adam_update(cfg, p, g, s["m"], s["v"], lr, t, wd)
            continue
        group, n, i = held
        chunk = s["m"].numel()
        pad = chunk * n - p.numel()
        pf = F.pad(p.reshape(-1), (0, pad))[i * chunk:(i + 1) * chunk]
        gf = F.pad(g.reshape(-1), (0, pad))[i * chunk:(i + 1) * chunk]
        pf = pf.clone()
        _adam_update(cfg, pf, gf, s["m"], s["v"], lr, t, wd)
        gather.setdefault(_is_expert(cfg, path), (group, n, []))[2].append(
            (p, pf))
    for group, n, items in gather.values():
        full = _all_gather(torch.cat([pf for _, pf in items]), group, n)
        per_rank = full.view(n, -1)
        off = 0
        for p, pf in items:
            c = pf.numel()
            p.copy_(per_rank[:, off:off + c].reshape(-1)[:p.numel()]
                    .view_as(p))
            off += c


def _reduce_grads(cfg: GPTConfig, mesh: Mesh, paths, grads):
    """Sum each gradient over the ranks that hold its parameter (a whole
    leaf's over the world, an expert leaf's over its dp group), one
    all-reduce per (group, dtype) over the flattened gradients, then
    scale by 1 / (dp x ep): JAX's gradient of the mean loss."""
    out = list(grads)
    buckets = {}
    for i, (path, g) in enumerate(zip(paths, grads)):
        group, n, _ = _holders(cfg, mesh, path)
        key = (_is_expert(cfg, path), g.dtype)
        buckets.setdefault(key, (group, n, []))[2].append(i)
    for (_, _), (group, n, idx) in buckets.items():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        if n > 1:
            dist.all_reduce(flat, group=group)
        flat = flat / mesh.world
        off = 0
        for i in idx:
            k = grads[i].numel()
            out[i] = flat[off:off + k].view_as(grads[i])
            off += k
    return out


# -------------------------------------------------------------- trainer


def collective_bytes_per_step(cfg: GPTConfig, batch: int):
    """Analytic logical payload bytes per train step of the collectives
    of the hybrid step, by JAX's labels and formulas ({label: bytes};
    `batch` the global batch). One rank with zero_stage 0 reports none."""
    d, L, S, V = cfg.d_model, cfg.n_layers, cfg.seq_len, cfg.vocab_size
    act_bytes = torch.empty((), dtype=cfg.compute_dtype).element_size()
    n_params = 12 * L * d * d + V * d + S * d
    out = {}
    if cfg.dp > 1:
        g_bytes = act_bytes if cfg.bf16_grads else 4
        out["dp_grad_allreduce_est"] = n_params * g_bytes
    if cfg.moe_experts and cfg.ep > 1:
        # per layer: dispatch + combine all-to-all of the [E, C, d]
        # capacity tensors, forward + backward (x2 each)
        T_loc = max(batch // max(cfg.dp * cfg.ep, 1), 1) * S \
            // max(cfg.micro_batches, 1)
        C = moe_utils.expert_capacity(T_loc, cfg.moe_experts,
                                      cfg.moe_top_k,
                                      cfg.moe_capacity_factor)
        out["ep_alltoall_est"] = (4 * cfg.n_layers * cfg.micro_batches
                                  * cfg.moe_experts * C * d * act_bytes)
    if cfg.zero_stage >= 1 and cfg.dp * cfg.pp * cfg.mp * cfg.ep > 1:
        # optimizer update: grads in, params all-gathered out, fp32 flat
        # buffers; a world of 1 shards nothing
        out["zero_shard_est"] = 2 * n_params * 4
    return out


class HybridGPT:
    """The train step over this rank's part of the dp x ep mesh.

    Usage (every rank, with the same arguments; dp x ep > 1 needs
    `torch.distributed.init_process_group` first):
        trainer = HybridGPT(cfg)                  # device="cuda"
        params, opt = trainer.init(seed=0)        # this rank's shard
        tok, lab = trainer.shard_data(tokens, labels)   # its rows
        params, opt, loss = trainer.train_step(params, opt, tok, lab)

    Parameters and Adam state are updated in place and returned (the
    JAX trainer returned new arrays); `loss` is the mean over the data
    ranks, a 0-d tensor on the device, not synchronised. MoE configs
    keep each step's routing statistics in `last_moe_stats`.
    """

    def __init__(self, cfg: GPTConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = make_mesh(cfg)
        # what the model functions take: None on one rank
        self._mesh = self.mesh if self.mesh.world > 1 else None
        self.last_moe_stats = None
        self._moe_stats_pending = None

    # ---------------------------------------------------------- state

    def init(self, seed=0):
        """This rank's shard of the full parameters made from `seed`
        (the same on every rank, whatever the mesh, as JAX's unsharded
        init), and its Adam state."""
        g = torch.Generator().manual_seed(int(seed))
        params = shard_state(self.cfg, init_params(self.cfg, g, self.device),
                             rank=self.mesh.rank)
        return params, init_opt_state(self.cfg, params, self.mesh)

    def _data(self, a):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                               else a).to(self.device, torch.long)

    def shard_data(self, tokens, labels):
        """This rank's rows of the global batch (tokens, labels [B, S]):
        rows rank * B / n onwards, n = dp x ep."""
        n, r = self.mesh.world, self.mesh.rank
        B = len(tokens)
        if B % n:
            raise ValueError(f"global batch {B} does not divide over "
                             f"{n} data ranks")
        b = B // n
        return (self._data(tokens[r * b:(r + 1) * b]),
                self._data(labels[r * b:(r + 1) * b]))

    # ----------------------------------------------------------- loss

    def loss(self, params, tokens, labels):
        out = self._loss(params, tokens, labels)
        return out[0] if self.cfg.moe_experts else out

    def _loss(self, params, tokens, labels):
        with torch.no_grad():
            return _loss_fn(params, self._data(tokens), self._data(labels),
                            self.cfg, self._mesh)

    def loss_and_moe_stats(self, params, tokens, labels):
        """(loss, stats) of a MoE config: stats per `_zero_moe_stats`
        (balance and z per-layer means, the batch's global expert counts
        and dropped choices)."""
        if not self.cfg.moe_experts:
            raise ValueError("a dense config has no MoE stats")
        return self._loss(params, tokens, labels)

    # ----------------------------------------------------------- step

    def _step(self, params, opt_state, tokens, labels, lr, step_num):
        """One step, no metrics: returns (loss, stats or None)."""
        cfg, mesh = self.cfg, self._mesh
        tokens, labels = self._data(tokens), self._data(labels)
        if cfg.bf16_grads:
            # differentiate wrt compute_dtype copies of the fp32 params
            target = _tree_map(
                lambda _, p: (p.detach().to(cfg.compute_dtype)
                              if p.dtype == torch.float32
                              else p.detach()), params)
        else:
            target = params
        named = list(_leaves(target))
        leaves = [t.requires_grad_() for _, t in named]
        out = _loss_fn(target, tokens, labels, cfg, mesh, dp_mean=False)
        loss, stats = out if cfg.moe_experts else (out, None)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        loss = loss.detach()
        if stats is not None:
            stats = {k: v.detach() for k, v in stats.items()}
        if mesh is not None:
            grads = _reduce_grads(cfg, mesh, [p for p, _ in named], grads)
            loss = loss.clone()
            dist.all_reduce(loss, group=mesh.data_group)
            loss = loss / mesh.world
        if cfg.grad_clip > 0:
            sq = sum((g.float() ** 2).sum() for (p, _), g in
                     zip(named, grads) if not _is_expert(cfg, p))
            if cfg.moe_experts:
                esq = sum((g.float() ** 2).sum() for (p, _), g in
                          zip(named, grads) if _is_expert(cfg, p))
                if mesh is not None and mesh.ep_group is not None:
                    dist.all_reduce(esq, group=mesh.ep_group)
                sq = sq + esq
            gnorm = torch.sqrt(sq)
            scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-6), max=1.0)
            grads = [(g.float() * scale).to(g.dtype) for g in grads]
        with torch.no_grad():
            _apply_updates(cfg, params, grads, opt_state, lr,
                           float(step_num), self.mesh)
        return loss, stats

    def train_step(self, params, opt_state, tokens, labels, lr=None,
                   step_num=1):
        lr = self.cfg.learning_rate if lr is None else float(lr)
        if _metrics._enabled:
            self._record_collectives(tokens)
        loss, stats = self._step(params, opt_state, tokens, labels, lr,
                                 step_num)
        if stats is not None:
            # with metrics on, record the previous step's stats (its
            # read does not wait on this step): the series lag one step
            self.last_moe_stats = stats
            if _metrics._enabled:
                prev = self._moe_stats_pending
                self._moe_stats_pending = stats
                if prev is not None:
                    self._record_moe_stats(prev)
        return params, opt_state, loss

    def train_many(self, params, opt_state, tokens, labels, k, lr=None,
                   start_step=1):
        """k steps on one batch, steps start_step onwards; returns
        (params, opt_state, losses[k]). MoE configs keep their routing
        statistics: `last_moe_stats` holds the final step's and the
        metrics record the k-step aggregate. (JAX compiles the k steps
        into one executable; here they are a loop over the step.)"""
        lr = self.cfg.learning_rate if lr is None else float(lr)
        k = int(k)
        if _metrics._enabled:
            self._record_collectives(tokens, steps=k)
        losses, per_step = [], []
        for i in range(k):
            loss, stats = self._step(params, opt_state, tokens, labels, lr,
                                     start_step + i)
            losses.append(loss)
            per_step.append(stats)
        if self.cfg.moe_experts:
            self.last_moe_stats = per_step[-1]
            if _metrics._enabled:
                _metrics.record_moe_stats(
                    "train",
                    torch.stack([s["counts"] for s in per_step]).sum(0)
                    .cpu().numpy(),
                    float(sum(float(s["dropped"]) for s in per_step)),
                    float(per_step[-1]["balance"]))
        return params, opt_state, torch.stack(losses)

    # -------------------------------------------------------- metrics

    def collective_bytes_per_step(self, batch):
        return collective_bytes_per_step(self.cfg, batch)

    def _record_collectives(self, tokens, steps=1):
        # `tokens` is this rank's shard: the estimate takes the global
        # batch
        batch = int(len(tokens)) * self.mesh.world
        for label, nbytes in self.collective_bytes_per_step(batch).items():
            _metrics.COLLECTIVE_CALLS.labels(label).inc(steps)
            _metrics.COLLECTIVE_BYTES.labels(label).inc(nbytes * steps)

    def _record_moe_stats(self, mstats):
        _metrics.record_moe_stats("train", mstats["counts"].cpu().numpy(),
                                  float(mstats["dropped"]),
                                  float(mstats["balance"]))

    def flush_moe_metrics(self):
        """Record the last step's MoE stats, which `train_step` holds
        back one step: call after the last step of a run with metrics
        on."""
        if self._moe_stats_pending is not None and _metrics._enabled:
            self._record_moe_stats(self._moe_stats_pending)
        self._moe_stats_pending = None
