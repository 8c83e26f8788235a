"""The `HybridGPT` train step of `paddle_tpu/parallel/hybrid_gpt.py`,
in PyTorch: the dense and the MoE GPT over a (dp, pp, mp, ep) mesh of
`torch.distributed` ranks, with Megatron tensor parallelism, a GPipe
micro-batch pipeline, sequence parallelism, the bucketed dense-DP
reduction and ZeRO-1.

Ported function by function, under the JAX names: `GPTConfig`,
`init_params`, `param_specs` (here `_cut_axes`), `_layer_norm`,
`_attention`, `_dense_ffn`, `_moe_data_axes`, `_zero_moe_stats`,
`_moe_ffn`, `_block`, `_stage_forward`, `_vocab_parallel_embed`,
`_ce_sum_fused`, `_ce_sum`, `_vocab_parallel_ce`, `_loss_fn`,
`grad_bucket_count`, `init_opt_state`, `_adam_update`,
`_apply_updates`, `collective_bytes_per_step` and `HybridGPT` with its
step, `loss_and_moe_stats`, `train_many` and the MoE and collective
metrics. Parameters are the same nested dict of tensors (`tok_emb`,
`pos_emb`, `ln_f_w`, `ln_f_b`, `head`, and `blocks` stacked on a
leading [L] axis; a MoE block adds `gate` [L, d, E] and holds its FFN
as experts, `w_fc1` [L, E, d, ff] ...), so `convert.load_jax_hybrid_gpt`
carries a JAX trainer's state across.

Attention runs through `ops.flash_attention.splash_mha` and the
residual-add + LayerNorm between attention and FFN through
`ops.layer_norm.add_ln`; with `qkv_kernel` (and a shape
`ops.qkv_proj.qkv_proj_supported` takes) the Q/K/V projection runs
through `ops.qkv_proj.qkv_proj`: on the card, hand-written kernels, at
an mp rank's H / mp heads and, under sequence parallelism, add_ln on
its S / mp rows. The rest is plain tensor code, as it was XLA's in JAX,
the MoE expert products included.

`remat_policy` is None (full per-block recompute) or
"save_splash_residuals" (bench_gpt's: every block still recomputes in
the backward, but the flash forward's (out, lse) are kept from the
forward, so attention's forward runs once a step instead of twice).
A recompute issues its block's collectives again, on every rank of an
mp group in the same order; the selective checkpoint saves the flash
forward's outputs only, never a collective's.

**The mesh.** One process a rank over `torch.distributed`: the
caller's `init_process_group` picks the backend, every rank builds the
trainer with the same config and calls it with the same arguments, and
dp x pp x mp x ep must be the world size. Rank ((dp_i * pp + pp_i) * mp
+ mp_i) * ep + ep_i is JAX's `Mesh(devices.reshape(dp, pp, mp, ep))`.
One process with every axis 1 needs no process group. A rank holds its
stage's layers (pp cuts the stacked [L] axis), its mp slice of the
heads, ffn and vocab axes and its E / ep experts; `tok_emb`, `pos_emb`,
`ln_f_*` and `head` are held by every stage. The fused `w_qkv` and
`b_qkv` are cut by heads: a rank holds the q, k and v of its H / mp
heads, `(3, H / mp, Dh)`, so the same parameters define the same model
at every mp (JAX's trainer cuts them contiguously, which at mp > 1
gives a rank the q of heads it reads as q and k; ROADMAP, Queue 3).

Tensor parallelism is Megatron's: the column-parallel input passes
`_CopyToMP` (identity forward, all-reduce backward) and the row-parallel
partial sums `_ReduceFromMP` (all-reduce forward, identity backward);
under sequence parallelism these are an all-gather along S and a
reduce-scatter along S (`_GatherSeq`, `_ReduceScatterSeq`), and the
activations between blocks hold a rank's S / mp rows. The MoE router
runs on every mp rank on the whole token set; its gate values pass
`_CopyToMP`, as the expert outputs they weight are partial sums.

**The pipeline.** A rank's data rows are cut into `micro_batches`
micro-batches. Stage 0 embeds each, every stage runs its layers, the
last runs the final LayerNorm, the head and the CE. The schedule is all
forwards in micro-batch order, then all backwards in reverse order
(GPipe): activations go to stage + 1 and their gradients come back by
point-to-point transfers, each a blocking send matched by a blocking
receive, so no cycle of waits can form. JAX's M + pp - 1 ticks compute
the bubbles on zeros and mask them out; here a stage runs only its M
real micro-batches, with the same loss (the mean of the M micro-batch
losses, broadcast over pp), MoE statistics and gradients. At pp = 1,
micro_batches > 1 accumulates the micro-batches' gradients in one
backward.

**Gradients.** Each rank differentiates its own loss. A gradient is
summed over the data ranks (dp x ep of its (pp, mp) cell; an expert's
over dp, its ep share arriving through the all-to-all's backward), over
pp for the leaves every stage holds, over mp for the leaves replicated
over mp whose gradient is a rank's share: under sequence parallelism
the ones applied to a rank's S / mp rows (`ln1_*`, `ln2_*`, `b_o`, the
dense `b_fc2`, `pos_emb`, `ln_f_*`), and the MoE `b_fc2` (1 / mp of it
rides each rank's expert buffer, as in JAX), then scaled to JAX's mean
over the dp x ep ranks. With `grad_bucket_bytes` (dense dp only) the
data reduction runs in flat per-dtype buckets of at most that many
bytes, in reversed leaf order, each all-reduce issued from
post-accumulate gradient hooks as soon as its gradients exist and
waited on before the update. The clip's global norm counts a cut
leaf's squares summed over its cut axes and a replicated leaf once.
With `zero_stage=1` a rank holds 1/n of every parameter's flat padded
Adam moments, n being the ranks that hold the same slice of it,
updates its part and all-gathers the result; where n is 1 the moments
stay shaped as the parameter. (JAX shards its flat moments over the
whole world: the layout differs, the trained parameters do not.)

Under gloo, a CUDA payload of an all-gather, a point-to-point transfer
or an all-to-all goes through host memory, and a reduce-scatter is an
all-reduce and this rank's slice (`moe_utils.host_staged`, chosen by
the group's backend).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
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
#: the mesh axes, in rank order (the last varies fastest)
AXES = ("dp", "pp", "mp", "ep")
#: the axes the token batch is sharded over
DATA_AXES = ("dp", "ep")
#: the leaves replicated over mp that sequence parallelism applies to a
#: rank's S / mp rows (and the dense `b_fc2`)
SP_ROW_LEAVES = ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "b_o", "pos_emb",
                 "ln_f_w", "ln_f_b")
#: the mp-cut axis of each block leaf (dense; the qkv pair by heads)
_MP_DIM = {"w_qkv": 2, "b_qkv": 1, "w_o": 1, "w_fc1": 2, "b_fc1": 1,
           "w_fc2": 1}
#: the mp-cut axis of each expert leaf (MoE)
_MP_DIM_EXPERT = {"w_fc1": 3, "b_fc1": 2, "w_fc2": 2}


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
    # parallelism: a (dp, pp, mp, ep) mesh of ranks
    dp: int = 1
    pp: int = 1
    mp: int = 1
    ep: int = 1              # experts sharded over ep; tokens over
                             # (dp, ep) jointly
    micro_batches: int = 1   # per train step, the pipeline's schedule
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
    fused_ce: bool = True    # mp = 1 only, as in JAX
    qkv_kernel: bool = False
    # AMP-O2-style: differentiate wrt compute_dtype copies of the fp32
    # params; Adam still updates the fp32 masters
    bf16_grads: bool = False
    compute_dtype: Any = torch.bfloat16
    # bucketed dense-DP gradient reduction: flat per-dtype buckets of at
    # most this many bytes (0: one all-reduce per dtype); dp only
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
        for axis in AXES + ("micro_batches",):
            if getattr(self, axis) < 1:
                raise ValueError(f"{axis}={getattr(self, axis)} must be "
                                 ">= 1")
        if self.n_layers % self.pp:
            raise ValueError(f"n_layers {self.n_layers} does not divide "
                             f"over pp={self.pp} stages")
        if self.n_heads % self.mp:
            raise ValueError(f"n_heads {self.n_heads} does not divide "
                             f"over mp={self.mp}")
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_heads {self.n_heads}")
        if self.vocab_size % self.mp:
            raise ValueError(f"vocab_size {self.vocab_size} does not "
                             f"divide over mp={self.mp}")
        # the alias: two conflicting non-zero counts are refused
        if (self.moe_experts and moe_num_experts
                and self.moe_experts != moe_num_experts):
            raise ValueError(f"moe_experts={self.moe_experts} conflicts "
                             f"with moe_num_experts={moe_num_experts}")
        if moe_num_experts and not self.moe_experts:
            self.moe_experts = moe_num_experts
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
        if self.sequence_parallel and self.seq_len % self.mp:
            raise ValueError(f"sequence parallelism: seq_len "
                             f"{self.seq_len} does not divide over "
                             f"mp={self.mp}")
        if self.grad_bucket_bytes and (self.mp != 1 or self.pp != 1
                                       or self.moe_experts):
            raise ValueError("grad_bucket_bytes needs the pure dense-DP "
                             "config (mp=pp=1, no MoE): only there is "
                             "every gradient leaf replicated, so a plain "
                             "dp sum per bucket is its reduction")
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


def _is_expert(cfg: GPTConfig, path):
    return bool(cfg.moe_experts) and path[0] == "blocks" \
        and path[-1] in EXPERT_LEAVES


def _cut_axes(cfg: GPTConfig, path):
    """{mesh axis: dimension of the full tensor it cuts} of the leaf at
    `path` (JAX's `param_specs`, with the qkv pair cut by heads)."""
    name = path[-1]
    if path[0] != "blocks":
        return {"tok_emb": {"mp": 0}, "head": {"mp": 1}}.get(name, {})
    cut = {"pp": 0}
    if _is_expert(cfg, path):
        cut["ep"] = 1
        mp_dim = _MP_DIM_EXPERT.get(name)
    else:
        mp_dim = _MP_DIM.get(name)
    if mp_dim is not None:
        cut["mp"] = mp_dim
    return cut


def _grad_axes(cfg: GPTConfig, path):
    """The mesh axes a rank's gradient of the leaf at `path` is summed
    over (before the 1 / (dp x ep) of the data mean)."""
    name = path[-1]
    expert = _is_expert(cfg, path)
    axes = ["dp"] if expert else list(DATA_AXES)
    if path[0] != "blocks":                    # every stage holds it
        axes.append("pp")
    sp = cfg.sequence_parallel and cfg.mp > 1
    if expert and name == "b_fc2":
        axes.append("mp")
    elif sp and (name in SP_ROW_LEAVES
                 or (name == "b_fc2" and not cfg.moe_experts)):
        axes.append("mp")
    return tuple(axes)


# ----------------------------------------------------------------- mesh


def _coords(rank, sizes):
    """A rank's mesh coordinates ({axis: index})."""
    out = {}
    for a in reversed(AXES):
        rank, out[a] = divmod(rank, sizes[a])
    return out


def _rank_of(coords, sizes):
    r = 0
    for a in AXES:
        r = r * sizes[a] + coords[a]
    return r


@dataclasses.dataclass
class Mesh:
    """One rank's place in the (dp, pp, mp, ep) mesh and its process
    groups: for every set of axes longer than one rank, the group of the
    ranks that share this rank's coordinates on the other axes (e.g.
    ("mp",) its mp group, ("dp", "ep") its data group). A group of one
    rank is None."""
    rank: int = 0
    sizes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(AXES, 1))
    coords: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(AXES, 0))
    groups: Dict[Any, Any] = dataclasses.field(default_factory=dict)

    @property
    def world(self):
        return math.prod(self.sizes.values())

    def axes(self, axes):
        """`axes` in mesh order, those of size 1 left out."""
        return tuple(a for a in AXES if a in axes and self.sizes[a] > 1)

    def size(self, axes):
        return math.prod(self.sizes[a] for a in self.axes(axes))

    def index(self, axes):
        """This rank's index in its group over `axes` (rank order)."""
        i = 0
        for a in self.axes(axes):
            i = i * self.sizes[a] + self.coords[a]
        return i

    def group(self, axes):
        return self.groups.get(self.axes(axes))

    def neighbour(self, axis, step):
        """The global rank `step` places along `axis` (cyclic)."""
        c = dict(self.coords)
        c[axis] = (c[axis] + step) % self.sizes[axis]
        return _rank_of(c, self.sizes)

    @property
    def data_group(self):
        return self.group(DATA_AXES)

    @property
    def ep_group(self):
        return self.group(("ep",))


def _mesh_sizes(cfg: GPTConfig):
    return {a: getattr(cfg, a) for a in AXES}


def make_mesh(cfg: GPTConfig) -> Mesh:
    """The calling rank's `Mesh`. A mesh of one rank is one process,
    whatever process group exists; else the default group must hold dp
    x pp x mp x ep ranks, and every rank must call this in the same
    order (it makes every subgroup)."""
    sizes = _mesh_sizes(cfg)
    n = math.prod(sizes.values())
    if n == 1:
        return Mesh()
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"dp={cfg.dp} x pp={cfg.pp} x mp={cfg.mp} x ep={cfg.ep} needs "
            f"torch.distributed initialised over {n} ranks "
            f"(init_process_group), got "
            + (f"{dist.get_world_size()}" if dist.is_initialized()
               else "no process group"))
    rank = dist.get_rank()
    mesh = Mesh(rank=rank, sizes=sizes, coords=_coords(rank, sizes))
    live = [a for a in AXES if sizes[a] > 1]
    for k in range(1, len(live) + 1):
        for axes in itertools.combinations(live, k):
            if k == len(live):
                mesh.groups[axes] = dist.group.WORLD
                continue
            fixed = [a for a in AXES if a not in axes]
            for at in itertools.product(*(range(sizes[a]) for a in fixed)):
                base = dict(zip(fixed, at))
                ranks = [_rank_of({**base, **dict(zip(axes, c))}, sizes)
                         for c in itertools.product(
                             *(range(sizes[a]) for a in axes))]
                g = dist.new_group(ranks)
                if rank in ranks:
                    mesh.groups[axes] = g
    return mesh


def _zero_holders(cfg: GPTConfig, mesh: Mesh, path):
    """(group, number of ranks, this rank's index) of the ranks that
    hold the same slice of the parameter at `path`, where ZeRO shards
    its moments; None at zero_stage 0 and where one rank holds the slice
    (ZeRO-1 over one rank is the identity: the moments stay shaped as
    the parameter)."""
    if cfg.zero_stage < 1:
        return None
    free = [a for a in AXES if a not in _cut_axes(cfg, path)]
    n = mesh.size(free)
    return (mesh.group(free), n, mesh.index(free)) if n > 1 else None


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


def _qkv_heads(t, parts, index):
    """The heads `index` of `parts` of a fused-QKV last axis laid out
    (3, H, Dh): that slice of each of q, k and v, (3, H / parts, Dh)."""
    lead = t.shape[:-1]
    return t.reshape(*lead, 3, parts, -1)[..., index, :].reshape(*lead, -1)


def _cut(cfg: GPTConfig, path, t, mesh: Mesh):
    """Rank `mesh`'s slice of the full leaf `t` at `path`."""
    for axis, dim in _cut_axes(cfg, path).items():
        n, i = mesh.sizes[axis], mesh.coords[axis]
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"{'.'.join(path)}: axis {dim} of "
                             f"{tuple(t.shape)} does not divide over "
                             f"{axis}={n}")
        if axis == "mp" and path[-1] in ("w_qkv", "b_qkv"):
            t = _qkv_heads(t, n, i)
        else:
            k = t.shape[dim] // n
            t = t.narrow(dim, i * k, k)
    return t.contiguous()


def shard_state(cfg: GPTConfig, params, opt_state=None, rank=0):
    """Cut full parameters (and, given, full-shaped Adam moments, one
    {"m", "v"} per parameter) to rank `rank`'s shard under `cfg`'s mesh
    (its stage's layers, its mp slice, its experts); moments in `cfg`'s
    layout (`init_opt_state`). Returns params, or (params, opt_state)."""
    sizes = _mesh_sizes(cfg)
    mesh = Mesh(rank=int(rank), sizes=sizes, coords=_coords(int(rank),
                                                            sizes))
    local = _tree_map(lambda path, t: _cut(cfg, path, t, mesh), params)
    if opt_state is None:
        return local

    def moments(path, p):
        s = _get(opt_state, path)
        out = {}
        for name in ("m", "v"):
            t = _cut(cfg, path, s[name].float(), mesh)
            held = _zero_holders(cfg, mesh, path)
            if held is not None:
                _, n, i = held
                chunk = _zero_pad(t.numel(), n) // n
                t = F.pad(t.reshape(-1), (0, chunk * n - t.numel()))
                t = t[i * chunk:(i + 1) * chunk].clone()
            out[name] = t
        return out
    return local, _tree_map(moments, params)


# ------------------------------------------------ collectives over mp


def _all_reduce(t, group, op=dist.ReduceOp.SUM):
    t = t.contiguous().clone()
    dist.all_reduce(t, op=op, group=group)
    return t


def _all_gather(t, group, n, dim=0):
    """The n ranks' equal-shaped `t`, concatenated in rank order along
    `dim`. Under gloo a CUDA `t` goes through host memory; the direct
    path (NCCL) has not run yet: every test and the card's smoke run use
    gloo."""
    t = t.contiguous()
    src = t.cpu() if moe_utils.host_staged(t, group) else t
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def _reduce_scatter_seq(t, group, n, i):
    """The sum of the n ranks' [B, S, ...] `t`, this rank's S / n rows.
    Gloo has no reduce-scatter: an all-reduce and this rank's slice. The
    `reduce_scatter_tensor` path (NCCL) has not run yet: every test and
    the card's smoke run use gloo."""
    k = t.shape[1] // n
    if dist.get_backend(group) == "gloo":
        return _all_reduce(t, group).narrow(1, i * k, k).contiguous()
    src = t.reshape(t.shape[0], n, k, *t.shape[2:]).transpose(0, 1)
    out = torch.empty((t.shape[0], k) + tuple(t.shape[2:]), dtype=t.dtype,
                      device=t.device)
    dist.reduce_scatter_tensor(out, src.contiguous(), group=group)
    return out


class _CopyToMP(torch.autograd.Function):
    """Identity forward; the backward sums the mp ranks' partial
    gradients (Megatron's copy to the tensor-parallel region)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromMP(torch.autograd.Function):
    """All-reduce forward (row-parallel partial sums); identity
    backward: every mp rank already holds the whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    """All-gather along S forward; the backward reduce-scatters the mp
    ranks' partial gradients along S."""

    @staticmethod
    def forward(ctx, x, group, n, i):
        ctx.group, ctx.n, ctx.i = group, n, i
        return _all_gather(x, group, n, dim=1)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_seq(g, ctx.group, ctx.n, ctx.i), None, None, \
            None


class _ReduceScatterSeq(torch.autograd.Function):
    """Reduce-scatter along S forward (row-parallel partial sums onto a
    rank's rows); the backward all-gathers the rows' gradients."""

    @staticmethod
    def forward(ctx, x, group, n, i):
        ctx.group, ctx.n = group, n
        return _reduce_scatter_seq(x, group, n, i)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.n, dim=1), None, None, None


class _SeqReplica(torch.autograd.Function):
    """`gathered` (this rank's rows `local` all-gathered along S) as
    the input of a computation every mp rank runs alike: the backward
    hands `local` its rows of that computation's gradient, which every
    rank holds whole (no sum)."""

    @staticmethod
    def forward(ctx, local, gathered, n, i):
        ctx.n, ctx.i = n, i
        return gathered.view_as(gathered)

    @staticmethod
    def backward(ctx, g):
        k = g.shape[1] // ctx.n
        return g.narrow(1, ctx.i * k, k), None, None, None


def _sp(cfg: GPTConfig):
    return cfg.sequence_parallel and cfg.mp > 1


def _enter_mp(t, cfg: GPTConfig, mesh):
    """The input of a column-parallel product: copied to the mp ranks
    (sequence parallel: gathered along S)."""
    if cfg.mp == 1:
        return t
    g = mesh.group(("mp",))
    if _sp(cfg):
        return _GatherSeq.apply(t, g, cfg.mp, mesh.coords["mp"])
    return _CopyToMP.apply(t, g)


def _exit_mp(t, cfg: GPTConfig, mesh):
    """A row-parallel product's partial sums, summed over mp (sequence
    parallel: onto this rank's rows)."""
    if cfg.mp == 1:
        return t
    g = mesh.group(("mp",))
    if _sp(cfg):
        return _ReduceScatterSeq.apply(t, g, cfg.mp, mesh.coords["mp"])
    return _ReduceFromMP.apply(t, g)


# ----------------------------------------------------------- model math


def _layer_norm(x, w, b, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, correction=0, keepdim=True)
    return ((xf - mu) / torch.sqrt(var + eps) * w + b).to(x.dtype)


def _attention(x, w_qkv, b_qkv, w_o, b_o, cfg: GPTConfig):
    """x [B, S, d] (the whole sequence, this rank's H / mp heads);
    causal self-attention through the flash kernel. Returns (out without
    its bias, b_o): out is a row-parallel partial sum over mp, the
    caller reduces it and adds b_o."""
    B, S, d = x.shape
    h = cfg.n_heads // cfg.mp
    hd = cfg.d_model // cfg.n_heads
    cd = cfg.compute_dtype
    xc = x.to(cd)
    if cfg.qkv_kernel and qkv_proj_supported(h, S, h * hd, d):
        # the fused projection: one rounding of product + bias, stored
        # straight into [B, H, S, hd]
        q, k, v = qkv_proj(xc, w_qkv.to(cd), b_qkv.to(cd), h)
    else:
        wq, wk, wv = w_qkv.to(cd).split(h * hd, dim=-1)
        bq, bk, bv = b_qkv.to(cd).split(h * hd, dim=-1)

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
    data rank): the group MoE routing statistics are summed across, for
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
    group and the experts' ff axis cut over mp.

    x [B, S_loc, d] this rank's activations (S_loc = S / mp under
    sequence parallelism, which gathers the whole sequence first).
    Experts: E in all, E / ep resident on each ep rank (w1 local [E_loc,
    d, ff / mp]). Every mp rank routes the whole token set alike; the
    gate values pass `_CopyToMP`, the expert outputs being partial sums
    over mp. The router and the index dispatch / combine come from
    `moe_utils` (serving's pair, whose backwards run in a fixed order);
    at ep > 1 the [E, C, d] dispatch buffers ride the all-to-all to the
    experts' owners and back. Capacity-overflowed (token, choice) pairs
    contribute 0: the block's residual is the drop path. Returns (out
    [B, S_loc, d] summed over mp, stats per `_zero_moe_stats`): balance
    and z over the global token set, counts and dropped summed in fp32
    over the data group (exact)."""
    cd = cfg.compute_dtype
    E = cfg.moe_experts
    ep = cfg.ep
    group = _moe_data_axes(cfg, mesh)
    xe = _enter_mp(x, cfg, mesh)              # the experts' input
    xr = x                                    # the router's
    if _sp(cfg):
        xr = _SeqReplica.apply(x, xe.detach(), cfg.mp, mesh.coords["mp"])
    B, S, d = xe.shape
    T = B * S
    xt = xe.reshape(T, d)
    logits = xr.reshape(T, d).float() @ gate_w.float()
    C = moe_utils.expert_capacity(T, E, cfg.moe_top_k,
                                  cfg.moe_capacity_factor)
    r = moe_utils.top_k_routing(logits, cfg.moe_top_k, C, dtype=cd,
                                group=group)
    plan = r.plan
    if cfg.mp > 1:
        plan = dataclasses.replace(plan, gates=_CopyToMP.apply(
            plan.gates, mesh.group(("mp",))))
    dispatched = moe_utils.dispatch_tokens_indexed(xt.to(cd), plan, E, C)
    if ep > 1:
        expert_in = moe_utils.all_to_all_dispatch(dispatched,
                                                  mesh.ep_group, ep)
    else:
        expert_in = dispatched                   # [E (= E_loc), C, d]
    h = torch.bmm(expert_in, w1.to(cd)) + b1[:, None, :].to(cd)
    h = F.gelu(h, approximate="tanh")
    # b2 rides inside the expert buffer (each token's bias share is
    # gate-weighted per chosen expert), scaled by 1/mp: the row-parallel
    # partial's reduction restores it once
    eout = torch.bmm(h, w2.to(cd)) + (b2[:, None, :] / cfg.mp).to(cd)
    if ep > 1:
        eout = moe_utils.all_to_all_combine(eout, mesh.ep_group, ep)
    out = moe_utils.combine_tokens_indexed(eout, plan)
    counts, dropped = plan.counts, plan.dropped
    if group is not None:
        counts, dropped = counts.clone(), dropped.clone()
        dist.all_reduce(counts, group=group)
        dist.all_reduce(dropped, group=group)
    stats = {"balance": r.balance_loss, "z": r.z_loss, "counts": counts,
             "dropped": dropped}
    return _exit_mp(out.reshape(B, S, d), cfg, mesh), stats


def _block(x, lp, cfg: GPTConfig, mesh=None):
    """One transformer block: [B, S_loc, d] -> ([B, S_loc, d], aux), aux
    the MoE statistics per `_zero_moe_stats` (None for a dense block:
    JAX's zeros only keep its scan's carry one structure)."""
    h = _layer_norm(x, lp["ln1_w"], lp["ln1_b"])
    attn, b_o = _attention(_enter_mp(h, cfg, mesh), lp["w_qkv"],
                           lp["b_qkv"], lp["w_o"], lp["b_o"], cfg)
    attn = _exit_mp(attn, cfg, mesh) + b_o.to(attn.dtype)
    if cfg.fused_add_ln:
        h2, x = add_ln(x, attn.to(x.dtype), lp["ln2_w"], lp["ln2_b"])
    else:
        x = x + attn.to(x.dtype)
        h2 = _layer_norm(x, lp["ln2_w"], lp["ln2_b"])
    if cfg.moe_experts:
        ff, aux = _moe_ffn(h2, lp["gate"], lp["w_fc1"], lp["b_fc1"],
                           lp["w_fc2"], lp["b_fc2"], cfg, mesh)
        return x + ff.to(x.dtype), aux
    ff, b2 = _dense_ffn(_enter_mp(h2, cfg, mesh), lp["w_fc1"],
                        lp["b_fc1"], lp["w_fc2"], lp["b_fc2"], cfg)
    ff = _exit_mp(ff, cfg, mesh)
    return x + (ff + b2.to(ff.dtype)).to(x.dtype), None


def _stage_forward(x, blocks, cfg: GPTConfig, mesh=None):
    """This stage's layers, a Python loop over the stacked layer axis;
    returns (x, the MoE statistics summed over layers, or None). With
    remat every block is recomputed in the backward; under
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


def _vocab_parallel_embed(tokens, tok_emb, cfg: GPTConfig, mesh=None):
    """The token embedding, its rows cut over mp: a rank looks up the
    ids of its shard (F.embedding of the clipped local ids), zeroes the
    others, and the sum over mp assembles the embedding (sequence
    parallel: onto this rank's rows).

    F.embedding, not indexing: its backward sums each id's rows in a
    fixed order on the CPU and the card, where indexing's backward (an
    accumulating index_put_) sums in another order from run to run on
    the CPU."""
    if cfg.mp == 1:
        return F.embedding(tokens, tok_emb)
    V_loc = tok_emb.shape[0]
    local = tokens - mesh.coords["mp"] * V_loc
    ok = (local >= 0) & (local < V_loc)
    emb = F.embedding(local.clamp(0, V_loc - 1), tok_emb)
    emb = torch.where(ok[..., None], emb, torch.zeros((), dtype=emb.dtype,
                                                      device=emb.device))
    return _exit_mp(emb, cfg, mesh)


def _embed(params, tokens, cfg: GPTConfig, mesh=None):
    """Stage 0's input: token + position embeddings, in the compute
    dtype ([B, S / mp, d] under sequence parallelism)."""
    S = tokens.shape[1]
    pos = params["pos_emb"][:S]
    if _sp(cfg):
        k = S // cfg.mp
        pos = pos[mesh.coords["mp"] * k:(mesh.coords["mp"] + 1) * k]
    cd = cfg.compute_dtype
    e = _vocab_parallel_embed(tokens, params["tok_emb"], cfg, mesh)
    return e.to(cd) + pos.to(cd)[None]


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


def _ce_sum(y, head, labels, cfg: GPTConfig, mesh=None):
    """Sum (not mean) of token CE over y [B, S', d]; at mp > 1 over the
    vocab shards (a stable global logsumexp: the max of the local maxima
    (no gradient), the sum of the shards' sums of exps and of the target
    logit, as JAX's pmax / psum)."""
    if cfg.mp == 1 and cfg.fused_ce:
        return _ce_sum_fused(y, head, labels, cfg)
    cd = cfg.compute_dtype
    logits = (y.to(cd) @ head.to(cd)).float()
    if cfg.mp == 1:
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, labels[..., None])[..., 0]
        return (lse - tgt).sum()
    g = mesh.group(("mp",))
    V_loc = head.shape[1]
    gmax = _all_reduce(logits.detach().amax(dim=-1), g, dist.ReduceOp.MAX)
    sumexp = torch.exp(logits - gmax[..., None]).sum(dim=-1)
    lse = torch.log(_ReduceFromMP.apply(sumexp, g)) + gmax
    local = labels - mesh.coords["mp"] * V_loc
    ok = (local >= 0) & (local < V_loc)
    tgt = logits.gather(-1, local.clamp(0, V_loc - 1)[..., None])[..., 0]
    tgt = _ReduceFromMP.apply(torch.where(ok, tgt, torch.zeros_like(tgt)),
                              g)
    return (lse - tgt).sum()


def _vocab_parallel_ce(y, head, labels, cfg: GPTConfig, mesh=None):
    """Mean token CE; y [B, S, d] the whole sequence on every mp rank,
    head [d, V / mp]. ce_seq_chunks > 1 streams the head matmul + CE
    over sequence chunks, so the [B, S, V] logits never materialise at
    once; the unfused CE recomputes each chunk in the backward, as the
    JAX package's per-chunk checkpoint does (the fused CE needs no
    checkpoint: it saves no logits)."""
    B, S, _ = y.shape
    C = max(1, cfg.ce_seq_chunks)
    if C == 1 or S % C != 0:
        return _ce_sum(y, head, labels, cfg, mesh) / (B * S)
    Sc = S // C
    sums = []
    for c in range(C):
        yy, ll = y[:, c * Sc:(c + 1) * Sc], labels[:, c * Sc:(c + 1) * Sc]
        if cfg.fused_ce and cfg.mp == 1:
            sums.append(_ce_sum(yy, head, ll, cfg))
        else:
            sums.append(checkpoint(_ce_sum, yy, head, ll, cfg, mesh,
                                   use_reentrant=False))
    return torch.stack(sums).sum() / (B * S)


def _head_loss(params, y, labels, cfg: GPTConfig, mesh=None):
    """The last stage's final LayerNorm, vocab head and mean CE of one
    micro-batch (sequence parallel: LN on this rank's rows, then the
    whole sequence gathered)."""
    yl = _layer_norm(y, params["ln_f_w"], params["ln_f_b"])
    return _vocab_parallel_ce(_enter_mp(yl, cfg, mesh), params["head"],
                              labels, cfg, mesh)


def _aux_scale(cfg: GPTConfig):
    """The per-layer-per-micro-batch mean's divisor of the summed MoE
    balance and z losses."""
    return cfg.n_layers * cfg.micro_batches


def _finish_stats(cfg: GPTConfig, loss, stats):
    """The MoE losses' per-layer means, added to the CE loss."""
    per = _aux_scale(cfg)
    stats = dict(stats, balance=stats["balance"] / per,
                 z=stats["z"] / per)
    return (loss + cfg.moe_aux_weight * stats["balance"]
            + cfg.moe_z_weight * stats["z"]), stats


def _sum_stats(total, stats):
    return stats if total is None else {k: total[k] + stats[k]
                                        for k in MOE_STATS}


def _micro(tokens, labels, cfg: GPTConfig):
    """The micro-batches' (tokens, labels) of this rank's rows."""
    M = cfg.micro_batches
    if len(tokens) % M:
        raise ValueError(f"the rank's batch {len(tokens)} does not divide "
                         f"into micro_batches={M}")
    return list(zip(tokens.chunk(M), labels.chunk(M)))


def _send(t, dst):
    """Blocking send of `t` to rank `dst`; under gloo a CUDA `t` goes
    through host memory. The direct path (NCCL, with `_recv`) has not
    run yet: every test and the card's smoke run use gloo."""
    t = t.contiguous()
    dist.send(t.cpu() if moe_utils.host_staged(t, None) else t, dst)


def _recv(shape, dtype, device, src):
    probe = torch.empty(0, device=device)
    staged = moe_utils.host_staged(probe, None)
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if staged else device)
    dist.recv(buf, src)
    return buf.to(device)


def _pipeline(params, tokens, labels, cfg: GPTConfig, mesh: Mesh,
              leaves=None):
    """This rank's stage of the GPipe schedule over the micro-batches
    (pp > 1): every forward in order, then, given the differentiated
    `leaves`, every backward in reverse order, each micro-batch's
    activation received from stage - 1 and sent to stage + 1 and its
    gradient sent back. Returns (the rank's loss, the MoE statistics or
    None, the leaves' gradients or None): the loss is the mean of the
    micro-batch losses, broadcast from the last stage; the statistics
    are summed over the stages."""
    pp, M = cfg.pp, cfg.micro_batches
    stage = mesh.coords["pp"]
    first, last = stage == 0, stage == pp - 1
    prev, nxt = mesh.neighbour("pp", -1), mesh.neighbour("pp", 1)
    B, S = tokens.shape
    shape = (B // M, S // cfg.mp if _sp(cfg) else S, cfg.d_model)
    cd, dev = cfg.compute_dtype, tokens.device
    runs, stats = [], None
    for tok, lab in _micro(tokens, labels, cfg):
        if first:
            x = _embed(params, tok, cfg, mesh)
        else:
            x = _recv(shape, cd, dev, prev)
            if leaves is not None:
                x.requires_grad_()
        y, st = _stage_forward(x, params["blocks"], cfg, mesh)
        if last:
            out = _head_loss(params, y, lab, cfg, mesh)
        else:
            _send(y.detach(), nxt)
            out = y
        runs.append((x, out, st))
        if st is not None:
            stats = _sum_stats(stats, {k: v.detach() for k, v in
                                       st.items()})
    ce = sum(out.detach() for _, out, _ in runs) / M if last else \
        torch.zeros((), device=dev)
    grads = None
    if leaves is not None:
        grads = [None] * len(leaves)
        per = _aux_scale(cfg)
        for m in reversed(range(M)):
            x, out, st = runs[m]
            runs[m] = None
            outs = [out]
            gouts = [torch.full((), 1.0 / M, device=dev) if last else
                     _recv(shape, out.dtype, dev, nxt)]
            if st is not None:
                outs += [st["balance"], st["z"]]
                gouts += [torch.full((), cfg.moe_aux_weight / per,
                                     device=dev),
                          torch.full((), cfg.moe_z_weight / per,
                                     device=dev)]
            inputs = list(leaves) + ([] if first else [x])
            gs = torch.autograd.grad(outs, inputs, gouts, allow_unused=True)
            if not first:
                _send(gs[-1], prev)
            for i, g in enumerate(gs[:len(leaves)]):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
    g_pp = mesh.group(("pp",))
    loss = _all_reduce(ce.float(), g_pp)          # the last stage's
    if stats is not None:
        stats = {k: _all_reduce(v, g_pp) for k, v in stats.items()}
        loss, stats = _finish_stats(cfg, loss, stats)
    return loss, stats, grads


def _loss_fn(params, tokens, labels, cfg: GPTConfig, mesh=None,
             dp_mean=True):
    """Forward loss of one rank's data shard: embed, all blocks, final
    LN, vocab head and mean CE over the micro-batches, plus (MoE)
    `moe_aux_weight` x the per-layer balance loss and `moe_z_weight` x
    the per-layer z-loss. At pp > 1 the stages' forwards
    (`_pipeline`, no gradient). With `dp_mean` the loss is the mean over
    the data ranks (an all-reduce); the trainer differentiates the
    rank's own loss (`dp_mean=False`) and reduces the gradients itself.
    MoE configs return (loss, stats): balance and z per-layer means,
    counts and dropped the global totals of the batch."""
    if cfg.pp > 1:
        loss, stats, _ = _pipeline(params, tokens, labels, cfg, mesh)
    else:
        ce, stats = None, None
        for tok, lab in _micro(tokens, labels, cfg):
            y, st = _stage_forward(_embed(params, tok, cfg, mesh),
                                   params["blocks"], cfg, mesh)
            ce_m = _head_loss(params, y, lab, cfg, mesh)
            ce = ce_m if ce is None else ce + ce_m
            if st is not None:
                stats = _sum_stats(stats, st)
        loss = ce / cfg.micro_batches
        if stats is not None:
            loss, stats = _finish_stats(cfg, loss, stats)
    group = _moe_data_axes(cfg, mesh)
    if group is not None and dp_mean:
        loss = dist_fn.all_reduce(loss, group=group) \
            / mesh.size(DATA_AXES)
    if cfg.moe_experts:
        return loss, stats
    return loss


# ------------------------------------------- bucketed DP grad reduction


def grad_bucket_count(params, bucket_bytes, grad_dtype=None):
    """`_GradBuckets`' plan's bucket count (JAX's host-side mirror of
    its `_bucketed_psum`): per dtype, ceil(total elements / elements a
    bucket)."""
    per_dtype = {}
    for _, leaf in _leaves(params):
        dt = grad_dtype if grad_dtype is not None else leaf.dtype
        if not dt.is_floating_point:
            continue
        per_dtype[dt] = per_dtype.get(dt, 0) + leaf.numel()
    n = 0
    for dt, elems in per_dtype.items():
        per = max(1, int(bucket_bytes) // torch.empty(
            (), dtype=dt).element_size())
        n += -(-elems // per)
    return n


class _GradBuckets:
    """The bucketed data-parallel reduction of one backward: per dtype,
    the leaves' gradients in reversed leaf order (about the order the
    backward finishes them) laid end to end and cut into flat buckets of
    at most `bucket_bytes`; a bucket's all-reduce is issued
    (`async_op=True`) from the post-accumulate gradient hook of the last
    of its leaves to finish, and `finish` waits on every bucket. Every
    rank runs the same backward, so every rank issues the buckets in
    the same order."""

    def __init__(self, leaves, bucket_bytes, group):
        self.leaves, self.group = leaves, group
        self.buckets, self.works = [], {}
        self.pending, self.of_leaf = [], {}
        by_dtype = {}
        for i, p in enumerate(leaves):
            by_dtype.setdefault(p.dtype, []).append(i)
        for dt, idxs in by_dtype.items():
            per = max(1, int(bucket_bytes) // torch.empty(
                (), dtype=dt).element_size())
            cur, room = [], per
            for i in reversed(idxs):
                start, n = 0, leaves[i].numel()
                while n:
                    take = min(n, room)
                    cur.append((i, start, take))
                    start, n, room = start + take, n - take, room - take
                    if room == 0:
                        self._add(cur)
                        cur, room = [], per
            if cur:
                self._add(cur)
        self.hooks = [p.register_post_accumulate_grad_hook(
            functools.partial(self._ready, i)) for i, p in enumerate(leaves)]

    def _add(self, pieces):
        b = len(self.buckets)
        self.buckets.append(pieces)
        self.pending.append({i for i, _, _ in pieces})
        for i, _, _ in pieces:
            self.of_leaf.setdefault(i, []).append(b)

    def _ready(self, i, _leaf):
        for b in self.of_leaf.get(i, ()):
            self.pending[b].discard(i)
            if not self.pending[b]:
                self._launch(b)

    def _launch(self, b):
        flat = torch.cat([self.leaves[i].grad.reshape(-1)[s:s + n]
                          for i, s, n in self.buckets[b]])
        self.works[b] = (dist.all_reduce(flat, group=self.group,
                                         async_op=True), flat)

    def finish(self, scale):
        """The reduced gradients x `scale`, in leaf order (the hooks
        removed, the leaves' .grad cleared). Every leaf of the dense
        model has a gradient, so every bucket has been issued."""
        for h in self.hooks:
            h.remove()
        out = [torch.empty_like(p).reshape(-1) for p in self.leaves]
        for b, pieces in enumerate(self.buckets):
            work, flat = self.works[b]
            work.wait()
            off = 0
            for i, s, n in pieces:
                out[i][s:s + n] = flat[off:off + n]
                off += n
        for p in self.leaves:
            p.grad = None
        return [(g * scale).view_as(p) for g, p in zip(out, self.leaves)]


# ------------------------------------------------------------ optimizer


def init_opt_state(cfg: GPTConfig, params, mesh=None):
    """fp32 Adam moments, one {"m", "v"} per parameter of this rank's
    `params`: shaped as the parameter at zero_stage 0; at zero_stage >= 1
    this rank's 1/n of the flat moments padded to a multiple of n, the
    number of ranks that hold the same slice of the parameter
    (`_zero_holders`), where n > 1, and shaped as the parameter where
    n = 1."""
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


def _apply_updates(cfg: GPTConfig, params, grads, opt_state, lr, t,
                   mesh=None):
    """Adam over every parameter, in place; no weight decay on vectors.
    `grads` lists the (reduced) gradients in `_leaves(params)` order.
    ZeRO (zero_stage >= 1): each rank updates its slice of a
    parameter's flat padded vector, and the slices are all-gathered, one
    all-gather for each group of holders."""
    mesh = mesh or Mesh()
    gather = {}                          # holders' axes -> (group, n, [..])
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
        key = mesh.axes([a for a in AXES if a not in _cut_axes(cfg, path)])
        gather.setdefault(key, (group, n, []))[2].append((p, pf))
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
    """Sum each gradient over `_grad_axes` (one all-reduce per (axes,
    dtype) over the flattened gradients), then scale by 1 / (dp x ep):
    JAX's gradient of the mean loss."""
    out = list(grads)
    buckets = {}
    for i, (path, g) in enumerate(zip(paths, grads)):
        key = (mesh.axes(_grad_axes(cfg, path)), g.dtype)
        buckets.setdefault(key, []).append(i)
    n_data = mesh.size(DATA_AXES)
    for (axes, _), idx in buckets.items():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        if axes:
            dist.all_reduce(flat, group=mesh.group(axes))
        flat = flat / n_data
        off = 0
        for i in idx:
            k = grads[i].numel()
            out[i] = flat[off:off + k].view_as(grads[i])
            off += k
    return out


def _grad_norm(cfg: GPTConfig, mesh, paths, grads):
    """The global norm of the logical gradient: each leaf's squares
    summed over the axes that cut it, a replicated leaf's counted
    once."""
    sums = {}
    for path, g in zip(paths, grads):
        axes = () if mesh is None else mesh.axes(_cut_axes(cfg, path))
        s = (g.float() ** 2).sum()
        sums[axes] = s if axes not in sums else sums[axes] + s
    sq = None
    for axes, s in sums.items():
        if axes:
            dist.all_reduce(s, group=mesh.group(axes))
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


# -------------------------------------------------------------- trainer


def collective_bytes_per_step(cfg: GPTConfig, batch: int):
    """Analytic logical payload bytes per train step of the collectives
    of the hybrid step, by JAX's labels and formulas ({label: bytes};
    `batch` the global batch). One rank with zero_stage 0 reports none."""
    d, L, S, V = cfg.d_model, cfg.n_layers, cfg.seq_len, cfg.vocab_size
    act_bytes = torch.empty((), dtype=cfg.compute_dtype).element_size()
    n_params = 12 * L * d * d + V * d + S * d
    out = {}
    if cfg.mp > 1:
        # forward: the embedding's sum, 2 a layer (attention out, FFN
        # out) and the vocab-parallel CE's; the backward mirrors them
        fwd = (2 * L + 1) * batch * S * d * act_bytes + 3 * batch * S * 4
        out["mp_psum_est"] = 2 * fwd
    if cfg.dp > 1:
        g_bytes = act_bytes if cfg.bf16_grads else 4
        out["dp_grad_allreduce_est"] = n_params * g_bytes
    if cfg.pp > 1:
        # a micro-batch's activation per stage hop, forward + backward
        Bm = max(batch // max(cfg.micro_batches, 1), 1)
        out["pp_ppermute_est"] = (2 * cfg.micro_batches * cfg.pp
                                  * Bm * S * d * act_bytes)
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
    """The train step over this rank's part of the (dp, pp, mp, ep)
    mesh.

    Usage (every rank, with the same arguments; a mesh of more than one
    rank needs `torch.distributed.init_process_group` first):
        trainer = HybridGPT(cfg)                  # device="cuda"
        params, opt = trainer.init(seed=0)        # this rank's shard
        tok, lab = trainer.shard_data(tokens, labels)   # its rows
        params, opt, loss = trainer.train_step(params, opt, tok, lab)

    Parameters and Adam state are updated in place and returned (the
    JAX trainer returned new arrays); `loss` is the mean over the data
    ranks, the same on every rank, a 0-d tensor on the device, not
    synchronised. MoE configs keep each step's routing statistics in
    `last_moe_stats`.
    """

    def __init__(self, cfg: GPTConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = make_mesh(cfg)
        # what the model functions take: None on one rank
        self._mesh = self.mesh if self.mesh.world > 1 else None
        self._use_buckets = cfg.grad_bucket_bytes > 0 and cfg.dp > 1
        # the all-reduces the last bucketed step issued (None unbucketed)
        self.last_grad_buckets = None
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
        those of its data index dp_i x ep + ep_i of dp x ep, which every
        pp and mp rank of that index shares."""
        n, r = self.mesh.size(DATA_AXES), self.mesh.index(DATA_AXES)
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

    def _grads(self, target, leaves, tokens, labels):
        """(the rank's loss, stats or None, gradients reduced to JAX's
        gradient of the mean loss, in `leaves` order)."""
        cfg, mesh = self.cfg, self._mesh
        paths = [p for p, _ in _leaves(target)]
        if cfg.pp > 1:
            loss, stats, grads = _pipeline(target, tokens, labels, cfg,
                                           mesh, leaves)
        else:
            buckets = None
            if self._use_buckets:
                buckets = _GradBuckets(leaves, cfg.grad_bucket_bytes,
                                       mesh.data_group)
            out = _loss_fn(target, tokens, labels, cfg, mesh,
                           dp_mean=False)
            loss, stats = out if cfg.moe_experts else (out, None)
            if buckets is not None:
                loss.backward(inputs=leaves)
                grads = buckets.finish(1.0 / mesh.size(DATA_AXES))
                self.last_grad_buckets = len(buckets.works)
                return loss.detach(), None, grads
            grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        if stats is not None:
            stats = {k: v.detach() for k, v in stats.items()}
        if mesh is not None:
            grads = _reduce_grads(cfg, mesh, paths, grads)
        return loss, stats, grads

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
        try:
            loss, stats, grads = self._grads(target, leaves, tokens, labels)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        if mesh is not None and mesh.data_group is not None:
            loss = _all_reduce(loss, mesh.data_group) / mesh.size(DATA_AXES)
        if cfg.grad_clip > 0:
            gnorm = _grad_norm(cfg, mesh, [p for p, _ in named], grads)
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
            self._record_collectives(tokens, params=params)
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
            self._record_collectives(tokens, steps=k, params=params)
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

    def _record_collectives(self, tokens, steps=1, params=None):
        # `tokens` is this rank's shard: the estimate takes the global
        # batch
        batch = int(len(tokens)) * self.mesh.size(DATA_AXES)
        for label, nbytes in self.collective_bytes_per_step(batch).items():
            _metrics.COLLECTIVE_CALLS.labels(label).inc(steps)
            _metrics.COLLECTIVE_BYTES.labels(label).inc(nbytes * steps)
        if self._use_buckets and params is not None:
            gd = self.cfg.compute_dtype if self.cfg.bf16_grads else None
            _metrics.GRAD_BUCKETS.labels("compiled").set(
                grad_bucket_count(params, self.cfg.grad_bucket_bytes, gd))

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
