"""The single-device dense GPT train step of
`paddle_tpu/parallel/hybrid_gpt.py`, in PyTorch.

Ported function by function, under the JAX names: `GPTConfig`,
`init_params`, `_layer_norm`, `_attention`, `_dense_ffn`, `_block`,
`_stage_forward`, `_ce_sum_fused`, `_ce_sum`, `_vocab_parallel_ce`,
`_loss_fn`, `init_opt_state`, `_adam_update`, `_apply_updates` and the
step body of `HybridGPT`. Parameters are the same nested dict of
tensors (`tok_emb`, `pos_emb`, `ln_f_w`, `ln_f_b`, `head`, and `blocks`
stacked on a leading [L] axis), so `convert.load_jax_hybrid_gpt`
carries a JAX trainer's state across.

Attention runs through `ops.flash_attention.splash_mha` and the
residual-add + LayerNorm between attention and FFN through
`ops.layer_norm.add_ln`; with `qkv_kernel` (and a shape
`ops.qkv_proj.qkv_proj_supported` takes) the Q/K/V projection runs
through `ops.qkv_proj.qkv_proj`: on the card, hand-written kernels. The
rest is plain tensor code, as it was XLA's in JAX.

`remat_policy` is None (full per-block recompute) or
"save_splash_residuals" (bench_gpt's: every block still recomputes in
the backward, but the flash forward's (out, lse) are kept from the
forward, so attention's forward runs once a step instead of twice).

Only the single-device dense step is ported: dp = pp = mp = ep = 1,
one micro-batch, no MoE, no sequence parallelism, no ZeRO, no bucketed
reduction and no other named remat policy. Other values raise
`NotImplementedError` (ROADMAP, Queue 1).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from .._device import resolve_device
from ..ops.flash_attention import (SPLASH_RESIDUAL_NAME,
                                   save_only_these_names, splash_mha)
from ..ops.layer_norm import add_ln
from ..ops.qkv_proj import qkv_proj, qkv_proj_supported

#: the named remat policies the port has (JAX also takes any name of
#: `jax.checkpoint_policies`)
REMAT_POLICIES = (None, "save_splash_residuals")

def param_shapes(V, S, d, ff, L):
    """The dense parameters' shapes by name (nested as the parameters
    are), from vocab, seq_len, d_model, d_ff and n_layers."""
    return {"tok_emb": (V, d), "pos_emb": (S, d), "ln_f_w": (d,),
            "ln_f_b": (d,), "head": (d, V),
            "blocks": {"ln1_w": (L, d), "ln1_b": (L, d),
                       "w_qkv": (L, d, 3 * d), "b_qkv": (L, 3 * d),
                       "w_o": (L, d, d), "b_o": (L, d),
                       "ln2_w": (L, d), "ln2_b": (L, d),
                       "w_fc1": (L, d, ff), "b_fc1": (L, ff),
                       "w_fc2": (L, ff, d), "b_fc2": (L, d)}}


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    seq_len: int = 1024
    d_model: int = 2048
    n_heads: int = 16
    n_layers: int = 24
    d_ff: int = 0            # default 4*d_model
    # parallelism: the single-device step only
    dp: int = 1
    pp: int = 1
    mp: int = 1
    ep: int = 1
    micro_batches: int = 1
    sequence_parallel: bool = False
    moe_experts: int = 0
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
    zero_stage: int = 0

    def __post_init__(self):
        if self.d_ff == 0:
            self.d_ff = 4 * self.d_model
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_heads {self.n_heads}")
        single = dict(dp=1, pp=1, mp=1, ep=1, micro_batches=1,
                      sequence_parallel=False, moe_experts=0, zero_stage=0,
                      grad_bucket_bytes=0)
        for name, want in single.items():
            if getattr(self, name) != want:
                raise NotImplementedError(
                    f"GPTConfig.{name}={getattr(self, name)!r}: only the "
                    f"single-device dense step ({name}={want!r}) is ported "
                    "(ROADMAP, Queue 1: what the train-step slice left)")
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
                              cfg.d_ff, cfg.n_layers))


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


def _block(x, lp, cfg: GPTConfig):
    """One transformer block: [B, S, d] -> [B, S, d]."""
    h = _layer_norm(x, lp["ln1_w"], lp["ln1_b"])
    attn, b_o = _attention(h, lp["w_qkv"], lp["b_qkv"], lp["w_o"],
                           lp["b_o"], cfg)
    attn = attn + b_o.to(attn.dtype)
    if cfg.fused_add_ln:
        h2, x = add_ln(x, attn.to(x.dtype), lp["ln2_w"], lp["ln2_b"])
    else:
        x = x + attn.to(x.dtype)
        h2 = _layer_norm(x, lp["ln2_w"], lp["ln2_b"])
    ff, b2 = _dense_ffn(h2, lp["w_fc1"], lp["b_fc1"], lp["w_fc2"],
                        lp["b_fc2"], cfg)
    return x + (ff + b2.to(ff.dtype)).to(x.dtype)


def _stage_forward(x, blocks, cfg: GPTConfig):
    """All layers, a Python loop over the stacked layer axis. With remat
    every block is recomputed in the backward; under
    "save_splash_residuals" a selective checkpoint keeps what
    `splash_mha` named (the flash forward's out and lse) and recomputes
    the rest."""
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
        return _block(x, dict(zip(names, leaves)), cfg)

    for leaves in per_layer:
        if cfg.remat:
            x = checkpoint(block_fn, x, *leaves, use_reentrant=False, **kw)
        else:
            x = block_fn(x, *leaves)
    return x


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


def _loss_fn(params, tokens, labels, cfg: GPTConfig):
    """Forward loss of one micro-batch on one device: embed, all
    blocks, final LN, vocab head and mean CE."""
    S = tokens.shape[1]
    cd = cfg.compute_dtype
    pos = params["pos_emb"][:S].to(cd)
    # F.embedding, not indexing: its backward sums each id's rows in a
    # fixed order on the CPU and the card, where indexing's backward (an
    # accumulating index_put_) sums in another order from run to run on
    # the CPU
    x = F.embedding(tokens, params["tok_emb"]).to(cd) + pos[None]
    y = _stage_forward(x, params["blocks"], cfg)
    yl = _layer_norm(y, params["ln_f_w"], params["ln_f_b"])
    return _vocab_parallel_ce(yl, params["head"], labels, cfg)


# ------------------------------------------------------------ optimizer


def _leaves(tree):
    """(path, tensor) of a nested dict in a fixed order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            for p, t in _leaves(tree[k]):
                yield (k,) + p, t
        else:
            yield (k,), tree[k]


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def init_opt_state(cfg: GPTConfig, params):
    """fp32 Adam moments, one {"m", "v"} per parameter (zero_stage 0)."""
    return _tree_map(lambda p: {"m": torch.zeros_like(p, dtype=torch.float32),
                                "v": torch.zeros_like(p, dtype=torch.float32)},
                     params)


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


def _apply_updates(cfg: GPTConfig, params, grads, opt_state, lr, t):
    """Adam over every parameter, in place; no weight decay on vectors.
    `grads` lists the gradients in `_leaves(params)` order."""
    for (path, p), g in zip(_leaves(params), grads):
        s = opt_state
        for k in path:
            s = s[k]
        wd = 0.0 if p.dim() <= 1 else cfg.weight_decay
        _adam_update(cfg, p, g.float(), s["m"], s["v"], lr, t, wd)


# -------------------------------------------------------------- trainer


class HybridGPT:
    """The single-device train step.

    Usage:
        trainer = HybridGPT(cfg)                  # device="cuda"
        params, opt = trainer.init(seed=0)
        params, opt, loss = trainer.train_step(params, opt, tokens, labels)

    Parameters and Adam state are updated in place and returned (the
    JAX trainer returned new arrays); `loss` is a 0-d tensor on the
    device, not synchronised.
    """

    def __init__(self, cfg: GPTConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, seed=0):
        g = torch.Generator().manual_seed(int(seed))
        params = init_params(self.cfg, g, self.device)
        return params, init_opt_state(self.cfg, params)

    def _data(self, a):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                               else a).to(self.device, torch.long)

    def loss(self, params, tokens, labels):
        with torch.no_grad():
            return _loss_fn(params, self._data(tokens), self._data(labels),
                            self.cfg)

    def train_step(self, params, opt_state, tokens, labels, lr=None,
                   step_num=1):
        cfg = self.cfg
        lr = cfg.learning_rate if lr is None else float(lr)
        tokens, labels = self._data(tokens), self._data(labels)
        if cfg.bf16_grads:
            # differentiate wrt compute_dtype copies of the fp32 params
            target = _tree_map(
                lambda p: (p.detach().to(cfg.compute_dtype)
                           if p.dtype == torch.float32
                           else p.detach()).requires_grad_(), params)
        else:
            target = params
        leaves = [t.requires_grad_() for _, t in _leaves(target)]
        loss = _loss_fn(target, tokens, labels, cfg)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        if cfg.grad_clip > 0:
            sq = sum((g.float() ** 2).sum() for g in grads)
            gnorm = torch.sqrt(sq)
            scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-6), max=1.0)
            grads = [(g.float() * scale).to(g.dtype) for g in grads]
        with torch.no_grad():
            _apply_updates(cfg, params, grads, opt_state, lr,
                           float(step_num))
        return params, opt_state, loss.detach()
