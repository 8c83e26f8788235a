"""Flash attention — the train step's K1a over [B, H, S, D], forward
and backward, and the paddle-layout entry's K1b over [B, S, H, D].

`splash_mha(q, k, v, causal=True, scale=None, kv_keep=None)` is the
port of `paddle_tpu/ops/pallas/flash_attention.py:splash_mha`:
multi-head self-attention, causal or full. As there, the query is scaled and
rounded to its own dtype first (`qs = (q * scale).to(q.dtype)`), and
the attention itself runs with scale 1, so autograd carries the scale
into dq exactly as JAX does. The attention is a pair of registered
operators, `paddle_tpu_torch::flash_fwd` and `::flash_bwd`, joined by
`torch.library.register_autograd`:

* flash_fwd: out in q's dtype and the fp32 logsumexp [B, H, S], both
  kept for the backward;
* flash_bwd: delta = rowsum(dout * out) in fp32, then dq, dk and dv.

With `kv_keep` ([B, S] integers; a key-padding mask gives 0/1) the
forward is `paddle_tpu_torch::flash_fwd_seg` (K1c), JAX's segmented
splash kernel: `kv_keep.to(torch.int32)` are the segment ids of queries
and keys alike, and a query attends a key only of its own segment (and
not above the diagonal when causal). So a real token sees only real
tokens and a padded one only padding, as in the TPU kernel. Its
backward on a CUDA tensor raises NotImplementedError: the card's
segmented backward kernel is not written yet (ROADMAP Queue 2); on a
CPU tensor it is the plain segmented backward.

Being a dispatched operator, the forward can be named by a selective
checkpoint policy: `save_only_these_names(SPLASH_RESIDUAL_NAME)` keeps
(out, lse) of every forward that `splash_mha(...,
save_residuals_for_remat=True)` tagged, so a block recomputed in the
backward does not run attention's forward again — the counterpart of
JAX's `checkpoint_name` and `save_only_these_names`.

On a CUDA tensor each operator launches `csrc/flash_attention.cu`, the
Hopper kernels that replace the TPU's splash kernel (`_splash_kernel`:
forward and fused dq/dkv backward, and the segmented forward), or
raises: head_dim 64 or 128,
fp32/bf16/fp16, any S; there is no fallback. On a CPU tensor each runs
its plain PyTorch version (`flash_fwd_reference`, `flash_bwd_reference`,
given the segment ids for K1c), the same arithmetic over whole S x S
score matrices (p and ds rounded to
the operands' dtype before the products they feed, as the 16-bit
kernels and splash round them). `attention_reference` is the whole
function in plain PyTorch differentiated by autograd — the JAX
package's `_xla_reference` — which the tests hold both against.

`flash_attention(q, k, v, bias=None, causal=False, scale=None,
block_q=None, block_k=None)` is the port of the package's own
`flash_attention()` over the paddle layout [B, S, H, D], D a multiple
of 128. It refuses (NotImplementedError) what JAX refuses: a bias, S
not divisible by min(block, S), D % 128. The blocks default to
256/256, JAX's choice when its autotune cache misses (the autotune
cache is not ported); the Hopper kernel tiles by its own 64 rows and
reads the blocks only for that refusal. Its forward on a CUDA tensor
launches the kernel that replaces the TPU's `_fwd_kernel` (the same
device code as K1a's forward, reading [B, S, H, D] in place, D 128 or
256) or raises; on a CPU tensor the plain `flash_fwd_bshd_reference`.
Its backward is the vjp of `attention_reference` over the unscaled q in
fp32, in plain tensor code, as JAX's `_flash_core_bwd` recomputes it in
XLA.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.checkpoint import CheckpointPolicy

from . import _build

#: kernel launches so far (each wrapper adds one per launch, nowhere else)
fwd_launch_count = 0
bwd_launch_count = 0
bshd_launch_count = 0
seg_launch_count = 0

#: K1b's blocks when the caller gives none (JAX's `DEFAULT_BLOCK_Q/K`)
DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 256

#: the name `splash_mha(save_residuals_for_remat=True)` gives its
#: forward's (out, lse), for `save_only_these_names`
SPLASH_RESIDUAL_NAME = "splash_residuals"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128)
_BSHD_HEAD_DIMS = (128, 256)
_SIGNATURES = {
    "paddle_tpu_torch_flash_fwd": [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "paddle_tpu_torch_flash_bwd": [ctypes.c_void_p] * 10
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "paddle_tpu_torch_flash_fwd_bshd": [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
    "paddle_tpu_torch_flash_fwd_seg": [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
}


def splash_supported(seq_len, head_dim):
    """The JAX package's static gate for the splash route
    (`splash_supported`, at jax 0.9.0's head_dim quantum of 64): S a
    multiple of 128, at least 128, and head_dim a multiple of 64. A
    head_dim that passes it and that the kernel does not take raises on
    the card."""
    return seq_len % 128 == 0 and seq_len >= 128 and head_dim % 64 == 0


def splash_mha(q, k, v, *, causal=True, scale=None, kv_keep=None,
               save_residuals_for_remat=False):
    """Multi-head self-attention on [B, H, S, D] tensors (q, k and v
    share H and S), with `kv_keep` [B, S] as the segment ids of queries
    and keys; see the module docstring. With
    `save_residuals_for_remat` the forward's (out, lse) carry
    `SPLASH_RESIDUAL_NAME` for a selective checkpoint policy."""
    b, h, s, d = q.shape
    if k.shape[2] != s or v.shape[2] != s:
        raise ValueError(
            f"splash_mha requires equal q/kv sequence lengths, got "
            f"q S={s}, k S={k.shape[2]}, v S={v.shape[2]}")
    if k.shape[1] != h or v.shape[1] != h:
        raise ValueError(
            f"splash_mha requires equal q/kv head counts (no GQA/MQA), "
            f"got q H={h}, k H={k.shape[1]}, v H={v.shape[1]}")
    if kv_keep is not None and tuple(kv_keep.shape) != (b, s):
        raise ValueError(f"splash_mha: kv_keep must be [B, S] = {(b, s)}, "
                         f"got {tuple(kv_keep.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qs = (q * scale).to(q.dtype)
    name = SPLASH_RESIDUAL_NAME if save_residuals_for_remat else ""
    q, k, v = qs.contiguous(), k.contiguous(), v.contiguous()
    if kv_keep is None:
        out, _ = flash_fwd(q, k, v, bool(causal), name)
    else:
        seg = kv_keep.to(device=q.device, dtype=torch.int32).contiguous()
        out, _ = flash_fwd_seg(q, k, v, seg, bool(causal), name)
    return out


def save_only_these_names(*names):
    """A selective-checkpoint policy (for
    `torch.utils.checkpoint.create_selective_checkpoint_contexts`) that
    keeps the outputs of every flash forward named one of `names` and
    recomputes everything else — JAX's
    `jax.checkpoint_policies.save_only_these_names` over the names
    `splash_mha` gives."""
    names = frozenset(names)
    ops = torch.ops.paddle_tpu_torch
    name_arg = {ops.flash_fwd.default: 4, ops.flash_fwd_seg.default: 5}

    def policy(ctx, op, *args, **kwargs):
        if op in name_arg and args[name_arg[op]] in names:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def attention_reference(q, k, v, scale, causal):
    """The plain version of the whole function, differentiated by torch
    autograd: the JAX package's `_xla_reference` over [B, H, S, D]
    (fp32 logits, -1e30 above the diagonal, output in q's dtype)."""
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    if causal:
        s, t = logits.shape[-2:]
        mask = torch.ones(s, t, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, v.float()).to(q.dtype)


def _scores(q, k, causal, seg=None):
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float())
    if causal:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    if seg is not None:
        other = seg[:, None, :, None] != seg[:, None, None, :]
        s = s.masked_fill(other, float("-inf"))
    return s


def flash_fwd_reference(q, k, v, causal, seg=None):
    """Plain version of the forward kernel (scale 1): returns (out in
    q's dtype, fp32 logsumexp [B, H, S]); with `seg` [B, S], K1c's: a
    query sees only keys of its own segment. As the kernel (and splash)
    does, p is rounded to v's dtype before p @ v; a no-op in fp32."""
    s = _scores(q, k, causal, seg)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def flash_bwd_reference(q, k, v, out, lse, dout, causal, seg=None):
    """Plain version of the backward kernels (scale 1): returns
    (dq, dk, dv) in the operands' dtype; with `seg` [B, S], the
    segmented forward's. As the kernels (and splash) do, p and ds are
    rounded to the operands' dtype before the products they feed; a
    no-op in fp32."""
    p = torch.exp(_scores(q, k, causal, seg) - lse[..., None])
    do = dout.float()
    delta = (do * out.float()).sum(-1)
    dv = torch.einsum("bhst,bhsd->bhtd", p.to(v.dtype).float(), do)
    dp = torch.einsum("bhsd,bhtd->bhst", do, v.float())
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dq = torch.einsum("bhst,bhtd->bhsd", ds, k.float())
    dk = torch.einsum("bhst,bhsd->bhtd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# The forward and backward as registered operators (scale 1; `name` only
# tags the forward for `save_only_these_names`). A CPU tensor runs the
# plain versions, looked up by module name at each call; a CUDA tensor
# launches the kernels.


@torch.library.custom_op(
    "paddle_tpu_torch::flash_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, str name) "
           "-> (Tensor, Tensor)")
def flash_fwd(q, k, v, causal, name):
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal)
    return _launch_fwd(q, k, v, causal)


@flash_fwd.register_fake
def _(q, k, v, causal, name):
    return torch.empty_like(q), q.new_empty(q.shape[:-1],
                                            dtype=torch.float32)


@torch.library.custom_op(
    "paddle_tpu_torch::flash_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, "
           "Tensor dout, bool causal) -> (Tensor, Tensor, Tensor)")
def flash_bwd(q, k, v, out, lse, dout, causal):
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, out, lse, dout, causal)
    return _launch_bwd(q, k, v, out, lse, dout.contiguous(), causal)


@flash_bwd.register_fake
def _(q, k, v, out, lse, dout, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_setup_context(ctx, inputs, output):
    q, k, v, causal, _name = inputs
    out, lse = output
    ctx.causal = causal
    ctx.save_for_backward(q, k, v, out, lse)


def _flash_backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_bwd(q, k, v, out, lse, dout, ctx.causal)
    return dq, dk, dv, None, None


flash_fwd.register_autograd(_flash_backward,
                            setup_context=_flash_setup_context)


@torch.library.custom_op(
    "paddle_tpu_torch::flash_fwd_seg", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor seg, bool causal, "
           "str name) -> (Tensor, Tensor)")
def flash_fwd_seg(q, k, v, seg, causal, name):
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal, seg)
    return _launch_fwd_seg(q, k, v, seg, causal)


@flash_fwd_seg.register_fake
def _(q, k, v, seg, causal, name):
    return torch.empty_like(q), q.new_empty(q.shape[:-1],
                                            dtype=torch.float32)


def _flash_seg_setup_context(ctx, inputs, output):
    q, k, v, seg, causal, _name = inputs
    out, lse = output
    ctx.causal = causal
    ctx.save_for_backward(q, k, v, out, lse, seg)


def _flash_seg_backward(ctx, dout, _dlse):
    q, k, v, out, lse, seg = ctx.saved_tensors
    if q.device.type != "cpu":
        raise NotImplementedError("K1c backward: ROADMAP Queue 2")
    dq, dk, dv = flash_bwd_reference(q, k, v, out, lse, dout, ctx.causal,
                                     seg)
    return dq, dk, dv, None, None, None


flash_fwd_seg.register_autograd(_flash_seg_backward,
                                setup_context=_flash_seg_setup_context)


# ------------------------------------------- flash_attention() (K1b)


def flash_attention(q, k, v, bias=None, causal=False, scale=None,
                    block_q=None, block_k=None):
    """q/k/v: [B, S, H, D] (the paddle layout) -> [B, S, H, D]; see the
    module docstring."""
    if bias is not None:
        raise NotImplementedError("flash_attention kernel: bias "
                                  "unsupported (as in the JAX package)")
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention needs q, k and v of one shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    block_q = min(block_q or DEFAULT_BLOCK_Q, s)
    block_k = min(block_k or DEFAULT_BLOCK_K, s)
    if s % block_q != 0 or s % block_k != 0 or d % 128 != 0:
        raise NotImplementedError(
            f"flash_attention kernel needs seq divisible by block "
            f"({block_q}/{block_k}) and head_dim%128==0 (got S={s}, D={d})")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return _FlashBSHD.apply(q, k, v, float(scale), bool(causal))


def attention_bshd_reference(q, k, v, scale, causal):
    """`attention_reference` over the paddle layout [B, S, H, D]: the
    JAX package's `_xla_reference` on the unscaled q (fp32 logits times
    scale, -1e30 above the diagonal, output in q's dtype)."""
    return attention_reference(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), scale,
                               causal).transpose(1, 2)


def flash_fwd_bshd_reference(q, k, v, scale, causal):
    """Plain version of K1b's forward over [B, S, H, D], the TPU
    kernel's arithmetic over whole score matrices: q scaled and rounded
    to its dtype, fp32 scores, -1e30 above the diagonal, p = exp(s - m)
    rounded to v's dtype before p @ v, out = acc / max(l, 1e-30) in q's
    dtype."""
    qs = (q * scale).to(q.dtype)
    s = torch.einsum("bshd,bthd->bhst", qs.float(), k.float())
    if causal:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    acc = torch.einsum("bhst,bthd->bshd", p.to(v.dtype).float(), v.float())
    l = p.sum(-1).clamp_min(1e-30).transpose(1, 2)[..., None]
    return (acc / l).to(q.dtype)


class _FlashBSHD(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        if q.device.type == "cpu":
            out = flash_fwd_bshd_reference(q, k, v, scale, causal)
        else:
            out = _launch_fwd_bshd(q, k, v, scale, causal)
        ctx.scale, ctx.causal = scale, causal
        ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = attention_bshd_reference(q, k, v, ctx.scale, ctx.causal)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None


# ---------------------------------------------------------- the kernels


def build():
    """Compile the kernels' shared library (see `_build.build`);
    returns its path."""
    return _build.build("flash_attention")


def _check(name, tensors, head_dims=_HEAD_DIMS, layout="[B, H, S, D]"):
    q = tensors[0]
    if q.dim() != 4:
        raise ValueError(f"{name} kernel: operands must be {layout}, "
                         f"got {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel: unsupported dtype {q.dtype}")
    if q.shape[-1] not in head_dims:
        raise ValueError(f"{name} kernel: head_dim {q.shape[-1]} not in "
                         f"{head_dims}")
    if q.device.type != "cuda":
        raise ValueError(f"{name} kernel: no kernel for device {q.device}")
    for t in tensors:
        if t.dtype != q.dtype:
            raise TypeError(f"{name} kernel: operands must share q's dtype "
                            f"{q.dtype}, got {t.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{name} kernel: operands must share q's shape "
                             f"{tuple(q.shape)}, got {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: operands must be contiguous "
                             f"and 16-byte aligned on {q.device}")


def _launch_fwd(q, k, v, causal):
    global fwd_launch_count
    _check("flash_fwd", (q, k, v))
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _build.load("flash_attention", _SIGNATURES)
    err = lib.paddle_tpu_torch_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B * H, S, D, _DTYPE_CODES[q.dtype], int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    fwd_launch_count += 1
    return out, lse


def _launch_fwd_seg(q, k, v, seg, causal):
    global seg_launch_count
    _check("flash_fwd_seg", (q, k, v))
    B, H, S, D = q.shape
    if seg.dtype != torch.int32 or tuple(seg.shape) != (B, S) \
            or seg.device != q.device or not seg.is_contiguous():
        raise ValueError("flash_fwd_seg kernel: segment ids must be "
                         f"contiguous int32 {(B, S)} on {q.device}")
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _build.load("flash_attention", _SIGNATURES)
    err = lib.paddle_tpu_torch_flash_fwd_seg(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, H, S, D, _DTYPE_CODES[q.dtype],
        int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd_seg kernel launch failed: CUDA error "
                           f"{err}")
    seg_launch_count += 1
    return out, lse


def _launch_bwd(q, k, v, out, lse, dout, causal):
    global bwd_launch_count
    _check("flash_bwd", (q, k, v, out, dout))
    B, H, S, D = q.shape
    if lse.dtype != torch.float32 or lse.shape != (B, H, S) \
            or not lse.is_contiguous():
        raise ValueError("flash_bwd kernel: lse must be contiguous fp32 "
                         f"{(B, H, S)}")
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty_like(lse)
    lib = _build.load("flash_attention", _SIGNATURES)
    err = lib.paddle_tpu_torch_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B * H, S, D, _DTYPE_CODES[q.dtype],
        int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd kernel launch failed: CUDA error "
                           f"{err}")
    bwd_launch_count += 1
    return dq, dk, dv


def _launch_fwd_bshd(q, k, v, scale, causal):
    global bshd_launch_count
    _check("flash_fwd_bshd", (q, k, v), _BSHD_HEAD_DIMS, "[B, S, H, D]")
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("flash_attention", _SIGNATURES)
    err = lib.paddle_tpu_torch_flash_fwd_bshd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, D,
        _DTYPE_CODES[q.dtype], int(causal), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd_bshd kernel launch failed: CUDA error "
                           f"{err}")
    bshd_launch_count += 1
    return out
