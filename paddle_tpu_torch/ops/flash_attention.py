"""Flash attention over [B, H, S, D], forward and backward — the train
step's K1a.

`splash_mha(q, k, v, causal=True, scale=None)` is the port of
`paddle_tpu/ops/pallas/flash_attention.py:splash_mha`: multi-head
self-attention, causal or full. As there, the query is scaled and
rounded to its own dtype first (`qs = (q * scale).to(q.dtype)`), and
the attention itself runs with scale 1, so autograd carries the scale
into dq exactly as JAX does. The attention is a
`torch.autograd.Function`:

* forward: out in q's dtype and the fp32 logsumexp [B, H, S], which is
  saved for the backward;
* backward: delta = rowsum(dout * out) in fp32, then dq, dk and dv.

On a CUDA tensor the forward and the backward each launch
`csrc/flash_attention.cu`, the Hopper kernels that replace the TPU's
splash kernel (`_splash_kernel`: forward and fused dq/dkv backward), or
raise: head_dim 64 or 128, fp32/bf16/fp16, any S; there is no
fallback. On a CPU tensor each runs its plain PyTorch version
(`flash_fwd_reference`, `flash_bwd_reference`), the same arithmetic
over whole S x S score matrices (p and ds rounded to the operands'
dtype before the products they feed, as the 16-bit kernels and splash
round them). `attention_reference` is the whole
function in plain PyTorch differentiated by autograd — the JAX
package's `_xla_reference` — which the tests hold both against.

Not ported yet (they raise): `kv_keep` segment ids and
`save_residuals_for_remat`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

#: kernel launches so far (each wrapper adds one per launch, nowhere else)
fwd_launch_count = 0
bwd_launch_count = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128)
_SIGNATURES = {
    "paddle_tpu_torch_flash_fwd": [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "paddle_tpu_torch_flash_bwd": [ctypes.c_void_p] * 10
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}


def splash_mha(q, k, v, *, causal=True, scale=None, kv_keep=None,
               save_residuals_for_remat=False):
    """Multi-head self-attention on [B, H, S, D] tensors (q, k and v
    share H and S); see the module docstring."""
    b, h, s, d = q.shape
    if k.shape[2] != s or v.shape[2] != s:
        raise ValueError(
            f"splash_mha requires equal q/kv sequence lengths, got "
            f"q S={s}, k S={k.shape[2]}, v S={v.shape[2]}")
    if k.shape[1] != h or v.shape[1] != h:
        raise ValueError(
            f"splash_mha requires equal q/kv head counts (no GQA/MQA), "
            f"got q H={h}, k H={k.shape[1]}, v H={v.shape[1]}")
    if kv_keep is not None:
        raise NotImplementedError(
            "splash_mha: kv_keep (segment ids) is not ported yet "
            "(ROADMAP, Queue 1)")
    if save_residuals_for_remat:
        raise NotImplementedError(
            "splash_mha: save_residuals_for_remat is not ported yet "
            "(ROADMAP, Queue 1)")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qs = (q * scale).to(q.dtype)
    return _FlashAttention.apply(qs, k, v, bool(causal))


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


def _scores(q, k, causal):
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float())
    if causal:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def flash_fwd_reference(q, k, v, causal):
    """Plain version of the forward kernel (scale 1): returns (out in
    q's dtype, fp32 logsumexp [B, H, S]). As the kernel (and splash)
    does, p is rounded to v's dtype before p @ v; a no-op in fp32."""
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def flash_bwd_reference(q, k, v, out, lse, dout, causal):
    """Plain version of the backward kernels (scale 1): returns
    (dq, dk, dv) in the operands' dtype. As the kernels (and splash)
    do, p and ds are rounded to the operands' dtype before the products
    they feed; a no-op in fp32."""
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    do = dout.float()
    delta = (do * out.float()).sum(-1)
    dv = torch.einsum("bhst,bhsd->bhtd", p.to(v.dtype).float(), do)
    dp = torch.einsum("bhsd,bhtd->bhst", do, v.float())
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dq = torch.einsum("bhst,bhtd->bhsd", ds, k.float())
    dk = torch.einsum("bhst,bhsd->bhtd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cpu":
            out, lse = flash_fwd_reference(q, k, v, causal)
        else:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            out, lse = _launch_fwd(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_bwd_reference(q, k, v, out, lse, dout,
                                             ctx.causal)
        else:
            dq, dk, dv = _launch_bwd(q, k, v, out, lse,
                                     dout.contiguous(), ctx.causal)
        return dq, dk, dv, None


# ---------------------------------------------------------- the kernels


def build():
    """Compile the kernels' shared library (see `_build.build`);
    returns its path."""
    return _build.build("flash_attention")


def _check(name, tensors):
    q = tensors[0]
    if q.dim() != 4:
        raise ValueError(f"{name} kernel: operands must be [B, H, S, D], "
                         f"got {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel: unsupported dtype {q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name} kernel: head_dim {q.shape[-1]} not in "
                         f"{_HEAD_DIMS}")
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
