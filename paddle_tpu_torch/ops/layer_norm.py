"""Fused residual-add + LayerNorm, forward and backward — the train
step's K2.

`add_ln(x, r, w, b, eps)` is the port of
`paddle_tpu/ops/pallas/layer_norm.py:add_ln`: it returns
`(LN(x + r) * w + b, x + r)`, the second output being the new residual
stream. It is a `torch.autograd.Function` whose forward runs one kernel
and whose backward runs one kernel and the sum of its partials:

* forward: z = x + r summed in fp32 and stored in x's dtype; out is
  normalised from the fp32 sum (not from the rounded z), in x's dtype;
  the fp32 row mean and rstd are kept for the backward;
* backward: dz = rstd * (g*w - mean(g*w) - zhat * mean(g*w*zhat)) + g_z,
  with zhat from the STORED z and the fp32 mean and rstd; x and r both
  receive dz; dw = sum over rows of g * zhat and db = sum of g, in
  fp32: the JAX package leaves these two sums to XLA, which fuses them
  into one pass; here the backward kernel sums them as it walks the
  rows (each block's partials, then a second launch adding the blocks'
  in a fixed order).

w and b are taken in fp32 whatever their dtype (their gradients flow
back through the cast). On a CUDA tensor each step launches
`csrc/layer_norm.cu`, the Hopper kernels that replace the TPU kernels
`_fwd_kernel` and `_bwd_kernel`, or raises: there is no fallback and
no size gate (any row count, any d up to 4096). On a CPU tensor each
step runs its plain PyTorch version (`add_ln_fwd_reference`,
`add_ln_bwd_reference`), the same arithmetic. `add_ln_reference` is the
whole function in plain PyTorch differentiated by autograd — the JAX
package's jnp fallback — which the tests hold both against.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches so far (each wrapper adds one per launch, nowhere
#: else; the backward's partial sum is part of its launch)
fwd_launch_count = 0
bwd_launch_count = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_D = 4096
_SIGNATURES = {
    "paddle_tpu_torch_add_ln_fwd": [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p],
    "paddle_tpu_torch_add_ln_bwd_blocks": [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 3,
    "paddle_tpu_torch_add_ln_bwd": [ctypes.c_void_p] * 10
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}


def add_ln(x, r, w, b, eps=1e-5):
    """(LN(x + r) * w + b, x + r) over the last axis; see the module
    docstring."""
    if r.shape != x.shape or r.dtype != x.dtype:
        raise ValueError(f"add_ln: x {x.dtype} {tuple(x.shape)} and r "
                         f"{r.dtype} {tuple(r.shape)} must match")
    return _AddLN.apply(x, r, w.float(), b.float(), float(eps))


def add_ln_reference(x, r, w, b, eps=1e-5):
    """The plain version of the whole function, differentiated by torch
    autograd: the JAX package's jnp fallback (out from the rounded z)."""
    z = x + r
    zf = z.float()
    mu = zf.mean(-1, keepdim=True)
    var = zf.var(-1, correction=0, keepdim=True)
    out = ((zf - mu) / torch.sqrt(var + eps) * w.float() + b.float())
    return out.to(x.dtype), z


def add_ln_fwd_reference(x2, r2, w, b, eps):
    """Plain version of the forward kernel over rows [N, d]: returns
    (out, z, mu [N], rstd [N])."""
    zf = x2.float() + r2.float()
    mu = zf.mean(-1)
    xc = zf - mu[:, None]
    rs = torch.rsqrt((xc * xc).mean(-1) + eps)
    out = xc * rs[:, None] * w + b
    return out.to(x2.dtype), zf.to(x2.dtype), mu, rs


def add_ln_bwd_reference(z2, w, mu, rs, g2, gz2):
    """Plain version of the backward kernels over rows [N, d]: returns
    (dz in g's dtype with the residual cotangent g_z added, dw, db),
    dw = sum over rows of g * zhat and db = sum of g, both fp32."""
    zhat = (z2.float() - mu[:, None]) * rs[:, None]
    gf = g2.float()
    gw = gf * w
    m1 = gw.mean(-1, keepdim=True)
    m2 = (gw * zhat).mean(-1, keepdim=True)
    dz = (rs[:, None] * (gw - m1 - zhat * m2) + gz2.float()).to(g2.dtype)
    return dz, (gf * zhat).sum(0), gf.sum(0)


class _AddLN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, r, w, b, eps):
        d = x.shape[-1]
        x2, r2 = x.reshape(-1, d), r.reshape(-1, d)
        if x.device.type == "cpu":
            out, z, mu, rs = add_ln_fwd_reference(x2, r2, w, b, eps)
        else:
            out, z, mu, rs = _launch_fwd(x2, r2, w, b, eps)
        ctx.save_for_backward(z, w, mu, rs)
        return out.view(x.shape), z.view(x.shape)

    @staticmethod
    def backward(ctx, g_out, g_z):
        z2, w, mu, rs = ctx.saved_tensors
        shape = g_out.shape
        g2 = g_out.reshape(z2.shape)
        gz2 = g_z.reshape(z2.shape)
        if z2.device.type == "cpu":
            dz, dw, db = add_ln_bwd_reference(z2, w, mu, rs, g2, gz2)
        else:
            dz, dw, db = _launch_bwd(z2, w, mu, rs, g2.contiguous(),
                                     gz2.contiguous())
        dz = dz.view(shape)
        return dz, dz, dw, db, None


# ---------------------------------------------------------- the kernels


def build():
    """Compile the kernels' shared library (see `_build.build`);
    returns its path."""
    return _build.build("layer_norm")


def _check(name, d, tensors, fp32):
    """Raise unless the row operands (`tensors`) share a supported
    dtype and the fp32 operands (`fp32`) are fp32, all contiguous on one
    CUDA device, with d no wider than the kernel takes."""
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_CODES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{name} kernel: unsupported dtypes "
                        f"{[t.dtype for t in tensors]}")
    if any(t.dtype != torch.float32 for t in fp32):
        raise TypeError(f"{name} kernel: w, b, mu and rstd must be float32")
    if d > MAX_D:
        raise ValueError(f"{name} kernel: d={d} is wider than {MAX_D}")
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel: no kernel for device {dev}")
    for t in (*tensors, *fp32):
        if t.device != dev:
            raise ValueError(f"{name} kernel: all operands must be on "
                             f"{dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: operands must be contiguous")


def _launch_fwd(x2, r2, w, b, eps):
    global fwd_launch_count
    rows, d = x2.shape
    x2, r2 = x2.contiguous(), r2.contiguous()
    w, b = w.contiguous(), b.contiguous()
    if w.shape != (d,) or b.shape != (d,):
        raise ValueError(f"add_ln_fwd kernel: w {tuple(w.shape)} and b "
                         f"{tuple(b.shape)} must be ({d},)")
    _check("add_ln_fwd", d, (x2, r2), (w, b))
    out, z = torch.empty_like(x2), torch.empty_like(x2)
    mu = torch.empty(rows, dtype=torch.float32, device=x2.device)
    rs = torch.empty_like(mu)
    if rows == 0:
        return out, z, mu, rs
    lib = _build.load("layer_norm", _SIGNATURES)
    err = lib.paddle_tpu_torch_add_ln_fwd(
        x2.data_ptr(), r2.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), z.data_ptr(), mu.data_ptr(), rs.data_ptr(), rows,
        d, _DTYPE_CODES[x2.dtype], eps,
        torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"add_ln_fwd kernel launch failed: CUDA error "
                           f"{err}")
    fwd_launch_count += 1
    return out, z, mu, rs


def _launch_bwd(z2, w, mu, rs, g2, gz2):
    """(dz, dw, db): the backward kernel, then the fixed-order sum of its
    blocks' dw and db partials (one launch counted)."""
    global bwd_launch_count
    rows, d = z2.shape
    _check("add_ln_bwd", d, (z2, g2, gz2), (w, mu, rs))
    dz = torch.empty_like(z2)
    if rows == 0:
        dw = torch.zeros(d, dtype=torch.float32, device=z2.device)
        return dz, dw, torch.zeros_like(dw)
    dw = torch.empty(d, dtype=torch.float32, device=z2.device)
    db = torch.empty_like(dw)
    lib = _build.load("layer_norm", _SIGNATURES)
    code = _DTYPE_CODES[z2.dtype]
    blocks = lib.paddle_tpu_torch_add_ln_bwd_blocks(
        z2.data_ptr(), g2.data_ptr(), gz2.data_ptr(), dz.data_ptr(), rows, d,
        code)
    if blocks <= 0:
        raise RuntimeError(f"add_ln_bwd kernel: no grid for [{rows}, {d}]: "
                           f"CUDA error {-blocks}")
    part = torch.empty(blocks, 2, d, dtype=torch.float32, device=z2.device)
    err = lib.paddle_tpu_torch_add_ln_bwd(
        z2.data_ptr(), w.data_ptr(), mu.data_ptr(), rs.data_ptr(),
        g2.data_ptr(), gz2.data_ptr(), dz.data_ptr(), part.data_ptr(),
        dw.data_ptr(), db.data_ptr(), blocks, rows, d, code,
        torch.cuda.current_stream(z2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"add_ln_bwd kernel launch failed: CUDA error "
                           f"{err}")
    bwd_launch_count += 1
    return dz, dw, db
