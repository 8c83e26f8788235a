"""The fused QKV projection — the train step's K5 under
`GPTConfig.qkv_kernel`.

`qkv_proj(x, w_qkv, b_qkv, n_heads)` is the port of
`paddle_tpu/ops/pallas/qkv_proj.py:qkv_proj`: x [B, S, d] times w_qkv
[d, 3 H hd] plus b_qkv [3 H hd], returned as (q, k, v), each
[B, H, S, hd] with hd = w_qkv's width / 3 / H. For each third i and
head h the result is `fp32(x @ w_i[:, h]) + fp32(b_i[h])` rounded once
to x's dtype, as the TPU kernel adds the bias to its fp32 accumulator
before its single cast (the einsum branch of the train step rounds the
product and then the sum, so in bf16 the two differ by a rounding).

It is a `torch.autograd.Function`:

* forward: on a CUDA tensor it launches `csrc/qkv_proj.cu` (the Hopper
  kernels that replace the TPU's `_kernel`: bf16 and fp16 on
  `qkv_proj_wgmma_kernel`, its grid from `plan`, fp32 on the
  CUDA-core `qkv_proj_kernel`) or raises — head_dim 64, an even head
  count, d a multiple of 16 bytes; there is no fallback. On a CPU
  tensor it runs the plain version `qkv_proj_reference`.
* backward: JAX's `_bwd` in plain tensor code (it is XLA einsums there,
  outside any kernel): dx and dw each one matrix product over the three
  thirds side by side, with fp32 sums and an fp32 result rounded once
  (dx to x's dtype, dw to w's), db an fp32 sum cast to b's dtype.

`qkv_proj_supported` is JAX's shape gate without its TPU-backend test,
so one config takes the same branch in both packages; the device then
chooses kernel or plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches so far (the wrapper adds one per launch, nowhere else)
launch_count = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIM = 64
_SIGNATURES = {
    "paddle_tpu_torch_qkv_proj": [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "paddle_tpu_torch_qkv_proj_wgmma": [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
}

#: the wgmma kernel's block tile (rows of B * S, columns of w_qkv)
TILE_M, TILE_N = 128, 256
#: SMs of the H100 the kernel was tuned on (`plan`'s default)
H100_SMS = 132


def plan(B, S, n_heads, sms=H100_SMS):
    """How the wgmma kernel cuts x [B, S, d] @ w_qkv [d, 3 H 64]: tiles
    of TILE_M rows of B * S by TILE_N columns (a tile may straddle the
    q / k / v thirds), walked along the columns first, so the blocks in
    flight share x's row tiles, by a persistent grid of one block on
    each of `sms` SMs (fewer where there are fewer tiles): measured
    faster than a block a tile (tools/torch_qkv_ab.py --sweep)."""
    rows = -(-B * S // TILE_M)
    cols = -(-3 * n_heads * _HEAD_DIM // TILE_N)
    tiles = rows * cols
    return {"row_tiles": rows, "col_tiles": cols, "tiles": tiles,
            "grid": min(tiles, sms)}


def qkv_proj_supported(n_heads, seq_len, local_width, x_width=None) -> bool:
    """JAX's gate: paired heads, head_dim 64, S % 8 == 0, and a bf16
    x-row block of S * x_width * 2 bytes <= 4 MiB (the TPU kernel's
    scoped-memory bound, kept so both packages take the same branch)."""
    hd = local_width // max(n_heads, 1)
    xw = x_width if x_width is not None else local_width
    return (n_heads % 2 == 0 and n_heads >= 2
            and n_heads * hd == local_width and hd == _HEAD_DIM
            and seq_len % 8 == 0
            and seq_len * xw * 2 <= 4 * 2 ** 20)


def qkv_proj_reference(x, w_qkv, b_qkv, n_heads):
    """Plain version of the forward: per third, fp32 product plus fp32
    bias, rounded once to x's dtype, as [B, H, S, hd]."""
    B, S, d = x.shape
    th = w_qkv.shape[1] // 3
    hd = th // n_heads
    outs = []
    for i in range(3):
        w = w_qkv[:, i * th:(i + 1) * th].float().reshape(d, n_heads, hd)
        b = b_qkv[i * th:(i + 1) * th].float().reshape(n_heads, 1, hd)
        outs.append((torch.einsum("bsd,dhe->bhse", x.float(), w) + b)
                    .to(x.dtype))
    return tuple(outs)


def qkv_proj(x, w_qkv, b_qkv, n_heads):
    """x [B, S, d], w_qkv [d, 3d], b_qkv [3d] -> (q, k, v), each
    [B, n_heads, S, d / n_heads]; see the module docstring. The caller
    gates on `qkv_proj_supported`."""
    return _QKVProj.apply(x, w_qkv, b_qkv, int(n_heads))


class _QKVProj(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, n_heads):
        if x.device.type == "cpu":
            q, k, v = qkv_proj_reference(x, w_qkv, b_qkv, n_heads)
        else:
            q, k, v = _launch(x, w_qkv, b_qkv, n_heads)
        ctx.save_for_backward(x, w_qkv, b_qkv)
        return q, k, v

    @staticmethod
    def backward(ctx, gq, gk, gv):
        x, w_qkv, b_qkv = ctx.saved_tensors
        B, S, d = x.shape
        # the three thirds' grads side by side as [B*S, 3 H hd]: one
        # product each for dx and dw, in the operands' dtype with fp32
        # sums inside and one rounding at the end, as JAX's einsums
        # (preferred_element_type fp32, then one cast) round them
        g = torch.cat([t.to(x.dtype) for t in (gq, gk, gv)], dim=1)
        g = g.permute(0, 2, 1, 3).reshape(B * S, w_qkv.shape[1])
        dx = _mm_f32(g, w_qkv.t().to(x.dtype)).reshape(B, S, d)
        dw = _mm_f32(x.reshape(B * S, d).t(), g)
        db = g.float().sum(0)
        return (dx.to(x.dtype), dw.to(w_qkv.dtype), db.to(b_qkv.dtype),
                None)


def _mm_f32(a, b):
    """a @ b with fp32 sums and an fp32 result, as XLA's
    preferred_element_type=float32 gives it: on the card one 16-bit
    product with an fp32 output (a 16-bit output would let cuBLAS add
    split-K partials in 16 bits), elsewhere a product of fp32 copies."""
    if a.device.type == "cuda" and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


# ---------------------------------------------------------- the kernel


def build():
    """Compile the kernel's shared library (see `_build.build`); returns
    its path."""
    return _build.build("qkv_proj")


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(x, w_qkv, b_qkv, n_heads):
    global launch_count
    if x.device.type != "cuda":
        raise ValueError(f"qkv_proj kernel: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"qkv_proj kernel: unsupported dtype {x.dtype}")
    if x.dim() != 3 or w_qkv.dim() != 2 or b_qkv.dim() != 1:
        raise ValueError("qkv_proj kernel: x must be [B, S, d], w_qkv "
                         "[d, 3 H hd], b_qkv [3 H hd]")
    B, S, d = x.shape
    th = w_qkv.shape[1] // 3
    hd = th // max(n_heads, 1)
    if (w_qkv.shape != (d, 3 * th) or b_qkv.shape != (3 * th,)
            or n_heads * hd != th or hd != _HEAD_DIM or n_heads % 2):
        raise ValueError(
            f"qkv_proj kernel: needs w_qkv [d, 3 H {_HEAD_DIM}] and b_qkv "
            f"[3 H {_HEAD_DIM}] with an even H; got x {tuple(x.shape)}, "
            f"w_qkv {tuple(w_qkv.shape)}, b_qkv {tuple(b_qkv.shape)}, "
            f"H={n_heads}")
    if d % (16 // x.element_size()):
        raise ValueError(f"qkv_proj kernel: d={d} must be a multiple of "
                         "16 bytes of the dtype")
    for t in (w_qkv, b_qkv):
        if t.dtype != x.dtype:
            raise TypeError(f"qkv_proj kernel: operands must share x's "
                            f"dtype {x.dtype}, got {t.dtype}")
    for t in (x, w_qkv, b_qkv):
        if t.device != x.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("qkv_proj kernel: operands must be contiguous "
                             f"and 16-byte aligned on {x.device}")
    q, k, v = (torch.empty(B, n_heads, S, hd, dtype=x.dtype, device=x.device)
               for _ in range(3))
    if x.numel() == 0:
        return q, k, v
    lib = _build.load("qkv_proj", _SIGNATURES)
    ptrs = (x.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(), q.data_ptr(),
            k.data_ptr(), v.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.float32:
        err = lib.paddle_tpu_torch_qkv_proj(*ptrs, B, S, d, n_heads, stream)
    else:
        grid = plan(B, S, n_heads, _sms(x.device))["grid"]
        err = lib.paddle_tpu_torch_qkv_proj_wgmma(
            *ptrs, B, S, d, n_heads, _DTYPE_CODES[x.dtype], grid, stream)
    if err != 0:
        raise RuntimeError(f"qkv_proj kernel launch failed: CUDA error {err}")
    launch_count += 1
    return q, k, v
