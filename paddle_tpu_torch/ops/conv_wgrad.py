"""The split-K weight gradient of a 1x1 convolution — K6.

`wgrad_1x1(x, dy, chunk=4096)` is the port of
`paddle_tpu/ops/pallas/conv_wgrad.py:wgrad_1x1`: dW[Ci, Co] (fp32) =
x[N, Ci]^T @ dy[N, Co], summed over N in `chunk`-row pieces. As in the
JAX package it is an entry of its own, wired into no convolution
backward there or here (the JAX docstring records it as a measured
negative result that is kept).

On a CUDA tensor it launches `csrc/conv_wgrad.cu` (the Hopper kernel
that replaces the TPU kernel: one block per (64 x 64 output tile,
N-chunk) writes an fp32 partial, a second pass sums the partials in
chunk order, no atomics) or raises — x and dy of one dtype among fp32,
bf16 and fp16, Ci and Co multiples of 16 bytes of it, at most 65535
chunks; there is no fallback. On a CPU tensor it runs the plain
version `wgrad_1x1_reference`, which adds the chunks' fp32 products in
the TPU grid's order.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches so far (the wrapper adds one per launch, nowhere else)
launch_count = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SIGNATURES = {"paddle_tpu_torch_wgrad_1x1": [ctypes.c_void_p] * 4
               + [ctypes.c_longlong] + [ctypes.c_int] * 4
               + [ctypes.c_void_p]}


def wgrad_1x1(x, dy, *, chunk=4096):
    """dW[Ci, Co] (fp32) = x[N, Ci]^T @ dy[N, Co], N a multiple of
    `chunk`; see the module docstring."""
    N, Ci = x.shape
    _, Co = dy.shape
    if N % chunk != 0:
        raise ValueError(f"N={N} not divisible by chunk={chunk}")
    if x.device.type == "cpu":
        return wgrad_1x1_reference(x, dy, chunk=chunk)
    return _launch(x, dy, chunk)


def wgrad_1x1_reference(x, dy, *, chunk=4096):
    """Plain version: an fp32 accumulator that each `chunk`-row piece's
    fp32 product x_c^T dy_c is added into, in order, as the TPU grid
    revisits its output block."""
    N, Ci = x.shape
    out = torch.zeros(Ci, dy.shape[1], dtype=torch.float32, device=x.device)
    for n0 in range(0, N, chunk):
        out += x[n0:n0 + chunk].float().t() @ dy[n0:n0 + chunk].float()
    return out


# ---------------------------------------------------------- the kernel


def build():
    """Compile the kernel's shared library (see `_build.build`); returns
    its path."""
    return _build.build("conv_wgrad")


def _launch(x, dy, chunk):
    global launch_count
    if x.device.type != "cuda":
        raise ValueError(f"wgrad_1x1 kernel: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"wgrad_1x1 kernel: unsupported dtype {x.dtype}")
    if dy.dtype != x.dtype:
        raise TypeError(f"wgrad_1x1 kernel: dy must share x's dtype "
                        f"{x.dtype}, got {dy.dtype}")
    if x.dim() != 2 or dy.dim() != 2 or dy.shape[0] != x.shape[0]:
        raise ValueError(f"wgrad_1x1 kernel: needs x [N, Ci] and dy [N, Co]"
                         f", got {tuple(x.shape)} and {tuple(dy.shape)}")
    N, Ci = x.shape
    Co = dy.shape[1]
    vec = 16 // x.element_size()
    if Ci % vec or Co % vec:
        raise ValueError(f"wgrad_1x1 kernel: Ci={Ci} and Co={Co} must be "
                         "multiples of 16 bytes of the dtype")
    if N // chunk > 65535:
        raise ValueError(f"wgrad_1x1 kernel: {N // chunk} chunks, at most "
                         "65535")
    for t in (x, dy):
        if t.device != x.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("wgrad_1x1 kernel: operands must be contiguous "
                             f"and 16-byte aligned on {x.device}")
    dw = torch.empty(Ci, Co, dtype=torch.float32, device=x.device)
    if N == 0 or Ci == 0 or Co == 0:
        return dw.zero_()
    part = torch.empty(N // chunk, Ci, Co, dtype=torch.float32,
                       device=x.device)
    lib = _build.load("conv_wgrad", _SIGNATURES)
    err = lib.paddle_tpu_torch_wgrad_1x1(
        x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(), N, Ci,
        Co, chunk, _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgrad_1x1 kernel launch failed: CUDA error "
                           f"{err}")
    launch_count += 1
    return dw
