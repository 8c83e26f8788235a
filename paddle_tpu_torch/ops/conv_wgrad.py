"""The split-K weight gradient of a 1x1 convolution — K6.

`wgrad_1x1(x, dy, chunk=4096)` is the port of
`paddle_tpu/ops/pallas/conv_wgrad.py:wgrad_1x1`: dW[Ci, Co] (fp32) =
x[N, Ci]^T @ dy[N, Co], summed over N in `chunk`-row pieces. As in the
JAX package it is an entry of its own, wired into no convolution
backward there or here (the JAX docstring records it as a measured
negative result that is kept).

On a CUDA tensor it launches `csrc/conv_wgrad.cu` (the Hopper kernel
that replaces the TPU kernel) or raises — x and dy of one dtype among
fp32, bf16 and fp16, Ci and Co multiples of 16 bytes of it; there is no
fallback. 16-bit operands take one persistent launch: TMA streams rows
of x and dy into wgmma, each block owns an output tile of up to 256 x
128 (all of dW at ResNet-50's [401408, 256] x [401408, 64], so each
operand is read once) and a split of N (every splits-th 32-row tile);
the splits' fp32 partials are added in a fixed order after a grid-wide
sync, so two launches give the same bits. fp32 operands take the CUDA
cores and a second launch that adds the splits' partials in order.
`plan` chooses the tile width, the splits and the grid; the split does
not follow `chunk`, which keeps its meaning in the plain version and in
the `N % chunk` check JAX makes. On a CPU tensor it runs the plain
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
               + [ctypes.c_longlong] + [ctypes.c_int] * 6
               + [ctypes.c_void_p]}
#: rows of N a 16-bit stage and an fp32 staged tile; output tile rows
ROWS_16, ROWS_32, TILE_M = 32, 32, 256


def wgrad_1x1(x, dy, *, chunk=4096):
    """dW[Ci, Co] (fp32) = x[N, Ci]^T @ dy[N, Co], N a multiple of
    `chunk`; see the module docstring."""
    N, Ci = x.shape
    _, Co = dy.shape
    if N % chunk != 0:
        raise ValueError(f"N={N} not divisible by chunk={chunk}")
    if x.device.type == "cpu":
        return wgrad_1x1_reference(x, dy, chunk=chunk)
    return _launch(x, dy)


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


def plan(N, Ci, Co, dtype, sms):
    """(bn, splits, grid) of one launch on a card of `sms` SMs.

    16-bit: the wider of Ci and Co is M (tiles of 256), the other N
    (tiles of `bn` = 64, or 128 where it is wider than 64); each tile's
    row tiles of 32 rows are cut into `splits` splits, as many as leave
    every SM at most one item; `grid` persistent blocks, one an SM at
    most. fp32: 64 x 64 tiles, ranges of 32-row tiles enough for ~4
    blocks an SM, a block an item."""
    if dtype == torch.float32:
        tiles = -(-Ci // 64) * -(-Co // 64)
        splits = max(1, min(-(-N // ROWS_32), 4 * sms // tiles))
        return 64, splits, tiles * splits
    m, n = max(Ci, Co), min(Ci, Co)
    bn = 64 if n <= 64 else 128
    tiles = -(-m // TILE_M) * -(-n // bn)
    splits = max(1, min(-(-N // ROWS_16), sms // tiles))
    return bn, splits, min(tiles * splits, sms)


def split_rows(N, splits, dtype):
    """The row tiles (of ROWS_16 or ROWS_32 rows) each split of one
    output tile walks, as the kernels walk them: in 16 bits split s takes
    every splits-th tile from s, so the blocks sweep N together; in fp32
    a contiguous range [s R / S, (s + 1) R / S) of the R tiles."""
    rows = ROWS_32 if dtype == torch.float32 else ROWS_16
    tiles = -(-N // rows)
    if dtype == torch.float32:
        return [range(s * tiles // splits, (s + 1) * tiles // splits)
                for s in range(splits)]
    return [range(s, tiles, splits) for s in range(splits)]


def build():
    """Compile the kernel's shared library (see `_build.build`); returns
    its path."""
    return _build.build("conv_wgrad")


def _launch(x, dy):
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
    if x.element_size() == 2 and N >= 2 ** 31:
        raise ValueError(f"wgrad_1x1 kernel: N={N} rows; TMA coordinates "
                         "reach 2**31 - 1")
    for t in (x, dy):
        if t.device != x.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("wgrad_1x1 kernel: operands must be contiguous "
                             f"and 16-byte aligned on {x.device}")
    dw = torch.empty(Ci, Co, dtype=torch.float32, device=x.device)
    if N == 0 or Ci == 0 or Co == 0:
        return dw.zero_()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    bn, splits, grid = plan(N, Ci, Co, x.dtype, sms)
    part = None
    if splits > 1 or x.dtype == torch.float32:
        part = torch.empty(splits, Ci, Co, dtype=torch.float32,
                           device=x.device)
    lib = _build.load("conv_wgrad", _SIGNATURES)
    err = lib.paddle_tpu_torch_wgrad_1x1(
        x.data_ptr(), dy.data_ptr(),
        None if part is None else part.data_ptr(), dw.data_ptr(), N, Ci, Co,
        _DTYPE_CODES[x.dtype], bn, splits, grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgrad_1x1 kernel launch failed: CUDA error "
                           f"{err}")
    launch_count += 1
    return dw
