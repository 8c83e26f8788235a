"""Grouped expert matmul — the MoE expert FFN's kernel.

`grouped_expert_matmul` is the port of
`paddle_tpu/ops/pallas/grouped_matmul.py:grouped_expert_matmul`:

    x      [E, C, D]   each expert's capacity buffer
    w      [E, D, F]   float (x's dtype), or int8 weight-only, or packed
                       int4 [E, D/2, F] (`pack_int4`)
    scale  [E, F]      per-(expert, out-channel) scales of a quantized w
    out    [E, C, F]   = x[e] @ w[e] * scale[e] / qmax, in x's dtype

On a CUDA tensor it launches `csrc/grouped_matmul.cu`, the Hopper
kernels that replace the TPU kernels `_gmm_kernel`, `_gmm_kernel_quant`
and `_gmm_kernel_quant4`, or raises: there is no fallback. At the
serving shapes the products are bound by the weight bytes. Every weight
format under bf16 or fp16 activations (the serving path) takes
`gmm_q16_kernel`: a block owns 128 weight columns of one expert and 80
capacity rows, the weights and x stream in through TMA, and wgmma
multiplies them; float weights are its shared-memory operand as they
arrive, int8 and int4 weights are dequantized in registers as its
register operand; where the output tiles cannot fill the card the blocks
of one tile split D and add their partials in a fixed order (`plan` says
which). fp32 activations take `gmm_kernel`, a block per (expert, 64
columns) on the CUDA cores that dequantizes in shared memory. (The
source explains both designs.) On a CPU tensor it runs
`grouped_matmul_reference`, the plain PyTorch version of the JAX
package's einsum oracle, which the tests and `chip_smoke.py` also hold
the kernels against.

`weight_only_matmul` is the dense weight-only projection (`_mm` of a
weight-only stack: x [..., D] @ int8 w [D, F] with a scale for each
output channel) through the same kernels at one group: on a CUDA tensor
`x[None] @ w[None] * scale[None] / qmax`, so the weight crosses device
memory as int8 and is dequantized in registers, as XLA fuses the
dequant into the dot on the TPU; on a CPU tensor the plain formula.
Its launches are counted apart from the expert products'
(`dense_launch_count`).

The host helpers (`pack_int4`, `unpack_int4`, `is_packed_int4`,
`quantize_int4_experts`, `expert_weight_bytes`) produce the JAX
package's bytes exactly.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

INT4_QMAX = 7.0

#: kernel launches so far, one counter per weight format (each wrapper
#: adds one per launch, nowhere else)
fp_launch_count = 0
int8_launch_count = 0
int4_launch_count = 0
#: launches of `weight_only_matmul`, the dense projections of a
#: weight-only stack (not counted in the three above)
dense_launch_count = 0
_COUNT_LOCK = threading.Lock()


def count(counter, n=1):
    """Add `n` to the launch counter named `counter`, under a lock: the
    engines of a serving fleet launch from several threads at once, and
    an unlocked `+=` can lose an increment."""
    with _COUNT_LOCK:
        globals()[counter] += n


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# -------------------------------------------------------- host helpers


def pack_int4(q, axis=-2):
    """Pack int4-valued int8 (`[-8, 7]`) pairs along `axis` into one int8
    byte each: low nibble = even index, high nibble = odd index. The axis
    length must be even."""
    q = torch.as_tensor(q)
    axis = axis % q.ndim
    n = q.shape[axis]
    if n % 2:
        raise ValueError(f"pack_int4 needs an even axis length, got {n}")
    even = q.index_select(axis, torch.arange(0, n, 2, device=q.device)).int()
    odd = q.index_select(axis, torch.arange(1, n, 2, device=q.device)).int()
    byte = ((odd << 4) | (even & 0x0F)) & 0xFF
    return byte.to(torch.uint8).view(torch.int8)


def unpack_int4(packed, axis=-2):
    """Inverse of `pack_int4`: int8 bytes -> int4 values (sign-extended),
    interleaved back to the original order."""
    axis = axis % packed.ndim
    p = packed.int()
    low = ((p & 0x0F) ^ 8) - 8
    high = p >> 4
    out = torch.stack([low, high], dim=axis + 1)
    shape = list(packed.shape)
    shape[axis] *= 2
    return out.reshape(shape).to(torch.int8)


def is_packed_int4(w, d_in):
    """True when `w` is an int4-packed weight for a logical `[..., d_in,
    d_out]` matmul: int8 storage with half the contraction rows."""
    return w.dtype == torch.int8 and w.shape[-2] * 2 == int(d_in)


def quantize_int4_experts(w):
    """[..., In, Out] float -> (packed int8 [..., In/2, Out], fp16 scales
    [..., Out]): symmetric per-out-channel amax scaling at qmax 7 (the
    rounding uses the fp32 scale), nibble-packed along the contraction
    axis. Dequant is `q * scale / qmax`."""
    wf = torch.as_tensor(w).float()
    scale = wf.abs().amax(dim=-2).clamp_min(1e-9)
    q = torch.clamp(torch.round(wf / scale[..., None, :] * INT4_QMAX),
                    -INT4_QMAX, INT4_QMAX).to(torch.int8)
    return pack_int4(q, axis=-2), scale.half()


def expert_weight_bytes(E, d_in, d_out, weight_dtype, num_layers=1):
    """Device bytes one expert-weight stack `[L, E, d_in, d_out]` costs,
    scales included: 4 B/elem fp32, 2 bf16/fp16, int8 1 B + a fp32 scale
    per out-channel, int4 0.5 B + a fp16 scale per out-channel."""
    n = num_layers * E * d_in * d_out
    per_scale = num_layers * E * d_out
    if weight_dtype == "float32":
        return 4 * n
    if weight_dtype in ("bfloat16", "float16"):
        return 2 * n
    if weight_dtype == "int8":
        return n + 4 * per_scale
    if weight_dtype == "int4":
        return n // 2 + 2 * per_scale
    raise ValueError(f"unknown expert weight dtype {weight_dtype!r}")


def _qmax(w, scale, d_in, qmax):
    """qmax as the JAX entry detects it: 7 for packed int4, else 127."""
    if qmax is not None:
        return float(qmax)
    return INT4_QMAX if scale is not None and is_packed_int4(w, d_in) \
        else 127.0


def dequantize(w, scale, d_in, dtype, qmax=None):
    """Expert weights `[..., d_in, F]` in `dtype`: `w.to(dtype) *
    (scale.to(dtype) / qmax)` per out-channel, a packed int4 `w` unpacked
    first — the JAX package's `_deq`, and the plain version's dequant.
    `qmax` defaults by the detected format, as `grouped_expert_matmul`."""
    if scale is None:
        return w.to(dtype)
    qmax = _qmax(w, scale, d_in, qmax)
    if is_packed_int4(w, d_in):
        w = unpack_int4(w, axis=-2)
    return w.to(dtype) * (scale.unsqueeze(-2).to(dtype) / qmax)


# ------------------------------------------------------------ entries


def grouped_expert_matmul(x, w, scale=None, *, qmax=None, out_dtype=None):
    """x [E, C, D] @ w [E, D, F] -> [E, C, F] (see the module docstring).
    `qmax` defaults by the detected weight format (7 packed int4, 127
    int8), so a caller that forgets it cannot mis-scale the dequant."""
    E, C, D = x.shape
    qmax = _qmax(w, scale, D, qmax)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_expert_matmul: no kernel for device "
                         f"{x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        if scale is not None:
            raise RuntimeError("grouped_expert_matmul: quantized weights "
                               "are forward-only (no gradient), as in "
                               "the JAX package")
        return _GroupedMatmul.apply(x, w, out_dtype)
    return _forward(x, w, scale, qmax, out_dtype)


def _forward(x, w, scale, qmax, out_dtype):
    if x.device.type == "cpu":
        return grouped_matmul_reference(x, w, scale, qmax=qmax,
                                        out_dtype=out_dtype)
    return _launch(x, w, scale, qmax, out_dtype)


class _GroupedMatmul(torch.autograd.Function):
    """Float-weight grouped matmul under autograd: the kernel forward,
    JAX's `_gmm_core_bwd` backward."""

    @staticmethod
    def forward(ctx, x, w, out_dtype):
        ctx.save_for_backward(x, w)
        return _forward(x.detach(), w.detach(), None, 127.0, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return grouped_matmul_backward(x, w, g) + (None,)


def grouped_matmul_backward(x, w, g):
    """(dx, dw) of out = x @ w for the cotangent g [E, C, F]: JAX's
    `_gmm_core_bwd`, the two grouped contractions, each cast to its
    input's dtype. They run in the inputs' dtype: a bf16 `bmm` sums its
    exact bf16 products in fp32, the arithmetic of JAX's fp32 einsum at
    the TPU's default precision, so an fp32 copy adds nothing but
    time."""
    cd = torch.promote_types(x.dtype, w.dtype)
    gc = g.to(cd)
    dx = torch.bmm(gc, w.to(cd).transpose(1, 2))
    dw = torch.bmm(x.to(cd).transpose(1, 2), gc)
    return dx.to(x.dtype), dw.to(w.dtype)


def weight_only_matmul(x, w, scale, *, qmax=127.0):
    """x [..., D] @ (w [D, F] int8 * scale [F] / qmax) -> [..., F] in x's
    dtype: the dense weight-only projection (see the module docstring).
    On a CUDA tensor the K4 kernel at one group, or a raise; on a CPU
    tensor the plain version, `x @ dequantize(w, scale)` with the dequant
    in x's dtype, as the JAX package's `_mm` computes it."""
    D = x.shape[-1]
    if w.ndim != 2 or scale.ndim != 1 or w.shape[0] != D:
        # a dense weight is never packed: D rows, or a raise
        raise ValueError(f"weight_only_matmul: w [{D}, F] and scale [F], "
                         f"got {tuple(w.shape)} and {tuple(scale.shape)}")
    if x.device.type == "cpu":
        return torch.matmul(x, dequantize(w, scale, D, x.dtype, qmax))
    if x.device.type != "cuda":
        raise ValueError(f"weight_only_matmul: no kernel for device "
                         f"{x.device}")
    out = _launch(x.reshape(1, -1, D).contiguous(), w[None], scale[None],
                  float(qmax), None, dense=True)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def grouped_matmul_reference(x, w, scale=None, *, qmax=None,
                             out_dtype=None):
    """The plain PyTorch version, the JAX package's
    `grouped_matmul_oracle`: dequantize in the compute dtype (`out_dtype`
    or x's), then `einsum("ecd,edf->ecf")` in it."""
    cd = out_dtype or x.dtype
    wf = dequantize(w, scale, x.shape[2], cd, qmax)
    return torch.einsum("ecd,edf->ecf", x.to(cd), wf).to(cd)


# ----------------------------------------------------------- the kernel


_SIGNATURES = {"paddle_tpu_torch_grouped_matmul":
               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
               + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p],
               "paddle_tpu_torch_grouped_matmul_q16":
               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
               + [ctypes.c_float] + [ctypes.c_int] * 3
               + [ctypes.c_void_p]}

#: gmm_q16_kernel's tile: weight columns (wgmma M) and capacity rows
#: (wgmma N) a block, and contraction rows a stage per weight format
Q16_COLS, Q16_ROWS = 128, 80
Q16_DEPTH = {0: 64, 1: 64, 2: 128}
#: the card's SMs where no card is asked (an H100 SXM)
H100_SMS = 132


def plan(E, C, D, F, w_format, x_dtype, sms=H100_SMS):
    """Which kernel a launch takes and how it is cut, from the shapes
    alone: `w_format` 0 float, 1 int8, 2 packed int4 (D is the logical
    depth). Every format under bf16 or fp16 activations takes "q16"
    (`gmm_q16_kernel`), fp32 activations "mma" (`gmm_kernel`). For
    "q16", `tiles` = E x ceil(F / 128) x ceil(C / 80) output tiles;
    where they cannot give every one of `sms` SMs a block, D is split
    (at most 4 parts, at least one stage each) and each tile's `split`
    blocks form one cluster: int8 and int4 into the fewest parts that
    give every SM a block, float weights into the most parts that still
    leave no SM two blocks (at ffn2 2 parts, where 3 put two blocks on
    half the SMs and ran 4% slower; `tools/torch_gmm_ab.py --sweep`).
    (Fewer, longer blocks run faster than more: the split's reduction
    costs more than a full card gains.)"""
    q16 = x_dtype in (torch.bfloat16, torch.float16)
    if not q16:
        return {"kernel": "mma", "split": 1, "cluster": 1,
                "blocks": E * -(-F // 64)}
    tiles = E * -(-F // Q16_COLS) * -(-C // Q16_ROWS)
    stages = -(-D // Q16_DEPTH[w_format])
    split = 1
    if tiles < sms:
        parts = sms // tiles if w_format == 0 else -(-sms // tiles)
        split = max(1, min(4, stages, parts))
    return {"kernel": "q16", "m_tile": Q16_COLS, "n_tile": Q16_ROWS,
            "k_tile": Q16_DEPTH[w_format], "tiles": tiles, "split": split,
            "cluster": split, "blocks": tiles * split}


def build():
    """Compile the kernels' shared library (see `_build.build`); returns
    its path."""
    return _build.build("grouped_matmul")


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _vec_ok(t, row):
    """16-byte copies fit: rows of `row` elements a multiple of 16 bytes
    long and the base 16-byte aligned."""
    return int(row * t.element_size() % 16 == 0 and t.data_ptr() % 16 == 0)


def _launch(x, w, scale, qmax, out_dtype, dense=False):
    E, C, D = x.shape
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"grouped_matmul kernel: x must be fp32, bf16 or "
                        f"fp16, got {x.dtype}")
    if out_dtype is not None and out_dtype != x.dtype:
        raise TypeError(f"grouped_matmul kernel: out_dtype {out_dtype} "
                        f"must be x's dtype {x.dtype}")
    if x.requires_grad or w.requires_grad:
        # differentiable calls come through `_GroupedMatmul` detached
        raise RuntimeError("grouped_matmul kernel: inputs that require "
                           "grad go through grouped_expert_matmul")
    if w.ndim != 3 or w.shape[0] != E:
        raise ValueError(f"grouped_matmul kernel: w {tuple(w.shape)} does "
                         f"not match x {tuple(x.shape)}")
    F = w.shape[2]
    if scale is None:
        fmt = 0
        if w.dtype != x.dtype or w.shape[1] != D:
            raise TypeError(f"grouped_matmul kernel: float w must be "
                            f"{x.dtype} [{E}, {D}, F], got {w.dtype} "
                            f"{tuple(w.shape)}")
    else:
        if w.dtype != torch.int8:
            raise TypeError(f"grouped_matmul kernel: a scaled w must be "
                            f"int8, got {w.dtype}")
        if w.shape[1] == D:
            fmt = 1
        elif 2 * w.shape[1] == D:
            fmt = 2
        else:
            raise ValueError(
                f"grouped_matmul kernel: w {tuple(w.shape)} has neither D="
                f"{D} rows (int8) nor D/2 (packed int4)"
                + (" — packed int4 needs an even D" if D % 2 else ""))
        if scale.dtype not in _DTYPE_CODES or tuple(scale.shape) != (E, F):
            raise TypeError(f"grouped_matmul kernel: scale must be float "
                            f"[{E}, {F}], got {scale.dtype} "
                            f"{tuple(scale.shape)}")
    tensors = (x, w) + (() if scale is None else (scale,))
    for t in tensors:
        if t.device != x.device:
            raise ValueError("grouped_matmul kernel: all operands must be "
                             f"on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("grouped_matmul kernel: operands must be "
                             "contiguous")
    out = torch.empty(E, C, F, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if D == 0:
        return out.zero_()
    lib = _build.load("grouped_matmul", _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), w.data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(),
            E, C, D, F, _DTYPE_CODES[x.dtype], fmt,
            0 if scale is None else _DTYPE_CODES[scale.dtype], float(qmax))
    how = plan(E, C, D, F, fmt, x.dtype, _sms(x.device))
    if how["kernel"] == "q16":
        err = lib.paddle_tpu_torch_grouped_matmul_q16(
            *args, how["split"], _vec_ok(x, D), _vec_ok(w, F), stream)
    else:
        err = lib.paddle_tpu_torch_grouped_matmul(
            *args, _vec_ok(x, D), _vec_ok(w, F), stream)
    if err != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed: CUDA "
                           f"error {err}")
    count("dense_launch_count" if dense else
          ("fp_launch_count", "int8_launch_count", "int4_launch_count")[fmt])
    return out
