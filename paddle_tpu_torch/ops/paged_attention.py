"""Block-table paged attention — the serving mixed step's kernel.

`ragged_paged_attention` is the port of
`paddle_tpu/ops/pallas/flash_attention.py:ragged_paged_attention`:

    q             [T, H, Dh]      — one query per flat token
    k_pool/v_pool [NB, BS, H, Dh] — one layer's paged pools
    block_tables  [S, MB] int32   — per-slot block lists, NULL-padded
    slot_ids      [T] int32       — owning slot per token (-1 = padding)
    positions     [T] int32       — token's position in its sequence

Token t attends the keys of its slot at positions <= positions[t].

On a CUDA tensor it launches `csrc/paged_attention.cu`, the Hopper
kernel that replaces the TPU kernel
`paddle_tpu/ops/pallas/paged_attention.py:_paged_attend_kernel` (G=1
ragged entry, float pools), or raises: there is no fallback. The work
is bound by device memory — one flop per byte in bf16 — so the kernel
reads each needed K/V row once, one coalesced warp load per row, stops
at the query's own position instead of masking whole blocks, and keeps
q, the running softmax state and the accumulator in registers (the
source explains the design). On a CPU tensor it runs
`ragged_gather_reference`, the plain PyTorch version of the JAX
package's gather reference, which the tests and `chip_smoke.py` also
hold the kernel against.

The kernel is compiled at first use with nvcc, from this package's own
source, into `build/paddle_tpu_torch/` at the repository root, and
bound through ctypes (a plain C interface) by `_build`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

#: kernel launches so far (the wrapper adds one per launch, nowhere else)
launch_count = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float16, torch.float16), (torch.float32, torch.bfloat16),
          (torch.float32, torch.float16)}
_HEAD_DIMS = (64, 128)


def ragged_paged_attention(q, k_pool, v_pool, block_tables, slot_ids,
                           positions, *, scale=None):
    """Flat-token attention over a block-paged KV cache (see the module
    docstring). Returns [T, H, Dh] in q's dtype; rows of padding tokens
    are finite but meaningless."""
    T, H, Dh = q.shape
    if k_pool.shape[-2] != H or v_pool.shape[-2] != H:
        raise ValueError(
            f"ragged_paged_attention: q has {H} heads but "
            f"k_pool/v_pool have {k_pool.shape[-2]}/{v_pool.shape[-2]}")
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    if q.device.type == "cpu":
        return ragged_gather_reference(q, k_pool, v_pool, block_tables,
                                       slot_ids, positions, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention: no kernel for device "
                         f"{q.device}")
    return _launch(q, k_pool, v_pool, block_tables, slot_ids, positions,
                   scale)


def ragged_gather_reference(q, k_pool, v_pool, block_tables, slot_ids,
                            positions, *, scale=None):
    """The plain PyTorch version: gather every token's whole block list
    into a contiguous copy, mask keys past the token's position with
    -1e9, softmax in fp32, and take the products in q's dtype — the
    JAX package's `ragged_gather_reference`, line for line."""
    T, H, Dh = q.shape
    BS = k_pool.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    safe_slot = slot_ids.long().clamp(0, block_tables.shape[0] - 1)
    bt = block_tables.long()[safe_slot]                # [T, MB]
    S = bt.shape[1] * BS
    k = k_pool[bt].to(q.dtype).reshape(T, S, H, Dh)
    v = v_pool[bt].to(q.dtype).reshape(T, S, H, Dh)
    logits = torch.einsum("thd,tshd->ths", q, k).float() * scale
    keep = torch.arange(S, device=q.device)[None, :] \
        <= positions.long()[:, None]                   # [T, S]
    logits = logits.masked_fill(~keep[:, None, :], -1e9)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("ths,tshd->thd", p, v)


# ----------------------------------------------------------- the kernel


_SIGNATURES = {"paddle_tpu_torch_paged_attention":
               [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
               + [ctypes.c_float, ctypes.c_void_p]}


def build():
    """Compile the kernel's shared library (see `_build.build`);
    returns its path."""
    return _build.build("paged_attention")


def _launch(q, k_pool, v_pool, block_tables, slot_ids, positions, scale):
    global launch_count
    T, H, Dh = q.shape
    NB, BS = k_pool.shape[:2]
    S, MB = block_tables.shape
    if (q.dtype, k_pool.dtype) not in _PAIRS or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_attention kernel: unsupported dtypes q="
                        f"{q.dtype}, pools={k_pool.dtype}/{v_pool.dtype}")
    if Dh not in _HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head_dim {Dh} not in "
                         f"{_HEAD_DIMS}")
    if k_pool.shape != (NB, BS, H, Dh) or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_attention kernel: pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)} do "
                         f"not match q {tuple(q.shape)}")
    for name, t, shape in (("block_tables", block_tables, (S, MB)),
                           ("slot_ids", slot_ids, (T,)),
                           ("positions", positions, (T,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise TypeError(f"paged_attention kernel: {name} must be "
                            f"int32 {shape}, got {t.dtype} "
                            f"{tuple(t.shape)}")
    tensors = (q, k_pool, v_pool, block_tables, slot_ids, positions)
    for t in tensors:
        if t.device != q.device:
            raise ValueError("paged_attention kernel: all operands must "
                             f"be on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("paged_attention kernel: operands must be "
                             "contiguous")
    out = torch.empty_like(q)
    if T == 0:
        return out
    lib = _build.load("paged_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paddle_tpu_torch_paged_attention(
        *(t.data_ptr() for t in tensors), out.data_ptr(),
        T, H, Dh, BS, S, MB, _DTYPE_CODES[q.dtype],
        _DTYPE_CODES[k_pool.dtype], float(scale), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    launch_count += 1
    return out
