"""Block-table paged attention — the serving mixed step's kernel.

Three entries, ports of `paddle_tpu/ops/pallas/flash_attention.py`'s
`ragged_paged_attention`, `verify_paged_attention` and
`paged_attention`:

    ragged: q [T, H, Dh], slot_ids [T], positions [T]
            — one query per flat token (prefill chunks, plain decodes)
    verify: q [B, K, H, Dh], slot_ids [B], positions [B, K]
            — K consecutive queries per slot (a speculative verify
              window), one block-table walk per group
    decode: q [B, H, Dh], context_lens [B] — one query per slot b,
            attending its first context_lens[b] keys (the ragged entry
            with slot_ids = arange(B), positions = context_lens - 1)

    k_pool/v_pool [NB, BS, H, Dh] — one layer's paged pools
    block_tables  [S, MB] int32   — per-slot block lists, NULL-padded
    k_scale/v_scale [NB, BS, H] fp32, optional — the pools are int8 or
                  float8_e4m3fn and dequantize per entry per head

A query attends the keys of its slot (slot -1 = padding, clamped to
slot 0) at positions <= its own.

Block-sparse decode (`kernel_name="paged_sparse"`, the JAX package's
`paged_sparse` entry) calls the ragged and verify entries over a
SHORTENED table `[S, Bt]`, Bt < MB, with positions compacted into it:
the same kernels, launches counted apart.

On a CUDA tensor each entry launches `csrc/paged_attention.cu`, the
Hopper kernels that replace the TPU kernel
`paddle_tpu/ops/pallas/paged_attention.py:_paged_attend_kernel` (its
G=1 ragged entry, its G=K verify entry, and its quantized branch), or
raises: there is no fallback. The work is bound by device memory, and
the source explains both designs:

* 16-bit pools under queries of their own type, and int8 / fp8 pools
  under any float query (`walk_pair`), run the walk
  (`verify_walk_kernel`): items of (group, head block, range of key
  tiles), each pool entry's heads of the block brought by one bulk copy
  into a ring, the products on the tensor cores (a warp a head), and
  the items' softmax states merged in a fixed order after a grid-wide
  sync, in one launch. Verify groups of G >= 2 are the walk's groups
  as `verify_plan` cuts them. On the ragged entry (and verify calls of
  G = 1) the kernel finds its groups itself, from slot_ids and
  positions on the card (`ragged_plan` is its Python twin): runs of
  consecutive tokens of one slot, 16 at most, so a prefill chunk reads
  each page once per 16 queries instead of once per query;
* fp32 pools, and fp32 queries over 16-bit pools, run
  `paged_attend_kernel`: a block per (group, head), each K/V row of the
  head one coalesced warp load, the walk stopping at the group's newest
  position.

The ragged walk's scratch is bounded by H, Dh and the SM count alone:
2 x SMs state slots of 16 rows x 16 heads (8 at Dh 128) x (Dh + 2)
fp32, 17.8 MB at Dh 64 on an H100's 132 SMs, at T = 256 as at any T
(a call of more than RAGGED_MAX_TOKENS tokens is cut into launches).

On a CPU tensor it runs `ragged_gather_reference` /
`verify_gather_reference`, the plain PyTorch versions of the JAX
package's gather references, which the tests and `chip_smoke.py` also
hold the kernels against. The plain versions dequantize in q's dtype,
as the JAX references do; the kernels dequantize in fp32, as the TPU
kernel does.

The kernel is compiled at first use with nvcc, from this package's own
source, into `build/paddle_tpu_torch/` at the repository root, and
bound through ctypes (a plain C interface) by `_build`.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import _build

# kernel launches so far, one counter per variant (the wrapper adds one
# per launch, nowhere else)
#: ragged entry over float pools (K3a)
launch_count = 0
#: ragged entry over int8 / fp8 pools (K3c)
int8_launch_count = 0
fp8_launch_count = 0
#: verify entry over float pools (K3b)
verify_launch_count = 0
#: verify entry over int8 / fp8 pools (K3b + K3c)
verify_int8_launch_count = 0
verify_fp8_launch_count = 0
#: the same entries over the block-sparse decode's shortened tables
#: (`kernel_name="paged_sparse"`)
sparse_launch_count = 0
sparse_int8_launch_count = 0
sparse_fp8_launch_count = 0
sparse_verify_launch_count = 0
sparse_verify_int8_launch_count = 0
sparse_verify_fp8_launch_count = 0

_COUNTERS = {
    ("ragged", None): "launch_count",
    ("ragged", torch.int8): "int8_launch_count",
    ("ragged", torch.float8_e4m3fn): "fp8_launch_count",
    ("verify", None): "verify_launch_count",
    ("verify", torch.int8): "verify_int8_launch_count",
    ("verify", torch.float8_e4m3fn): "verify_fp8_launch_count",
    ("sparse", None): "sparse_launch_count",
    ("sparse", torch.int8): "sparse_int8_launch_count",
    ("sparse", torch.float8_e4m3fn): "sparse_fp8_launch_count",
    ("sparse_verify", None): "sparse_verify_launch_count",
    ("sparse_verify", torch.int8): "sparse_verify_int8_launch_count",
    ("sparse_verify", torch.float8_e4m3fn):
        "sparse_verify_fp8_launch_count"}
_COUNT_LOCK = threading.Lock()
_THREAD = threading.local()     # this thread's launches, by counter


def count(counter, n=1):
    """Add `n` to the launch counter named `counter`, under a lock: the
    engines of a serving fleet launch from several threads at once, and
    an unlocked `+=` can lose an increment. The calling thread's own
    tally (`thread_counts`) grows by `n` too."""
    with _COUNT_LOCK:
        globals()[counter] += n
    mine = _THREAD.__dict__
    mine[counter] = mine.get(counter, 0) + n


def thread_counts():
    """{counter: launches} made by the calling thread so far. A caller
    that steps one engine in this thread reads it before and after the
    step to know that engine's launches while other threads launch."""
    return dict(_THREAD.__dict__)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.int8: 3, torch.float8_e4m3fn: 4}
_FLOAT_PAIRS = {(torch.float32, torch.float32),
                (torch.bfloat16, torch.bfloat16),
                (torch.float16, torch.float16),
                (torch.float32, torch.bfloat16),
                (torch.float32, torch.float16)}
_QUANT_POOLS = (torch.int8, torch.float8_e4m3fn)
_FLOAT_QUERIES = (torch.float32, torch.bfloat16, torch.float16)
_HEAD_DIMS = (64, 128)
#: the most queries one verify group may hold on the card
MAX_GROUP = 8
#: rows of a ragged group (mma.sync's m16): runs of one slot's tokens
#: are cut every RAGGED_ROWS tokens
RAGGED_ROWS = 16
#: flat tokens one ragged launch plans (the kernel's kMaxTokens); a call
#: of more is cut into launches of this many
RAGGED_MAX_TOKENS = 1024
#: the fewest key tiles a ragged item is cut to (the plan's wmin)
RAGGED_MIN_TILES = 2


def _check_heads(name, h, k_pool, v_pool):
    if k_pool.shape[-2] != h or v_pool.shape[-2] != h:
        raise ValueError(
            f"{name}: q has {h} heads but k_pool/v_pool have "
            f"{k_pool.shape[-2]}/{v_pool.shape[-2]}")


def _entry(entry, kernel_name):
    """The counter family of one call of `entry` ("ragged" / "verify"):
    its own, or with `kernel_name="paged_sparse"` the block-sparse
    decode's."""
    if kernel_name is None:
        return entry
    if kernel_name != "paged_sparse":
        raise ValueError(f"kernel_name={kernel_name!r}: None or "
                         "'paged_sparse'")
    return "sparse" if entry == "ragged" else "sparse_verify"


def ragged_paged_attention(q, k_pool, v_pool, block_tables, slot_ids,
                           positions, k_scale=None, v_scale=None, *,
                           scale=None, kernel_name=None):
    """Flat-token attention over a block-paged KV cache (see the module
    docstring). Returns [T, H, Dh] in q's dtype; rows of padding tokens
    are finite but meaningless. `kernel_name="paged_sparse"` counts the
    launches as the block-sparse decode's."""
    entry = _entry("ragged", kernel_name)
    T, H, Dh = q.shape
    _check_heads("ragged_paged_attention", H, k_pool, v_pool)
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    if q.device.type == "cpu":
        return ragged_gather_reference(q, k_pool, v_pool, block_tables,
                                       slot_ids, positions, k_scale,
                                       v_scale, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention: no kernel for device "
                         f"{q.device}")
    return _launch(entry, q[:, None], k_pool, v_pool, block_tables,
                   slot_ids, positions.reshape(T, 1), k_scale, v_scale,
                   scale)[:, 0]


def verify_paged_attention(q, k_pool, v_pool, block_tables, slot_ids,
                           positions, k_scale=None, v_scale=None, *,
                           scale=None, kernel_name=None):
    """Verify-shaped paged attention (see the module docstring): q
    [B, K, H, Dh], slot_ids [B], positions [B, K]. Query j of a group
    sees its slot's keys at positions <= positions[b, j], so draft j
    sees drafts 0..j-1 and nothing later. Returns [B, K, H, Dh] in q's
    dtype; groups of padding slots are finite but meaningless.
    `kernel_name="paged_sparse"` counts the launches as the block-sparse
    decode's."""
    entry = _entry("verify", kernel_name)
    B, K, H, Dh = q.shape
    _check_heads("verify_paged_attention", H, k_pool, v_pool)
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    if q.device.type == "cpu":
        return verify_gather_reference(q, k_pool, v_pool, block_tables,
                                       slot_ids, positions, k_scale,
                                       v_scale, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"verify_paged_attention: no kernel for device "
                         f"{q.device}")
    return _launch(entry, q, k_pool, v_pool, block_tables, slot_ids,
                   positions, k_scale, v_scale, scale)


def paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                    k_scale=None, v_scale=None, *, scale=None):
    """Decode-shaped paged attention: q [B, H, Dh], one query per slot
    b attending its first `context_lens[b]` cached keys (>= 1) — the
    ragged entry with slot_ids = arange(B) and positions =
    context_lens - 1, as the JAX package's `paged_attention` and its
    kernel entry `decode_attend` give it. Returns [B, H, Dh] in q's
    dtype."""
    B = q.shape[0]
    slots = torch.arange(B, dtype=torch.int32, device=q.device)
    positions = (context_lens.to(device=q.device, dtype=torch.int32)
                 - 1).contiguous()
    return ragged_paged_attention(q, k_pool, v_pool, block_tables, slots,
                                  positions, k_scale, v_scale, scale=scale)


def _gather_dequant(pool, scale_pool, bt, q_dtype):
    """pool[bt] in q's dtype, times the per-entry-per-head scales when
    the pool is quantized — the JAX package's `_gather_dequant`. fp8
    rows are gathered as their bytes."""
    if pool.dtype == torch.float8_e4m3fn:
        g = pool.view(torch.uint8)[bt].view(pool.dtype)
    else:
        g = pool[bt]
    g = g.to(q_dtype)
    if scale_pool is not None:
        g = g * scale_pool[bt].to(q_dtype)[..., None]
    return g


def ragged_gather_reference(q, k_pool, v_pool, block_tables, slot_ids,
                            positions, k_scale=None, v_scale=None, *,
                            scale=None):
    """The plain PyTorch version of the ragged entry: gather every
    token's whole block list into a contiguous copy (dequantized in q's
    dtype), mask keys past the token's position with -1e9, softmax in
    fp32, and take the products in q's dtype — the JAX package's
    `ragged_gather_reference`, line for line."""
    T, H, Dh = q.shape
    BS = k_pool.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    safe_slot = slot_ids.long().clamp(0, block_tables.shape[0] - 1)
    bt = block_tables.long()[safe_slot]                # [T, MB]
    S = bt.shape[1] * BS
    k = _gather_dequant(k_pool, k_scale, bt, q.dtype).reshape(T, S, H, Dh)
    v = _gather_dequant(v_pool, v_scale, bt, q.dtype).reshape(T, S, H, Dh)
    logits = torch.einsum("thd,tshd->ths", q, k).float() * scale
    keep = torch.arange(S, device=q.device)[None, :] \
        <= positions.long()[:, None]                   # [T, S]
    logits = logits.masked_fill(~keep[:, None, :], -1e9)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("ths,tshd->thd", p, v)


def verify_gather_reference(q, k_pool, v_pool, block_tables, slot_ids,
                            positions, k_scale=None, v_scale=None, *,
                            scale=None):
    """The plain PyTorch version of the verify entry: one gather of the
    block list per group — the JAX package's `verify_gather_reference`,
    line for line."""
    B, K, H, Dh = q.shape
    BS = k_pool.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    safe_slot = slot_ids.long().clamp(0, block_tables.shape[0] - 1)
    bt = block_tables.long()[safe_slot]                # [B, MB]
    S = bt.shape[1] * BS
    k = _gather_dequant(k_pool, k_scale, bt, q.dtype).reshape(B, S, H, Dh)
    v = _gather_dequant(v_pool, v_scale, bt, q.dtype).reshape(B, S, H, Dh)
    logits = torch.einsum("bkhd,bshd->bhks", q, k).float() * scale
    keep = torch.arange(S, device=q.device)[None, None, :] \
        <= positions.long()[:, :, None]                # [B, K, S]
    logits = logits.masked_fill(~keep[:, None], -1e9)  # [B, H, K, S]
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhks,bshd->bkhd", p, v)


# ----------------------------------------------------------- the kernel


_SIGNATURES = {"paddle_tpu_torch_paged_attention":
               [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
               + [ctypes.c_float, ctypes.c_void_p],
               "paddle_tpu_torch_paged_verify":
               [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
               + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p],
               "paddle_tpu_torch_paged_ragged":
               [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
               + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]}


def walk_pair(q_dtype, kv_dtype):
    """Whether this (query, pool) pair takes the walk, on both entries:
    int8 / fp8 pools under any float query, 16-bit pools under their
    own type. fp32 pools and fp32 queries over 16-bit pools keep
    `paged_attend_kernel`."""
    return kv_dtype in _QUANT_POOLS or (
        q_dtype == kv_dtype and q_dtype in (torch.bfloat16, torch.float16))


def heads_a_block(head_dim):
    """Heads one block of the walk takes: 16 at head_dim 64, 8 at 128
    (a tile of K and V is then 64 KB in 16 bits)."""
    return 16 if head_dim == 64 else 8


def verify_plan(N, H, head_dim, sms):
    """(heads a block, head blocks, ranges a walk, items, grid) of one
    verify-walk launch over N groups on a card of `sms` SMs: 16 heads a
    block at head_dim 64, 8 at 128; each (group, head block)'s walk cut
    into R = sms // (N x head blocks) ranges (at least 1), so that the
    items fill the card once; `grid` persistent blocks, one an SM at
    most."""
    hb = heads_a_block(head_dim)
    hblk = -(-H // hb)
    ranges = max(1, sms // (N * hblk))
    items = N * hblk * ranges
    return hb, hblk, ranges, items, min(items, sms)


def walk_tiles(BS):
    """Keys a tile of the verify walk: gcd(BS, 16), so a tile never
    crosses a page."""
    return math.gcd(BS, 16)


def walk_ranges(last, BS, ranges):
    """The key-tile ranges [t0, t1) of one (group, head block)'s items:
    the walk of a group whose newest key is `last` (the maximum of its
    positions, clamped into the table) has last // KT + 1 tiles, cut
    into `ranges` parts as the kernel cuts them."""
    tn = last // walk_tiles(BS) + 1
    return [(r * tn // ranges, (r + 1) * tn // ranges)
            for r in range(ranges)]


def ragged_plan(slot_ids, positions, S, MB, BS, H, head_dim, target,
                wmin=RAGGED_MIN_TILES):
    """The ragged walk's plan of one launch, as the kernel's
    `build_plan` computes it on the card (a Python twin for the tests;
    the wrapper never calls it). `slot_ids`, `positions`: the tokens'
    [T] ints.

    Groups are the maximal runs of consecutive tokens with the same
    slot (slot -1 clamped to 0, past S to S - 1), cut every RAGGED_ROWS
    tokens; a group's walk ends at the maximum of its rows' positions
    clamped into [0, MB x BS - 1] and has last // KT + 1 key tiles (KT
    = `walk_tiles(BS)`). W is the fewest tiles an item, at least W0 =
    max(wmin, ceil(head blocks x all tiles / target)), whose items
    number at most `target` (if none does, a group an item); a group is
    cut into n = ceil(tiles / W) ranges for each head block (as
    `walk_ranges` cuts a verify walk into n); its items take (head
    block, range) in that order, and state slots in the same order when
    n > 1 (a unit of one item writes its output in place). The slots
    number fewer than 2 x target. The wrapper's target is the SM
    count.

    Returns dict(groups=[(start, rows, slot, last)], W=W,
    items=[(group, head block, t0, t1, state slot or None)],
    slots=state slots)."""
    slot_ids = [int(x) for x in slot_ids]
    positions = [int(x) for x in positions]
    T = len(slot_ids)
    hblk = -(-H // heads_a_block(head_dim))
    kt = walk_tiles(BS)
    cs = [min(max(s, 0), S - 1) for s in slot_ids]
    groups, i = [], 0
    while i < T:
        j = i + 1
        while j < T and j - i < RAGGED_ROWS and cs[j] == cs[i]:
            j += 1
        last = min(max(max(positions[i:j]), 0), MB * BS - 1)
        groups.append((i, j - i, cs[i], last))
        i = j
    tiles = [last // kt + 1 for _, _, _, last in groups]

    def count(w):
        return hblk * sum(-(-tn // w) for tn in tiles)
    # bisection between W0 and a W that fits (or a group an item), as
    # the kernel searches
    lo = max(wmin, -(-hblk * sum(tiles) // target))
    room = target - hblk * len(groups)
    hi = max(lo, -(-hblk * sum(tiles) // room) if room > 0 else sum(tiles))
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if count(mid) <= target else (mid + 1, hi)
    W = lo
    items, slots = [], 0
    for g, tn in enumerate(tiles):
        n = -(-tn // W)
        for hbk in range(hblk):
            for c in range(n):
                items.append((g, hbk, c * tn // n, (c + 1) * tn // n,
                              slots if n > 1 else None))
                slots += n > 1
    return dict(groups=groups, W=W, items=items, slots=slots)


def build():
    """Compile the kernel's shared library (see `_build.build`);
    returns its path."""
    return _build.build("paged_attention")


def _launch(entry, q, k_pool, v_pool, block_tables, slot_ids, positions,
            k_scale, v_scale, scale):
    """Launch the kernel over q [N, G, H, Dh] and positions [N, G]; adds
    its launches (one, or one per RAGGED_MAX_TOKENS groups of one query)
    to the (entry, pool type) variant's counter."""
    N, G, H, Dh = q.shape
    NB, BS = k_pool.shape[:2]
    S, MB = block_tables.shape
    quant = k_pool.dtype in _QUANT_POOLS
    if v_pool.dtype != k_pool.dtype or not (
            (q.dtype, k_pool.dtype) in _FLOAT_PAIRS
            or (quant and q.dtype in _FLOAT_QUERIES)):
        raise TypeError(f"paged_attention kernel: unsupported dtypes q="
                        f"{q.dtype}, pools={k_pool.dtype}/{v_pool.dtype}")
    if Dh not in _HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head_dim {Dh} not in "
                         f"{_HEAD_DIMS}")
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"paged_attention kernel: a group of {G} "
                         f"queries; the kernel holds 1 to {MAX_GROUP}")
    if k_pool.shape != (NB, BS, H, Dh) or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_attention kernel: pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)} do "
                         f"not match q {tuple(q.shape)}")
    scales = (k_scale, v_scale)
    if quant != (k_scale is not None) or quant != (v_scale is not None):
        raise TypeError(f"paged_attention kernel: {k_pool.dtype} pools "
                        f"{'need' if quant else 'take no'} k_scale and "
                        "v_scale")
    ints = [("block_tables", block_tables, (S, MB)),
            ("slot_ids", slot_ids, (N,)), ("positions", positions, (N, G))]
    for name, t, shape in ints:
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise TypeError(f"paged_attention kernel: {name} must be "
                            f"int32 {shape}, got {t.dtype} "
                            f"{tuple(t.shape)}")
    if quant:
        for t in scales:
            if t.dtype != torch.float32 or tuple(t.shape) != (NB, BS, H):
                raise TypeError(
                    "paged_attention kernel: scales must be float32 "
                    f"{(NB, BS, H)}, got {t.dtype} {tuple(t.shape)}")
    tensors = (q, k_pool, v_pool, *(scales if quant else ()),
               block_tables, slot_ids, positions)
    for t in tensors:
        if t.device != q.device:
            raise ValueError("paged_attention kernel: all operands must "
                             f"be on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("paged_attention kernel: operands must be "
                             "contiguous")
    out = torch.empty_like(q)
    if N == 0:
        return out
    lib = _build.load("paged_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale_ptrs = (k_scale.data_ptr() if quant else None,
                  v_scale.data_ptr() if quant else None)
    codes = (_DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype])
    launches = 1
    walk = walk_pair(q.dtype, k_pool.dtype)
    if walk:
        if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
            raise ValueError("paged_attention kernel: the walk's bulk "
                             "copies need 16-byte aligned pools")
        sms = torch.cuda.get_device_properties(
            q.device).multi_processor_count
    if walk and G == 1:
        # groups found on the card: no host read of slot_ids / positions;
        # the plan aims at an item an SM
        target = sms
        hb = heads_a_block(Dh)
        state = torch.empty(2 * target * RAGGED_ROWS * hb * (Dh + 2),
                            dtype=torch.float32, device=q.device)
        starts = range(0, N, RAGGED_MAX_TOKENS)
        launches = len(starts)
        err = 0
        for t0 in starts:
            t1 = min(N, t0 + RAGGED_MAX_TOKENS)
            err = err or lib.paddle_tpu_torch_paged_ragged(
                q[t0:t1].data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                *scale_ptrs, block_tables.data_ptr(),
                slot_ids[t0:t1].data_ptr(), positions[t0:t1].data_ptr(),
                out[t0:t1].data_ptr(), state.data_ptr(), t1 - t0, H, Dh, BS,
                S, MB, *codes, float(scale), RAGGED_MIN_TILES,
                target, 2 * target, sms, stream)
    elif walk:
        hb, _hblk, ranges, items, grid = verify_plan(N, H, Dh, sms)
        state = torch.empty(items * G * hb * (Dh + 2), dtype=torch.float32,
                            device=q.device)
        err = lib.paddle_tpu_torch_paged_verify(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *scale_ptrs,
            block_tables.data_ptr(), slot_ids.data_ptr(),
            positions.data_ptr(), out.data_ptr(), state.data_ptr(), N, G, H,
            Dh, BS, S, MB, *codes, float(scale), ranges, grid, stream)
    else:
        err = lib.paddle_tpu_torch_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *scale_ptrs,
            block_tables.data_ptr(), slot_ids.data_ptr(),
            positions.data_ptr(), out.data_ptr(), N, G, H, Dh, BS, S, MB,
            *codes, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    count(_COUNTERS[(entry, k_pool.dtype if quant else None)], launches)
    return out
