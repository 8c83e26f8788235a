"""Block-paged KV cache for continuous batching.

Port of `paddle_tpu/serving/kv_cache.py`: one `[L, num_blocks,
block_size, H, Dh]` pool per K and V covers every request; a request
owns an ordered list of blocks, and the per-slot block table is padded
to a fixed `max_blocks_per_slot` width, so the mixed step sees the same
shapes whichever requests are resident.

Block 0 is the NULL block: padding entries in block tables and the
cache writes of padding tokens land there, and the attention mask
(`key position <= query position`) guarantees it is never read
through. The allocator hands out blocks `1..num_blocks-1` LIFO.

The pools are torch tensors on the engine's device, written in place
by the mixed step. `kv_dtype="int8"` or `"fp8_e4m3"` stores them
quantized, with fp32 scale pools `k_scale`/`v_scale` `[L, NB, BS, H]`:
one scale per pool entry per head, at the same (block, offset)
coordinates as the K/V bytes, so truncation and release carry the
scales by construction. Block summaries, copy-on-write and block
transport wait for later slices.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

NULL_BLOCK = 0

#: supported pool dtypes -> torch storage dtype; the one-byte ones
#: store quantized payloads with per-entry-per-head fp32 scales
KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16, "int8": torch.int8,
             "fp8_e4m3": torch.float8_e4m3fn}

#: the largest finite float8_e4m3fn value; quantize-on-append clips to
#: it (values past it would cast to NaN)
FP8_MAX = 448.0


class BlockAllocator:
    """LIFO free-list over block ids [reserved, num_blocks), with
    per-block reference counts: `alloc` hands a block out at refcount
    1, `incref` adds an owner, and `free` decrements — the block
    returns to the free list only when its last owner lets go.
    Allocation is all-or-nothing."""

    def __init__(self, num_blocks, reserved=1):
        if num_blocks <= reserved:
            raise ValueError(
                f"num_blocks={num_blocks} leaves no allocatable blocks "
                f"past the {reserved} reserved null block(s)")
        self.num_blocks = int(num_blocks)
        self.reserved = int(reserved)
        self._free = list(range(self.num_blocks - 1,
                                self.reserved - 1, -1))
        self._refs = {}                      # block id -> owner count

    @property
    def num_free(self):
        return len(self._free)

    @property
    def num_used(self):
        return len(self._refs)

    @property
    def capacity(self):
        return self.num_blocks - self.reserved

    def refcount(self, block):
        return self._refs.get(block, 0)

    @property
    def invariant_ok(self):
        """allocated + free + reserved == pool size, with no overlap."""
        allocated = set(self._refs)
        free = set(self._free)
        return (not (allocated & free)
                and len(self._free) == len(free)
                and len(allocated) + len(free) + self.reserved
                == self.num_blocks
                and all(c > 0 for c in self._refs.values()))

    def alloc(self, n):
        """n blocks (each at refcount 1), or None when the pool can't
        cover the request — the caller decides whether to preempt
        (never partial)."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def incref(self, blocks):
        """Add an owner to already-allocated blocks."""
        for b in blocks:
            if b not in self._refs:
                raise ValueError(f"incref of unallocated block {b}")
            self._refs[b] += 1

    def free(self, blocks):
        """Drop one owner per block; a block whose count hits zero goes
        back on the free list."""
        for b in blocks:
            c = self._refs.get(b, 0)
            if c <= 0:
                raise ValueError(f"double free of block {b}")
            if c == 1:
                del self._refs[b]
                self._free.append(b)
            else:
                self._refs[b] = c - 1


class PagedKVCache:
    """Paged pools on the device + per-slot block tables and the slot
    length ledger on the host. `kv_dtype` (default: `dtype`) names the
    pools' storage; "int8" and "fp8_e4m3" add the scale pools."""

    def __init__(self, num_layers, num_heads, head_dim, *, num_blocks,
                 block_size, max_slots, max_blocks_per_slot,
                 dtype="float32", kv_dtype=None, device="cuda"):
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.max_slots = int(max_slots)
        self.max_blocks_per_slot = int(max_blocks_per_slot)
        self.dtype = str(dtype)
        self.kv_dtype = str(kv_dtype) if kv_dtype else self.dtype
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype={self.kv_dtype!r} not supported; pick one of "
                f"{sorted(KV_DTYPES)} ('int8'/'fp8_e4m3' store "
                "per-entry-per-head scaled quantized pools)")
        self.device = resolve_device(device)
        shape = (num_layers, self.num_blocks, self.block_size,
                 num_heads, head_dim)
        tdt = KV_DTYPES[self.kv_dtype]
        self.k_pool = torch.zeros(shape, dtype=tdt, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=tdt, device=self.device)
        self.k_scale = self.v_scale = None
        if self.quantized:
            self.k_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=self.device)
            self.v_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=self.device)
        self.allocator = BlockAllocator(self.num_blocks)
        self.block_tables = np.zeros(
            (self.max_slots, self.max_blocks_per_slot), np.int32)
        self._slot_blocks = [[] for _ in range(self.max_slots)]
        self.slot_lens = np.zeros(self.max_slots, np.int32)

    # ------------------------------------------------------------ sizing
    @property
    def quantized(self):
        return KV_DTYPES[self.kv_dtype].itemsize == 1

    @property
    def kv_bytes_per_token(self):
        """Device bytes one cached token costs across K+V and all
        layers, the quantization scales included."""
        per = (self.num_heads * self.head_dim
               * KV_DTYPES[self.kv_dtype].itemsize)
        if self.quantized:
            per += self.num_heads * 4            # fp32 scale per head
        return self.num_layers * 2 * per

    @property
    def block_bytes(self):
        """Device bytes one K+V block (all layers) occupies, scales
        included."""
        return self.kv_bytes_per_token * self.block_size

    @property
    def max_slot_tokens(self):
        return self.max_blocks_per_slot * self.block_size

    def blocks_for(self, n_tokens):
        return -(-int(n_tokens) // self.block_size)

    def blocks_missing(self, slot, new_len):
        return max(0, self.blocks_for(new_len)
                   - len(self._slot_blocks[slot]))

    def slot_num_blocks(self, slot):
        return len(self._slot_blocks[slot])

    def slot_blocks(self, slot):
        """The slot's ordered block list (a copy)."""
        return list(self._slot_blocks[slot])

    # --------------------------------------------------------- lifecycle
    def ensure_capacity(self, slot, new_len) -> bool:
        """Grow `slot`'s block table to cover `new_len` tokens. False
        (state unchanged) when the free list can't supply the blocks."""
        if new_len > self.max_slot_tokens:
            raise ValueError(
                f"slot needs {new_len} tokens but max_blocks_per_slot="
                f"{self.max_blocks_per_slot} x block_size="
                f"{self.block_size} caps it at {self.max_slot_tokens}")
        need = self.blocks_missing(slot, new_len)
        if need == 0:
            return True
        got = self.allocator.alloc(need)
        if got is None:
            return False
        row = self._slot_blocks[slot]
        for b in got:
            self.block_tables[slot, len(row)] = b
            row.append(b)
        return True

    def truncate_slot(self, slot, new_len):
        """Roll back `slot` to cover only `new_len` tokens: blocks past
        `blocks_for(new_len)` go back to the free list and their table
        entries reset to NULL. Returns the number of blocks freed."""
        keep = self.blocks_for(new_len)
        row = self._slot_blocks[slot]
        if len(row) <= keep:
            return 0
        extra = row[keep:]
        self.allocator.free(extra)
        self._slot_blocks[slot] = row[:keep]
        self.block_tables[slot, keep:] = NULL_BLOCK
        return len(extra)

    def release_slot(self, slot):
        row = self._slot_blocks[slot]
        if row:
            self.allocator.free(row)
        self._slot_blocks[slot] = []
        self.block_tables[slot, :] = NULL_BLOCK
        self.slot_lens[slot] = 0

    # ----------------------------------------------------------- metrics
    @property
    def blocks_in_use(self):
        return self.allocator.num_used

    @property
    def utilization(self):
        return self.allocator.num_used / max(1, self.allocator.capacity)
