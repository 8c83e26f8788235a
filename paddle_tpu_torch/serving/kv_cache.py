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
coordinates as the K/V bytes, so truncation, release, copy-on-write,
prefix adoption and transport carry the scales by construction.

`summaries=True` adds the block-sparse decode's key summaries
`k_sum_min` / `k_sum_max` `[L, NB, H, Dh]` fp32: the channel-wise min
and max of each pool block's keys, per head, which the engine updates
on append (a block's offset-0 write resets its row). They ride the
same block coordinates.

Shared blocks (the radix prefix cache, `prefix_cache.py`) are
reference counted by the allocator; a write into a shared block first
takes a private copy (`cow_block`). `export_blocks` / `import_blocks`
move block payloads through host numpy arrays (the prefix cache's
spill and restore, and the block transport of disaggregated serving,
whose destination admits a migrated request by `import_into_slot`).
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

#: the "empty" value of a min summary row (max rows take its negation):
#: finite, far above any key, and far enough below the fp32 maximum that
#: the scorer's products stay finite — an unwritten row scores a huge
#: negative bound and is never picked over a written one
SUMMARY_INIT = 1e30

#: storage dtypes numpy has no type for travel to the host as their bits
_HOST_BITS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8}


def _bits(t):
    """`t` viewed as a dtype that indexing copies and numpy both take:
    bf16 as int16, fp8 as uint8 (their bits), others as they are."""
    bits = _HOST_BITS.get(t.dtype)
    return t if bits is None else t.view(bits)


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
    pools' storage; "int8" and "fp8_e4m3" add the scale pools, and
    `summaries=True` the key-summary pools."""

    def __init__(self, num_layers, num_heads, head_dim, *, num_blocks,
                 block_size, max_slots, max_blocks_per_slot,
                 dtype="float32", kv_dtype=None, summaries=False,
                 device="cuda"):
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
        self.summaries = bool(summaries)
        self.k_sum_min = self.k_sum_max = None
        if self.summaries:
            mshape = (num_layers, self.num_blocks, num_heads, head_dim)
            self.k_sum_min = torch.full(mshape, SUMMARY_INIT,
                                        dtype=torch.float32,
                                        device=self.device)
            self.k_sum_max = torch.full(mshape, -SUMMARY_INIT,
                                        dtype=torch.float32,
                                        device=self.device)
        self.allocator = BlockAllocator(self.num_blocks)
        self.block_tables = np.zeros(
            (self.max_slots, self.max_blocks_per_slot), np.int32)
        self._slot_blocks = [[] for _ in range(self.max_slots)]
        self.slot_lens = np.zeros(self.max_slots, np.int32)
        # the radix prefix cache, when one is attached: a dry free list
        # evicts its idle cached leaves before an allocation is refused
        self.prefix_cache = None
        self.blocks_exported = 0
        self.blocks_imported = 0

    # ------------------------------------------------------------ sizing
    @property
    def quantized(self):
        return KV_DTYPES[self.kv_dtype].itemsize == 1

    @property
    def kv_bytes_per_token(self):
        """Device bytes one cached token costs across K+V and all
        layers, the quantization scales and (spread over a block's
        tokens) the key-summary rows included."""
        per = (self.num_heads * self.head_dim
               * KV_DTYPES[self.kv_dtype].itemsize)
        if self.quantized:
            per += self.num_heads * 4            # fp32 scale per head
        per *= 2                                 # K and V
        if self.summaries:
            # one fp32 min and max row a block, K only
            per += (2 * self.num_heads * self.head_dim * 4
                    ) // self.block_size
        return self.num_layers * per

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
    def _alloc(self, n):
        """`allocator.alloc` with the prefix cache as backstop: a dry
        free list first evicts LRU idle cached leaves, then retries, so
        idle cached blocks never cause a preemption the pool could have
        absorbed."""
        got = self.allocator.alloc(n)
        if got is None and self.prefix_cache is not None:
            self.prefix_cache.evict(n - self.allocator.num_free)
            got = self.allocator.alloc(n)
        return got

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
        got = self._alloc(need)
        if got is None:
            return False
        row = self._slot_blocks[slot]
        for b in got:
            self.block_tables[slot, len(row)] = b
            row.append(b)
        return True

    # ---------------------------------------------------- prefix sharing
    def adopt_blocks(self, slot, blocks):
        """Append already-allocated (cached) blocks to `slot`'s table,
        one reference each: the prefix cache's hit at admission. The
        slot reads them and never writes them."""
        row = self._slot_blocks[slot]
        if len(row) + len(blocks) > self.max_blocks_per_slot:
            raise ValueError("adopted prefix exceeds max_blocks_per_slot")
        self.allocator.incref(blocks)
        for b in blocks:
            self.block_tables[slot, len(row)] = b
            row.append(b)

    def cow_block(self, slot, index):
        """Copy-on-write `slot`'s table entry at `index`: a private
        block takes a copy of the shared block's data, replaces it in
        the table, and the slot's reference on the original is dropped.
        False (state unchanged) when no block can be had, even after
        eviction. A request that re-feeds a token inside a shared block
        writes into its copy, never into what other readers see."""
        row = self._slot_blocks[slot]
        src = row[index]
        got = self._alloc(1)
        if got is None:
            return False
        dst = got[0]
        self._copy_block_data(src, dst)
        row[index] = dst
        self.block_tables[slot, index] = dst
        self.allocator.free([src])
        return True

    def _pools(self):
        """Every pool tensor, each indexing its block at axis 1: K, V,
        then the scales (quantized pools), then the summaries."""
        out = [self.k_pool, self.v_pool]
        if self.quantized:
            out += [self.k_scale, self.v_scale]
        if self.summaries:
            out += [self.k_sum_min, self.k_sum_max]
        return out

    def _copy_block_data(self, src, dst):
        """pool[:, dst] = pool[:, src] for every pool tensor, in place on
        the pools' device (a device-to-device copy each, no host read):
        a copied block dequantizes and scores as its source does."""
        for p in self._pools():
            b = _bits(p)
            b[:, dst].copy_(b[:, src])

    # ------------------------------------------------- block transport
    def kv_meta(self):
        """The pool geometry a block payload must agree with: a spill
        restores only into a pool of the same meta."""
        return {"num_layers": self.num_layers,
                "num_heads": self.num_heads,
                "head_dim": self.head_dim,
                "block_size": self.block_size,
                "dtype": self.dtype,
                "kv_dtype": self.kv_dtype,
                "summaries": self.summaries}

    def export_blocks(self, block_ids):
        """`block_ids`' data as host numpy arrays, one per pool tensor
        (`_pools()` order), each `[n, L, ...]` (block-major). bf16 and
        fp8 pools travel as their bits (int16, uint8)."""
        ids = [int(b) for b in block_ids]
        if not ids:
            raise ValueError("export_blocks needs at least one block")
        idx = torch.tensor(ids, dtype=torch.long, device=self.device)
        out = tuple(_bits(p).index_select(1, idx).movedim(1, 0).cpu()
                    .numpy() for p in self._pools())
        self.blocks_exported += len(ids)
        return out

    def import_blocks(self, block_ids, arrays):
        """Write `export_blocks` payloads into `block_ids` (allocated by
        the caller), in place. Payloads whose count, shape or dtype do
        not match this pool are refused before anything is written."""
        ids = [int(b) for b in block_ids]
        if not ids:
            raise ValueError("import_blocks needs at least one block")
        pools = [_bits(p) for p in self._pools()]
        if len(arrays) != len(pools):
            raise ValueError(
                f"expected {len(pools)} payload arrays for kv_dtype="
                f"{self.kv_dtype!r} (summaries={self.summaries}), got "
                f"{len(arrays)}")
        host = []
        for a, p in zip(arrays, pools):
            a = np.asarray(a)
            expect = (len(ids), p.shape[0]) + tuple(p.shape[2:])
            want = torch.empty(0, dtype=p.dtype).numpy().dtype
            if tuple(a.shape) != expect or a.dtype != want:
                raise ValueError(
                    f"payload {tuple(a.shape)}/{a.dtype} does not match "
                    f"pool geometry {expect}/{want}")
            host.append(a)
        idx = torch.tensor(ids, dtype=torch.long, device=self.device)
        for a, p in zip(host, pools):
            p.index_copy_(1, idx, torch.from_numpy(np.ascontiguousarray(a))
                          .to(self.device).movedim(0, 1))
        self.blocks_imported += len(ids)

    def import_into_slot(self, slot, slot_len, chunks):
        """Admit a migrated request's KV: allocate blocks covering
        `slot_len` tokens, write the transported chunks
        (`transport.BlockChunk`s) into them and wire up `slot`'s table.
        The chunks must cover blocks [0, blocks_for(slot_len)) with no
        gap, which is checked before anything is allocated. Returns
        False, with the state unchanged, when the free list (after the
        prefix cache's eviction backstop) cannot supply the blocks; the
        scheduler then leaves the request queued and retries."""
        if slot_len <= 0:
            raise ValueError(f"import_into_slot needs slot_len >= 1, "
                             f"got {slot_len}")
        need = self.blocks_for(slot_len)
        ordered = sorted(chunks, key=lambda c: c.start)
        at = 0
        for c in ordered:
            if c.start != at:
                raise ValueError(
                    f"migration chunks leave a gap at block {at} "
                    f"(next chunk starts at {c.start})")
            at += c.count
        if at != need:
            raise ValueError(
                f"migration chunks cover {at} blocks but slot_len="
                f"{slot_len} needs {need}")
        if self._slot_blocks[slot]:
            raise ValueError(f"slot {slot} is not empty")
        got = self._alloc(need)
        if got is None:
            return False
        try:
            for c in ordered:
                self.import_blocks(got[c.start:c.start + c.count], c.arrays)
        except Exception:
            self.allocator.free(got)
            raise
        self._slot_blocks[slot] = list(got)
        self.block_tables[slot, :need] = got
        self.block_tables[slot, need:] = NULL_BLOCK
        self.slot_lens[slot] = slot_len
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
