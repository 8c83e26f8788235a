"""Radix-tree prefix KV cache over the paged block pools.

Port of `paddle_tpu/serving/prefix_cache.py`. A token's K/V depends only
on the tokens before it, so requests whose prompts share a block-aligned
head (a system prompt, a few-shot template, a replayed conversation) can
share the PHYSICAL blocks of that head: the radix tree maps token runs
to block lists, and admission walks it so chunked prefill starts at the
first uncached token instead of position 0.

* **Node = block-aligned token run.** An edge holds `tokens` (a multiple
  of `block_size` ids) and the matching `blocks`; children are keyed by
  their first block's tokens, so siblings diverge within their first
  block. Lookup and insert split nodes at block boundaries.
* **Reference counts** live in `kv_cache.BlockAllocator`: the tree holds
  one reference per cached block and every slot table that adopted it
  another, so preemption (`release_slot`) and speculative rollback
  (`truncate_slot`) only drop the slot's reference.
* **Locks** (`node.lock`) count resident requests whose tables adopted
  the node's blocks; a locked node is never evicted. `unlock_slot`
  drops them when the slot is freed (finish, preempt, expiry, cancel).
* **Eviction is LRU over unlocked leaves** whose blocks only the tree
  holds: `PagedKVCache._alloc` calls `evict()` when the free list runs
  dry, so idle cached blocks go before anyone is preempted.
* **Copy-on-write.** Matching is whole-block, but the prompt's last token
  is always re-fed (its hidden state samples the first output), so when
  the whole prompt is cached the first token fed lands inside the last
  shared block: the slot takes a private device-side copy of that block
  (`kv_cache.cow_block`) and writes there.

Quantized pools, their scales and the key summaries need no code here:
they index blocks by the same ids, and `cow_block`, `export_blocks` and
`import_blocks` carry every pool tensor.

Pure host bookkeeping; the device work (copies, transport) is the KV
cache's.
"""
from __future__ import annotations

import heapq
import itertools


class RadixNode:
    __slots__ = ("parent", "children", "tokens", "blocks", "lock",
                 "stamp")

    def __init__(self, parent, tokens, blocks):
        self.parent = parent
        self.children = {}       # first-block token tuple -> RadixNode
        self.tokens = tuple(tokens)   # len == len(blocks) * block_size
        self.blocks = list(blocks)
        self.lock = 0            # resident slots using these blocks
        self.stamp = 0           # LRU clock at last touch

    @property
    def is_leaf(self):
        return not self.children


class RadixPrefixCache:
    """Block-aligned radix tree over one `PagedKVCache`'s pools."""

    def __init__(self, kv):
        self.kv = kv
        self.bs = kv.block_size
        self.root = RadixNode(None, (), ())
        self.root.lock = 1               # the root is never evictable
        self._slot_nodes = [[] for _ in range(kv.max_slots)]
        self._tick = itertools.count(1)
        # running counters (the engine reports them)
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.evictions = 0               # blocks reclaimed by LRU
        self.cow_copies = 0
        kv.prefix_cache = self

    # ------------------------------------------------------------- stats
    @property
    def cached_blocks(self):
        """Blocks currently held by tree references."""
        total = 0
        stack = [self.root]
        while stack:
            n = stack.pop()
            total += len(n.blocks)
            stack.extend(n.children.values())
        return total

    def hit_ratio(self):
        t = self.hit_tokens + self.miss_tokens
        return self.hit_tokens / t if t else 0.0

    # ------------------------------------------------------------- match
    def _touch(self, node):
        node.stamp = next(self._tick)

    def _key(self, tokens, at):
        return tuple(tokens[at:at + self.bs])

    def _split(self, node, keep_blocks):
        """Split `node` so its edge holds exactly `keep_blocks` blocks;
        the remainder moves to a child. Locks/stamps are inherited by
        BOTH halves (a lock on the long edge locked every block in it)."""
        cut = keep_blocks * self.bs
        child = RadixNode(node, node.tokens[cut:],
                          node.blocks[keep_blocks:])
        child.children = node.children
        for c in child.children.values():
            c.parent = child
        child.lock = node.lock
        child.stamp = node.stamp
        node.tokens = node.tokens[:cut]
        node.blocks = node.blocks[:keep_blocks]
        node.children = {self._key(child.tokens, 0): child}
        if node.lock:
            # every slot holding the long edge now holds BOTH halves,
            # so its unlock releases both
            for lst in self._slot_nodes:
                if node in lst:
                    lst.append(child)
        return node

    def _walk(self, tokens, max_blocks, split=True):
        """Walk the tree over `tokens`, matching at most `max_blocks`
        whole blocks. Returns (nodes, blocks, n_blocks): the matched
        path (root excluded), their blocks in order, and the count.
        With `split`, a partial edge match splits the node so the path
        covers EXACTLY the matched blocks."""
        node = self.root
        nodes, blocks = [], []
        at = 0                           # matched blocks so far
        while at < max_blocks:
            child = node.children.get(self._key(tokens, at * self.bs))
            if child is None:
                break
            nb = len(child.blocks)
            take = 0
            while take < nb and at + take < max_blocks and \
                    tuple(tokens[(at + take) * self.bs:
                                 (at + take + 1) * self.bs]) \
                    == child.tokens[take * self.bs:(take + 1) * self.bs]:
                take += 1
            if take == 0:
                break
            if take < nb:
                if split:
                    child = self._split(child, take)
                    nodes.append(child)
                    blocks.extend(child.blocks)
                    at += take
                # partial edge: nothing deeper can match
                break
            nodes.append(child)
            blocks.extend(child.blocks)
            at += nb
            node = child
        return nodes, blocks, at

    # --------------------------------------------------------- admission
    def lookup_and_adopt(self, slot, tokens):
        """Admission-time lookup for `slot`'s runtime prompt. Adopts
        every cached block covering the prompt head into the slot's
        table (shared, refcounted), CoWs the partially-extended block
        when the hit ends mid-block, locks the matched path against
        eviction, and returns the number of cached tokens — the
        scheduler feeds the prompt from there."""
        n = len(tokens)
        usable = n - 1          # the LAST token is always re-fed
        if usable <= 0:
            self.miss_tokens += n
            return 0
        want_blocks = -(-usable // self.bs)      # ceil: CoW may extend
        nodes, blocks, got = self._walk(tokens, want_blocks)
        hit = min(got * self.bs, usable)
        full = hit // self.bs
        partial = hit % self.bs
        # lock + LRU-touch the matched path BEFORE any allocation: the
        # CoW below can trigger an eviction pass, which must not pick
        # the very nodes this request just hit
        for node in nodes:
            node.lock += 1
            self._touch(node)
        self._slot_nodes[slot].extend(nodes)
        if full:
            self.kv.adopt_blocks(slot, blocks[:full])
        if partial:
            # the hit ends inside blocks[full]: adopt + private copy so
            # the re-fed tail can write without touching the shared copy
            self.kv.adopt_blocks(slot, [blocks[full]])
            if self.kv.cow_block(slot, full):
                self.cow_copies += 1
            else:
                # pool dry even after eviction: fall back to the
                # block-aligned hit and recompute the partial tail
                self.kv.truncate_slot(slot, full * self.bs)
                hit = full * self.bs
        self.hit_tokens += hit
        self.miss_tokens += n - hit
        return hit

    def unlock_slot(self, slot):
        """Drop the slot's eviction locks (slot freed: finish, preempt,
        expiry or cancellation). Block references were already dropped
        by `release_slot`; the blocks stay cached until evicted."""
        for node in self._slot_nodes[slot]:
            node.lock -= 1
        self._slot_nodes[slot] = []

    # ------------------------------------------------------------ insert
    def insert(self, slot, tokens):
        """Cache `slot`'s written K/V for `tokens` (full blocks only).
        Called at prefill completion (prompt reuse) and at finish
        (prompt + generated output, e.g. chat history). Already-cached
        prefixes dedup against the existing tree — only the new suffix
        takes tree references; the slot's own duplicate blocks for a
        deduped range simply drop off when the slot releases."""
        nblocks = len(tokens) // self.bs
        if nblocks == 0:
            return 0
        nodes, _, got = self._walk(tokens, nblocks)
        if got >= nblocks:
            return 0
        row = self.kv.slot_blocks(slot)
        new_blocks = row[got:nblocks]
        new_tokens = tuple(tokens[got * self.bs:nblocks * self.bs])
        if len(new_blocks) != nblocks - got:
            return 0                      # slot shorter than claimed
        # the walk split any partially-matching edge, so the deepest
        # matched node is exactly the attach parent
        parent = nodes[-1] if nodes else self.root
        node = RadixNode(parent, new_tokens, new_blocks)
        self._touch(node)
        parent.children[self._key(new_tokens, 0)] = node
        self.kv.allocator.incref(new_blocks)
        return len(new_blocks)

    # ---------------------------------------------------------- eviction
    def evict(self, need_blocks):
        """Free at least `need_blocks` blocks by evicting LRU unlocked
        leaves whose blocks the tree holds the ONLY reference to.
        Returns the number of blocks actually returned to the free
        list.

        Leaves whose blocks a resident slot still references (e.g. the
        writer that published them — it holds block refs but no node
        lock) are skipped: dropping the tree's reference there would
        free NOTHING while destroying a hot prefix; if the pool is
        genuinely full of in-use blocks, failing here so the scheduler
        preempts is the correct outcome."""
        if need_blocks <= 0:
            return 0
        heap = []
        seq = itertools.count()

        def evictable(n):
            return (n.is_leaf and n.lock == 0 and n.parent is not None
                    and all(self.kv.allocator.refcount(b) == 1
                            for b in n.blocks))

        def push(n):
            if evictable(n):
                heapq.heappush(heap, (n.stamp, next(seq), n))

        stack = [self.root]
        while stack:
            n = stack.pop()
            push(n)
            stack.extend(n.children.values())
        freed = 0
        while heap and freed < need_blocks:
            _, _, node = heapq.heappop(heap)
            if not evictable(node):
                continue                  # stale heap entry
            self.kv.allocator.free(node.blocks)
            freed += len(node.blocks)
            parent = node.parent
            del parent.children[self._key(node.tokens, 0)]
            node.parent = None
            push(parent)
        self.evictions += freed
        return freed

    def evict_all(self):
        """Drop every unlocked cached block (shutdown / tests)."""
        total = 0
        while True:
            freed = self.evict(self.kv.num_blocks)
            total += freed
            if freed == 0:
                return total

    # ------------------------------------------------------ persistence
    def spill(self, path):
        """Write the radix tree and its cached blocks' data to a host
        file (a prefix cache kept across engine restarts): each node's
        token run and its `kv.export_blocks` payloads, after the pool's
        `kv_meta()` so that `restore` can refuse a mismatched pool.
        Read-only on the tree; parents precede children in the records
        so restore rebuilds the edges in one pass. Returns the number
        of blocks spilled."""
        import pickle
        order = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                order.append(n)
            stack.extend(n.children.values())
        index = {self.root: -1}
        for i, n in enumerate(order):
            index[n] = i
        records = []
        blocks = 0
        for n in order:
            records.append({
                "parent": index[n.parent],
                "tokens": tuple(n.tokens),
                "arrays": self.kv.export_blocks(n.blocks),
            })
            blocks += len(n.blocks)
        with open(path, "wb") as f:
            pickle.dump({"format": 1, "kv_meta": self.kv.kv_meta(),
                         "nodes": records}, f)
        return blocks

    def restore(self, path):
        """Re-adopt a spilled tree into THIS cache's pool: allocate
        fresh blocks (the allocation's refcount-1 is exactly the
        tree's reference), scatter the payloads back with
        `kv.import_blocks`, and rebuild the radix edges in spill
        order. All-or-nothing: a `kv_meta` mismatch raises, and a pool
        too small for the whole spill restores NOTHING (a partial tree
        would orphan subtrees). Only valid on an empty tree (warm
        boot); read only files this program spilled (they are pickles).
        Returns the number of blocks restored."""
        import pickle
        with open(path, "rb") as f:
            payload = pickle.load(f)
        if payload.get("kv_meta") != self.kv.kv_meta():
            raise ValueError(
                f"prefix spill kv_meta {payload.get('kv_meta')} does "
                f"not match this pool's {self.kv.kv_meta()}")
        if self.root.children:
            raise ValueError(
                "restore() needs an empty prefix tree (warm boot)")
        records = payload["nodes"]
        need = sum(len(r["arrays"][0]) for r in records)
        if need == 0 or need > self.kv.allocator.num_free:
            return 0
        built = []
        for rec in records:
            n_blocks = len(rec["arrays"][0])
            ids = self.kv.allocator.alloc(n_blocks)
            self.kv.import_blocks(ids, rec["arrays"])
            parent = (self.root if rec["parent"] < 0
                      else built[rec["parent"]])
            node = RadixNode(parent, rec["tokens"], ids)
            self._touch(node)
            parent.children[self._key(node.tokens, 0)] = node
            built.append(node)
        return need
