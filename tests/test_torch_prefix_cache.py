"""The port's radix prefix cache against the JAX package's.

`ServingEngine(prefix_caching=True)` shares the KV blocks of cached
prompt heads across requests (`serving.prefix_cache.RadixPrefixCache`
over the refcounted `PagedKVCache`), copies a shared block on write and
spills / restores its tree. At tests/test_multitick.py's sizes (vocab
193, hidden 32, 2 layers, 4 heads, block_size=4, fp32, CPU, the same
weights carried across by `paddle_tpu_torch.convert`):

* the same scripted and random sequences of admit / insert / finish /
  preempt / evict / truncate drive JAX's cache and the port's: the tree
  (token runs, blocks, locks, LRU stamps), block tables, refcounts, the
  free list and the hit / miss / eviction / copy counts stay equal;
* `cow_block` copies K, V, the scale columns and the summary rows, bit
  for bit; `export_blocks` / `import_blocks` round-trip every pool;
* two waves of requests (shared heads, then replayed conversations and
  an exact full-prompt replay) give JAX's tokens, per-request
  `cache_hit_tokens` and cache counters, tolerance 0, plain, under
  preemption, with draft_k=3, over an int8 pool and at 4 ticks; and the
  port's cache-off engine's tokens;
* a spill / restore round trip serves the same tokens and hits; a
  mismatched `kv_meta` raises and a pool too small restores nothing.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTForGeneration as JaxGPT
from paddle_tpu.serving.engine import ServingEngine as JaxEngine
from paddle_tpu.serving.kv_cache import PagedKVCache as JaxKV
from paddle_tpu.serving.prefix_cache import RadixPrefixCache as JaxRadix
from paddle_tpu_torch.convert import load_jax_gpt
from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.kv_cache import NULL_BLOCK, PagedKVCache
from paddle_tpu_torch.serving.prefix_cache import RadixPrefixCache

VOCAB, HEADS, NEW = 193, 4, 6


def _carry(jm):
    tensors = jm._gen_tensors()
    names = (["word_embeddings", "position_embeddings"]
             + list(jm._dec_names) + ["ln_f.weight", "ln_f.bias",
                                      "lm_head.weight"])
    arrays = {n: np.asarray(t._data) for n, t in zip(names, tensors)}
    return load_jax_gpt(arrays, HEADS, device="cpu")


@pytest.fixture(scope="module")
def models():
    """(jax model, port model on the CPU) with the same weights."""
    paddle.seed(1234)
    jm = JaxGPT(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                num_attention_heads=HEADS, max_position_embeddings=128,
                compute_dtype="float32")
    jm.eval()
    return jm, _carry(jm)


# ------------------------------------------------------ tree mechanics


def _caches(num_blocks=25, max_slots=4, mbps=6):
    """(JAX cache + tree, port cache + tree) of one geometry."""
    geo = dict(num_blocks=num_blocks, block_size=4, max_slots=max_slots,
               max_blocks_per_slot=mbps)
    jkv = JaxKV(1, 1, 4, **geo)
    tkv = PagedKVCache(1, 1, 4, device="cpu", **geo)
    return (jkv, JaxRadix(jkv)), (tkv, RadixPrefixCache(tkv))


def _state(kv, pc):
    """Everything the tree and the allocator hold, comparable across
    the frameworks."""
    def node(n):
        return (n.tokens, tuple(n.blocks), n.lock, n.stamp,
                tuple(sorted((k, node(c)) for k, c in n.children.items())))
    return dict(
        tree=node(pc.root), tables=kv.block_tables.tolist(),
        rows=[kv.slot_blocks(s) for s in range(kv.max_slots)],
        lens=kv.slot_lens.tolist(), refs=dict(kv.allocator._refs),
        free=list(kv.allocator._free),
        locks=[[n.tokens for n in lst] for lst in pc._slot_nodes],
        counts=(pc.hit_tokens, pc.miss_tokens, pc.evictions,
                pc.cow_copies, pc.cached_blocks))


def _apply(kv, pc, op):
    """One operation of a sequence, as the scheduler makes them."""
    kind, slot = op[0], op[1]
    if kind == "admit":                  # lookup, grow, publish
        tokens, want = op[2], op[3]
        hit = pc.lookup_and_adopt(slot, tokens)
        if kv.ensure_capacity(slot, want):
            kv.slot_lens[slot] = want
            pc.insert(slot, tokens[:want])
            return hit
        kv.release_slot(slot)            # pool dry: give it back
        pc.unlock_slot(slot)
        return -1
    if kind == "truncate":
        kv.slot_lens[slot] = op[2]
        return kv.truncate_slot(slot, op[2])
    if kind == "finish":                 # publish, then free
        pc.insert(slot, op[2][:int(kv.slot_lens[slot])])
    if kind in ("finish", "preempt"):
        pc.unlock_slot(slot)
        kv.release_slot(slot)
        return 0
    if kind == "evict":
        return pc.evict(op[2])
    raise ValueError(kind)


def _scripted():
    a = list(range(100, 119))            # 19 tokens: 4 full blocks
    b = a[:8] + list(range(50, 62))      # shares 2 blocks
    return [("admit", 0, a, 19), ("admit", 1, a, 22), ("admit", 2, b, 20),
            ("truncate", 1, 17), ("finish", 0, a), ("preempt", 2),
            ("admit", 3, a[:16], 16),    # the whole prompt cached: CoW
            ("evict", 0, 3), ("finish", 1, a + [7, 8, 9]),
            ("finish", 3, a[:16]), ("evict", 0, 4), ("admit", 0, b, 24),
            ("evict", 0, 100)]


def _random_ops(rng, state, n=300):
    """Ops drawn against the port's state as it goes (the JAX side
    sees the same ops): half the admissions reuse a shared head."""
    heads = [list(range(1000 * i, 1000 * i + 8)) for i in range(1, 4)]
    fresh = iter(range(10 ** 6, 10 ** 7))
    toks = {}
    for _ in range(n):
        kv = state()
        slot = int(rng.randint(4))
        live = kv.slot_num_blocks(slot) > 0
        op = rng.randint(5)
        if not live and op != 4:
            base = heads[rng.randint(3)] if rng.rand() < 0.5 else []
            toks[slot] = base + [next(fresh)
                                 for _ in range(rng.randint(1, 8))]
            want = min(len(toks[slot]) + int(rng.randint(0, 6)),
                       kv.max_slot_tokens)
            yield ("admit", slot, toks[slot], want)
        elif op == 1 and live:
            n_len = int(kv.slot_lens[slot])
            yield ("truncate", slot,
                   int(rng.randint(max(1, n_len // 2), n_len + 1)))
        elif op == 2 and live:
            yield ("finish" if rng.rand() < 0.5 else "preempt", slot,
                   toks[slot])
        elif op == 3:
            yield ("evict", slot, int(rng.randint(1, 5)))


@pytest.mark.parametrize("seq", ["scripted", 0, 1, 2])
def test_tree_sequences_match_jax(seq):
    (jkv, jpc), (tkv, tpc) = _caches()
    ops = (_scripted() if seq == "scripted"
           else _random_ops(np.random.RandomState(seq), lambda: tkv))
    n = 0
    for op in ops:
        assert _apply(tkv, tpc, op) == _apply(jkv, jpc, op), op
        assert _state(tkv, tpc) == _state(jkv, jpc), op
        assert tkv.allocator.invariant_ok
        for s in range(tkv.max_slots):
            nb = tkv.slot_num_blocks(s)
            assert (tkv.block_tables[s, :nb] != NULL_BLOCK).all()
            assert (tkv.block_tables[s, nb:] == NULL_BLOCK).all()
        n += 1
    assert n >= 13
    if seq == "scripted":
        assert tpc.cow_copies == 1 and tpc.evictions > 0
    for kv, pc in ((tkv, tpc), (jkv, jpc)):
        for s in range(kv.max_slots):
            pc.unlock_slot(s)
            kv.release_slot(s)
        pc.evict_all()
    assert _state(tkv, tpc) == _state(jkv, jpc)
    assert tkv.allocator.num_used == 0


def test_dry_pool_evicts_before_refusing():
    """`ensure_capacity` reclaims idle cached blocks before it fails,
    as JAX's does (the multi-tick preallocation goes through it too)."""
    for kv, pc in _caches(num_blocks=9, mbps=8):
        toks = list(range(16))
        assert kv.ensure_capacity(0, 16)
        kv.slot_lens[0] = 16
        pc.insert(0, toks)
        kv.release_slot(0)
        pc.unlock_slot(0)
        assert kv.allocator.num_free == 4
        assert kv.ensure_capacity(1, 32)        # needs all 8
        assert pc.evictions == 4 and kv.allocator.invariant_ok


# ------------------------------------------------- copies and transport


def _filled(kv_dtype, seed=0):
    """A port cache with summaries whose every pool tensor holds random
    bytes, and slot 0 on two blocks."""
    kv = PagedKVCache(2, 2, 8, num_blocks=10, block_size=4, max_slots=2,
                      max_blocks_per_slot=4, kv_dtype=kv_dtype,
                      summaries=True, device="cpu")
    g = torch.Generator().manual_seed(seed)
    for p in kv._pools():
        bits = p.view(torch.uint8) if p.element_size() == 1 else p
        if bits.dtype == torch.uint8:
            bits.copy_(torch.randint(0, 120, bits.shape, generator=g,
                                     dtype=torch.uint8))
        else:
            bits.copy_(torch.randn(bits.shape, generator=g))
    assert kv.ensure_capacity(0, 8)
    return kv


def _pool_bits(kv, block):
    return [p.view(torch.uint8)[:, block].clone() if p.element_size() == 1
            else p[:, block].clone() for p in kv._pools()]


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8",
                                      "fp8_e4m3"])
def test_cow_block_copies_every_pool(kv_dtype):
    kv = _filled(kv_dtype)
    pools = kv._pools()
    assert len(pools) == (6 if kv.quantized else 4)
    src = kv.slot_blocks(0)[1]
    before = _pool_bits(kv, src)
    kv.allocator.incref([src])           # a second reader
    assert kv.cow_block(0, 1)
    dst = kv.slot_blocks(0)[1]
    assert dst != src and kv.block_tables[0, 1] == dst
    assert kv.allocator.refcount(src) == 1
    assert kv.allocator.refcount(dst) == 1
    for a, b, c in zip(_pool_bits(kv, dst), before, _pool_bits(kv, src)):
        assert torch.equal(a, b) and torch.equal(c, b)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "fp8_e4m3"])
def test_export_import_round_trip(kv_dtype):
    kv = _filled(kv_dtype)
    ids = kv.slot_blocks(0)
    arrays = kv.export_blocks(ids)
    assert [a.shape[0] for a in arrays] == [2] * len(kv._pools())
    other = _filled(kv_dtype, seed=1)
    got = other.allocator.alloc(2)
    other.import_blocks(got, arrays)
    for a, b in zip(_pool_bits(other, torch.tensor(got)),
                    _pool_bits(kv, torch.tensor(ids))):
        assert torch.equal(a, b)
    assert kv.blocks_exported == other.blocks_imported == 2
    plain = PagedKVCache(2, 2, 8, num_blocks=10, block_size=4, max_slots=2,
                         max_blocks_per_slot=4, kv_dtype=kv_dtype,
                         device="cpu")
    with pytest.raises(ValueError, match="payload"):
        plain.import_blocks(plain.allocator.alloc(2), arrays)


# ------------------------------------------------------------- engines


def _waves():
    """Wave 1: six prompts on a shared 10-token head. Wave 2 is built
    from wave 1's outputs: three conversations replayed with a new
    suffix, and one exact replay of a 16-token prompt (a whole prompt
    cached: the copy-on-write path)."""
    rng = np.random.RandomState(0)
    head = rng.randint(1, VOCAB, 10).tolist()
    first = [head + rng.randint(1, VOCAB, n).tolist()
             for n in (3, 5, 2, 6, 4, 7)]

    def second(out):
        return ([first[i] + out[i] + rng2.randint(1, VOCAB, 3).tolist()
                 for i in (0, 2, 3)] + [first[3]])
    rng2 = np.random.RandomState(1)
    return first, second


def _serve(eng):
    first, second = _waves()
    r1 = [eng.submit(p, NEW) for p in first]
    eng.run()
    r2 = [eng.submit(p, NEW) for p in second([list(r.output) for r in r1])]
    eng.run()
    reqs = r1 + r2
    return [list(r.output) for r in reqs], [r.cache_hit_tokens
                                            for r in reqs]


def _counts(eng):
    pc = eng.prefix_cache
    return (pc.hit_tokens, pc.miss_tokens, pc.evictions, pc.cow_copies)


def _kw(**kw):
    return dict(dict(max_slots=2, block_size=4, max_seq_len=64,
                     cache_dtype="float32", seed=0), **kw)


@pytest.mark.parametrize("case", [
    dict(),
    dict(max_slots=4, num_blocks=13),
    dict(draft_k=3),
    dict(kv_dtype="int8"),
    dict(ticks_per_dispatch=4, max_slots=4, num_blocks=13),
], ids=["plain", "preempt", "draft3", "int8", "ticks4-preempt"])
def test_engine_matches_jax(models, case):
    jm, tm = models
    je = JaxEngine(jm, prefix_caching=True, **_kw(**case))
    want, want_hits = _serve(je)
    eng = ServingEngine(tm, prefix_caching=True, device="cpu",
                        **_kw(**case))
    got, hits = _serve(eng)
    assert got == want
    assert hits == want_hits
    assert _counts(eng) == _counts(je)
    assert _counts(eng)[3] >= 1                  # the exact replay
    assert sum(hits[6:]) > 0                     # the replays hit
    assert eng.scheduler.preemption_count == je.scheduler.preemption_count
    if "num_blocks" in case:
        assert eng.scheduler.preemption_count > 0
        assert _counts(eng)[2] > 0               # LRU eviction ran
    off, _ = _serve(ServingEngine(tm, device="cpu", **_kw(**case)))
    assert got == off
    assert eng.kv.allocator.invariant_ok
    eng.prefix_cache.evict_all()
    assert eng.kv.blocks_in_use == 0
    assert eng.kv.allocator.num_free == eng.kv.allocator.capacity


def test_spill_restore_round_trip(models, tmp_path):
    """Wave 1 on one engine, spilled at close; a fresh engine restores
    the spill and serves wave 2 with the tokens and hits of an engine
    that kept its cache throughout."""
    _, tm = models
    first, second = _waves()
    kept = ServingEngine(tm, prefix_caching=True, device="cpu", **_kw())
    want, want_hits = _serve(kept)

    a = ServingEngine(tm, prefix_caching=True, device="cpu", **_kw())
    r1 = [a.submit(p, NEW) for p in first]
    a.run()
    cached = a.prefix_cache.cached_blocks
    path = tmp_path / "prefix.pkl"
    assert a.close(spill_prefix=path) == cached > 0
    assert a.kv.blocks_in_use == 0

    b = ServingEngine(tm, prefix_caching=True, device="cpu", **_kw())
    assert b.prefix_cache.restore(path) == cached
    assert b.prefix_cache.cached_blocks == cached
    r2 = [b.submit(p, NEW) for p in second([list(r.output) for r in r1])]
    b.run()
    assert [list(r.output) for r in r1 + r2] == want
    assert [r.cache_hit_tokens for r in r2] == want_hits[6:]
    with pytest.raises(ValueError, match="empty prefix tree"):
        b.prefix_cache.restore(path)
    for bad in (dict(kv_dtype="int8"), dict(block_size=8),
                dict(track_summaries=True)):
        other = ServingEngine(tm, prefix_caching=True, device="cpu",
                              **_kw(**bad))
        with pytest.raises(ValueError, match="kv_meta"):
            other.prefix_cache.restore(path)
    small = ServingEngine(tm, prefix_caching=True, device="cpu",
                          **_kw(num_blocks=cached))
    assert small.prefix_cache.restore(path) == 0
    assert small.prefix_cache.cached_blocks == 0
    assert small.kv.blocks_in_use == 0
