"""Disaggregated prefill/decode serving of the port against the JAX package.

At the port's test size (vocab 193, hidden 32, 2 layers, 4 heads, block
4, fp32, CPU, one JAX `GPTForGeneration` carried across by
`paddle_tpu_torch.convert`), tolerance 0 (greedy tokens are integers):

* **Codec** — the port's `encode_chunk` and the JAX package's give the
  same bytes for the same blocks of fp32, bf16, int8 and fp8_e4m3 pools,
  with scales and with key summaries (the port hands bf16 and fp8 out as
  their bits and names them by their logical dtype), each side decodes
  the other's frames bit for bit, the state frames match, and a bad
  magic, version or kind is refused;
* **`import_into_slot`** — multi-chunk coverage, gaps, short cover and a
  dry pool leave the port's cache in the JAX cache's state;
* **the in-process transport** counts the JAX transport's bytes;
* **engine handoff** — the JAX engines' and the port's prefill ->
  decode handoff and decode -> decode shed give the monolithic engine's
  tokens over the acceptance matrix (float; int8 + draft_k=2 + prefix
  caching), a JAX ticket resumes on the port's decode engine, a ticket
  waits for blocks then admits, a migrant survives preemption, a request
  finishing at its first token never migrates, a penalized decode role
  and a 4-tick decode role keep the monolithic tokens, and a mismatched
  ticket is refused;
* **thread safety** — the K3 / K4 launch counters take 8 threads x
  10,000 increments exactly, and two threads reaching an unbuilt kernel
  run its compiler once.
"""
import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTForGeneration as JaxGPT
from paddle_tpu.serving import batcher as jb
from paddle_tpu.serving.distributed import transport as jt
from paddle_tpu.serving.engine import ServingEngine as JaxEngine
from paddle_tpu.serving.kv_cache import PagedKVCache as JaxKV
from paddle_tpu_torch.convert import load_jax_gpt
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import grouped_matmul as tgm
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.serving import batcher as tb
from paddle_tpu_torch.serving.distributed import TPServingEngine
from paddle_tpu_torch.serving.distributed import transport as tt
from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.kv_cache import PagedKVCache, _bits

VOCAB, HEADS = 193, 4

#: JAX pool dtypes by kv_dtype (the port's pools hold the same bits)
_JNP = {None: jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8,
        "fp8_e4m3": jnp.float8_e4m3fn}


# ---------------------------------------------------------------- codec


def _pool_pair(kv_dtype=None, summaries=False, num_blocks=17):
    """(JAX cache, port cache) of one geometry, their pools filled with
    the same random contents."""
    geo = dict(num_blocks=num_blocks, block_size=4, max_slots=4,
               max_blocks_per_slot=6, dtype="float32", kv_dtype=kv_dtype,
               summaries=summaries)
    jkv, tkv = JaxKV(2, 3, 5, **geo), PagedKVCache(2, 3, 5, device="cpu",
                                                   **geo)
    rng = np.random.RandomState(3)
    arrays = []
    for i, p in enumerate(jkv._pools()):
        if i < 2 and kv_dtype == "int8":
            a = rng.randint(-127, 128, p.shape).astype(np.int8)
        else:
            a = np.asarray(jnp.asarray(rng.randn(*p.shape).astype(
                np.float32)).astype(_JNP[kv_dtype] if i < 2
                                    else jnp.float32))
        arrays.append(a)
    jkv._set_pools([jnp.asarray(a) for a in arrays])
    for a, p in zip(arrays, tkv._pools()):
        b = _bits(p)
        b.copy_(torch.from_numpy(a.view(b.numpy().dtype).copy()))
    return jkv, tkv


POOLS = [(d, s) for d in (None, "bfloat16", "int8", "fp8_e4m3")
         for s in (False, True)]


@pytest.mark.parametrize("kv_dtype,summaries", POOLS)
def test_chunk_frames_match_jax(kv_dtype, summaries):
    """Port and JAX frames of the same non-contiguous blocks are the same
    bytes, and each side decodes the other's bit for bit."""
    jkv, tkv = _pool_pair(kv_dtype, summaries)
    assert tkv.kv_meta() == jkv.kv_meta()
    for start, ids in ((0, [5, 2, 9]), (3, [1]), (1, [16, 4, 7, 3, 11])):
        ja = jkv.export_blocks(ids)
        ta = tkv.export_blocks(ids)
        jf = jt.encode_chunk(jkv.kv_meta(), jt.BlockChunk(start, len(ids),
                                                          ja))
        tf = tt.encode_chunk(tkv.kv_meta(), tt.BlockChunk(start, len(ids),
                                                          ta))
        assert tf == jf
        meta, chunk = tt.decode_chunk(jf)
        assert meta == tkv.kv_meta()
        assert (chunk.start, chunk.count) == (start, len(ids))
        for a, b in zip(chunk.arrays, ta):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        _, jchunk = jt.decode_chunk(tf)
        for a, b in zip(jchunk.arrays, ja):
            assert str(a.dtype) == str(b.dtype)
            assert a.tobytes() == np.asarray(b).tobytes()
        # and the decoded port chunk imports into a fresh port pool as
        # the source's blocks, bit for bit
        _, dst = _pool_pair(kv_dtype, summaries)
        got = dst.allocator.alloc(len(ids))
        dst.import_blocks(got, chunk.arrays)
        for s, d in zip(ids, got):
            for ps, pd in zip(tkv._pools(), dst._pools()):
                assert torch.equal(_bits(ps)[:, s], _bits(pd)[:, d])


def _tickets(meta, chunks=()):
    kw = dict(prompt=[1, 2, 3], output=[9, 8], max_new_tokens=16,
              eos_token_id=None, deadline=12.5, tenant="t0", slot_len=4,
              total_blocks=1, kv_meta=meta, submit_time=1.0,
              first_token_time=2.0, cache_hit_tokens=4, preemptions=1,
              created_at=3.0, adapter_id="a", trace_id="tr")
    return (jt.MigrationTicket(chunks=list(chunks), **kw),
            tt.MigrationTicket(chunks=list(chunks), **kw))


def test_state_frames_match_jax():
    jkv, tkv = _pool_pair()
    jtk, ttk = _tickets(jkv.kv_meta())
    assert tt.encode_state(ttk) == jt.encode_state(jtk)
    state = tt.decode_state(jt.encode_state(jtk))
    rebuilt = tt.MigrationTicket(chunks=[], **state)
    assert rebuilt.state_dict() == ttk.state_dict()


def test_bad_frames_refused():
    _, tkv = _pool_pair()
    frame = tt.encode_chunk(tkv.kv_meta(), tt.BlockChunk(
        0, 1, tkv.export_blocks([1])))
    with pytest.raises(ValueError, match="magic"):
        tt.decode_chunk(b"NOPE" + frame[4:])
    bad = frame.replace(b'"v": 1', b'"v": 2', 1)
    with pytest.raises(ValueError, match="version"):
        tt.decode_chunk(bad)
    with pytest.raises(ValueError, match="state"):
        tt.decode_state(frame)
    with pytest.raises(ValueError, match="chunk"):
        tt.decode_chunk(tt.encode_state(_tickets(tkv.kv_meta())[1]))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_transport_counts_match_jax(kv_dtype):
    """Both in-process transports count the same bytes, blocks and
    tickets for the same chunks, and hand back the same assembly."""
    jkv, tkv = _pool_pair(kv_dtype)
    jtr, ttr = jt.InProcessTransport(), tt.InProcessTransport()
    jtr.send_chunk("p", "d", "k", jkv.kv_meta(), jt.BlockChunk(
        0, 2, jkv.export_blocks([3, 7])))
    ttr.send_chunk("p", "d", "k", tkv.kv_meta(), tt.BlockChunk(
        0, 2, tkv.export_blocks([3, 7])))
    jtk, _ = _tickets(jkv.kv_meta(), [jt.BlockChunk(
        2, 1, jkv.export_blocks([9]))])
    _, ttk = _tickets(tkv.kv_meta(), [tt.BlockChunk(
        2, 1, tkv.export_blocks([9]))])
    jtr.send_ticket("p", "d", "k", jtk)
    ttr.send_ticket("p", "d", "k", ttk)
    for f in ("bytes_sent", "bytes_received", "blocks_sent",
              "tickets_sent"):
        assert getattr(ttr, f) == getattr(jtr, f), f
    with pytest.raises(KeyError):
        ttr.collect("d", "other")
    got = ttr.collect("d", "k")
    assert [(c.start, c.count) for c in got.chunks] == [(0, 2), (2, 1)]
    assert got.state_dict() == ttk.state_dict()
    assert not ttr.pending("d", "k")


# ------------------------------------------------------ import_into_slot


def _state(kv):
    return (kv.block_tables.tolist(), kv.slot_lens.tolist(),
            [kv.slot_blocks(s) for s in range(kv.max_slots)],
            dict(kv.allocator._refs), list(kv.allocator._free))


def _chunks(mod, kv, ids, split_at=None):
    parts = [(0, ids)] if split_at is None else [(0, ids[:split_at]),
                                                 (split_at, ids[split_at:])]
    return [mod.BlockChunk(s, len(p), kv.export_blocks(p))
            for s, p in parts]


def test_import_into_slot_assembles_like_jax():
    jsrc, tsrc = _pool_pair()
    jdst, tdst = _pool_pair()
    ids = [5, 2, 8]
    jc = _chunks(jt, jsrc, ids, split_at=2)[::-1]
    tc = _chunks(tt, tsrc, ids, split_at=2)[::-1]
    assert jdst.import_into_slot(0, 11, jc)
    assert tdst.import_into_slot(0, 11, tc)
    assert _state(tdst) == _state(jdst)
    assert tdst.allocator.invariant_ok
    for s, d in zip(ids, tdst.slot_blocks(0)):
        for ps, pd in zip(tsrc._pools(), tdst._pools()):
            assert torch.equal(_bits(ps)[:, s], _bits(pd)[:, d])
    with pytest.raises(ValueError, match="not empty"):
        tdst.import_into_slot(0, 11, tc)


@pytest.mark.parametrize("case", ["gap", "short", "zero"])
def test_import_into_slot_refuses_bad_coverage_like_jax(case):
    """Gaps and short cover raise before anything is allocated, on both
    sides, with the same message."""
    jsrc, tsrc = _pool_pair()
    jdst, tdst = _pool_pair()
    start, n, slot_len = {"gap": (1, 2, 12), "short": (0, 2, 12),
                          "zero": (0, 2, 0)}[case]
    errs = []
    for mod, src, dst in ((jt, jsrc, jdst), (tt, tsrc, tdst)):
        with pytest.raises(ValueError) as ei:
            dst.import_into_slot(0, slot_len, [mod.BlockChunk(
                start, n, src.export_blocks([1, 2]))])
        errs.append(str(ei.value))
        assert dst.allocator.num_used == 0 and dst.allocator.invariant_ok
    assert errs[0] == errs[1]


def test_import_into_slot_dry_pool_like_jax():
    """A dry pool returns False with the state unchanged; once blocks
    free, the same chunks import."""
    jsrc, tsrc = _pool_pair()
    jdst, tdst = _pool_pair(num_blocks=3)
    for mod, src, dst in ((jt, jsrc, jdst), (tt, tsrc, tdst)):
        hog = dst.allocator.alloc(2)
        chunks = [mod.BlockChunk(0, 2, src.export_blocks([1, 2]))]
        before = _state(dst)
        assert dst.import_into_slot(0, 8, chunks) is False
        assert _state(dst) == before
        dst.allocator.free(hog)
        assert dst.import_into_slot(0, 8, chunks)
        assert dst.allocator.invariant_ok
    assert _state(tdst) == _state(jdst)


# ------------------------------------------------------- engine handoff


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


def _geo(kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("block_size", 4)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("cache_dtype", "float32")
    return kw


def _port(tm, role="mixed", **kw):
    return ServingEngine(tm, role=role, device="cpu", **_geo(kw))


def _jax(jm, role="mixed", **kw):
    return JaxEngine(jm, role=role, seed=0, **_geo(kw))


def _prompts(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, int(k)).tolist()
            for k in rng.randint(5, 20, n)]


def _handoff_all(pre, reqs, max_steps=100):
    for _ in range(max_steps):
        if all(r.state in ("handoff", "finished") for r in reqs):
            return
        pre.step()
    raise AssertionError([r.state for r in reqs])


def _drain_check(*engines):
    for eng in engines:
        assert eng.scheduler.num_active == 0
        if eng.prefix_cache is not None:
            eng.prefix_cache.evict_all()
        assert eng.kv.blocks_in_use == 0
        assert eng.kv.allocator.invariant_ok


def _handoff(make, mod, prompts, new, **kw):
    """Prefill on one engine, hand every request off to a decode engine
    through `mod`'s transport; returns (outputs, tickets' (slot_len,
    output, total_blocks), engines)."""
    pre = make("prefill", **{k: v for k, v in kw.items()
                             if k != "draft_k"})
    dec = make("decode", **kw)
    reqs = [pre.submit(p, new) for p in prompts]
    _handoff_all(pre, reqs)
    t = mod.InProcessTransport()
    dreqs, seen = [], []
    for i, r in enumerate(reqs):
        first = list(r.output)
        ticket = pre.extract_request(r)
        assert r.state == "migrated"
        assert ticket.output == first            # the first token rides
        assert ticket.slot_len == len(r.prompt)
        seen.append((ticket.slot_len, ticket.output, ticket.total_blocks))
        t.send_ticket(0, 1, f"k{i}", ticket)
        dreqs.append(dec.submit_migrated(t.collect(1, f"k{i}")))
    assert pre.scheduler.num_active == 0          # slots freed at extract
    dec.run()
    return [list(r.output) for r in dreqs], seen, (pre, dec)


MATRIX = [dict(), dict(kv_dtype="int8", draft_k=2, prefix_caching=True)]


@pytest.mark.parametrize("kw", MATRIX, ids=["float", "int8-spec-prefix"])
def test_handoff_matches_jax_and_monolithic(models, kw):
    jm, tm = models
    prompts = _prompts()
    oracle = _port(tm, **kw).generate_batch(prompts, 10)
    assert oracle == _jax(jm, **kw).generate_batch(prompts, 10)
    tout, tseen, tengs = _handoff(lambda r, **k: _port(tm, r, **k), tt,
                                  prompts, 10, **kw)
    jout, jseen, jengs = _handoff(lambda r, **k: _jax(jm, r, **k), jt,
                                  prompts, 10, **kw)
    assert tout == oracle == jout
    assert tseen == jseen
    _drain_check(*tengs, *jengs)


def test_jax_ticket_resumes_on_the_port(models):
    """A JAX prefill engine's tickets, through the JAX codec's frames,
    decoded by the port's codec, resume on the port's decode engine."""
    jm, tm = models
    prompts = _prompts(seed=4)
    oracle = _port(tm).generate_batch(prompts, 8)
    pre = _jax(jm, "prefill")
    dec = _port(tm, "decode")
    reqs = [pre.submit(p, 8) for p in prompts]
    _handoff_all(pre, reqs)
    dreqs = []
    for r in reqs:
        tk = pre.extract_request(r)
        chunks = [tt.decode_chunk(jt.encode_chunk(tk.kv_meta, c))[1]
                  for c in tk.chunks]
        state = tt.decode_state(jt.encode_state(tk))
        dreqs.append(dec.submit_migrated(tt.MigrationTicket(
            chunks=chunks, **state)))
    dec.run()
    assert [list(r.output) for r in dreqs] == oracle
    _drain_check(dec)


def test_role_budgets_match_jax(models):
    jm, tm = models
    for role in ("mixed", "prefill", "decode"):
        for draft_k in (0, 2):
            assert _port(tm, role, draft_k=draft_k).token_budget == \
                _jax(jm, role, draft_k=draft_k).token_budget
    for draft_k in (0, 2):
        for slots in (1, 3, 8):
            for requested in (None, 5, 64):
                kw = dict(requested=requested, verify_width=draft_k + 1,
                          role="decode")
                assert tb.choose_token_budget(slots, 4, **kw) == \
                    jb.choose_token_budget(slots, 4, **kw)
    dec, mixed = _port(tm, "decode"), _port(tm)
    assert dec.token_budget < mixed.token_budget
    assert dec.token_budget > dec.kv.max_slots
    with pytest.raises(ValueError, match="role"):
        _port(tm, "weird")
    assert _port(tm, "prefill", name="p0").name == "p0"


def test_request_finishing_at_first_token_never_migrates(models):
    _, tm = models
    pre = _port(tm, "prefill")
    req = pre.submit(_prompts()[0], max_new_tokens=1)
    while not req.done:
        pre.step()
    assert req.state == "finished"
    _drain_check(pre)


def test_shed_mid_stream_matches_monolithic(models):
    jm, tm = models
    p = _prompts()[0]
    oracle = _port(tm).generate_batch([p], 20)[0]
    pre, a, b = _port(tm, "prefill"), _port(tm, "decode"), _port(
        tm, "decode")
    t = tt.InProcessTransport()
    r = pre.submit(p, 20)
    _handoff_all(pre, [r])
    t.send_ticket(0, "a", "h", pre.extract_request(r))
    ra = a.submit_migrated(t.collect("a", "h"))
    while len(ra.output) < 5 and not ra.done:
        a.step()
    assert not ra.done
    tk = a.extract_request(ra)                 # a live shed, mid-decode
    assert tk.slot_len == len(p) + len(ra.output) - 1
    assert [c.start for c in tk.chunks] == [0]  # every block rides along
    t.send_ticket("a", "b", "s", tk)
    rb = b.submit_migrated(t.collect("b", "s"))
    b.run()
    assert list(rb.output) == oracle
    _drain_check(pre, a, b)


def test_ticket_waits_for_blocks_then_admits(models):
    """A ticket that cannot get its blocks waits at the queue head and
    admits once the pool frees: never a partial import."""
    _, tm = models
    pre = _port(tm, "prefill")
    dec = _port(tm, "decode", max_slots=2, num_blocks=8)
    p = [5] * 17                        # 5 blocks once decoding
    oracle = _port(tm).generate_batch([p, p[:9]], 6)
    t = tt.InProcessTransport()
    r1, r2 = pre.submit(p, 6), pre.submit(p[:9], 6)
    _handoff_all(pre, [r1, r2])
    t.send_ticket(0, 1, "a", pre.extract_request(r1))
    t.send_ticket(0, 1, "b", pre.extract_request(r2))
    d1 = dec.submit_migrated(t.collect(1, "a"))
    d2 = dec.submit_migrated(t.collect(1, "b"))
    dec.step()
    # d2 jumped the queue (appendleft) and fits; d1 must wait
    assert d2.state == "decode" and d1.state == "queued"
    assert d1.ticket is not None and dec.kv.allocator.invariant_ok
    dec.run()
    assert [list(d1.output), list(d2.output)] == oracle
    _drain_check(pre, dec)


def test_migrated_request_survives_preemption(models):
    _, tm = models
    p = _prompts()[0]
    oracle = _port(tm).generate_batch([p], 12)[0]
    pre, dec = _port(tm, "prefill"), _port(tm, "decode")
    t = tt.InProcessTransport()
    r = pre.submit(p, 12)
    _handoff_all(pre, [r])
    t.send_ticket(0, 1, "k", pre.extract_request(r))
    dr = dec.submit_migrated(t.collect(1, "k"))
    for _ in range(3):
        dec.step()
    assert dr.state == "decode" and dr.ticket is None
    dec.scheduler._preempt_victim(set())
    assert dr.state == "queued" and dr.slot == -1
    dec.run()
    assert list(dr.output) == oracle
    _drain_check(pre, dec)


DECODE_ROLES = {
    # greedy with a repetition penalty: the decode role rebuilds each
    # migrant's count histogram from prompt + output
    "penalized": dict(sampling=tb.SamplingConfig(repetition_penalty=1.3)),
    "4-ticks": dict(ticks_per_dispatch=4),
    "4-ticks-spec": dict(ticks_per_dispatch=4, draft_k=2),
}


@pytest.mark.parametrize("name", sorted(DECODE_ROLES))
def test_decode_role_variants_match_monolithic(models, name):
    jm, tm = models
    kw = DECODE_ROLES[name]
    prompts = _prompts(4, seed=6)
    prompts[3] = prompts[3][:4] * 4                # drafts get accepted
    penalty = {k: v for k, v in kw.items() if k == "sampling"}
    oracle = _port(tm, **penalty).generate_batch(prompts, 16)
    if penalty:
        assert oracle == _jax(jm, sampling=jb.SamplingConfig(
            repetition_penalty=1.3)).generate_batch(prompts, 16)
    out, _, engs = _handoff(lambda r, **k: _port(tm, r, **k), tt, prompts,
                            16, **kw)
    assert out == oracle
    _drain_check(*engs)


def test_submit_migrated_refuses_bad_tickets(models):
    _, tm = models
    pre, dec = _port(tm, "prefill"), _port(tm, "decode")
    q = pre.submit(_prompts()[0], 4)
    with pytest.raises(ValueError, match="extractable"):
        pre.extract_request(q)                  # still queued
    _handoff_all(pre, [q])
    ticket = pre.extract_request(q)
    other = _port(tm, "decode", kv_dtype="int8")
    with pytest.raises(ValueError, match="geometry"):
        other.submit_migrated(ticket)
    lost = tt.MigrationTicket(**dict(ticket.__dict__,
                                     chunks=ticket.chunks[:0]))
    with pytest.raises(ValueError, match="lost a chunk"):
        dec.submit_migrated(lost)
    needs = tt.MigrationTicket(**dict(ticket.__dict__, adapter_id="t0"))
    with pytest.raises(ValueError, match="adapter"):
        dec.submit_migrated(needs)
    assert not dec.scheduler.has_work
    dec.submit_migrated(ticket)
    dec.run()
    _drain_check(pre, dec)


def test_tp_engine_refuses_migration(models):
    _, tm = models
    with pytest.raises(NotImplementedError, match="role"):
        TPServingEngine(tm, tensor_parallel=1, device="cpu",
                        role="prefill", **_geo({}))
    eng = TPServingEngine(tm, tensor_parallel=1, device="cpu", **_geo({}))
    with pytest.raises(NotImplementedError):
        eng.extract_request(None)
    with pytest.raises(NotImplementedError):
        eng.submit_migrated(None)


# --------------------------------------------------------- thread safety


@pytest.mark.parametrize("mod,counter", [
    (tpa, "launch_count"), (tpa, "verify_int8_launch_count"),
    (tgm, "dense_launch_count"), (tgm, "int4_launch_count")])
def test_launch_counters_are_exact_under_threads(mod, counter):
    """8 threads x 10,000 increments read 80,000."""
    setattr(mod, counter, 0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)                 # switch threads often
    try:
        threads = [threading.Thread(target=lambda: [
            mod.count(counter) for _ in range(10_000)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(switch)
    assert getattr(mod, counter) == 80_000
    setattr(mod, counter, 0)


def test_thread_counts_hold_each_threads_launches():
    """Each thread's paged-attention tally holds its own launches while
    other threads launch: what attributes a fleet's launches to the
    replica whose step made them."""
    seen = {}

    def work(i):
        before = tpa.thread_counts()
        for _ in range(1000 * (i + 1)):
            tpa.count("launch_count")
        tpa.count("verify_launch_count", i)
        after = tpa.thread_counts()
        seen[i] = {c: n - before.get(c, 0) for c, n in after.items()}

    tpa.launch_count = tpa.verify_launch_count = 0
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(switch)
    for i in range(4):
        assert seen[i] == {"launch_count": 1000 * (i + 1),
                           "verify_launch_count": i}
    assert tpa.launch_count == 10_000 and tpa.verify_launch_count == 6
    tpa.launch_count = tpa.verify_launch_count = 0


def test_two_threads_build_a_kernel_once(tmp_path, monkeypatch):
    """Two threads reaching an unbuilt kernel at once run the compiler
    once (a fake toolkit whose nvcc counts its runs and sleeps)."""
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    log = tmp_path / "runs"
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo run >> {log}\n"
        "sleep 0.3\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo lib > "$2"\n')
    nvcc.chmod(0o755)
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", str(cuda))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    libs = []
    threads = [threading.Thread(
        target=lambda: libs.append(_build.build("paged_attention")))
        for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert log.read_text().count("run") == 1
    assert len(libs) == 2 and libs[0] == libs[1] and libs[0].exists()
    assert not [p for p in os.listdir(tmp_path / "build")
                if p.endswith(".tmp")]
