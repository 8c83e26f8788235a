"""Host-side serving bookkeeping of the PyTorch port against the JAX
package: BlockAllocator, PagedKVCache tables and lengths, pack_step,
choose_token_budget, prefill_chunk and Scheduler.plan, driven through
the same scripted sequences on both and compared exactly — plans,
block tables, slot lengths, queues and preemptions.
"""
import numpy as np
import pytest

from paddle_tpu.serving import batcher as jb
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu.serving import scheduler as jsch
from paddle_tpu_torch.serving import batcher as tb
from paddle_tpu_torch.serving import kv_cache as tkv
from paddle_tpu_torch.serving import scheduler as tsch


def test_block_allocator_matches():
    rng = np.random.RandomState(0)
    ja, ta = jkv.BlockAllocator(13), tkv.BlockAllocator(13)
    held = []
    for _ in range(200):
        op = rng.randint(3)
        if op == 0:
            n = int(rng.randint(1, 5))
            got = ja.alloc(n)
            assert ta.alloc(n) == got
            if got is not None:
                held.append(got)
        elif op == 1 and held:
            blocks = held.pop(rng.randint(len(held)))
            ja.free(blocks)
            ta.free(blocks)
        elif op == 2 and held:
            blocks = held[rng.randint(len(held))]
            ja.incref(blocks)
            ta.incref(blocks)
            held.append(list(blocks))
        assert ta._free == ja._free and ta._refs == ja._refs
        assert ta.invariant_ok and ta.num_used == ja.num_used
    with pytest.raises(ValueError):
        tkv.BlockAllocator(4).free([2])


def test_paged_kv_cache_bookkeeping_matches():
    args = (2, 2, 8)
    kw = dict(num_blocks=9, block_size=4, max_slots=3,
              max_blocks_per_slot=4)
    jc = jkv.PagedKVCache(*args, **kw)
    tc = tkv.PagedKVCache(*args, device="cpu", **kw)
    script = [("ensure", 0, 5), ("ensure", 1, 16), ("ensure", 2, 9),
              ("ensure", 0, 8), ("ensure", 2, 12), ("truncate", 1, 6),
              ("ensure", 2, 12), ("release", 0), ("ensure", 2, 16),
              ("truncate", 2, 0), ("ensure", 0, 13)]
    for op, slot, *n in script:
        if op == "ensure":
            assert tc.blocks_missing(slot, n[0]) == \
                jc.blocks_missing(slot, n[0])
            assert tc.ensure_capacity(slot, n[0]) == \
                jc.ensure_capacity(slot, n[0])
        elif op == "truncate":
            assert tc.truncate_slot(slot, n[0]) == \
                jc.truncate_slot(slot, n[0])
        else:
            jc.release_slot(slot)
            tc.release_slot(slot)
        np.testing.assert_array_equal(tc.block_tables, jc.block_tables)
        np.testing.assert_array_equal(tc.slot_lens, jc.slot_lens)
        assert [tc.slot_blocks(s) for s in range(3)] == \
            [jc.slot_blocks(s) for s in range(3)]
        assert tc.blocks_in_use == jc.blocks_in_use
        assert tc.utilization == jc.utilization
    with pytest.raises(ValueError):
        tc.ensure_capacity(0, 17)
    assert tuple(tc.k_pool.shape) == tuple(jc.k_pool.shape)


def test_pack_step_matches():
    decode = [(2, 42, 7), (0, 43, 3)]
    prefills = [(1, np.arange(5, dtype=np.int32), 0, True),
                (3, np.arange(9, 12, dtype=np.int32), 9, False)]
    want = jb.pack_step(16, 4, decode, prefills)
    got = tb.pack_step(16, 4, decode, prefills)
    for f in ("token_ids", "slot_ids", "positions", "sample_index"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in ("num_tokens", "decode_slots", "prefill_done",
              "prefill_tokens", "decode_tokens"):
        assert getattr(got, f) == getattr(want, f)
    with pytest.raises(ValueError):
        tb.pack_step(4, 4, [], [(0, np.arange(5, dtype=np.int32), 0,
                                 True)])


def test_budget_and_chunk_helpers_match():
    for slots in (1, 2, 4, 8, 33):
        for bs in (4, 8, 16):
            for req in (None, 1, 7, 64, 100):
                assert tb.choose_token_budget(slots, bs, req) == \
                    jb.choose_token_budget(slots, bs, req)
    for rem in (0, 1, 5, 16, 100):
        for left in (-1, 0, 1, 7, 16, 24, 256):
            assert tb.prefill_chunk(rem, left) == \
                jb.prefill_chunk(rem, left)
    assert tb.next_pow2(17) == jb.next_pow2(17)
    assert tb.round_up(17, 8) == jb.round_up(17, 8)


def _pair(num_blocks, block_size, max_slots, budget, mbps=8, clock=None):
    kw = dict(num_blocks=num_blocks, block_size=block_size,
              max_slots=max_slots, max_blocks_per_slot=mbps)
    ck = {"clock": clock} if clock else {}
    js = jsch.Scheduler(jkv.PagedKVCache(1, 1, 8, **kw),
                        max_slots=max_slots, token_budget=budget, **ck)
    ts = tsch.Scheduler(tkv.PagedKVCache(1, 1, 8, device="cpu", **kw),
                        max_slots=max_slots, token_budget=budget, **ck)
    return js, ts


def _plan_key(plan):
    return ([(s, int(t), p) for s, t, p in plan.decode],
            [(s, c.tolist(), st, done) for s, c, st, done in
             plan.prefills],
            [r.req_id for r in plan.expired])


def _same_state(js, ts):
    np.testing.assert_array_equal(ts.kv.block_tables, js.kv.block_tables)
    np.testing.assert_array_equal(ts.kv.slot_lens, js.kv.slot_lens)
    assert [r.req_id for r in ts.queue] == [r.req_id for r in js.queue]
    assert [None if r is None else (r.req_id, r.state, r.fed)
            for r in ts.slots] == \
        [None if r is None else (r.req_id, r.state, r.fed)
         for r in js.slots]
    assert ts.preemption_count == js.preemption_count


def _drive(js, ts, max_steps=200):
    """The engine's host loop without a model: plan, note_fed, then
    emit a deterministic token for every sampling slot and finish at
    the horizon — on both schedulers, checked after every step."""
    for _ in range(max_steps):
        if not js.has_work:
            break
        jp, tp = js.plan(), ts.plan()
        assert _plan_key(tp) == _plan_key(jp)
        js.note_fed(jp)
        ts.note_fed(tp)
        sampling = [s for s, _c, _st, done in jp.prefills if done] \
            + [s for s, _t, _p in jp.decode]
        for sch in (js, ts):
            for slot in sampling:
                req = sch.slots[slot]
                req.state = "decode"
                req.output.append((req.req_id * 7 + len(req.output)) % 50)
                if len(req.output) >= req.max_new_tokens:
                    sch.finish(req)
        _same_state(js, ts)
    assert not js.has_work and not ts.has_work


def test_plan_admission_under_full_queue():
    js, ts = _pair(num_blocks=17, block_size=4, max_slots=2, budget=16)
    for sch in (js, ts):
        for n in (3, 5, 2, 7, 4):
            sch.submit(list(range(1, n + 1)), 4)
    _drive(js, ts)


def test_plan_chunked_prefill():
    js, ts = _pair(num_blocks=33, block_size=4, max_slots=2, budget=8)
    for sch in (js, ts):
        sch.submit(list(range(1, 21)), 4)
        sch.submit(list(range(1, 12)), 3)
    _drive(js, ts)


def test_plan_preemption_when_blocks_run_dry():
    js, ts = _pair(num_blocks=9, block_size=2, max_slots=3, budget=16)
    for sch in (js, ts):
        sch.submit([1, 2], 6)
        sch.submit([3, 4, 5], 6)
        sch.submit([6, 7, 8, 9, 10, 11], 6)
    _drive(js, ts)
    assert ts.preemption_count > 0


def test_plan_deadlines_and_cancel():
    now = [0.0]
    js, ts = _pair(num_blocks=17, block_size=4, max_slots=1, budget=16,
                   clock=lambda: now[0])
    reqs = {}
    for name, sch in (("j", js), ("t", ts)):
        reqs[name] = [sch.submit([1, 2], 4),
                      sch.submit([3, 4], 4, deadline=5.0),
                      sch.submit([5, 6, 7], 4)]
    jp, tp = js.plan(), ts.plan()
    assert _plan_key(tp) == _plan_key(jp)
    js.note_fed(jp)
    ts.note_fed(tp)
    now[0] = 10.0
    assert js.cancel(reqs["j"][2]) and ts.cancel(reqs["t"][2])
    jp, tp = js.plan(), ts.plan()
    assert _plan_key(tp) == _plan_key(jp) and tp.expired
    assert reqs["t"][1].state == "expired"
    assert not ts.cancel(reqs["t"][2])
    _same_state(js, ts)
