"""The port's serving frontend and replica router against the JAX package.

At the port's test size (vocab 193, hidden 32, 2 layers, 4 heads, block
4, fp32, CPU, one JAX `GPTForGeneration` carried across by
`paddle_tpu_torch.convert`), tolerance 0 (greedy tokens are integers):

* **`FairQueue`** serves tenants in the JAX queue's round-robin order,
  bounded, with removal;
* **`ShadowRadixIndex`** gives the JAX index's matches and sizes over
  the JAX tests' cases and a random operation sequence, `on_migrate` and
  `remove` included;
* **`ReplicaHealth`** and the dispatch policies (affinity, round robin,
  dead replicas, block-size mismatch) over fake frontends;
* **`ServingFrontend`** — concurrent submissions and streams give the
  monolithic engine's (and the JAX engine's) tokens; cancellation
  reclaims the slot and blocks; deadlines expire; backpressure waits;
  tenants take turns; a failing step loop and `stop()` fail the
  in-flight handles; an idle frontend runs no step;
* **`ReplicaRouter`** — a routed mixed fleet keeps the monolithic
  tokens with affinity hits, failover and cancellation; the
  disaggregated fleet (1 prefill + 2 decode replicas) gives the JAX
  fleet's and the monolithic engine's tokens over the float pool and
  over int8 + draft_k=2 + prefix caching, with stream-ahead, a shed hop
  and a failover, auto-balance, every replica drained to zero blocks;
  roles are validated; adapter traffic keeps to its resident replica
  and out of the shadow tries.
"""
import asyncio
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTForGeneration as JaxGPT
from paddle_tpu.serving.batcher import FairQueue as JaxFairQueue
from paddle_tpu.serving.distributed import ReplicaRouter as JaxRouter
from paddle_tpu.serving.distributed import ShadowRadixIndex as JaxShadow
from paddle_tpu.serving.engine import ServingEngine as JaxEngine
from paddle_tpu.serving.frontend import ServingFrontend as JaxFrontend
from paddle_tpu_torch.convert import load_jax_gpt
from paddle_tpu_torch.serving import make_random_adapter
from paddle_tpu_torch.serving.batcher import FairQueue
from paddle_tpu_torch.serving.distributed import (NoReplicaAvailable,
                                                  ReplicaHealth,
                                                  ReplicaRouter,
                                                  ShadowRadixIndex)
from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.frontend import (DeadlineExceeded,
                                               FrontendClosed,
                                               RequestCancelled,
                                               RequestMigrated,
                                               ServingFrontend)

VOCAB, HEADS = 193, 4


# ------------------------------------------------------------ FairQueue


def test_fair_queue_round_robin_matches_jax():
    rng = np.random.RandomState(0)
    ops = [("push", f"t{rng.randint(3)}", i) if rng.rand() < 0.6
           else ("pop",) for i in range(200)]
    outs = []
    for q in (FairQueue(max_pending=16), JaxFairQueue(max_pending=16)):
        got = []
        for op in ops:
            got.append(q.push(op[1], op[2]) if op[0] == "push"
                       else q.pop())
        got.append(len(q))
        outs.append(got)
    assert outs[0] == outs[1]
    q = FairQueue(max_pending=16)
    for i in range(3):
        q.push("a", f"a{i}")
    q.push("b", "b0")
    q.push("c", "c0")
    assert [q.pop() for _ in range(5)] == ["a0", "b0", "c0", "a1", "a2"]
    assert q.pop() is None


def test_fair_queue_bounded_and_remove():
    q = FairQueue(max_pending=2)
    assert q.push("a", 1) and q.push("b", 2)
    assert q.full and not q.push("a", 3)
    q.pop()
    assert q.push("a", 3)
    q = FairQueue(max_pending=8)
    q.push("a", "x")
    q.push("a", "y")
    assert q.remove("x") and not q.remove("x")
    assert list(q.items()) == ["y"]
    assert q.pop() == "y" and len(q) == 0


# --------------------------------------------------------- shadow index


def test_shadow_index_cases():
    idx = ShadowRadixIndex(block_size=4)
    idx.insert("r0", list(range(10)))
    assert [idx.match("r0", list(range(n))) for n in (10, 8, 6, 3)] == \
        [8, 8, 4, 0]
    assert idx.match("r0", [9] * 5) == 0 and idx.match("r1", range(10)) == 0
    idx = ShadowRadixIndex(block_size=2, capacity_blocks=3)
    idx.insert("a", [1, 2, 3, 4])
    idx.insert("a", [5, 6, 7, 8])
    assert idx.size("a") == 3
    assert idx.match("a", [5, 6, 7, 8]) == 4
    assert idx.match("a", [1, 2, 3, 4]) == 2
    idx = ShadowRadixIndex(block_size=1, capacity_blocks=2)
    idx.insert("a", [1, 2, 3, 4])
    assert idx.size("a") == 2 and idx.match("a", [1, 2, 3, 4]) == 2
    idx.drop("a")
    assert idx.size("a") == 0 and idx.match("a", [1, 2]) == 0


def test_shadow_on_migrate_and_remove():
    idx = ShadowRadixIndex(block_size=4)
    seq = list(range(12))
    idx.insert("a", seq)
    idx.on_migrate("a", "b", seq)
    assert (idx.match("a", seq), idx.match("b", seq)) == (0, 12)
    assert (idx.size("a"), idx.size("b")) == (0, 3)
    head = list(range(8))
    a_tail, b_tail = head + [101, 102, 103, 104], head + [201, 202, 203, 204]
    idx.insert("r", a_tail)
    idx.insert("r", b_tail)
    assert idx.remove("r", a_tail) == 1       # only a's own leaf
    assert (idx.match("r", a_tail), idx.match("r", b_tail)) == (8, 12)
    assert idx.remove("ghost", [1, 2, 3, 4]) == 0
    assert idx.remove("r", [9, 9, 9, 9]) == 0
    idx = ShadowRadixIndex(block_size=1, capacity_blocks=4)
    for i in range(4):
        idx.insert("r", [10 + i])
    idx.remove("r", [10])
    idx.insert("r", [50])
    assert idx.size("r") == 4
    assert all(idx.match("r", [t]) == 1 for t in (11, 12, 13, 50))


def test_shadow_index_matches_jax_on_random_ops():
    rng = np.random.RandomState(7)
    heads = [rng.randint(1, 9, 8).tolist() for _ in range(3)]
    ops = []
    for _ in range(400):
        seq = heads[rng.randint(3)] + rng.randint(1, 9, rng.randint(
            0, 10)).tolist()
        r = int(rng.randint(3))
        ops.append((("insert", "match", "remove", "on_migrate", "drop")[
            rng.choice(5, p=[0.4, 0.3, 0.12, 0.15, 0.03])], r, seq))
    results = []
    for idx in (ShadowRadixIndex(2, capacity_blocks=12),
                JaxShadow(2, capacity_blocks=12)):
        got = []
        for kind, r, seq in ops:
            if kind == "on_migrate":
                got.append(idx.on_migrate(r, (r + 1) % 3, seq))
            elif kind == "drop":
                got.append(idx.drop(r))
            else:
                got.append(getattr(idx, kind)(r, seq))
            got.append(tuple(idx.size(i) for i in range(3)))
        results.append(got)
    assert results[0] == results[1]


# ------------------------------------------------- health and dispatch


class _FakeTask:
    def __init__(self):
        self._done = False

    def done(self):
        return self._done


class _FakeScheduler:
    def __init__(self):
        self.queue = []
        self.num_active = 0


class _FakeEngine:
    def __init__(self, block_size=4):
        self.block_size = block_size
        self.scheduler = _FakeScheduler()
        self.clock = time.monotonic


class _FakeFrontend:
    def __init__(self):
        self.engine = _FakeEngine()
        self._fair = []
        self._task = _FakeTask()
        self._closed = False


def test_health_probes_and_events():
    fes = [_FakeFrontend(), _FakeFrontend()]
    h = ReplicaHealth(fes)
    assert h.alive(0) and h.alive(1) and h.num_up == 2
    fes[0]._task._done = True
    assert not h.alive(0)
    assert h.snapshot()["down"] == [0] and h.snapshot()["up"] == [1]
    fes[1]._closed = True
    assert not h.alive(1)

    async def run():
        h2 = ReplicaHealth([_FakeFrontend()])
        ev = h2.down_event(0)
        h2.mark_down(0)
        assert ev.is_set()
        h2.mark_up(0)
        assert not ev.is_set() and h2.down_event(0) is ev and h2.alive(0)
        h2.mark_down(0)
        assert ev.is_set()
        assert h2.add(_FakeFrontend()) == 1 and h2.alive(1)

    asyncio.run(run())


def test_dispatch_policies():
    r = ReplicaRouter([_FakeFrontend(), _FakeFrontend()])
    head = list(range(100, 112))
    first, hit1 = r._pick(head + [1, 2])
    r.frontends[first].engine.scheduler.num_active = 3
    second, hit2 = r._pick(head + [3, 4])
    assert (hit1, hit2, second, r.affinity_hits) == (False, True, first, 1)
    r = ReplicaRouter([_FakeFrontend(), _FakeFrontend()])
    r.frontends[0].engine.scheduler.num_active = 2
    assert r._pick([1, 2, 3, 4, 5]) == (1, False)
    r = ReplicaRouter([_FakeFrontend(), _FakeFrontend()],
                      policy="round_robin")
    assert [r._pick(list(range(50, 62)))[0] for _ in range(4)] == \
        [0, 1, 0, 1]
    r = ReplicaRouter([_FakeFrontend(), _FakeFrontend()])
    r.health.mark_down(0)
    assert r._pick([1, 2, 3, 4])[0] == 1
    r.quiesce(1)
    with pytest.raises(NoReplicaAvailable):
        r._pick([1, 2, 3, 4])
    r.unquiesce(1)
    r.health.mark_down(1)
    with pytest.raises(NoReplicaAvailable):
        r._pick([1, 2, 3, 4])
    fes = [_FakeFrontend(), _FakeFrontend()]
    fes[1].engine.block_size = 8
    with pytest.raises(ValueError, match="block_size"):
        ReplicaRouter(fes)
    with pytest.raises(ValueError, match="policy"):
        ReplicaRouter([_FakeFrontend()], policy="random")


# ----------------------------------------------------------- engines


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


def _prompts(n=3, seed=0, lo=5, hi=20):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, int(k)).tolist()
            for k in rng.randint(lo, hi, n)]


async def _mid_stream(fes, idxs):
    """The first of replicas `idxs` seen holding a decode with a token
    out (waits up to 30 s for one)."""
    for _ in range(30_000):
        for i in idxs:
            if any(r is not None and r.state == "decode" and r.output
                   for r in fes[i].engine.scheduler.slots):
                return i
        await asyncio.sleep(0.001)
    raise AssertionError(f"no replica of {idxs} held a live decode")


async def _shed_one(router, idxs):
    """Shed one live decode from the first of replicas `idxs` holding
    one."""
    while not router.shed(await _mid_stream(router.frontends, idxs), 1):
        await asyncio.sleep(0.001)


def _drain_check(*engines):
    for eng in engines:
        assert eng.scheduler.num_active == 0
        if eng.prefix_cache is not None:
            eng.prefix_cache.evict_all()
        assert eng.kv.blocks_in_use == 0
        assert eng.kv.allocator.invariant_ok


# ------------------------------------------------------------- frontend


def test_frontend_submit_and_stream_match_generation(models):
    """Concurrent submissions (three tenants) and a stream give the
    monolithic engine's tokens, which are the JAX engine's."""
    jm, tm = models
    prompts = _prompts(6, seed=0, lo=3, hi=13)
    want = _port(tm).generate_batch(prompts, 6)
    assert want == _jax(jm).generate_batch(prompts, 6)

    async def run():
        eng = _port(tm, prefix_caching=True)
        async with ServingFrontend(eng, max_pending=8) as fe:
            outs = await asyncio.gather(*[
                fe.submit(p, max_new_tokens=6, tenant=f"t{i % 3}")
                for i, p in enumerate(prompts)])
            streamed = [t async for t in fe.stream(prompts[0], 6)]
        return outs, streamed, eng

    outs, streamed, eng = asyncio.run(run())
    assert outs == want and streamed == want[0]
    _drain_check(eng)


def test_frontend_cancellation_reclaims(models):
    _, tm = models
    p_long, p_other = _prompts(2, seed=1)
    want_long = _port(tm).generate_batch([p_long], 30)[0]
    want_other = _port(tm).generate_batch([p_other], 6)[0]

    async def run():
        eng = _port(tm, max_slots=2)
        async with ServingFrontend(eng) as fe:
            async def consume_two():
                got = []
                async for t in fe.stream(p_long, max_new_tokens=30):
                    got.append(t)
                    if len(got) == 2:
                        break
                return got
            two, other = await asyncio.gather(
                consume_two(), fe.submit(p_other, max_new_tokens=6))
            for _ in range(50):
                if eng.scheduler.num_active == 0:
                    break
                await asyncio.sleep(0.02)
            # a handle cancelled by hand surfaces RequestCancelled
            gen = fe.stream([5, 6, 7], max_new_tokens=40)
            await gen.__anext__()
            fe._live[0].cancel()
            fe._wake.set()
            with pytest.raises(RequestCancelled):
                while True:
                    await gen.__anext__()
            return two, other, eng

    two, other, eng = asyncio.run(run())
    assert two == want_long[:2] and other == want_other
    _drain_check(eng)


def test_frontend_deadlines(models):
    _, tm = models

    async def run():
        eng = _port(tm)
        async with ServingFrontend(eng, max_pending=1) as fe:
            with pytest.raises(DeadlineExceeded):
                await fe.submit([1, 2, 3], max_new_tokens=4, timeout=-1.0)
            with pytest.raises(DeadlineExceeded):
                await fe.submit([3, 4, 5], max_new_tokens=4, timeout=0.0)
        # a submit stuck behind a saturated queue still expires
        eng = _port(tm)
        fe = ServingFrontend(eng, max_pending=1, engine_queue_depth=0)
        async with fe:
            blocker = asyncio.ensure_future(fe.submit([1, 2], 2))
            await asyncio.sleep(0.05)
            t0 = eng.clock()
            with pytest.raises(DeadlineExceeded):
                await fe.submit([3, 4], max_new_tokens=2, timeout=0.2)
            assert eng.clock() - t0 < 5.0
            blocker.cancel()
            try:
                await blocker
            except (asyncio.CancelledError, FrontendClosed,
                    RequestCancelled):
                pass

    asyncio.run(run())


def test_frontend_backpressure_and_fairness(models):
    _, tm = models
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, VOCAB, 4).tolist() for _ in range(5)]
    want = _port(tm).generate_batch(prompts, 4)
    order = []

    async def run():
        eng = _port(tm, max_slots=2)
        async with ServingFrontend(eng, max_pending=1) as fe:
            outs = await asyncio.gather(*[fe.submit(p, 4)
                                          for p in prompts])
        eng = _port(tm, max_slots=1)
        real = eng.submit

        def spying(prompt_ids, *a, **kw):
            order.append(kw.get("tenant", "default"))
            return real(prompt_ids, *a, **kw)
        eng.submit = spying
        async with ServingFrontend(eng, max_pending=16,
                                   engine_queue_depth=1) as fe:
            tasks = [asyncio.ensure_future(fe.submit(p, 3, tenant="a"))
                     for p in prompts + prompts[:1]]
            await asyncio.sleep(0)                # a's flood lands first
            tasks.append(asyncio.ensure_future(
                fe.submit(prompts[2], 3, tenant="b")))
            await asyncio.gather(*tasks)
        return outs

    assert asyncio.run(run()) == want
    assert order.index("b") <= 2, order


def test_frontend_failures_and_idle(models):
    _, tm = models

    async def run():
        eng = _port(tm)

        def boom():
            raise RuntimeError("device exploded")
        eng.step = boom
        async with ServingFrontend(eng) as fe:
            with pytest.raises(RuntimeError, match="exploded"):
                await asyncio.wait_for(fe.submit([1, 2, 3], 4), 10)
        eng = _port(tm)
        fe = ServingFrontend(eng)
        await fe.start()
        gen = fe.stream([5, 6, 7], 40)
        await gen.__anext__()                     # in flight now
        await fe.stop()
        with pytest.raises(FrontendClosed):
            while True:
                await gen.__anext__()
        with pytest.raises(FrontendClosed):
            await fe.submit([1, 2], 2)
        _drain_check(eng)
        eng = _port(tm)
        async with ServingFrontend(eng, max_pending=8) as fe:
            await asyncio.sleep(0.1)
            pre = fe.step_calls
            out = await fe.submit([5, 6, 7], 4)
            busy = fe.step_calls
            await asyncio.sleep(0.1)
            return pre, busy, fe.step_calls, out, eng

    pre, busy, after, out, eng = asyncio.run(run())
    assert pre == 0 and busy > 0 and len(out) == 4 and after == busy
    assert eng.steps_run <= busy


# --------------------------------------------------------- mixed fleet


def test_routed_mixed_fleet(models):
    """A routed mixed fleet keeps the engine's tokens, hits its shadow
    tries, never double counts admitted dispatches, and cancels
    cleanly."""
    _, tm = models
    rng = np.random.RandomState(0)
    head = rng.randint(1, VOCAB, 12).tolist()
    prompts = [head + rng.randint(1, VOCAB, 3).tolist()
               for _ in range(5)] + _prompts(3, seed=3, lo=6, hi=8)
    want = _port(tm).generate_batch(prompts, 6)
    long_want = _port(tm).generate_batch([prompts[-1]], 30)[0]

    async def run():
        fes = [ServingFrontend(_port(tm, max_slots=3, prefix_caching=True),
                               max_pending=16) for _ in range(2)]
        router = ReplicaRouter(fes)
        async with router:
            outs = [await router.submit(p, 6) for p in prompts]
            got = []
            async for tok in router.stream(prompts[-1], 30):
                assert sum(router._inflight) == 0
                got.append(tok)
                if len(got) == 2:
                    break
            await asyncio.sleep(0.1)
        return outs, got, router

    outs, got, router = asyncio.run(run())
    assert outs == want and got == long_want[:2]
    assert router.affinity_hits >= 4 and router._inflight == [0, 0]
    _drain_check(*[fe.engine for fe in router.frontends])


@pytest.mark.parametrize("kill", ["task", "step"])
def test_mixed_fleet_failover(models, kill):
    _, tm = models
    prompts = _prompts(3, seed=2, lo=5, hi=12)
    want = _port(tm).generate_batch(prompts, 40)

    async def run():
        fes = [ServingFrontend(_port(tm, max_slots=3, prefix_caching=True),
                               max_pending=16) for _ in range(2)]
        router = ReplicaRouter(fes, probe_interval=0.02)
        async with router:
            tasks = [asyncio.ensure_future(router.submit(p, 40))
                     for p in prompts]
            victim = await _mid_stream(fes, (0, 1))
            if kill == "task":
                fes[victim]._task.cancel()      # dies without cleanup
            else:
                def boom():
                    raise RuntimeError("injected crash")
                fes[victim].engine.step = boom
            outs = await asyncio.gather(*tasks)
        return outs, router

    outs, router = asyncio.run(run())
    assert outs == want
    assert router.failovers >= 1 and router.health.snapshot()["down"]


# --------------------------------------------------- disaggregated fleet


def _fleet(make, router_cls, frontend_cls, n_decode=2, migration=None,
           **dec_kw):
    pre = make("prefill", max_slots=3, prefix_caching=True)
    decs = [make("decode", max_slots=3, **dec_kw) for _ in range(n_decode)]
    fes = [frontend_cls(e, max_pending=16) for e in [pre] + decs]
    return router_cls(fes, roles=["prefill"] + ["decode"] * n_decode,
                      probe_interval=0.02, migration=migration), fes


MATRIX = {"float": {}, "int8-spec-prefix": dict(
    kv_dtype="int8", draft_k=2, prefix_caching=True)}


def _matrix_makers(models, case):
    jm, tm = models
    kw = MATRIX[case]

    def port(role, **k):
        k = dict(kw, **k)
        if role == "prefill":
            k.pop("draft_k", None)
        return _port(tm, role, **k)

    def jax(role, **k):
        k = dict(kw, **k)
        if role == "prefill":
            k.pop("draft_k", None)
        return _jax(jm, role, **k)
    return port, jax


@pytest.mark.parametrize("case", sorted(MATRIX))
def test_disagg_fleet_matches_jax_and_monolithic(models, case):
    jm, tm = models
    prompts = _prompts(6, seed=1)
    want = _port(tm, **MATRIX[case]).generate_batch(prompts, 10)
    port, jax = _matrix_makers(models, case)
    runs = []
    for make, rcls, fcls in ((port, ReplicaRouter, ServingFrontend),
                             (jax, JaxRouter, JaxFrontend)):
        router, fes = _fleet(make, rcls, fcls, **(
            {"kv_dtype": "int8"} if case != "float" else {}))

        async def run():
            async with router:
                return await asyncio.gather(*[router.submit(p, 10)
                                              for p in prompts])
        runs.append((asyncio.run(run()), router, fes))
    (tout, trouter, tfes), (jout, jrouter, _) = runs
    assert tout == want == jout
    st = trouter.stats()
    assert st["migrations"] == {"handoff": len(prompts), "shed": 0}
    assert st["role_dispatches"]["prefill"] == len(prompts)
    assert st["role_dispatches"]["decode"] == len(prompts)
    # every exported block crossed the wire once and was imported once
    sent = st["transport"]["blocks_sent"]
    assert sent == tfes[0].engine.kv.blocks_exported == sum(
        fe.engine.kv.blocks_imported for fe in tfes[1:]) > 0
    assert st["transport"]["tickets_sent"] == len(prompts)
    jst = jrouter.stats()["transport"]
    assert (sent, len(prompts)) == (jst["blocks_sent"], jst["tickets_sent"])
    # the payload is exactly the blocks' bytes; the rest is frame headers
    kv = tfes[0].engine.kv
    per_block = sum(p[:, 0].numel() * p.element_size() for p in kv._pools())
    assert 0 < st["transport"]["bytes_sent"] - sent * per_block < 4096 * (
        sent + len(prompts))
    _drain_check(*[fe.engine for fe in tfes])


def test_blocks_stream_ahead_of_the_ticket(models):
    """A long prompt prefills over several steps; its completed blocks
    ship before the ticket, whose own chunks start past block 0."""
    _, tm = models
    long_prompt = np.random.RandomState(9).randint(1, VOCAB, 40).tolist()
    want = _port(tm).generate_batch([long_prompt], 6)[0]
    router, fes = _fleet(lambda r, **k: _port(tm, r, **k), ReplicaRouter,
                         ServingFrontend, n_decode=1)
    seen = []
    orig = router.transport.send_ticket

    def spy(src, dst, key, ticket):
        seen.append([c.start for c in ticket.chunks])
        return orig(src, dst, key, ticket)
    router.transport.send_ticket = spy

    async def run():
        async with router:
            return await router.submit(long_prompt, 6)

    assert asyncio.run(run()) == want
    assert seen and seen[0] and seen[0][0] > 0
    assert router.transport.blocks_sent == -(-len(long_prompt) // 4)
    _drain_check(*[fe.engine for fe in fes])


@pytest.mark.parametrize("case", sorted(MATRIX))
def test_disagg_shed_and_failover_stay_lossless(models, case):
    _, tm = models
    prompts = _prompts(4, seed=2)
    want = _port(tm, **MATRIX[case]).generate_batch(prompts, 40)
    port, _ = _matrix_makers(models, case)
    router, fes = _fleet(port, ReplicaRouter, ServingFrontend, **(
        {"kv_dtype": "int8"} if case != "float" else {}))

    async def run():
        async with router:
            tasks = [asyncio.ensure_future(router.submit(p, 40))
                     for p in prompts]
            await _shed_one(router, (1, 2))       # a shed mid-stream...
            # ...then kill a decode replica holding a live decode
            victim = await _mid_stream(fes, (1, 2))

            def boom():
                raise RuntimeError("injected decode crash")
            fes[victim].engine.step = boom
            return await asyncio.gather(*tasks), victim

    outs, victim = asyncio.run(run())
    assert outs == want
    st = router.stats()
    assert st["migrations"]["shed"] >= 1
    _drain_check(*[fe.engine for i, fe in enumerate(fes) if i != victim])


def test_prefill_failover_restarts_the_pipeline(models):
    """The prefill replica's step raises mid-prefill (its stream-ahead
    already shipping): the requests restart on the other prefill replica,
    the abandoned transfers are dropped, and the caller sees each token
    once."""
    _, tm = models
    prompts = _prompts(4, seed=8, lo=30, hi=46)
    want = _port(tm).generate_batch(prompts, 12)
    make = lambda r, **k: _port(tm, r, **k)           # noqa: E731
    fes = [ServingFrontend(make("prefill", max_slots=2), max_pending=16),
           ServingFrontend(make("prefill", max_slots=2), max_pending=16),
           ServingFrontend(make("decode", max_slots=4), max_pending=16)]
    router = ReplicaRouter(fes, roles=["prefill", "prefill", "decode"],
                           probe_interval=0.02)
    real = fes[0].engine.step
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] > 1:
            raise RuntimeError("injected prefill crash")
        return real()
    fes[0].engine.step = flaky

    async def run():
        async with router:
            return await asyncio.gather(*[router.submit(p, 12)
                                          for p in prompts])

    assert asyncio.run(run()) == want
    # one failover for each request the dead replica held
    assert router.failovers >= 1 and router.health.snapshot()["down"] == [0]
    assert router.stats()["migrations"]["handoff"] == len(prompts)
    assert not router.transport._inbox
    _drain_check(fes[1].engine, fes[2].engine)


def test_auto_balance_sheds(models):
    _, tm = models
    prompts = _prompts(6, seed=3)
    want = _port(tm).generate_batch(prompts, 40)
    router, fes = _fleet(lambda r, **k: _port(tm, r, **k), ReplicaRouter,
                         ServingFrontend,
                         migration={"imbalance": 2, "interval": 0.02})

    async def run():
        async with router:
            return await asyncio.gather(*[router.submit(p, 40)
                                          for p in prompts])

    assert asyncio.run(run()) == want
    assert router.stats()["migrations"]["shed"] >= 1
    assert router.migration["max_per_tick"] == 1
    _drain_check(*[fe.engine for fe in fes])
    quiet, _ = _fleet(lambda r, **k: _port(tm, r, **k), ReplicaRouter,
                      ServingFrontend, migration={"imbalance": 1000})
    assert quiet.rebalance() == 0


def test_mixed_dispatch_replica_moves_no_kv_until_shed(models):
    """roles=["mixed", "decode"]: requests served on the mixed replica
    move no KV; a shed of its live decode migrates with parity and counts
    as a shed."""
    _, tm = models
    prompts = _prompts(3, seed=5)
    want = _port(tm).generate_batch(prompts, 40)

    def fleet():
        return ReplicaRouter(
            [ServingFrontend(_port(tm, max_slots=3, prefix_caching=True),
                             max_pending=16),
             ServingFrontend(_port(tm, "decode", max_slots=3),
                             max_pending=16)],
            roles=["mixed", "decode"], probe_interval=0.02)

    async def run(router, shed):
        async with router:
            tasks = [asyncio.ensure_future(router.submit(p, 40))
                     for p in prompts]
            if shed:
                await _shed_one(router, (0,))
            return await asyncio.gather(*tasks)

    router = fleet()
    assert asyncio.run(run(router, False)) == want
    st = router.stats()
    assert st["migrations"] == {"handoff": 0, "shed": 0}
    assert st["transport"]["blocks_sent"] == 0
    router = fleet()
    assert asyncio.run(run(router, True)) == want
    st = router.stats()
    assert st["migrations"]["shed"] >= 1 and st["migrations"]["handoff"] == 0
    _drain_check(*[fe.engine for fe in router.frontends])


def test_role_validation(models):
    _, tm = models
    pre, dec = _port(tm, "prefill"), _port(tm, "decode")
    fes = [ServingFrontend(pre), ServingFrontend(dec)]
    with pytest.raises(ValueError, match="engine role"):
        ReplicaRouter(fes, roles=["decode", "prefill"])
    with pytest.raises(ValueError, match="decode-capable"):
        ReplicaRouter([fes[0]], roles=["prefill"])
    with pytest.raises(ValueError, match="mixed/prefill/decode"):
        ReplicaRouter(fes, roles=["prefill", "weird"])
    with pytest.raises(ValueError, match="identical KV geometry"):
        ReplicaRouter([ServingFrontend(pre), ServingFrontend(
            _port(tm, "decode", kv_dtype="int8"))],
            roles=["prefill", "decode"])
    with pytest.raises(ValueError, match="disaggregated fleet"):
        ReplicaRouter([ServingFrontend(_port(tm)),
                       ServingFrontend(_port(tm))], migration=True)


def test_direct_prefill_submit_surfaces_migration(models):
    _, tm = models
    fe = ServingFrontend(_port(tm, "prefill"))

    async def run():
        async with fe:
            await fe.submit(_prompts()[0], max_new_tokens=8)

    with pytest.raises(RequestMigrated) as ei:
        asyncio.run(run())
    assert len(ei.value.ticket.output) == 1


def test_fleet_lifecycle(models):
    """quiesce / is_drained / add_replica on a running disaggregated
    fleet: a quiesced decode replica takes no new request, an added one
    does, with the engine's tokens."""
    _, tm = models
    prompts = _prompts(4, seed=11)
    want = _port(tm).generate_batch(prompts, 8)
    router, fes = _fleet(lambda r, **k: _port(tm, r, **k), ReplicaRouter,
                         ServingFrontend, n_decode=1)

    async def run():
        async with router:
            first = await router.submit(prompts[0], 8)
            router.quiesce(1)
            assert router.is_drained(1)
            with pytest.raises(ValueError, match="engine role"):
                await router.add_replica(ServingFrontend(_port(
                    tm, "prefill")), role="decode")
            idx = await router.add_replica(ServingFrontend(
                _port(tm, "decode", max_slots=3)), role="decode")
            rest = await asyncio.gather(*[router.submit(p, 8)
                                          for p in prompts[1:]])
            return [first] + rest, idx

    outs, idx = asyncio.run(run())
    assert outs == want and idx == 2
    assert router.frontends[1].engine.kv.blocks_imported < \
        router.frontends[2].engine.kv.blocks_imported
    _drain_check(*[fe.engine for fe in router.frontends])


# -------------------------------------------------------------- adapters


def test_adapter_affinity_over_two_tenants(models):
    """Same-tenant requests land where their adapter is resident, each
    tenant's tokens are a solo engine's, and adapter traffic never
    teaches the shadow tries."""
    _, tm = models
    rng = np.random.RandomState(31)
    ads = {t: make_random_adapter(tm.decoder, 4, seed=i + 1, scale=0.3)
           for i, t in enumerate(("a", "b"))}
    prompts = [rng.randint(1, VOCAB, n).tolist() for n in (5, 7, 6, 9, 4, 8)]

    async def run():
        router = ReplicaRouter([ServingFrontend(
            _port(tm, max_slots=3, max_adapters=3, lora_rank=4),
            max_pending=16) for _ in range(2)])
        for t, w in ads.items():
            router.register_adapter(t, w)
        async with router:
            outs = [await router.submit(p, 5, adapter_id=("a", "b")[i % 2])
                    for i, p in enumerate(prompts)]
        return outs, router

    outs, router = asyncio.run(run())
    assert router.adapter_affinity_hits >= len(prompts) - 2
    assert router.affinity_hits == 0
    assert all(router.shadow.size(i) == 0 for i in range(2))
    for t in ("a", "b"):
        solo = _port(tm, max_adapters=2, lora_rank=4)
        solo.register_adapter(t, ads[t])
        idxs = [i for i in range(len(prompts)) if ("a", "b")[i % 2] == t]
        reqs = [solo.submit(prompts[i], 5, adapter_id=t) for i in idxs]
        solo.run()
        assert [list(r.output) for r in reqs] == [outs[i] for i in idxs]


def test_adapter_request_hands_off_with_its_pin(models):
    """A tenant's request in a disaggregated fleet re-pins its adapter on
    the decode replica and keeps the solo engine's tokens; the pins come
    back."""
    _, tm = models
    ad = make_random_adapter(tm.decoder, 4, seed=5, scale=0.3)
    prompts = _prompts(3, seed=12)
    solo = _port(tm, max_adapters=2, lora_rank=4)
    solo.register_adapter("a", ad)
    reqs = [solo.submit(p, 8, adapter_id="a") for p in prompts]
    solo.run()
    router, fes = _fleet(lambda r, **k: _port(
        tm, r, max_adapters=2, lora_rank=4, **k), ReplicaRouter,
        ServingFrontend, n_decode=1)
    router.register_adapter("a", ad)

    async def run():
        async with router:
            return await asyncio.gather(*[router.submit(
                p, 8, adapter_id="a") for p in prompts])

    assert asyncio.run(run()) == [list(r.output) for r in reqs]
    assert router.stats()["migrations"]["handoff"] == len(prompts)
    for fe in fes:
        assert fe.engine.adapters.total_pins == 0
    _drain_check(*[fe.engine for fe in fes])
