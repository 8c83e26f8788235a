"""The port's request tracing, flight recorders and SLO plane against the
JAX package's.

`paddle_tpu_torch.serving.tracing` / `slo` and the hooks in the port's
scheduler, engine, adapter cache, transport, router and health layer,
held on the CPU (vocab 193, hidden 32, 2 layers, 4 heads, fp32) against
`paddle_tpu.serving`:

* `RequestTracer`, `SlidingWindowQuantile` and `SLOMonitor` give the
  JAX package's results for the same calls (the cases of
  tests/test_tracing.py: lifecycle and derive, shell traces, the
  monotone clamp, the event cap, idempotent terminals, reopen on
  re-dispatch, capacity eviction, numpy-percentile quantiles, window
  pruning, edge-triggered breaches, deadline misses, the gauges);
* **engine parity**: with recording on and one manual clock (set before
  each step, shared by both engines), each request's trace (event
  names, replicas, attributes, timestamps), both registries over
  `CONTRACT_METRICS` (values, histogram buckets and sums) and the
  flight records equal the JAX engine's, for a preempting dense engine,
  draft_k=3, 4 ticks a dispatch, the prefix cache, block-sparse decode,
  LoRA adapters, MoE and rank 0 of a tp = 2 engine (the gloo ranks of
  torch_tp_ranks.py against JAX's TPServingEngine). The JAX multi-tick
  engine runs with `multitick_async=False` and both are read after
  `flush_observability()`. Named exceptions: `compile_cache_size` (the
  port has no jit cache and records -1), the host-stall and adapter
  load-seconds counters (timed on other clocks: compared by presence),
  and the MoE aux-loss gauge (a float each framework reduces in its own
  order: rtol 1e-5);
* the stitching cases of tests/test_tracing.py — a failover, a
  preempted migrant, a stream abandoned after its handoff — give one
  trace with the JAX package's events;
* recording off records nothing (the JAX health layer sets its
  replicas-up gauge regardless: a recorded departure);
* tools/torch_trace_smoke.py's contract holds, run in-process.
"""
import asyncio
import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu as paddle
import torch_tp_ranks as tr
from paddle_tpu.models.gpt import GPTForGeneration as JaxGPT
from paddle_tpu.profiler import metrics as jm
from paddle_tpu.serving import metrics as jsm
from paddle_tpu.serving import slo as jslo
from paddle_tpu.serving import tracing as jtr
from paddle_tpu.serving.adapters import make_random_adapter as jax_adapter
from paddle_tpu.serving.distributed import InProcessTransport as JaxTransport
from paddle_tpu.serving.distributed import ReplicaHealth as JaxHealth
from paddle_tpu.serving.distributed import ReplicaRouter as JaxRouter
from paddle_tpu.serving.distributed import TPServingEngine as JaxTP
from paddle_tpu.serving.engine import ServingEngine as JaxEngine
from paddle_tpu.serving.frontend import ServingFrontend as JaxFrontend
from paddle_tpu_torch.convert import load_jax_gpt
from paddle_tpu_torch.profiler import metrics as tm
from paddle_tpu_torch.serving import metrics as tsm
from paddle_tpu_torch.serving import slo as tslo
from paddle_tpu_torch.serving import tracing as ttr
from paddle_tpu_torch.serving.adapters import make_random_adapter
from paddle_tpu_torch.serving.distributed import (InProcessTransport,
                                                  ReplicaHealth,
                                                  ReplicaRouter)
from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.frontend import ServingFrontend

VOCAB, HEADS, NEW = 193, 4, 8
MOE = dict(num_expert=4, top_k=2, capacity_factor=2.0)
#: (metrics, serving metrics, tracing, slo) of each package
PKG = {"jax": (jm, jsm, jtr, jslo), "torch": (tm, tsm, ttr, tslo)}
#: registry entries timed on a clock other than the shared manual one
OTHER_CLOCK = ("paddle_tpu_serving_host_stall_seconds_total",
               "paddle_tpu_serving_adapter_load_seconds_total")
AUX_LOSS = "paddle_tpu_moe_aux_loss"


def _recording(on):
    for m, _s, t, _slo in PKG.values():
        (m.enable if on else m.disable)()
        (t.enable if on else t.disable)()


def _reset():
    for m, _s, t, _slo in PKG.values():
        m.REGISTRY.reset()
        t.TRACER.reset()


@pytest.fixture(autouse=True)
def _clean():
    """Every test starts with recording off and empty registries and
    tracers, and leaves them so (the switches are process-wide)."""
    was = [(m._enabled, t._enabled) for m, _s, t, _slo in PKG.values()]
    _recording(False)
    _reset()
    yield
    _reset()
    for (wm, wt), (m, _s, t, _slo) in zip(was, PKG.values()):
        (m.enable if wm else m.disable)()
        (t.enable if wt else t.disable)()


def _arrays(jmodel):
    tensors = jmodel._gen_tensors()
    names = (["word_embeddings", "position_embeddings"]
             + list(jmodel._dec_names) + ["ln_f.weight", "ln_f.bias",
                                          "lm_head.weight"])
    return {n: np.asarray(t._data) for n, t in zip(names, tensors)}


def _jax_model(moe=None):
    paddle.seed(1234)
    jmodel = JaxGPT(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                    num_attention_heads=HEADS, max_position_embeddings=128,
                    compute_dtype="float32", moe=moe)
    jmodel.eval()
    return jmodel


@pytest.fixture(scope="module")
def models():
    """{kind: (JAX model, the port's on the CPU)}: dense and MoE, the
    same weights carried across by `load_jax_gpt`."""
    out = {}
    for kind, moe in (("dense", None), ("moe", MOE)):
        jmodel = _jax_model(moe)
        out[kind] = (jmodel, load_jax_gpt(_arrays(jmodel), HEADS, moe=moe,
                                          device="cpu"))
    return out


def _geo(kw):
    return dict(dict(max_slots=4, block_size=4, max_seq_len=64,
                     cache_dtype="float32", seed=0), **kw)


def _jax_engine(jmodel, role="mixed", **kw):
    return JaxEngine(jmodel, role=role, **_geo(kw))


def _port_engine(tmodel, role="mixed", **kw):
    return ServingEngine(tmodel, role=role, device="cpu", **_geo(kw))


def _prompt(n=9, seed=0):
    return np.random.RandomState(seed).randint(1, VOCAB, n).tolist()


# -------------------------------------------------- the tracer and SLO plane


def _lifecycle(t, slo, m):
    t.enable()
    clk = iter(float(i) for i in range(100))
    rt = t.RequestTracer(capacity=8, max_events=16, clock=lambda: next(clk))
    tid = rt.mint("tenantA")
    rt.event(tid, "enqueued", replica="e0", ts=1.0)
    rt.event(tid, "admitted", replica="e0", ts=1.5, kind="prefill")
    rt.event(tid, "first_token", replica="e0", ts=2.0)
    rt.event(tid, "decode_step", replica="e0", ts=2.25, gap=0.25, tokens=1)
    rt.event(tid, "handoff_export", replica="e0", ts=2.5)
    rt.event(tid, "decode_step", replica="e1", ts=2.75, gap=0.5, tokens=2)
    rt.event(tid, "decode_step", replica="e1")     # the tracer's clock
    rt.finish(tid, "finished", replica="e1")
    tr_ = rt.get(tid)
    return dict(trace=tr_.as_dict(), derive=tr_.derive(),
                monotone=tr_.monotone(), replicas=tr_.replicas,
                first=repr(tr_.first("first_token")), active=rt.active(),
                chrome=[{k: v for k, v in e.items() if k != "pid"}
                        for e in rt.chrome_events()],
                table=rt.summary_table())


def _shell(t, slo, m):
    t.enable()
    rt = t.RequestTracer(capacity=8, max_events=16)
    rt.event("tr-ghost", "decode_step", replica="e1", ts=1.0, tenant="t9")
    return dict(trace=rt.get("tr-ghost").as_dict(), active=len(rt.active()))


def _clamp_and_cap(t, slo, m):
    t.enable()
    m.enable()
    rt = t.RequestTracer(capacity=8, max_events=8)
    a = rt.mint()
    rt.event(a, "enqueued", ts=5.0)
    rt.event(a, "admitted", ts=4.0)            # skewed: clamped to 5.0
    b = rt.mint()
    for i in range(12):
        rt.event(b, "decode_step", ts=float(i))
    rt.finish(b, "finished", ts=99.0)          # lands past the cap
    return dict(a=rt.get(a).as_dict(), b=rt.get(b).as_dict(),
                dropped=m.REGISTRY.snapshot()[
                    "paddle_tpu_serving_trace_events_dropped_total"])


def _terminals_and_reopen(t, slo, m):
    t.enable()
    m.enable()
    rt = t.RequestTracer(capacity=8, max_events=16)
    a = rt.mint()
    rt.finish(a, "cancelled", ts=1.0)
    rt.finish(a, "finished", ts=2.0)           # the first terminal wins
    rt.event(a, "decode_step", ts=2.5)         # after a terminal: dropped
    b = rt.mint()
    rt.event(b, "enqueued", replica="e0", ts=1.0)
    rt.finish(b, "cancelled", replica="e0", ts=2.0)
    rt.event(b, "dispatched", replica="e1", ts=3.0)   # reopens
    reopened = (rt.get(b).done, len(rt.active()))
    rt.finish(b, "finished", replica="e1", ts=4.0)
    snap = m.REGISTRY.snapshot()
    return dict(a=rt.get(a).as_dict(), b=rt.get(b).as_dict(),
                reopened=reopened, replicas=rt.get(b).replicas,
                traces=snap["paddle_tpu_serving_trace_requests_total"],
                events=snap["paddle_tpu_serving_trace_events_total"],
                active=snap["paddle_tpu_serving_trace_active"])


def _capacity(t, slo, m):
    t.enable()
    rt = t.RequestTracer(capacity=2, max_events=16)
    a, b = rt.mint(), rt.mint()
    rt.finish(a, "finished")
    c = rt.mint()                              # evicts a (finished)
    d = rt.mint()                              # all open: evicts b
    out = dict(kept=[rt.get(x) is not None for x in (a, b, c, d)],
               dropped=rt.dropped_traces, active=len(rt.active()))
    rt.reset()
    out["after_reset"] = (rt.traces(), rt.active(), rt.dropped_traces)
    return out


def _disabled(t, slo, m):
    rt = t.RequestTracer(capacity=8, max_events=16)
    rt.event("tr-x", "enqueued", ts=1.0)
    rt.finish("tr-x", "finished")
    return dict(traces=rt.traces(), get=rt.get("tr-x"))


def _quantiles(t, slo, m):
    rng = np.random.RandomState(3)
    vals = rng.rand(64).tolist()
    w = slo.SlidingWindowQuantile(window_s=100.0, max_samples=128)
    for i, v in enumerate(vals):
        w.observe(v, ts=float(i) * 0.1)
    out = {q: w.quantile(q, 6.4) for q in (0.0, 0.5, 0.95, 0.99, 1.0)}
    assert out[0.95] == pytest.approx(np.percentile(vals, 95))
    p = slo.SlidingWindowQuantile(window_s=10.0, max_samples=128)
    p.observe(100.0, ts=0.0)
    p.observe(1.0, ts=50.0)
    out["pruned"] = (p.quantile(0.99, now=55.0), p.count(55.0),
                     p.quantile(0.5, now=1000.0))
    c = slo.SlidingWindowQuantile(window_s=1e9, max_samples=4)
    for i in range(10):
        c.observe(float(i), ts=float(i))
    out["capped"] = (c.dropped, c.total, c.quantile(0.0, now=10.0))
    return out


def _slo_config(t, slo, m):
    cfg = slo.SLOConfig.from_dict({"default": {"ttft_p95": 1.0},
                                   "tenants": {"vip": {"ttft_p95": 0.2}}})
    with pytest.raises(ValueError, match="unknown SLOConfig"):
        slo.SLOConfig.from_dict({"objectives": {}})
    return dict(vip=cfg.targets_for("vip"), other=cfg.targets_for("o"),
                defaults=slo.DEFAULT_OBJECTIVES)


def _breaches(t, slo, m):
    m.enable()
    clk = [100.0]
    mon = slo.SLOMonitor({"default": {"ttft_p95": 0.1},
                          "window_s": 20.0}, clock=lambda: clk[0])
    fired = []
    mon.on_breach(lambda *a: fired.append(a))
    reports = []
    mon.on_ttft("t", 0.05, 95.0)
    reports.append(mon.evaluate())
    mon.on_ttft("t", 5.0, 99.0)
    reports.append(mon.evaluate())
    reports.append(mon.evaluate())             # still burning: no re-fire
    clk[0] = 130.0                             # the window slides past
    mon.on_ttft("t", 0.05, 129.0)
    reports.append(mon.evaluate())
    mon.on_ttft("t", 5.0, 129.5)               # re-armed: fires again
    mon.on_inter_token("t", 0.5, 129.5)
    reports.append(mon.evaluate())
    snap = m.REGISTRY.snapshot()
    return dict(reports=reports, fired=fired, breaches=mon.breaches,
                gauges={n: snap[n] for n in (
                    "paddle_tpu_serving_slo_ttft_p95_seconds",
                    "paddle_tpu_serving_slo_burn_rate",
                    "paddle_tpu_serving_slo_breaches_total")})


def _deadlines(t, slo, m):
    m.enable()
    mon = slo.SLOMonitor({"default": {"deadline_miss_rate": 0.25},
                          "window_s": 100.0}, clock=lambda: 10.0)
    for i in range(8):
        mon.on_outcome("t", "finished", i == 0, float(i))
    first = mon.evaluate()
    for _ in range(4):
        mon.on_outcome("t", "expired", True, 9.0)
    return dict(first=first, second=mon.evaluate(), snap=m.REGISTRY.snapshot()[
        "paddle_tpu_serving_slo_deadline_miss_ratio"])


def _attach(t, slo, m):
    mon = slo.SLOMonitor({"default": {"ttft_p95": 10.0}})
    enabled = [t.enabled()]
    with mon:
        enabled.append(t.enabled())
        t.TRACER._notify("on_ttft", "t", 0.5, 1.0)
    t.TRACER._notify("on_ttft", "t", 0.5, 2.0)   # detached: ignored
    t.disable()
    return dict(enabled=enabled, total=mon._ttft["t"].total)


def _flight(t, slo, m):
    rec = t.StepFlightRecorder("fl", "decode", maxlen=3)
    for i in range(5):
        rec.note(ts=float(i), dur=0.001 * (i + 1), prefill_tokens=i,
                 decode_tokens=2 * i, ticks=i + 1, host_stall=0.5,
                 early_exit_finish=i % 2)
    return dict(summary=rec.summary(), records=list(rec.records),
                chrome=[{k: v for k, v in e.items() if k != "pid"}
                        for e in rec.chrome_events()])


UNIT_CASES = {f.__name__[1:]: f for f in (
    _lifecycle, _shell, _clamp_and_cap, _terminals_and_reopen, _capacity,
    _disabled, _quantiles, _slo_config, _breaches, _deadlines, _attach,
    _flight)}


@pytest.mark.parametrize("case", sorted(UNIT_CASES))
def test_tracer_and_slo_match_jax(case):
    results = {}
    for name, (m, _s, t, slo) in PKG.items():
        results[name] = UNIT_CASES[case](t, slo, m)
        _recording(False)
    assert results["torch"] == results["jax"]


def test_observer_errors_are_not_swallowed():
    """A departure the docstrings record: the JAX tracer and monitor
    swallow an observer's or a breach callback's exception, the port's
    raise at the call site."""
    ttr.enable()

    class Bad:
        def on_ttft(self, *a):
            raise RuntimeError("observer failed")
    rt = ttr.RequestTracer(capacity=4, max_events=8)
    rt.add_observer(Bad())
    with pytest.raises(RuntimeError, match="observer failed"):
        rt._notify("on_ttft", "t", 0.5, 1.0)
    mon = tslo.SLOMonitor({"default": {"ttft_p95": 0.1}},
                          clock=lambda: 1.0)
    mon.on_breach(lambda *a: 1 / 0)
    mon.on_ttft("t", 5.0, 1.0)
    with pytest.raises(ZeroDivisionError):
        mon.evaluate()


def test_breach_counted_once_after_raising_callback():
    """A sustained breach is one ok -> burning edge: after a breach
    callback raises, three more evaluations count nothing again. JAX's
    monitor (which swallows the raise) counts the same single breach;
    tolerance 0 on the counts."""
    _recording(True)
    counts = {}
    for pkg, (_m, sm, _t, slo) in PKG.items():
        mon = slo.SLOMonitor({"default": {"ttft_p95": 0.1}},
                             clock=lambda: 1.0)
        fired = []

        def bad(*a, fired=fired):
            fired.append(a[:2])
            raise ZeroDivisionError("callback failed")
        mon.on_breach(bad)
        mon.on_ttft("t", 5.0, 1.0)
        for _ in range(3):
            if pkg == "torch":
                with pytest.raises(ZeroDivisionError):
                    mon.evaluate()
                # after the first raise the edge is marked: the later
                # evaluations reach no callback and return
                break
            mon.evaluate()
        for _ in range(3):
            mon.evaluate()
        counter = sm.SERVING_SLO_BREACHES.labels("t", "ttft_p95").value
        counts[pkg] = (mon.breaches, counter, len(fired))
    assert counts["torch"] == counts["jax"] == (1, 1, 1)


# ------------------------------------------------------- engine parity


def _batch():
    rng = np.random.RandomState(0)
    return [[(rng.randint(1, VOCAB, n).tolist(), None)
             for n in (5, 9, 3, 12)]]


def _waves():
    """Two waves on a shared 8-token head; the second replays two
    conversations with a new suffix and one prompt exactly."""
    rng = np.random.RandomState(0)
    head = rng.randint(1, VOCAB, 8).tolist()
    first = [head + rng.randint(1, VOCAB, n).tolist() for n in (3, 6, 5)]
    second = [first[0] + rng.randint(1, VOCAB, 4).tolist(),
              first[2] + rng.randint(1, VOCAB, 3).tolist(), first[1]]
    return [[(p, None) for p in first], [(p, None) for p in second]]


def _repeat():
    rng = np.random.RandomState(0)
    return [[(rng.randint(1, VOCAB, 9).tolist(), None),
             ([5, 6, 7, 8] * 4, None), ([3, 1, 4] * 4, None)]]


def _sparse():
    rng = np.random.RandomState(5)
    return [[(rng.randint(1, VOCAB, n).tolist(), None)
             for n in (30, 9, 21)]]


def _tenants():
    rng = np.random.RandomState(2)
    return [[(rng.randint(1, VOCAB, n).tolist(), a)
             for n, a in ((7, None), (9, "t1"), (5, "t2"), (11, "t1"))]]


#: case -> (model kind, engine keywords, traffic)
ENGINE_CASES = {
    "dense_preempting": ("dense", dict(num_blocks=14), _batch),
    "draft3": ("dense", dict(draft_k=3), _repeat),
    "ticks4": ("dense", dict(ticks_per_dispatch=4), _batch),
    "prefix": ("dense", dict(prefix_caching=True, max_slots=2), _waves),
    "sparse": ("dense", dict(sparse_blocks=1, sparse_recent=1), _sparse),
    "adapters": ("dense", dict(max_adapters=3, lora_rank=4), _tenants),
    "moe": ("moe", {}, _batch),
}


def _serve_observed(pkg, model, kw, traffic):
    m, s, t, _slo = PKG[pkg]
    m.REGISTRY.reset()
    t.TRACER.reset()
    _recording(True)
    clock = tr.ManualClock()
    if pkg == "jax":
        eng = JaxEngine(model, clock=clock, name="e0",
                        multitick_async=False, **_geo(kw))
        make_adapter = jax_adapter
    else:
        eng = ServingEngine(model, clock=clock, name="e0", device="cpu",
                            **_geo(kw))
        make_adapter = make_random_adapter
    if kw.get("max_adapters"):
        for i, name in enumerate(("t1", "t2")):
            eng.register_adapter(name, make_adapter(
                model.decoder, 4, seed=i + 1, scale=0.3))
    reqs = tr.drive_observed(eng, clock, traffic(), NEW)
    out = tr.observed(eng, reqs, m, s, t)
    _recording(False)
    return out, eng


def _hold_observed(got, want):
    """The port's observed run against the JAX engine's, with the named
    exceptions."""
    assert got["tokens"] == want["tokens"]
    assert got["preemptions"] == want["preemptions"]
    for gt, wt in zip(got["traces"], want["traces"]):
        gt, wt = dict(gt), dict(wt)
        assert gt.pop("trace_id").startswith("tr-")
        wt.pop("trace_id")
        assert gt == wt
    for name, w in want["metrics"].items():
        g = got["metrics"][name]
        if name in OTHER_CLOCK:
            assert (g["type"], sorted(g["values"])) == \
                (w["type"], sorted(w["values"])), name
        elif name == AUX_LOSS:
            assert sorted(g["values"]) == sorted(w["values"])
            for k, v in w["values"].items():
                assert g["values"][k] == pytest.approx(v, rel=1e-5), k
        else:
            assert g == w, name
    assert got["flight_steps"] == want["flight_steps"] == len(got["flight"])
    for gr, wr in zip(got["flight"], want["flight"]):
        assert gr.pop("compile_cache_size") == -1
        wr.pop("compile_cache_size")
        assert gr == wr
    assert len(got["flight"]) == len(want["flight"])


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_observability_matches_jax(models, case):
    kind, kw, traffic = ENGINE_CASES[case]
    jmodel, tmodel = models[kind]
    want, _ = _serve_observed("jax", jmodel, kw, traffic)
    got, eng = _serve_observed("torch", tmodel, kw, traffic)
    _hold_observed(got, want)
    m = got["metrics"]
    # each case exercises what it names
    assert m["paddle_tpu_serving_requests_total"]["values"] == {
        "outcome=finished": float(len(got["tokens"]))}
    assert eng.flight.steps == eng.steps_run
    if case == "dense_preempting":
        assert got["preemptions"] > 0
    if case == "draft3":
        assert m["paddle_tpu_serving_draft_tokens_total"]["values"][
            "outcome=accepted"] > 0
    if case == "ticks4":
        assert eng.device_ticks_run > eng.dispatches_run
        assert "reason=finish" in m[
            "paddle_tpu_serving_early_exits_total"]["values"]
    if case == "prefix":
        assert m["paddle_tpu_serving_prefix_cache_hit_tokens_total"][
            "values"][""] > 0
    if case == "sparse":
        assert m["paddle_tpu_serving_kv_blocks_skipped_total"][
            "values"][""] > 0
    if case == "adapters":
        assert m["paddle_tpu_serving_adapter_cache_hits_total"][
            "values"][""] > 0
    if case == "moe":
        assert m["paddle_tpu_moe_expert_tokens_total"]["values"]


def test_tp2_rank0_observability_matches_jax(tmp_path):
    """Rank 0 of the port's tp = 2 engine (two gloo ranks, each with its
    own registry and tracer) against JAX's TPServingEngine."""
    paddle.seed(1234)
    jmodel = JaxGPT(vocab_size=tr.VOCAB, hidden_size=32, num_layers=2,
                    num_attention_heads=tr.HEADS,
                    max_position_embeddings=128, compute_dtype="float32")
    jmodel.eval()
    np.savez(tmp_path / "float.npz", **_arrays(jmodel))
    ranks = tr.run_ranks(2, str(tmp_path), [dict(
        name="observed", model="float", tp=2, ep=1, kw={},
        traffic="observed")])
    _recording(True)
    clock = tr.ManualClock()
    jeng = JaxTP(jmodel, tensor_parallel=2, clock=clock, name="e0",
                 multitick_async=False, **tr.BASE_KW)
    reqs = tr.drive_observed(jeng, clock, [[(p, None)
                                            for p in tr.prompts()]], tr.NEW)
    want = tr.observed(jeng, reqs, jm, jsm, jtr)
    got = ranks[0]["observed"]
    assert got["flight"][0]["tp"] == 2 and got["flight"][0]["ep"] == 1
    _hold_observed(got, want)
    # rank 1 makes the same decisions and records the same spans
    one = ranks[1]["observed"]
    assert one["tokens"] == got["tokens"]
    assert [[e["name"] for e in t["events"]] for t in one["traces"]] == \
        [[e["name"] for e in t["events"]] for t in got["traces"]]


def test_recording_off_records_nothing(models):
    _, tmodel = models["dense"]
    eng = _port_engine(tmodel, draft_k=2, prefix_caching=True)
    eng.generate_batch([_prompt(9), _prompt(5, seed=1)], max_new_tokens=6)
    assert ttr.TRACER.traces() == []
    assert eng.flight.steps == 0
    for name, entry in tm.REGISTRY.snapshot().items():
        for v in entry["values"].values():
            assert (v["count"] if entry["type"] == "histogram" else v) \
                == 0, name
    assert all(r.trace_id is None for r in eng.scheduler.slots if r)
    # a recorded departure: JAX's health layer sets its replicas-up gauge
    # with recording off; the port's records it only while on
    from test_torch_router import _FakeFrontend
    for health, sm in ((JaxHealth, jsm), (ReplicaHealth, tsm)):
        h = health([_FakeFrontend(), _FakeFrontend()])
        h.mark_down(0)
    assert jsm.ROUTER_REPLICAS_UP.value == 1
    assert tsm.ROUTER_REPLICAS_UP.value == 0
    tm.enable()
    h = ReplicaHealth([_FakeFrontend(), _FakeFrontend()])
    h.mark_down(1)
    assert tsm.ROUTER_REPLICAS_UP.value == 1
    h.mark_up(1)
    assert tsm.ROUTER_REPLICAS_UP.value == 2


# ------------------------------------------------------ stitching cases


def _names(trace):
    return [e.name for e in trace.events]


def _failover(pkg, models):
    """tests/test_tracing.py's failover: kill the serving replica after
    the second delivered token."""
    jmodel, tmodel = models["dense"]
    p = _prompt(9, seed=1)
    if pkg == "jax":
        engines = [_jax_engine(jmodel, max_slots=3, prefix_caching=True,
                               name=f"fo{i}") for i in range(2)]
        frontend, router_cls = JaxFrontend, JaxRouter
    else:
        engines = [_port_engine(tmodel, max_slots=3, prefix_caching=True,
                                name=f"fo{i}") for i in range(2)]
        frontend, router_cls = ServingFrontend, ReplicaRouter
    for e in engines:
        e.generate_batch([[7, 7]], max_new_tokens=1)
        e.prefix_cache.evict_all()
    _recording(True)
    fes = [frontend(e, max_pending=16) for e in engines]

    async def run():
        router = router_cls(fes, probe_interval=0.02)
        async with router:
            got = []
            async for tok in router.stream(p, max_new_tokens=16):
                got.append(tok)
                if len(got) == 2:
                    victim = max(range(2), key=router.queue_depth)

                    def boom():
                        raise RuntimeError("injected crash")
                    fes[victim].engine.step = boom
        return got, router

    out, router = asyncio.run(run())
    m, s, t, _slo = PKG[pkg]
    (trace,) = t.TRACER.traces()
    snap = m.REGISTRY.snapshot()
    return dict(out=out, failovers=router.failovers,
                outcome=trace.outcome, monotone=trace.monotone(),
                names=sorted(set(_names(trace))),
                finished=_names(trace).count("finished"),
                replicas=trace.replicas, active=t.TRACER.active(),
                traces=snap["paddle_tpu_serving_trace_requests_total"],
                failover_total=snap[
                    "paddle_tpu_serving_router_failovers_total"],
                outcomes=sorted(k for k, v in snap[
                    "paddle_tpu_serving_router_requests_total"][
                        "values"].items() if v))


def _preempted_migrant(pkg, models):
    """A migrant that is preempted re-prefills from its transported
    history; every span lands on the one trace the source minted. Driven
    by hand under the manual clock, so the traces are compared whole."""
    jmodel, tmodel = models["dense"]
    clock = tr.ManualClock()
    if pkg == "jax":
        pre = _jax_engine(jmodel, role="prefill", name="pp0", clock=clock)
        dec = _jax_engine(jmodel, role="decode", name="pd0", clock=clock)
        transport = JaxTransport()
    else:
        pre = _port_engine(tmodel, role="prefill", name="pp0", clock=clock)
        dec = _port_engine(tmodel, role="decode", name="pd0", clock=clock)
        transport = InProcessTransport()
    _recording(True)
    m, s, t, _slo = PKG[pkg]
    # the transport's span reads the tracer's clock: the manual one too
    real_clock, t.TRACER.clock = t.TRACER.clock, clock
    try:
        return _migrate_and_preempt(t, m, pre, dec, transport, clock)
    finally:
        t.TRACER.clock = real_clock


def _migrate_and_preempt(t, m, pre, dec, transport, clock):
    req = pre.submit(_prompt(10, seed=2), max_new_tokens=8)
    while req.state not in ("handoff", "finished"):
        clock.t += 0.125
        pre.step()
    assert req.state == "handoff"
    clock.t += 0.125
    ticket = pre.extract_request(req)
    assert ticket.trace_id == req.trace_id
    transport.send_ticket(0, 1, "k0", ticket)
    dreq = dec.submit_migrated(transport.collect(1, "k0"))
    clock.t += 0.125
    dec.step()                                 # import + decode
    assert dec.scheduler._preempt_victim(set()) is dreq
    while dec.scheduler.has_work:
        clock.t += 0.125
        dec.step()
    (trace,) = t.TRACER.traces()
    return dict(trace={k: v for k, v in trace.as_dict().items()
                       if k != "trace_id"},
                kinds=[e.attrs.get("kind") for e in trace.events
                       if e.name == "admitted"],
                replicas=trace.replicas, active=t.TRACER.active(),
                metrics={n: m.REGISTRY.snapshot()[n] for n in (
                    "paddle_tpu_serving_requests_total",
                    "paddle_tpu_serving_kv_blocks_migrated_total",
                    "paddle_tpu_serving_preemptions_total",
                    "paddle_tpu_serving_ttft_seconds",
                    "paddle_tpu_serving_inter_token_seconds",
                    "paddle_tpu_serving_trace_queue_wait_seconds")})


def _abandoned(pkg, models):
    """The caller walks away after its second token (past the handoff):
    the trace closes "cancelled", the inbox is dropped, every block
    comes back."""
    jmodel, tmodel = models["dense"]
    if pkg == "jax":
        engines = [_jax_engine(jmodel, role="prefill", max_slots=3,
                               name="cp0"),
                   _jax_engine(jmodel, role="decode", max_slots=3,
                               name="cd0")]
        frontend, router_cls = JaxFrontend, JaxRouter
    else:
        engines = [_port_engine(tmodel, role="prefill", max_slots=3,
                                name="cp0"),
                   _port_engine(tmodel, role="decode", max_slots=3,
                                name="cd0")]
        frontend, router_cls = ServingFrontend, ReplicaRouter
    for e in engines:
        e.generate_batch([[7, 7]], max_new_tokens=1)
    _recording(True)
    fes = [frontend(e, max_pending=16) for e in engines]

    async def run():
        router = router_cls(fes, roles=["prefill", "decode"],
                            probe_interval=0.02)
        async with router:
            got = []
            async for tok in router.stream(_prompt(8, seed=3),
                                           max_new_tokens=30):
                got.append(tok)
                if len(got) == 2:
                    break
            await asyncio.sleep(0.15)          # the cancellation lands
        return got, router

    got, router = asyncio.run(run())
    m, s, t, _slo = PKG[pkg]
    (trace,) = t.TRACER.traces()
    drained = [(e.scheduler.num_active, e.kv.blocks_in_use)
               for e in engines]
    return dict(got=len(got), outcome=trace.outcome,
                names=sorted(set(_names(trace)) - {"decode_step"}),
                active=t.TRACER.active(), inbox=router.transport._inbox,
                drained=drained)


STITCH_CASES = {"failover": _failover, "preempted_migrant":
                _preempted_migrant, "abandoned_after_handoff": _abandoned}


@pytest.mark.parametrize("case", sorted(STITCH_CASES))
def test_stitching_matches_jax(models, case):
    want = STITCH_CASES[case]("jax", models)
    _recording(False)
    _reset()
    got = STITCH_CASES[case]("torch", models)
    assert got == want
    assert got.get("active") == []
    if case == "failover":
        assert got["failovers"] >= 1 and got["outcome"] == "finished"
        assert "failover" in got["names"] and len(got["replicas"]) == 2
        assert got["finished"] == 1
    if case == "preempted_migrant":
        assert got["kinds"] == ["prefill", "import", "re_prefill"]
        assert got["replicas"] == ["0->1", "pd0", "pp0"]
    if case == "abandoned_after_handoff":
        assert got["outcome"] == "cancelled" and got["inbox"] == {}
        assert {"handoff_export", "migration_transport"} <= set(got["names"])
        assert got["drained"] == [(0, 0), (0, 0)]


def test_trace_smoke_tool(capsys):
    """tools/torch_trace_smoke.py's contract, in-process."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "torch_trace_smoke.py")
    spec = importlib.util.spec_from_file_location("torch_trace_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main() == 0
    out = capsys.readouterr().out
    for name in tsm.CONTRACT_METRICS:
        assert name in out
    assert "trace smoke OK: 8 stitched traces" in out
