"""Fleet-wide request-trace smoke run of the port, with its contract check.

The port's twin of tools/trace_smoke.py (the JAX package's contract):
a Poisson stream of requests through a 1-prefill + 2-decode
`ReplicaRouter` fleet of `paddle_tpu_torch` engines (int8 pools, the
prefill replica with the prefix cache, the decode replicas with
draft_k=2), every request handed off at its first token and one shed
between the decode replicas, with metrics, tracing and an `SLOMonitor`
on. It holds:

* **one stitched trace per request** — its events span the prefill
  replica, the transport hop and a decode replica, in monotone time,
  ending "finished", none dropped;
* **spans against histograms** — the span-derived TTFT, inter-token and
  queue-wait values fall in the registry histograms' buckets count for
  count, and their sums agree up to the order of summation (each value
  is the same float on both sides);
* **the transport** — the registry's bytes sent = received = the
  transport's own byte counters; the handoff-latency histogram counts
  every migration (handoffs and sheds);
* **zero orphans** — no open trace, no resident request and no held KV
  block after the drain;
* **the SLO plane** — an impossible TTFT target on one tenant fires
  exactly one edge-triggered breach while the other tenants stay ok;
* **the metric contract** — every name of `CONTRACT_METRICS` appears in
  the Prometheus dump.

`run_smoke(model, device)` runs it on any device (chip_smoke.py's phase
5q runs it on the card); the script runs a 2-layer, hidden-32 model on
the CPU:

    python tools/torch_trace_smoke.py

Exit status is non-zero on any violation.
"""
import bisect
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

N_REQUESTS = 8
MAX_NEW = 16
BREACH_TENANT = "tenant1"
#: the engines' geometry on the CPU (tools/trace_smoke.py's)
CPU_GEO = dict(max_slots=3, block_size=4, max_seq_len=64,
               cache_dtype="float32")


def workload(vocab, n=N_REQUESTS, head=12, tail=(4, 14)):
    """Deterministic Poisson stream, tools/trace_smoke.py's shape: a
    shared `head`-token prefix on half the prompts, three tenants in
    turn. Returns [(arrival seconds, tenant, prompt)]."""
    import random

    import numpy as np
    rng = np.random.RandomState(7)
    shared = rng.randint(1, vocab, head).tolist()
    gaps = random.Random(3)
    t, events = 0.0, []
    for i in range(n):
        t += 0.01 + min(gaps.expovariate(40.0), 0.15)
        rest = rng.randint(1, vocab, int(rng.randint(*tail))).tolist()
        events.append((t, f"tenant{i % 3}",
                       (shared + rest) if i % 2 == 0 else rest))
    return events


def fleet(model, device, geo):
    """Frontends over 1 prefill + 2 decode engines, named pre0, dec0 and
    dec1, each warmed with recording off."""
    from paddle_tpu_torch.serving.engine import ServingEngine
    from paddle_tpu_torch.serving.frontend import ServingFrontend
    kw = dict(geo, kv_dtype="int8", seed=0, device=device)
    engines = [ServingEngine(model, role="prefill", prefix_caching=True,
                             name="pre0", **kw)]
    engines += [ServingEngine(model, role="decode", draft_k=2,
                              name=f"dec{i}", **kw) for i in range(2)]
    for eng in engines:
        eng.generate_batch([[7, 7]], max_new_tokens=1)
        if eng.prefix_cache is not None:
            eng.prefix_cache.evict_all()
    return [ServingFrontend(e, max_pending=16) for e in engines]


def _buckets(values, bounds):
    """Cumulative counts of `values` at each upper bound and +Inf, as a
    histogram keeps them."""
    counts = [0] * (len(bounds) + 1)
    for v in values:
        counts[bisect.bisect_left(bounds, v)] += 1
    out, acc = [], 0
    for c in counts:
        acc += c
        out.append(acc)
    return out


def hold_histogram(failures, label, hist, values):
    """The histogram `hist` (unlabeled) observed exactly `values`."""
    child = hist._default()
    got = [c for _ub, c in child.cumulative()]
    if got != _buckets(values, list(child.buckets)):
        failures.append(f"{label}: histogram buckets {got} != the spans' "
                        f"{_buckets(values, list(child.buckets))}")
    span_sum = math.fsum(values)
    if not math.isclose(child.sum, span_sum, rel_tol=1e-9, abs_tol=1e-12):
        failures.append(f"{label}: histogram sum {child.sum!r} != the "
                        f"spans' {span_sum!r}")


def run_smoke(model, device="cpu", geo=None, vocab=193, tail=(4, 14),
              max_new=MAX_NEW):
    """Drive the fleet with recording on and check the contract.
    Returns (stats, failures); recording is left on, the caller turns
    it off (and reads the registry first)."""
    import asyncio

    from paddle_tpu_torch.profiler import metrics as pm
    from paddle_tpu_torch.serving import metrics as sm
    from paddle_tpu_torch.serving import slo, tracing
    from paddle_tpu_torch.serving.distributed import ReplicaRouter

    events = workload(vocab, tail=tail)
    failures = []
    fes = fleet(model, device, geo or CPU_GEO)
    warm_steps = [fe.engine.steps_run for fe in fes]
    router = ReplicaRouter(fes, roles=["prefill", "decode", "decode"],
                           probe_interval=0.02)
    # recording on only now: every histogram observation has its span
    pm.REGISTRY.reset()
    pm.enable()
    tracing.TRACER.reset()
    monitor = slo.SLOMonitor({
        # relaxed targets: the smoke holds the plumbing (exactly one
        # engineered breach), not production latencies
        "default": {"ttft_p95": 30.0, "inter_token_p99": 30.0,
                    "deadline_miss_rate": 0.5},
        "tenants": {BREACH_TENANT: {"ttft_p95": 1e-9}},
    }).attach()                                  # attach() enables tracing
    breach_log = []
    monitor.on_breach(lambda tenant, obj, burn, value, target:
                      breach_log.append((tenant, obj)))

    async def run():
        async def fire(ev, t0):
            t, tenant, prompt = ev
            delay = t - (asyncio.get_running_loop().time() - t0)
            if delay > 0:
                await asyncio.sleep(delay)
            return await router.submit(prompt, max_new_tokens=max_new,
                                       tenant=tenant)

        async def shed_once():
            for _ in range(2000):
                await asyncio.sleep(0.005)
                busiest = max((1, 2), key=router.queue_depth)
                if router.shed(busiest, 1):
                    return

        async with router:
            t0 = asyncio.get_running_loop().time()
            outs, _ = await asyncio.gather(
                asyncio.gather(*[fire(ev, t0) for ev in events]),
                shed_once())
        return outs

    outs = asyncio.run(run())
    if any(len(o) != max_new for o in outs):
        failures.append("not every request produced its full horizon")
    migrations = router.stats()["migrations"]
    if migrations["handoff"] != N_REQUESTS or migrations["shed"] < 1:
        failures.append(f"migrations {migrations}: want {N_REQUESTS} "
                        "handoffs and a shed")

    traces = tracing.TRACER.traces()
    if len(traces) != N_REQUESTS:
        failures.append(f"expected {N_REQUESTS} traces, got {len(traces)}")
    orphans = tracing.TRACER.active()
    if orphans:
        failures.append(f"{len(orphans)} open trace(s) after the drain")
    ttfts, gaps, waits = [], [], []
    for tr in traces:
        names = [e.name for e in tr.events]
        if tr.outcome != "finished" or not tr.monotone() \
                or tr.dropped_events:
            failures.append(f"{tr.trace_id}: outcome {tr.outcome!r}, "
                            f"monotone {tr.monotone()}, dropped "
                            f"{tr.dropped_events}")
        for needed in ("dispatched", "enqueued", "admitted",
                       "first_token", "handoff_export",
                       "migration_transport", "decode_admission",
                       "finished"):
            if needed not in names:
                failures.append(f"{tr.trace_id}: missing {needed!r} "
                                f"(events: {names})")
        engines = [r for r in tr.replicas if "->" not in r]
        hops = [r for r in tr.replicas if "->" in r]
        if "pre0" not in engines or not {"dec0", "dec1"} & set(engines) \
                or not hops:
            failures.append(f"{tr.trace_id}: replicas {tr.replicas}, want "
                            "the prefill replica, a hop and a decode one")
        d = tr.derive()
        if d["ttft"] is None or d["queue_wait"] is None:
            failures.append(f"{tr.trace_id}: TTFT / queue wait not "
                            "derivable from the spans")
            continue
        ttfts.append(d["ttft"])
        waits.append(d["queue_wait"])
        gaps += d["inter_token"]
    hold_histogram(failures, "TTFT", sm.SERVING_TTFT_SECONDS, ttfts)
    hold_histogram(failures, "inter-token",
                    sm.SERVING_INTER_TOKEN_SECONDS, gaps)
    hold_histogram(failures, "queue wait", sm.SERVING_TRACE_QUEUE_WAIT,
                    waits)

    t = router.transport
    sent = sm.SERVING_KV_TRANSPORT_BYTES.labels("sent").value
    received = sm.SERVING_KV_TRANSPORT_BYTES.labels("received").value
    if not (sent == received == t.bytes_sent == t.bytes_received > 0):
        failures.append(f"transport bytes: registry sent {sent}, received "
                        f"{received}; transport {t.bytes_sent} / "
                        f"{t.bytes_received}")
    n_mig = migrations["handoff"] + migrations["shed"]
    if sm.SERVING_HANDOFF_LATENCY.count != n_mig:
        failures.append(f"handoff histogram count "
                        f"{sm.SERVING_HANDOFF_LATENCY.count} != {n_mig} "
                        "migrations")

    for fe, warm in zip(fes, warm_steps):
        rec, steps = fe.engine.flight, fe.engine.steps_run - warm
        if rec.steps == 0 or rec.steps != steps:
            failures.append(f"{fe.engine.name}: {rec.steps} flight records "
                            f"for {steps} traced steps")

    report = monitor.evaluate()
    bad = report.get(BREACH_TENANT, {}).get("ttft_p95")
    if not bad or bad["ok"]:
        failures.append(f"{BREACH_TENANT} ttft_p95=1e-9 did not breach: "
                        f"{bad}")
    monitor.evaluate()                  # still burning: must not re-fire
    if breach_log != [(BREACH_TENANT, "ttft_p95")]:
        failures.append(f"breaches {breach_log}: want exactly one, "
                        "edge-triggered")
    for tenant, entry in report.items():
        for obj, r in entry.items():
            if tenant != BREACH_TENANT and not r["ok"]:
                failures.append(f"unexpected SLO breach {tenant}/{obj}")

    for fe in fes:
        eng = fe.engine
        if eng.scheduler.num_active or eng.scheduler.queue:
            failures.append(f"replica {eng.name} not drained")
        if eng.prefix_cache is not None:
            eng.prefix_cache.evict_all()
        if eng.kv.blocks_in_use or not eng.kv.allocator.invariant_ok:
            failures.append(f"replica {eng.name} holds "
                            f"{eng.kv.blocks_in_use} KV blocks")
    monitor.detach()
    text = pm.REGISTRY.to_prometheus()
    for name in sm.CONTRACT_METRICS:
        if name not in text:
            failures.append(f"serving metric missing from the dump: {name}")
    stats = {"traces": len(traces),
             "events": sum(len(tr.events) for tr in traces),
             "span_ttft_mean_ms": (math.fsum(ttfts) / len(ttfts) * 1e3
                                   if ttfts else 0.0),
             "handoffs": migrations["handoff"],
             "sheds": migrations["shed"],
             "transport_bytes": t.bytes_sent,
             "handoff_ms_mean": (sm.SERVING_HANDOFF_LATENCY.sum * 1e3
                                 / max(sm.SERVING_HANDOFF_LATENCY.count,
                                       1)),
             "breaches": monitor.breaches, "router": router,
             "engines": [fe.engine for fe in fes], "prometheus": text}
    return stats, failures


def cpu_model():
    """A 2-layer, hidden-32 GPT (vocab 193) drawn from torch seed 0."""
    import torch

    from paddle_tpu_torch.models.gpt import GPTForGeneration
    torch.manual_seed(0)
    return GPTForGeneration(vocab_size=193, hidden_size=32, num_layers=2,
                            num_attention_heads=4,
                            max_position_embeddings=128, device="cpu")


def main():
    from paddle_tpu_torch.profiler import metrics as pm
    from paddle_tpu_torch.serving import tracing
    try:
        stats, failures = run_smoke(cpu_model())
    finally:
        pm.disable()
        tracing.disable()
    print(stats["prometheus"])
    tracing.TRACER.reset()
    if failures:
        for f in failures:
            print(f"SMOKE FAILURE: {f}", file=sys.stderr)
        return 1
    print(f"trace smoke OK: {stats['traces']} stitched traces / "
          f"{stats['events']} events, span TTFT mean "
          f"{stats['span_ttft_mean_ms']:.2f} ms, {stats['handoffs']} "
          f"handoffs, {stats['sheds']} shed(s), "
          f"{stats['transport_bytes']} transport bytes, "
          f"{stats['breaches']} SLO breach(es)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
