"""The port's metrics registry and profiler against the JAX package's.

`paddle_tpu_torch.profiler` keeps its own registry (`metrics.REGISTRY`)
and its own host-span recorder. Held here on the CPU, against
`paddle_tpu.profiler`:

* one script of registry operations (the cases of
  tests/test_profiler_metrics.py: counters, gauges, histograms, labeled
  children, a type conflict, reset, eight threads incrementing) applied
  to a fresh `MetricsRegistry` of each package gives the same
  `to_prometheus()`, `to_json()`, `snapshot()` and `render_table()`;
* every module-level metric of `profiler.metrics` and every name of
  `serving.metrics.CONTRACT_METRICS` has the same type, label names,
  help string and buckets in both packages, and `draft_hit_ratio` and
  `moe_utilization_entropy` agree;
* the `RecordEvent` ring keeps its newest spans and counts the dropped;
* `summary()` carries the host table, the device line, the metrics
  table and the tracer and flight sections;
* `export_chrome_tracing` writes the same events, by name, phase and
  track, as the JAX package's for the same script (timestamps differ);
* `Profiler` runs torch.profiler on the CPU, reads no device kernel
  there and says so, and raises when torch.profiler fails to start.
"""
import json
import math
import threading

import numpy as np
import pytest

from paddle_tpu import profiler as jprof
from paddle_tpu.profiler import metrics as jm
from paddle_tpu.serving import metrics as jsm
from paddle_tpu.serving import tracing as jtr
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.profiler import metrics as tm
from paddle_tpu_torch.profiler import statistic as tstat
from paddle_tpu_torch.serving import metrics as tsm
from paddle_tpu_torch.serving import tracing as ttr

PACKAGES = {"jax": (jm, jsm, jtr, jprof), "torch": (tm, tsm, ttr, tprof)}


@pytest.fixture(autouse=True)
def _clean():
    """Recording off and both registries and tracers empty around every
    test (the JAX package's switches are process-wide too)."""
    states = [(m._enabled, t._enabled) for m, _s, t, _p in
              PACKAGES.values()]
    for m, _s, t, p in PACKAGES.values():
        m.disable()
        t.disable()
        m.REGISTRY.reset()
        t.TRACER.reset()
        p._recorder.clear()
    yield
    for (was_m, was_t), (m, _s, t, p) in zip(states, PACKAGES.values()):
        m.REGISTRY.reset()
        t.TRACER.reset()
        p._recorder.clear()
        (m.enable if was_m else m.disable)()
        (t.enable if was_t else t.disable)()


# ------------------------------------------------- one script, two packages


def _counter(mm):
    reg = mm.MetricsRegistry()
    c = reg.counter("c_total", "help text")
    c.inc()
    c.inc(2.5)
    with pytest.raises(ValueError):
        c.inc(-1)
    assert reg.counter("c_total") is c
    return reg


def _labels(mm):
    reg = mm.MetricsRegistry()
    c = reg.counter("ops_total", labelnames=("op",))
    c.labels("add").inc(3)
    c.labels(op="mul").inc()
    for bad in (lambda: c.inc(), lambda: c.labels("a", "b"),
                lambda: c.labels(bogus="x")):
        with pytest.raises(ValueError):
            bad()
    reg.counter("esc_total", labelnames=("v",)).labels('a"b\n').inc()
    reg.counter("req_total", "requests", ("code",)).labels("200").inc(3)
    return reg


def _gauge(mm):
    reg = mm.MetricsRegistry()
    g = reg.gauge("g", "a gauge")
    g.set(5)
    g.inc(2)
    g.dec()
    reg.gauge("temp").set(-3.5)
    lab = reg.gauge("lab", labelnames=("a", "b"))
    lab.labels("x", "y").set(0.25)
    lab.labels(b="z", a="w").set(4)
    with pytest.raises(ValueError):
        lab.labels("x", b="y")
    return reg


def _histogram(mm):
    reg = mm.MetricsRegistry()
    h = reg.histogram("h_seconds", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    reg.histogram("d_seconds", "default buckets").observe(3e-6)
    lh = reg.histogram("lh", labelnames=("k",),
                       buckets=mm.exponential_buckets(1e-4, 4.0, 10))
    lh.labels("a").observe(0.3)
    lh.labels("b").observe(1e-5)
    with pytest.raises(ValueError):
        reg.histogram("bad", buckets=(1.0, 0.1))
    with pytest.raises(ValueError):
        mm.exponential_buckets(0, 2.0, 3)
    return reg


def _type_conflict(mm):
    reg = mm.MetricsRegistry()
    reg.counter("x")
    reg.counter("y", labelnames=("a",))
    errors = []
    for bad in (lambda: reg.gauge("x"),
                lambda: reg.counter("y", labelnames=("b",))):
        with pytest.raises(ValueError) as e:
            bad()
        errors.append(str(e.value))
    reg.gauge("errors", "|".join(errors))
    return reg


def _reset(mm):
    reg = mm.MetricsRegistry()
    c = reg.counter("c", labelnames=("k",))
    g = reg.gauge("g")
    h = reg.histogram("h", buckets=(1.0,))
    c.labels("v").inc(7)
    g.set(3)
    h.observe(0.5)
    reg.reset()
    assert reg.counter("c", labelnames=("k",)) is c
    assert c.labels("v").value == 0 and g.value == 0
    c.labels("w").inc(2)
    reg2 = mm.MetricsRegistry()
    reg2.counter("gone").inc()
    reg2.clear()
    assert reg2.get("gone") is None
    return reg


def _threads(mm):
    reg = mm.MetricsRegistry()
    c = reg.counter("c_total", labelnames=("t",))
    h = reg.histogram("h", buckets=(0.5,))
    g = reg.gauge("g")

    def work(i):
        child = c.labels("shared")
        for _ in range(500):
            child.inc()
            h.observe(0.25)
            g.inc()
            c.labels(str(i % 3)).inc(2)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.labels("shared").value == 8 * 500
    return reg


SCRIPTS = {"counter": _counter, "labels": _labels, "gauge": _gauge,
           "histogram": _histogram, "type_conflict": _type_conflict,
           "reset": _reset, "threads": _threads}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_registry_script_matches_jax(case):
    want = SCRIPTS[case](jm)
    got = SCRIPTS[case](tm)
    assert got.to_prometheus() == want.to_prometheus()
    assert got.to_json() == want.to_json()
    assert json.loads(got.to_json(indent=2)) == got.snapshot()
    assert got.snapshot() == want.snapshot()
    assert got.render_table() == want.render_table()
    strip = [{k: v for k, v in e.items() if k not in ("ts", "pid")}
             for e in got.chrome_counter_events()]
    assert strip == [{k: v for k, v in e.items() if k not in ("ts", "pid")}
                     for e in want.chrome_counter_events()]


def _describe(metric):
    return (metric.type, metric.labelnames, metric.help,
            getattr(metric, "buckets", None))


def test_module_metrics_match_jax():
    """Every metric `profiler.metrics` registers, in both packages."""
    jnames = {m.name for m in vars(jm).values() if isinstance(m, jm._Metric)}
    tnames = {m.name for m in vars(tm).values() if isinstance(m, tm._Metric)}
    assert tnames == jnames and len(tnames) == 29
    for name in jnames:
        assert _describe(tm.REGISTRY.get(name)) == \
            _describe(jm.REGISTRY.get(name)), name
    assert tm.DEFAULT_TIME_BUCKETS == jm.DEFAULT_TIME_BUCKETS


def test_contract_metrics_match_jax():
    assert tsm.CONTRACT_METRICS == jsm.CONTRACT_METRICS
    assert len(set(tsm.CONTRACT_METRICS)) == len(tsm.CONTRACT_METRICS)
    for name in tsm.CONTRACT_METRICS:
        got, want = tm.REGISTRY.get(name), jm.REGISTRY.get(name)
        assert got is not None, name
        assert _describe(got) == _describe(want), name
    # the serving module registers nothing outside the contract
    extra = {m.name for m in vars(tsm).values() if isinstance(m, tm._Metric)}
    assert extra <= set(tsm.CONTRACT_METRICS)
    jextra = {m.name for m in vars(jsm).values()
              if isinstance(m, jm._Metric)}
    assert extra == jextra


def test_draft_hit_ratio_and_entropy_match_jax():
    assert tsm.draft_hit_ratio() == jsm.draft_hit_ratio() == 0.0
    for sm in (tsm, jsm):
        sm.SERVING_DRAFT_TOKENS.labels("proposed").inc(12)
        sm.SERVING_DRAFT_TOKENS.labels("accepted").inc(5)
    assert tsm.draft_hit_ratio() == jsm.draft_hit_ratio() == 5 / 12
    for counts in ([0, 0, 0], [3], [5, 0, 0, 1], [2, 2, 2, 2],
                   np.arange(8) ** 2):
        assert tm.moe_utilization_entropy(counts) == \
            jm.moe_utilization_entropy(counts)
    for m in (tm, jm):
        m.enable()
        m.record_moe_stats("serving", [3, 0, 5, 1], 2, 1.25,
                           utilization=0.5)
        m.record_moe_stats("train", [1, 1], 0, 0.75)
    for name in ("paddle_tpu_moe_expert_tokens_total",
                 "paddle_tpu_moe_dropped_tokens_total",
                 "paddle_tpu_moe_expert_utilization",
                 "paddle_tpu_moe_aux_loss"):
        assert tm.REGISTRY.snapshot()[name] == jm.REGISTRY.snapshot()[name]


# ---------------------------------------------------------------- profiler


def test_host_recorder_ring_bound():
    for m, prof in ((tm, tprof), (jm, jprof)):
        m.enable()
        rec = prof._HostEventRecorder(maxlen=4)
        for i in range(10):
            rec.add(f"e{i}", i * 1.0, i + 0.5, tid=1)
        assert len(rec.events) == 4 and rec.dropped == 6
        assert [e["name"] for e in rec.events] == ["e6", "e7", "e8", "e9"]
        assert m.HOST_EVENTS_DROPPED.value == 6
        rec.clear()
        assert rec.dropped == 0 and not rec.events


def _chrome_script(m, tr, prof, tmp):
    """Record the same spans, metrics, trace and flight record in one
    package; returns its chrome export's events."""
    m.enable()
    tr.enable()
    m.REGISTRY.get("paddle_tpu_serving_steps_total").inc(3)
    m.REGISTRY.get("paddle_tpu_serving_ttft_seconds").observe(0.25)
    tid = tr.TRACER.mint("t0")
    tr.TRACER.event(tid, "enqueued", replica="e0", ts=1.0)
    tr.TRACER.event(tid, "admitted", replica="e0", ts=1.5, kind="prefill")
    tr.TRACER.event(tid, "first_token", replica="e0", ts=2.0)
    tr.TRACER.event(tid, "decode_step", replica="e0", ts=2.5, gap=0.5)
    tr.TRACER.finish(tid, "finished", replica="e0", ts=3.0)
    rec = tr.StepFlightRecorder("chrome_e0", "mixed", maxlen=8)
    tr.register_flight_recorder(rec)
    rec.note(ts=1.0, dur=0.01, prefill_tokens=4, decode_tokens=2)
    p = prof.Profiler(timer_only=True,
                      on_trace_ready=prof.export_chrome_tracing(str(tmp)))
    p.start()
    for name in ("outer", "inner", "inner"):
        with prof.RecordEvent(name):
            pass
    p.stop()
    (path,) = tmp.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    # other tests' live engines' recorders may add tracks: keep this one's
    return [e for e in events if not str(e.get("tid", "")).startswith(
        "engine:") or e["tid"] == "engine:chrome_e0"], tid


def test_chrome_export_matches_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want, jtid = _chrome_script(jm, jtr, jprof, tmp_path / "jax")
    got, ttid = _chrome_script(tm, ttr, tprof, tmp_path / "torch")

    # other JAX modules a test process imports register metrics of their
    # own in JAX's registry: hold the series both registries hold
    shared = set(tm.REGISTRY._metrics) & set(jm.REGISTRY._metrics)

    def key(events, tid):
        return sorted((e["name"], e["ph"],
                       "trace" if e.get("tid") == f"trace:{tid}"
                       else str(e.get("tid")), json.dumps(
                           {k: v for k, v in e.get("args", {}).items()
                            if k != "trace_id"}, sort_keys=True))
                      for e in events if e["ph"] != "C"
                      or e["name"].split("{")[0] in shared)
    assert key(got, ttid) == key(want, jtid)
    names = {e["name"] for e in got}
    assert {"outer", "inner", "finished", "step[mixed]",
            "paddle_tpu_serving_steps_total"} <= names
    assert {e["tid"] for e in got if e["ph"] == "X"
            and e["name"].startswith(("queued", "prefill", "decode"))} \
        == {f"trace:{ttid}"}


def test_summary_sections(tmp_path):
    tm.enable()
    ttr.enable()
    tsm.SERVING_STEPS.inc(2)
    tid = ttr.TRACER.mint("t0")
    ttr.TRACER.event(tid, "enqueued", replica="e0", ts=1.0)
    ttr.TRACER.event(tid, "first_token", replica="e0", ts=1.25)
    ttr.TRACER.finish(tid, "finished", replica="e0", ts=2.0)
    rec = ttr.StepFlightRecorder("sum_e0", "prefill", maxlen=4)
    ttr.register_flight_recorder(rec)
    rec.note(ts=1.0, dur=0.002, prefill_tokens=9, decode_tokens=0)
    p = tprof.Profiler(timer_only=True)
    with p:
        with tprof.RecordEvent("host_span"):
            pass
    text = tprof.summary(prof=p)
    for section in ("Host Event Summary", "host_span", "Metrics Summary",
                    "paddle_tpu_serving_steps_total",
                    "request traces (serving.tracing)",
                    "span-derived TTFT mean 250.00 ms",
                    "step flight recorders (serving.tracing)", "sum_e0"):
        assert section in text, section
    # a Profiler that ran torch.profiler adds its device table
    assert tstat.NO_DEVICE_KERNELS not in text


def test_profiler_on_cpu_reads_no_device_kernels(capsys):
    import torch
    p = tprof.Profiler(targets=[tprof.ProfilerTarget.CPU])
    with p:
        with tprof.RecordEvent("matmul_span"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert p._prof is not None
    assert tstat.device_kernel_times(p._prof) == {}
    text = p.summary()
    assert tstat.NO_DEVICE_KERNELS in text
    assert "matmul_span" in text
    assert tstat.NO_DEVICE_KERNELS in capsys.readouterr().out
    # the module-level report reads the same profiler
    assert tstat.NO_DEVICE_KERNELS in tprof.summary(prof=p)


def test_profiler_raises_on_failure(monkeypatch):
    import torch.profiler as tp

    class Broken:
        def __init__(self, **kw):
            pass

        def start(self):
            raise RuntimeError("profiler refused to start")

    monkeypatch.setattr(tp, "profile", Broken)
    p = tprof.Profiler()
    with pytest.raises(RuntimeError, match="refused to start"):
        p.start()
    assert not tprof._recording[0]


def test_benchmark_timer_gauges():
    tm.enable()
    b = tprof.benchmark()
    b.begin()
    for _ in range(3):
        b.before_reader()
        b.after_reader()
        b.after_step(num_samples=16)
    rep = b.report()
    assert rep["steps"] == 3 and rep["unit"] == "samples/s"
    assert tm.STEPS_PER_SEC.value > 0 and tm.SAMPLES_PER_SEC.value > 0
    assert "ips:" in b.step_info()
    assert math.isfinite(rep["ips_avg"])


@pytest.mark.parametrize("name", ["profiler", "profiler.metrics",
                                  "profiler.statistic", "profiler.timer",
                                  "serving.metrics", "serving.tracing",
                                  "serving.slo"])
def test_exports_every_public_name_of_jax(name):
    """Every public name of the JAX module (its imported modules aside)
    is defined by the port's."""
    import importlib
    import types
    jmod = importlib.import_module(f"paddle_tpu.{name}")
    tmod = importlib.import_module(f"paddle_tpu_torch.{name}")
    names = [n for n, v in vars(jmod).items() if not n.startswith("_")
             and not isinstance(v, types.ModuleType) or n == "metrics"]
    assert names
    assert [n for n in names if not hasattr(tmod, n)] == []
