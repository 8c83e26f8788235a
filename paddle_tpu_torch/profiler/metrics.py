"""Process-wide metrics registry.

Port of `paddle_tpu/profiler/metrics.py`: a thread-safe registry of
Counter / Gauge / Histogram metrics with labeled children, exported as
Prometheus text, JSON, a summary table or chrome-trace counter events.
The port keeps its own registry (`REGISTRY`); metric names, label
names, bucket bounds and help strings are the JAX package's, verbatim,
so a dashboard built on the JAX server reads the port unchanged.

Hot paths record against the module-level ``_enabled`` flag, so a call
site costs one attribute read and a branch while recording is off:

    from ..profiler import metrics as _metrics
    ...
    if _metrics._enabled:
        _metrics.MOE_AUX_LOSS.labels("serving").set(aux)

Turn it on with ``metrics.enable()`` (or ``PADDLE_TPU_METRICS=1`` in the
environment); read it with ``REGISTRY.snapshot()`` / ``to_prometheus()``
/ ``to_json()``, or merged with the host spans in
``paddle_tpu_torch.profiler.summary()``.

Registered here and recorded by nothing in the port yet (their
recorders are not ported): the dispatch, VJP-cache, NaN/Inf, jit,
collective, gradient-bucket, pipeline, training-throughput and hapi
metrics, the kernel-autotune counters and the two guard counters.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time


# --------------------------------------------------------------- switch

_enabled = bool(os.environ.get("PADDLE_TPU_METRICS", ""))


def enable():
    """Turn on hot-path instrumentation process-wide."""
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def exponential_buckets(start: float, factor: float, count: int):
    """Fixed exponential histogram bucket upper bounds."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


# 1us .. ~4.2s in x4 steps: covers eager dispatch (~50us) through jit
# compiles (seconds) with 12 buckets
DEFAULT_TIME_BUCKETS = exponential_buckets(1e-6, 4.0, 12)


# -------------------------------------------------------------- metrics


class _Metric:
    """Base: a named metric with (optionally) labeled children."""

    type = "untyped"

    def __init__(self, name, help="", labelnames=()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children = {}
        if not self.labelnames:
            # unlabeled metric: a single default child shares the lock
            self._children[()] = self._make_child()

    def _make_child(self):
        raise NotImplementedError

    def labels(self, *values, **kv):
        """Child for one label-value combination (created on demand)."""
        if kv:
            if values:
                raise ValueError("pass label values positionally or by "
                                 "name, not both")
            try:
                values = tuple(kv[n] for n in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"unknown label {e} for metric {self.name!r} "
                    f"(labels: {self.labelnames})") from None
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes {len(self.labelnames)} "
                f"label value(s), got {len(values)}")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values,
                                                  self._make_child())
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"metric {self.name!r} is labeled {self.labelnames}; "
                "use .labels(...)")
        return self._children[()]

    def reset(self):
        with self._lock:
            if self.labelnames:
                self._children.clear()
            else:
                self._children = {(): self._make_child()}

    def samples(self):
        """[(labelvalues, child)] snapshot-stable list."""
        with self._lock:
            return list(self._children.items())


class _CounterChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n=1):
        if n < 0:
            raise ValueError("counters can only increase; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Counter(_Metric):
    type = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, n=1):
        self._default().inc(n)

    @property
    def value(self):
        return self._default().value


class _GaugeChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self._value = float(v)

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        self.inc(-n)

    @property
    def value(self):
        return self._value


class Gauge(_Metric):
    type = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, v):
        self._default().set(v)

    def inc(self, n=1):
        self._default().inc(n)

    def dec(self, n=1):
        self._default().dec(n)

    @property
    def value(self):
        return self._default().value


class _HistogramChild:
    __slots__ = ("buckets", "bucket_counts", "_sum", "_count", "_lock")

    def __init__(self, buckets):
        self.buckets = buckets               # upper bounds, ascending
        self.bucket_counts = [0] * (len(buckets) + 1)  # +1 => +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v):
        v = float(v)
        # linear scan: bucket lists are small (<=16) and fixed
        i = 0
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                break
        else:
            i = len(self.buckets)
        with self._lock:
            self.bucket_counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def sum(self):
        return self._sum

    @property
    def count(self):
        return self._count

    def cumulative(self):
        """[(upper_bound, cumulative_count)] including +Inf."""
        out, acc = [], 0
        with self._lock:
            counts = list(self.bucket_counts)
        for ub, c in zip(list(self.buckets) + [math.inf], counts):
            acc += c
            out.append((ub, acc))
        return out


class Histogram(_Metric):
    type = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=None):
        self.buckets = tuple(buckets) if buckets is not None \
            else DEFAULT_TIME_BUCKETS
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError("histogram buckets must be ascending")
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v):
        self._default().observe(v)

    @property
    def sum(self):
        return self._default().sum

    @property
    def count(self):
        return self._default().count


# ------------------------------------------------------------- registry


class MetricsRegistry:
    """Process-global name -> metric store. `counter`/`gauge`/`histogram`
    get-or-create (re-registration with a different type or labels is an
    error); `snapshot`/`to_prometheus`/`to_json` export; `reset` zeroes
    every value (registrations survive) for tests."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or \
                        m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.type} with labels {m.labelnames}")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name):
        return self._metrics.get(name)

    def reset(self):
        """Zero every metric (keep registrations) — for tests."""
        with self._lock:
            for m in self._metrics.values():
                m.reset()

    def clear(self):
        """Drop all registrations (fresh registry)."""
        with self._lock:
            self._metrics.clear()

    # ------------------------------------------------------------ export

    def snapshot(self):
        """{name: {type, help, labels, values}} plain-python snapshot.
        Histogram values are {buckets: [[ub, cumcount]...], sum, count}.
        Label keys are rendered `a=x,b=y` ("" for unlabeled)."""
        out = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            values = {}
            for lv, child in m.samples():
                key = ",".join(f"{n}={v}"
                               for n, v in zip(m.labelnames, lv))
                if m.type == "histogram":
                    values[key] = {
                        "buckets": [[("+Inf" if ub == math.inf else ub),
                                     c] for ub, c in child.cumulative()],
                        "sum": child.sum,
                        "count": child.count,
                    }
                else:
                    values[key] = child.value
            out[m.name] = {"type": m.type, "help": m.help,
                           "labels": list(m.labelnames),
                           "values": values}
        return out

    def to_json(self, indent=None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines = []
        with self._lock:
            metrics = sorted(self._metrics.values(),
                             key=lambda m: m.name)
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.type}")
            for lv, child in sorted(m.samples()):
                lbl = _label_str(m.labelnames, lv)
                if m.type == "histogram":
                    for ub, c in child.cumulative():
                        le = "+Inf" if ub == math.inf else _fmt(ub)
                        blbl = _label_str(m.labelnames + ("le",),
                                          lv + (le,))
                        lines.append(f"{m.name}_bucket{blbl} {c}")
                    lines.append(
                        f"{m.name}_sum{lbl} {_fmt(child.sum)}")
                    lines.append(f"{m.name}_count{lbl} {child.count}")
                else:
                    lines.append(f"{m.name}{lbl} {_fmt(child.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def render_table(self) -> str:
        """Human-readable table of every non-zero sample (the metrics
        section of `profiler.summary()`)."""
        rows = []
        for name, m in sorted(self.snapshot().items()):
            for key, v in sorted(m["values"].items()):
                if m["type"] == "histogram":
                    if not v["count"]:
                        continue
                    mean = v["sum"] / v["count"]
                    val = (f"count={v['count']} sum={v['sum']:.6g} "
                           f"mean={mean:.6g}")
                else:
                    if not v:
                        continue
                    val = f"{v:.6g}"
                label = f"{name}{{{key}}}" if key else name
                rows.append((label, m["type"], val))
        if not rows:
            return "Metrics: (none recorded)"
        w = max(len(r[0]) for r in rows)
        sep = "-" * (w + 46)
        lines = [sep, "Metrics Summary", sep,
                 f"{'Name':{w}s}  {'Type':9s}  Value"]
        lines += [f"{n:{w}s}  {t:9s}  {v}" for n, t, v in rows]
        lines.append(sep)
        return "\n".join(lines)

    def chrome_counter_events(self):
        """Chrome-trace counter events (`ph: "C"`) for every scalar
        sample, timestamped now on the host-span clock — merged into
        `export_chrome_tracing` output next to RecordEvent spans."""
        ts = time.perf_counter() * 1e6
        pid = os.getpid()
        events = []
        for name, m in self.snapshot().items():
            if m["type"] == "histogram":
                for key, v in m["values"].items():
                    series = f"{name}{{{key}}}" if key else name
                    events.append({
                        "name": series, "ph": "C", "ts": ts, "pid": pid,
                        "args": {"count": v["count"], "sum": v["sum"]}})
                continue
            for key, v in m["values"].items():
                series = f"{name}{{{key}}}" if key else name
                events.append({"name": series, "ph": "C", "ts": ts,
                               "pid": pid, "args": {"value": v}})
        return events


def _label_str(names, values):
    if not names:
        return ""
    pairs = ",".join(f'{n}="{_escape(v)}"'
                     for n, v in zip(names, values))
    return "{" + pairs + "}"


def _escape(v):
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


def _fmt(v):
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


REGISTRY = MetricsRegistry()


# ----------------------------------------------- framework metric handles
#
# Pre-registered handles for the instrumented hot paths; exported metric
# names are part of the observability contract (the JAX package's, verbatim).

DISPATCH_OPS = REGISTRY.counter(
    "paddle_tpu_dispatch_ops_total",
    "Eager op dispatches through core.dispatch.apply", ("op",))
VJP_CACHE = REGISTRY.counter(
    "paddle_tpu_vjp_jit_cache_total",
    "VJP-jit cache events (hit/miss/fallback/eviction)", ("event",))
VJP_BACKWARD_SECONDS = REGISTRY.histogram(
    "paddle_tpu_vjp_backward_seconds",
    "Per-node backward time: trace (cache miss, includes jit trace) vs "
    "replay (cache hit) vs fallback (uncacheable closure)", ("mode",))
NAN_INF_EVENTS = REGISTRY.counter(
    "paddle_tpu_nan_inf_events_total",
    "NaN/Inf detections under FLAGS_check_nan_inf", ("op",))
JIT_COMPILES = REGISTRY.counter(
    "paddle_tpu_jit_compiles_total",
    "XLA compilations per jitted entry point", ("fn",))
JIT_COMPILE_SECONDS = REGISTRY.counter(
    "paddle_tpu_jit_compile_seconds_total",
    "Cumulative trace+compile wall seconds per jitted entry point",
    ("fn",))
COLLECTIVE_CALLS = REGISTRY.counter(
    "paddle_tpu_collective_calls_total",
    "Eager collective API calls", ("collective",))
COLLECTIVE_BYTES = REGISTRY.counter(
    "paddle_tpu_collective_bytes_total",
    "Payload bytes through collectives (eager: measured; compiled "
    "hybrid steps: analytic estimate)", ("collective",))
COLLECTIVE_SECONDS = REGISTRY.histogram(
    "paddle_tpu_collective_seconds",
    "Eager collective wall time", ("collective",))
GRAD_BUCKETS = REGISTRY.gauge(
    "paddle_tpu_grad_buckets",
    "Gradient all-reduce buckets per step for the bucketed reduction "
    "paths (eager fused_allreduce_gradients / compiled hybrid DP step)",
    ("path",))
PIPELINE_BUBBLE_TICKS = REGISTRY.gauge(
    "paddle_tpu_pipeline_stage_bubble_ticks",
    "Idle schedule ticks per pipeline stage for the compiled schedule",
    ("stage",))
PIPELINE_BUBBLE_RATIO = REGISTRY.gauge(
    "paddle_tpu_pipeline_bubble_ratio",
    "Schedule-level bubble fraction (idle slots / total slots)")
PIPELINE_STEP_SECONDS = REGISTRY.histogram(
    "paddle_tpu_pipeline_step_seconds",
    "Wall time of CompiledPipeline.loss_and_grads")
STEPS_PER_SEC = REGISTRY.gauge(
    "paddle_tpu_train_steps_per_sec",
    "Rolling training steps/sec (hapi fit loop)")
SAMPLES_PER_SEC = REGISTRY.gauge(
    "paddle_tpu_train_samples_per_sec",
    "Rolling training samples/sec (hapi fit loop)")
TOKENS_PER_SEC = REGISTRY.gauge(
    "paddle_tpu_train_tokens_per_sec",
    "Training tokens/sec (set by bench.py / LM training loops)")
HAPI_BATCHES = REGISTRY.counter(
    "paddle_tpu_hapi_batches_total",
    "Batches seen by the hapi callback loop", ("mode",))
HAPI_EPOCHS = REGISTRY.counter(
    "paddle_tpu_hapi_epochs_total",
    "Completed hapi fit epochs")
HOST_EVENTS_DROPPED = REGISTRY.counter(
    "paddle_tpu_profiler_host_events_dropped_total",
    "RecordEvent spans dropped by the bounded host ring buffer")

# ---- kernel autotuner (the JAX package's ops.pallas.autotune) -------
KERNEL_AUTOTUNE_CACHE_HITS = REGISTRY.counter(
    "paddle_tpu_kernel_autotune_cache_hits_total",
    "Tuned-kernel config lookups served from the persistent cache "
    "(zero search cost)", ("kernel",))
KERNEL_AUTOTUNE_CACHE_MISSES = REGISTRY.counter(
    "paddle_tpu_kernel_autotune_cache_misses_total",
    "Tuned-kernel config lookups that fell back to the hand-picked "
    "default (no cached winner for the shape bucket)", ("kernel",))
KERNEL_AUTOTUNE_SEARCH_SECONDS = REGISTRY.counter(
    "paddle_tpu_kernel_autotune_search_seconds_total",
    "Wall seconds spent measuring kernel-variant candidates",
    ("kernel",))
KERNEL_AUTOTUNE_REJECTED_PARITY = REGISTRY.counter(
    "paddle_tpu_kernel_autotune_candidates_rejected_parity_total",
    "Kernel-variant candidates refused admission by the XLA-oracle "
    "parity gate (or by failing to run at all)", ("kernel",))

# ---- trace-discipline guards (the JAX package's analysis.guards) -----
COMPILE_WATCHDOG_BUDGET_EXCEEDED = REGISTRY.counter(
    "paddle_tpu_compile_watchdog_budget_exceeded_total",
    "Jit instances that compiled past their per-instance budget under "
    "analysis.guards.sanitize (a spec/signature mismatch forcing a "
    "silent recompile of a one-compile entry)", ("fn",))
TRANSFER_GUARD_TRIPS = REGISTRY.counter(
    "paddle_tpu_compile_watchdog_transfer_guard_trips_total",
    "jax transfer-guard errors (implicit device transfers) observed "
    "crossing an analysis.guards.sanitize boundary")

# ---- MoE routing: shared by the hybrid trainer
# ("train" path) and the serving mixed step ("serving" path) -----------
MOE_EXPERT_TOKENS = REGISTRY.counter(
    "paddle_tpu_moe_expert_tokens_total",
    "Tokens dispatched to each expert (post-capacity)",
    ("path", "expert"))
MOE_DROPPED_TOKENS = REGISTRY.counter(
    "paddle_tpu_moe_dropped_tokens_total",
    "(token, choice) routing assignments lost to capacity overflow "
    "(the token rides the residual path instead)", ("path",))
MOE_EXPERT_UTILIZATION = REGISTRY.gauge(
    "paddle_tpu_moe_expert_utilization",
    "Normalized entropy of the cumulative per-expert token "
    "distribution (1.0 = perfectly balanced, 0.0 = one expert takes "
    "everything)", ("path",))
MOE_AUX_LOSS = REGISTRY.gauge(
    "paddle_tpu_moe_aux_loss",
    "Latest GShard load-balance loss of the routed batch (1.0 = "
    "uniform routing)", ("path",))


def moe_utilization_entropy(counts):
    """Normalized entropy of a per-expert token-count vector in
    [0, 1] — the `paddle_tpu_moe_expert_utilization` gauge value (one
    definition shared by the trainer, the serving engine, bench.py and
    the moe_smoke contract)."""
    import numpy as _np
    c = _np.asarray(counts, _np.float64)
    total = c.sum()
    if total <= 0 or c.size <= 1:
        return 0.0
    p = c / total
    p = p[p > 0]
    return float(-(p * _np.log(p)).sum() / _np.log(c.size))


def record_moe_stats(path, counts, dropped, aux, utilization=None):
    """One emission path for a routed batch's MoE stats — shared by
    the hybrid trainer ("train") and the serving engine ("serving") so
    the counter/gauge semantics cannot drift. `utilization` overrides
    the entropy source (the engine passes its CUMULATIVE distribution;
    the trainer lets the per-step counts speak)."""
    import numpy as _np
    counts = _np.asarray(counts, _np.float64)
    for e, c in enumerate(counts):
        if c:
            MOE_EXPERT_TOKENS.labels(path, str(e)).inc(float(c))
    dropped = float(dropped)
    if dropped:
        MOE_DROPPED_TOKENS.labels(path).inc(dropped)
    MOE_AUX_LOSS.labels(path).set(float(aux))
    MOE_EXPERT_UTILIZATION.labels(path).set(
        moe_utilization_entropy(counts) if utilization is None
        else float(utilization))
