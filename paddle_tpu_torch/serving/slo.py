"""Declarative SLO plane over the request-trace event stream.

Port of `paddle_tpu/serving/slo.py`. `SLOMonitor` subscribes to
`serving.tracing.TRACER` as an observer: every first token feeds a
per-tenant TTFT sample, every decode / verify emit an inter-token-gap
sample, every terminal outcome a deadline verdict. Objectives are
declared per tenant (`SLOConfig`) and evaluated over sliding-window
quantile estimators — a bounded (ts, value) reservoir pruned to
`window_s`, so a burst two windows ago cannot mask a breach now.
`evaluate()` publishes the per-tenant gauges
(`paddle_tpu_serving_slo_*`), computes the burn rate (measured /
target) per objective, and fires edge-triggered breach callbacks on
ok -> burning transitions. A callback that raises raises out of
`evaluate()`.

Everything is host-side and pull-based: observing a sample is an O(1)
deque append (observers run on the recording thread, which may be an
engine's executor thread: the monitor's windows take its lock);
quantiles are computed only inside `evaluate()`.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time

from ..profiler import metrics as _pmetrics
from . import metrics as _smetrics
from . import tracing as _tracing

__all__ = ["SlidingWindowQuantile", "SLOConfig", "SLOMonitor",
           "DEFAULT_OBJECTIVES"]

#: objective name -> default target. ttft_p95 / inter_token_p99 are
#: seconds; deadline_miss_rate is a windowed fraction of terminal
#: requests that expired or finished past their deadline.
DEFAULT_OBJECTIVES = {
    "ttft_p95": 0.5,
    "inter_token_p99": 0.25,
    "deadline_miss_rate": 0.05,
}

#: objective -> the per-tenant gauge its measured value lands on
_OBJECTIVE_GAUGES = {
    "ttft_p95": "SERVING_SLO_TTFT_P95",
    "inter_token_p99": "SERVING_SLO_INTER_TOKEN_P99",
    "deadline_miss_rate": "SERVING_SLO_DEADLINE_MISS_RATIO",
}


class SlidingWindowQuantile:
    """Time-windowed reservoir: (ts, value) pairs pruned to the last
    `window_s` seconds, hard-capped at `max_samples` (oldest dropped
    first, counted). Quantiles are linear-interpolated over the sorted
    window — numpy.percentile semantics, so tests can cross-check."""

    def __init__(self, window_s=60.0, max_samples=2048):
        self.window_s = float(window_s)
        self.max_samples = max(1, int(max_samples))
        self._samples = collections.deque()
        self.dropped = 0
        self.total = 0

    def observe(self, value, ts):
        self.total += 1
        if len(self._samples) >= self.max_samples:
            self._samples.popleft()
            self.dropped += 1
        self._samples.append((ts, float(value)))

    def _prune(self, now):
        cutoff = now - self.window_s
        while self._samples and self._samples[0][0] < cutoff:
            self._samples.popleft()

    def count(self, now):
        self._prune(now)
        return len(self._samples)

    def quantile(self, q, now):
        """q in [0, 1]; None when the window is empty."""
        self._prune(now)
        if not self._samples:
            return None
        vals = sorted(v for _, v in self._samples)
        pos = q * (len(vals) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(vals) - 1)
        frac = pos - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac


@dataclasses.dataclass
class SLOConfig:
    """Declarative objectives: `default` applies to every tenant,
    `tenants[name]` overrides per objective. `burn_threshold` is the
    burn rate (measured / target) above which an objective counts as
    breached — 1.0 means the target itself is the alert line."""

    default: dict = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_OBJECTIVES))
    tenants: dict = dataclasses.field(default_factory=dict)
    window_s: float = 60.0
    max_samples: int = 2048
    burn_threshold: float = 1.0

    def targets_for(self, tenant):
        targets = dict(self.default)
        targets.update(self.tenants.get(tenant, {}))
        return targets

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        unknown = set(d) - {"default", "tenants", "window_s",
                            "max_samples", "burn_threshold"}
        if unknown:
            raise ValueError(f"unknown SLOConfig keys: {sorted(unknown)}")
        return cls(**d)


class SLOMonitor:
    """Tracer observer + evaluator. `attach()` enables tracing (the SLO
    plane rides the trace event stream — there is no second feed) and
    subscribes; `evaluate()` turns the windows into a report, the
    registry gauges, and edge-triggered `on_breach` callbacks."""

    def __init__(self, config=None, clock=time.monotonic):
        self.config = config if config is not None else SLOConfig()
        if isinstance(self.config, dict):
            self.config = SLOConfig.from_dict(self.config)
        self.clock = clock
        self._ttft = {}        # tenant -> SlidingWindowQuantile
        self._inter = {}
        self._outcomes = {}    # tenant -> deque[(ts, missed)]
        self._burning = {}     # (tenant, objective) -> bool
        self._callbacks = []
        self.breaches = 0
        self._lock = threading.RLock()

    # ------------------------------------------------------ lifecycle
    def attach(self):
        _tracing.enable()
        _tracing.TRACER.add_observer(self)
        return self

    def detach(self):
        _tracing.TRACER.remove_observer(self)
        return self

    def __enter__(self):
        return self.attach()

    def __exit__(self, *a):
        self.detach()

    def on_breach(self, cb):
        """cb(tenant, objective, burn_rate, measured, target) — fired
        once per ok -> burning transition (edge-triggered; recovery
        re-arms it)."""
        self._callbacks.append(cb)
        return cb

    # ----------------------------------------- tracer observer feed
    def _window(self, table, tenant):
        w = table.get(tenant)
        if w is None:
            w = table[tenant] = SlidingWindowQuantile(
                self.config.window_s, self.config.max_samples)
        return w

    def on_ttft(self, tenant, value, ts):
        with self._lock:
            self._window(self._ttft, tenant).observe(value, ts)

    def on_inter_token(self, tenant, value, ts):
        with self._lock:
            self._window(self._inter, tenant).observe(value, ts)

    def on_outcome(self, tenant, outcome, deadline_missed, ts):
        with self._lock:
            dq = self._outcomes.get(tenant)
            if dq is None:
                dq = self._outcomes[tenant] = collections.deque(
                    maxlen=self.config.max_samples)
            dq.append((ts, bool(deadline_missed)))

    # ------------------------------------------------------ evaluate
    def _miss_rate(self, tenant, now):
        dq = self._outcomes.get(tenant)
        if not dq:
            return None, 0
        cutoff = now - self.config.window_s
        while dq and dq[0][0] < cutoff:
            dq.popleft()
        if not dq:
            return None, 0
        misses = sum(1 for _, m in dq if m)
        return misses / len(dq), len(dq)

    def _measure(self, tenant, objective, now):
        if objective == "ttft_p95":
            w = self._ttft.get(tenant)
            return ((w.quantile(0.95, now), w.count(now))
                    if w else (None, 0))
        if objective == "inter_token_p99":
            w = self._inter.get(tenant)
            return ((w.quantile(0.99, now), w.count(now))
                    if w else (None, 0))
        if objective == "deadline_miss_rate":
            return self._miss_rate(tenant, now)
        raise ValueError(f"unknown SLO objective: {objective!r}")

    def evaluate(self, now=None):
        """-> {tenant: {objective: {value, target, burn_rate, ok,
        samples}}} over tenants with either declared overrides or
        observed traffic. Objectives with an empty window are omitted
        (no data is not a breach)."""
        if now is None:
            now = self.clock()
        with self._lock:
            return self._evaluate(now)

    def _evaluate(self, now):
        tenants = (set(self.config.tenants) | set(self._ttft)
                   | set(self._inter) | set(self._outcomes))
        report = {}
        for tenant in sorted(tenants):
            entry = {}
            for objective, target in sorted(
                    self.config.targets_for(tenant).items()):
                value, n = self._measure(tenant, objective, now)
                if value is None:
                    continue
                burn = (value / target) if target > 0 else math.inf
                ok = burn <= self.config.burn_threshold
                entry[objective] = {"value": value, "target": target,
                                    "burn_rate": burn, "ok": ok,
                                    "samples": n}
                if _pmetrics._enabled:
                    getattr(_smetrics, _OBJECTIVE_GAUGES[objective]) \
                        .labels(tenant).set(value)
                    _smetrics.SERVING_SLO_BURN_RATE.labels(
                        tenant, objective).set(
                        burn if math.isfinite(burn) else -1.0)
                key = (tenant, objective)
                edge = not ok and not self._burning.get(key, False)
                # the edge is marked before the callbacks run, so a
                # callback that raises still leaves it counted once
                self._burning[key] = not ok
                if edge:
                    self.breaches += 1
                    if _pmetrics._enabled:
                        _smetrics.SERVING_SLO_BREACHES.labels(
                            tenant, objective).inc()
                    for cb in list(self._callbacks):
                        cb(tenant, objective, burn, value, target)
            if entry:
                report[tenant] = entry
        return report
