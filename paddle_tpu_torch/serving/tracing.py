"""Fleet-wide request tracing for the serving engine.

Port of `paddle_tpu/serving/tracing.py`. Two host-side event stores,
both bounded, both gated like `profiler.metrics._enabled`:

* **Request traces** (`TRACER`, a `RequestTracer`) — one stitched
  timeline of span events per request: enqueued, admitted, prefill
  chunks, first token, handoff export, migration transport, decode
  admission, decode / verify steps, preempted, then finished, expired
  or cancelled. The trace id is minted at router dispatch (or at engine
  submit for an engine without a router) and rides the request through
  the frontend, scheduler, engine and `MigrationTicket` to the
  destination replica's scheduler, so one trace survives a handoff, a
  shed and a failover. A failover's re-dispatch reopens the trace the
  dying replica's cancel closed (`_REOPEN_EVENTS`): the surviving
  replica's outcome wins.
* **Step flight recorders** (`StepFlightRecorder`, one per engine) — a
  bounded ring of per-step records (role, tokens prefilled and decoded,
  active slots, accepted drafts, sparse skip ratio, blocks imported,
  step wall time), exported as chrome "X" slices on an `engine:<name>`
  track.

Both stores register with the port's profiler
(`profiler.register_chrome_source` / `register_summary_section`), so
`profiler.export_chrome_tracing` and `profiler.summary()` merge them
with the host spans and the registry's counters.

Hot-path discipline: every call site in the engine, scheduler, router
and transport tests ``if tracing._enabled:`` first, so recording off
costs one branch; recording on touches only host ints and floats the
step already holds — no read of a device tensor, no launch.

Replicas step from the event loop's executor threads: the tracer's
table, each flight ring and the recorder set take locks. An observer
or callback that raises is not swallowed: the error reaches the
recording call site.

Env knobs: ``PADDLE_TPU_TRACE=1`` enables at import,
``PADDLE_TPU_TRACE_CAPACITY`` bounds the retained-trace table
(default 2048, oldest finished evicted first),
``PADDLE_TPU_TRACE_EVENTS_MAX`` bounds events per trace (default 512),
``PADDLE_TPU_FLIGHT_STEPS`` bounds each flight ring (default 4096).
"""
from __future__ import annotations

import collections
import itertools
import os
import threading
import time
import weakref

from ..profiler import metrics as _pmetrics
from . import metrics as _smetrics

__all__ = [
    "EVENT_NAMES", "ensure_trace", "on_submit", "on_submit_migrated",
    "on_admitted", "on_first_token", "on_tokens", "on_preempted",
    "on_extracted", "on_transport", "on_terminal",
    "TRACER", "RequestTracer", "Trace", "TraceEvent",
    "StepFlightRecorder", "enable", "disable", "enabled",
    "register_flight_recorder", "flight_recorders", "recording",
]

_enabled = os.environ.get(
    "PADDLE_TPU_TRACE", "0").lower() not in ("0", "", "false")


def enable():
    """Turn request tracing on process-wide (idempotent)."""
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def enabled():
    return _enabled


def recording(on, reset=True):
    """Metrics (`profiler.metrics`) and request tracing both on or both
    off. Turning them on empties the registry and the tracer first,
    unless `reset` is False."""
    if on and reset:
        _pmetrics.REGISTRY.reset()
        TRACER.reset()
    (_pmetrics.enable if on else _pmetrics.disable)()
    (enable if on else disable)()


#: events that REOPEN a finished trace. A replica death makes the dying
#: frontend's stop() cancel its live requests — the engine-side cancel
#: closes the trace "cancelled" before the router re-dispatches the
#: SAME request elsewhere. The re-dispatch (and the destination
#: enqueue) must un-close it so the surviving replica's real outcome
#: lands on the one stitched trace.
_REOPEN_EVENTS = frozenset({"dispatched", "enqueued"})

#: span taxonomy: the decode loop coalesces one decode_step/verify_step
#: event per emit, not one per token — `tokens`/`gap` attrs carry the
#: detail.
EVENT_NAMES = (
    "dispatched", "enqueued", "admitted", "prefill_chunk",
    "first_token", "handoff", "handoff_export", "migration_transport",
    "decode_admission", "decode_step", "verify_step", "preempted",
    "failover", "finished", "expired", "cancelled", "error",
)


class TraceEvent:
    __slots__ = ("name", "ts", "replica", "attrs")

    def __init__(self, name, ts, replica, attrs):
        self.name = name
        self.ts = ts
        self.replica = replica
        self.attrs = attrs

    def as_dict(self):
        d = {"name": self.name, "ts": self.ts}
        if self.replica is not None:
            d["replica"] = self.replica
        if self.attrs:
            d.update(self.attrs)
        return d

    def __repr__(self):
        return (f"TraceEvent({self.name!r}, ts={self.ts:.6f}, "
                f"replica={self.replica!r})")


class Trace:
    """One request's stitched timeline. Timestamps are clamped monotone
    per trace at record time (fleet clocks are per-engine monotonic
    clocks in one process; the clamp absorbs sub-microsecond races
    between the router thread and engine executor threads)."""

    __slots__ = ("trace_id", "tenant", "events", "done", "outcome",
                 "dropped_events", "_last_ts")

    def __init__(self, trace_id, tenant):
        self.trace_id = trace_id
        self.tenant = tenant
        self.events = []
        self.done = False
        self.outcome = None
        self.dropped_events = 0
        self._last_ts = None

    @property
    def replicas(self):
        return sorted({e.replica for e in self.events
                       if e.replica is not None})

    def first(self, name):
        for e in self.events:
            if e.name == name:
                return e
        return None

    def monotone(self):
        ts = [e.ts for e in self.events]
        return all(a <= b for a, b in zip(ts, ts[1:]))

    def derive(self):
        """Span-derived latencies, defined so they MATCH the registry
        histograms exactly: enqueued.ts is `req.submit_time` and
        first_token.ts the engine's emit-time `now`, the same two
        numbers `SERVING_TTFT_SECONDS` subtracts."""
        enq = self.first("enqueued")
        adm = self.first("admitted")
        ft = self.first("first_token")
        gaps = [e.attrs.get("gap") for e in self.events
                if e.name in ("decode_step", "verify_step")
                and e.attrs.get("gap") is not None]
        d = {
            "trace_id": self.trace_id,
            "tenant": self.tenant,
            "outcome": self.outcome,
            "replicas": self.replicas,
            "events": len(self.events),
            "ttft": (ft.ts - enq.ts) if ft and enq else None,
            "queue_wait": (adm.ts - enq.ts) if adm and enq else None,
            "inter_token": gaps,
        }
        exp = self.first("handoff_export")
        if exp is not None:
            # handoff gap: export on the source to the next token the
            # destination emitted (the stream stall a migration costs)
            for e in self.events:
                if e.ts >= exp.ts and e.name in (
                        "first_token", "decode_step", "verify_step"):
                    d["handoff_gap"] = e.ts - exp.ts
                    break
        return d

    def as_dict(self):
        return {"trace_id": self.trace_id, "tenant": self.tenant,
                "outcome": self.outcome, "done": self.done,
                "dropped_events": self.dropped_events,
                "events": [e.as_dict() for e in self.events]}


class RequestTracer:
    """Process-global trace table + observer fan-out.

    Thread-safe: the router event loop, every engine's executor thread
    and the scheduler all record under one lock (host dict/list ops —
    nanoseconds against a multi-ms step). Observers (the SLO plane)
    are notified outside the lock; an observer that raises raises at
    the recording call site."""

    def __init__(self, capacity=None, max_events=None,
                 clock=time.monotonic):
        if capacity is None:
            capacity = int(os.environ.get(
                "PADDLE_TPU_TRACE_CAPACITY", 2048))
        if max_events is None:
            max_events = int(os.environ.get(
                "PADDLE_TPU_TRACE_EVENTS_MAX", 512))
        self.capacity = max(1, int(capacity))
        self.max_events = max(8, int(max_events))
        self.clock = clock
        self._traces = collections.OrderedDict()
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._observers = []
        self._open = 0   # incremental: scanning the table per event
        self.dropped_traces = 0   # would be O(capacity) on the hot path

    # ------------------------------------------------------ lifecycle
    def mint(self, tenant="default"):
        """New trace id (router dispatch / solo engine submit)."""
        tid = f"tr-{next(self._seq):08x}"
        with self._lock:
            self._traces[tid] = Trace(tid, str(tenant))
            self._open += 1
            self._evict_locked()
        self._set_active_gauge()
        return tid

    def _evict_locked(self):
        while len(self._traces) > self.capacity:
            # drop the oldest FINISHED trace first; if every retained
            # trace is still open, drop the oldest outright (a stuck
            # fleet must not pin unbounded memory)
            victim = None
            for k, tr in self._traces.items():
                if tr.done:
                    victim = k
                    break
            if victim is None:
                victim = next(iter(self._traces))
            if not self._traces[victim].done:
                self._open -= 1
            del self._traces[victim]
            self.dropped_traces += 1

    def event(self, trace_id, name, replica=None, ts=None, **attrs):
        """Record one span event. Unknown ids get a shell trace (late
        enable / post-eviction stitching stays lossy-but-safe); events
        after a terminal are dropped unless `name` reopens the trace."""
        if not _enabled or trace_id is None:
            return
        if ts is None:
            ts = self.clock()
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None:
                tr = Trace(trace_id, str(attrs.get("tenant", "default")))
                self._traces[trace_id] = tr
                self._open += 1
                self._evict_locked()
            if tr.done:
                if name in _REOPEN_EVENTS:
                    tr.done = False
                    tr.outcome = None
                    self._open += 1
                else:
                    return
            if len(tr.events) >= self.max_events:
                tr.dropped_events += 1
                if _pmetrics._enabled:
                    _smetrics.SERVING_TRACE_EVENTS_DROPPED.inc()
                return
            if tr._last_ts is not None and ts < tr._last_ts:
                ts = tr._last_ts
            tr._last_ts = ts
            tr.events.append(TraceEvent(name, ts, replica, attrs))
        if _pmetrics._enabled:
            _smetrics.SERVING_TRACE_EVENTS.labels(name).inc()
        self._set_active_gauge()

    def finish(self, trace_id, outcome, replica=None, ts=None, **attrs):
        """Close a trace with a terminal outcome. Idempotent: the first
        terminal wins (the router's abandon path and the engine's
        cancel path may both fire; double-closing would double-count
        `SERVING_TRACES`)."""
        if not _enabled or trace_id is None:
            return
        if ts is None:
            ts = self.clock()
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None or tr.done:
                return
            if tr._last_ts is not None and ts < tr._last_ts:
                ts = tr._last_ts
            tr._last_ts = ts
            # the terminal event always lands, even past max_events
            tr.events.append(TraceEvent(outcome, ts, replica, attrs))
            tr.done = True
            tr.outcome = outcome
            self._open -= 1
        if _pmetrics._enabled:
            _smetrics.SERVING_TRACES.labels(outcome).inc()
        self._set_active_gauge()

    def _set_active_gauge(self):
        if _pmetrics._enabled:
            _smetrics.SERVING_TRACE_ACTIVE.set(self._open)

    # ------------------------------------------------------- queries
    def get(self, trace_id):
        with self._lock:
            return self._traces.get(trace_id)

    def traces(self):
        with self._lock:
            return list(self._traces.values())

    def active(self):
        """Open traces — the smoke tool's orphan check: after a clean
        drain this must be empty."""
        with self._lock:
            return [t for t in self._traces.values() if not t.done]

    def reset(self):
        with self._lock:
            self._traces.clear()
            self._open = 0
            self.dropped_traces = 0
        self._set_active_gauge()

    # ------------------------------------------------------ observers
    def add_observer(self, obs):
        if obs not in self._observers:
            self._observers.append(obs)

    def remove_observer(self, obs):
        try:
            self._observers.remove(obs)
        except ValueError:
            pass

    def _notify(self, method, *args):
        for obs in list(self._observers):
            fn = getattr(obs, method, None)
            if fn is not None:
                fn(*args)

    # ----------------------------------------------- chrome / summary
    def chrome_events(self):
        """Per-trace track: phase "X" slices (queued / prefill /
        decode) + one instant per raw event, ts in µs like the host
        recorder."""
        pid = os.getpid()
        out = []
        for tr in self.traces():
            tid = f"trace:{tr.trace_id}"
            for e in tr.events:
                out.append({"name": e.name, "ph": "i", "s": "t",
                            "ts": e.ts * 1e6, "pid": pid, "tid": tid,
                            "args": e.as_dict()})
            d = tr.derive()
            enq = tr.first("enqueued")
            adm = tr.first("admitted")
            ft = tr.first("first_token")
            last = tr.events[-1] if tr.events else None
            for name, a, b in (("queued", enq, adm),
                               ("prefill", adm, ft),
                               ("decode", ft, last)):
                if a is not None and b is not None and b.ts >= a.ts:
                    out.append({"name": f"{name}[{tr.tenant}]",
                                "ph": "X", "ts": a.ts * 1e6,
                                "dur": (b.ts - a.ts) * 1e6,
                                "pid": pid, "tid": tid,
                                "args": {"trace_id": tr.trace_id}})
        return out

    def summary_table(self):
        traces = self.traces()
        if not traces:
            return ""
        by_outcome = collections.Counter(
            t.outcome or "open" for t in traces)
        ttfts = [d["ttft"] for d in (t.derive() for t in traces)
                 if d["ttft"] is not None]
        lines = ["---- request traces (serving.tracing) ----",
                 f"{'Outcome':16s} {'Traces':>8s}"]
        for outcome, n in sorted(by_outcome.items()):
            lines.append(f"{outcome:16s} {n:>8d}")
        if ttfts:
            lines.append(f"span-derived TTFT mean "
                         f"{sum(ttfts) / len(ttfts) * 1e3:.2f} ms over "
                         f"{len(ttfts)} trace(s)")
        if self.dropped_traces:
            lines.append(f"(trace table evicted {self.dropped_traces}; "
                         f"raise PADDLE_TPU_TRACE_CAPACITY)")
        return "\n".join(lines)


TRACER = RequestTracer()


# ---------------------------------------------------------------- hooks
# The engine, scheduler, router and transport call these; every call
# site tests `if tracing._enabled:` first, so the off path stays one
# branch (the check inside `RequestTracer.event` guards direct callers).

def ensure_trace(req):
    """Attach a trace id to a request, minting one when the router did
    not (solo engines submit without a frontend)."""
    if req.trace_id is None:
        req.trace_id = TRACER.mint(tenant=req.tenant)
    return req.trace_id


def on_submit(req, replica=None):
    ensure_trace(req)
    TRACER.event(req.trace_id, "enqueued", replica=replica,
                 ts=req.submit_time, tenant=req.tenant,
                 prompt_tokens=len(req.prompt))


def on_submit_migrated(req, replica=None, ts=None):
    ensure_trace(req)
    TRACER.event(req.trace_id, "decode_admission", replica=replica,
                 ts=ts, tenant=req.tenant, tokens_done=len(req.output))


def on_admitted(req, replica=None, kind="prefill", ts=None):
    """kind: "prefill" (fresh), "re_prefill" (after preemption, or a
    migrant that lost its imported blocks), "import" (migrated-in KV).
    Only the fresh admission observes the queue-wait histogram — its
    span twin is `admitted.ts - enqueued.ts` of the same trace."""
    TRACER.event(req.trace_id, "admitted", replica=replica, ts=ts,
                 kind=kind, slot=req.slot,
                 cached_tokens=req.cache_hit_tokens)
    if (kind == "prefill" and _pmetrics._enabled and ts is not None):
        _smetrics.SERVING_TRACE_QUEUE_WAIT.observe(
            max(0.0, ts - req.submit_time))


def on_first_token(req, replica=None, ts=None):
    TRACER.event(req.trace_id, "first_token", replica=replica, ts=ts)
    if ts is not None:
        TRACER._notify("on_ttft", req.tenant, ts - req.submit_time, ts)


def on_tokens(req, replica=None, ts=None, n=1, gap=None, verify=False):
    TRACER.event(req.trace_id,
                 "verify_step" if verify else "decode_step",
                 replica=replica, ts=ts, tokens=n, gap=gap)
    if gap is not None:
        TRACER._notify("on_inter_token", req.tenant, gap, ts)


def on_preempted(req, replica=None, ts=None):
    TRACER.event(req.trace_id, "preempted", replica=replica, ts=ts,
                 preemptions=req.preemptions)


def on_extracted(req, ticket, replica=None):
    TRACER.event(req.trace_id, "handoff_export", replica=replica,
                 ts=ticket.created_at, slot_len=ticket.slot_len,
                 blocks=sum(c.count for c in ticket.chunks),
                 shipped_ahead=ticket.total_blocks
                 - sum(c.count for c in ticket.chunks))


def on_transport(trace_id, src, dst, nbytes=0, blocks=0):
    TRACER.event(trace_id, "migration_transport",
                 replica=f"{src}->{dst}", bytes=nbytes, blocks=blocks)


def on_terminal(req, outcome, replica=None, ts=None):
    missed = outcome == "expired" or (
        req.deadline is not None and ts is not None
        and ts > req.deadline)
    TRACER.finish(req.trace_id, outcome, replica=replica, ts=ts,
                  tokens=len(req.output), deadline_missed=missed)
    TRACER._notify("on_outcome", req.tenant, outcome, missed,
                   ts if ts is not None else TRACER.clock())


# ------------------------------------------------- step flight recorder
_FLIGHT = weakref.WeakSet()
_FLIGHT_LOCK = threading.Lock()


def register_flight_recorder(rec):
    with _FLIGHT_LOCK:
        _FLIGHT.add(rec)


def flight_recorders():
    with _FLIGHT_LOCK:
        return list(_FLIGHT)


class StepFlightRecorder:
    """Bounded per-engine ring of per-step records. The engine notes one
    record a `step()` (a dispatch, on a multi-tick engine) — host ints
    and floats it already holds — only while tracing is on; the ring is
    sized by PADDLE_TPU_FLIGHT_STEPS (default 4096), so a long-lived
    replica keeps a recent window, not its whole history. Noting and
    reading take the ring's lock (an engine steps on an executor thread
    while another thread exports)."""

    def __init__(self, engine_name, role, maxlen=None):
        if maxlen is None:
            maxlen = int(os.environ.get(
                "PADDLE_TPU_FLIGHT_STEPS", 4096))
        self.engine_name = engine_name
        self.role = role
        self.maxlen = max(1, int(maxlen))
        self.records = collections.deque(maxlen=self.maxlen)
        self.dropped = 0
        self.steps = 0
        self._lock = threading.Lock()

    def note(self, **fields):
        with self._lock:
            if len(self.records) == self.maxlen:
                self.dropped += 1
            self.records.append(fields)
            self.steps += 1

    def snapshot(self):
        """The ring's records, oldest first (a copy)."""
        with self._lock:
            return list(self.records)

    def chrome_events(self):
        pid = os.getpid()
        tid = f"engine:{self.engine_name}"
        out = []
        for r in self.snapshot():
            args = {k: v for k, v in r.items()
                    if k not in ("ts", "dur")}
            out.append({"name": f"step[{self.role}]", "ph": "X",
                        "ts": r.get("ts", 0.0) * 1e6,
                        "dur": r.get("dur", 0.0) * 1e6,
                        "pid": pid, "tid": tid, "args": args})
        return out

    def summary(self):
        recs = self.snapshot()
        agg = {"engine": self.engine_name, "role": self.role,
               "steps": self.steps, "dropped": self.dropped}
        if recs:
            agg["prefill_tokens"] = sum(
                r.get("prefill_tokens", 0) for r in recs)
            agg["decode_tokens"] = sum(
                r.get("decode_tokens", 0) for r in recs)
            durs = [r.get("dur", 0.0) for r in recs]
            agg["step_ms_mean"] = sum(durs) / len(durs) * 1e3
            agg["step_ms_max"] = max(durs) * 1e3
            # multi-tick dispatches: the ticks each ran and the events
            # that ended them early — absent on single-tick engines,
            # whose records carry no tick fields
            ticks = [r["ticks"] for r in recs if "ticks" in r]
            if ticks:
                agg["dispatches"] = len(ticks)
                agg["ticks_total"] = sum(ticks)
                agg["ticks_per_dispatch_mean"] = (
                    sum(ticks) / len(ticks))
                agg["early_exit_finish"] = sum(
                    r.get("early_exit_finish", 0) for r in recs)
                agg["early_exit_overflow"] = sum(
                    r.get("early_exit_overflow", 0) for r in recs)
                agg["host_stall_s"] = sum(
                    r.get("host_stall", 0.0) for r in recs)
        return agg


# ----------------------------------------------- profiler registration
def _chrome_source():
    events = []
    for rec in flight_recorders():
        events.extend(rec.chrome_events())
    events.extend(TRACER.chrome_events())
    return events


def _summary_section():
    parts = []
    tbl = TRACER.summary_table()
    if tbl:
        parts.append(tbl)
    flights = [rec.summary() for rec in flight_recorders()
               if rec.steps]
    if flights:
        lines = ["---- step flight recorders (serving.tracing) ----",
                 f"{'Engine':14s} {'Role':8s} {'Steps':>7s} "
                 f"{'Prefill':>8s} {'Decode':>8s} {'ms/step':>8s}"]
        for f in sorted(flights, key=lambda f: f["engine"]):
            lines.append(
                f"{f['engine']:14s} {f['role']:8s} {f['steps']:>7d} "
                f"{f.get('prefill_tokens', 0):>8d} "
                f"{f.get('decode_tokens', 0):>8d} "
                f"{f.get('step_ms_mean', 0.0):>8.2f}")
        parts.append("\n".join(lines))
    return "\n\n".join(parts)


from .. import profiler as _profiler  # noqa: E402  (cycle-safe: the
# profiler package never imports serving; registration at import time
# is what lets export_chrome_tracing / summary() see these stores)
_profiler.register_chrome_source(_chrome_source)
_profiler.register_summary_section(_summary_section)
