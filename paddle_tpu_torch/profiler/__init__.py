"""paddle_tpu_torch.profiler.

Port of `paddle_tpu/profiler/`: host spans (`RecordEvent`) in a bounded
ring, the metrics registry (`metrics`), one merged text report
(`summary()`) and a chrome-trace export (`export_chrome_tracing`).
Subsystems that own event stores of their own (the serving tracer and
the engines' step flight recorders) plug in through
`register_chrome_source` / `register_summary_section`, so this package
never imports the serving stack.

The device plane is `torch.profiler.profile` — the CPU activity, and
the CUDA activity when a card is present — where the JAX package runs
`jax.profiler.start_trace` and parses its xplane files. `Profiler`
raises when that profiler fails to start or stop: a failure is never
turned into an empty reading.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from enum import Enum

from . import metrics
from .metrics import REGISTRY as metrics_registry  # noqa: F401


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    TPU = 2


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class _HostEventRecorder:
    """Bounded ring of host spans. Keeps the newest `maxlen` spans; when
    full, the oldest is dropped and counted (`.dropped` and
    paddle_tpu_profiler_host_events_dropped_total), so a long run never
    grows it without limit."""

    def __init__(self, maxlen=None):
        if maxlen is None:
            maxlen = int(os.environ.get(
                "PADDLE_TPU_PROFILER_EVENTS_MAX", 65536))
        self.maxlen = max(1, int(maxlen))
        self.events = collections.deque(maxlen=self.maxlen)
        self.dropped = 0
        self.lock = threading.Lock()

    def add(self, name, start, end, tid):
        with self.lock:
            if len(self.events) == self.maxlen:
                self.dropped += 1
                if metrics._enabled:
                    metrics.HOST_EVENTS_DROPPED.inc()
            self.events.append(
                {"name": name, "ph": "X", "ts": start * 1e6,
                 "dur": (end - start) * 1e6, "pid": os.getpid(),
                 "tid": tid})

    def clear(self):
        with self.lock:
            self.events.clear()
            self.dropped = 0


_recorder = _HostEventRecorder()
_recording = [False]

# Pluggable providers: a chrome source returns a list of trace-event
# dicts merged into export_chrome_tracing's file; a summary section
# returns a text block (or "" to stay silent) appended to summary().
_chrome_sources = []
_summary_sections = []


def register_chrome_source(fn):
    if fn not in _chrome_sources:
        _chrome_sources.append(fn)


def register_summary_section(fn):
    if fn not in _summary_sections:
        _summary_sections.append(fn)


def _extra_chrome_events():
    events = []
    for fn in list(_chrome_sources):
        events.extend(fn() or [])
    return events


def _extra_summary_sections():
    parts = []
    for fn in list(_summary_sections):
        text = fn()
        if text:
            parts.append(text)
    return parts


class RecordEvent:
    """A user span on the host clock (`time.perf_counter`), recorded
    while a `Profiler` runs."""

    def __init__(self, name, event_type=None):
        self.name = name
        self._start = None
        self._tid = None

    def begin(self):
        self._start = time.perf_counter()
        # the opening thread's id: a span begun on a worker thread lands
        # on that thread's row, even when another thread ends it
        self._tid = threading.get_ident()

    def end(self):
        if self._start is not None and _recording[0]:
            _recorder.add(self.name, self._start, time.perf_counter(),
                          self._tid if self._tid is not None
                          else threading.get_ident())
        self._start = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *a):
        self.end()


def make_scheduler(closed=0, ready=1, record=4, repeat=0, skip_first=0):
    def scheduler(step):
        s = step - skip_first
        if s < 0:
            return ProfilerState.CLOSED
        total = closed + ready + record
        pos = s % total if repeat == 0 or s < repeat * total else None
        if pos is None:
            return ProfilerState.CLOSED
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        return ProfilerState.RECORD
    return scheduler


def export_chrome_tracing(dir_name, worker_name=None):
    """An `on_trace_ready` handler writing the host spans, one counter
    sample per metric series (while recording is on) and the registered
    sources' events to `<dir_name>/<worker_name or 'worker'>_<unix
    time>.json` (its path in the profiler's `exported_path`)."""
    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        path = os.path.join(
            dir_name, f"{worker_name or 'worker'}_{int(time.time())}.json")
        events = list(_recorder.events)
        if metrics._enabled:
            events += metrics.REGISTRY.chrome_counter_events()
        events += _extra_chrome_events()
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)
        prof.exported_path = path
    return handler


class Profiler:
    """Host spans plus the torch.profiler device plane.

    `start()` turns `RecordEvent` recording on and, unless
    `timer_only`, starts `torch.profiler.profile` (the CUDA activity
    when a card is present or `targets` names `ProfilerTarget.GPU`);
    `stop()` stops both and calls `on_trace_ready(self)`. Either raises
    when torch.profiler does."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=False):
        self.scheduler = scheduler or (lambda step: ProfilerState.RECORD)
        self.on_trace_ready = on_trace_ready
        self.step_num = 0
        self.timer_only = timer_only
        self.targets = None if targets is None else list(targets)
        self.record_shapes = record_shapes
        self.profile_memory = profile_memory
        self.with_flops = with_flops
        self.exported_path = None
        self._prof = None         # the torch.profiler.profile, once started
        self._running = False

    def _activities(self):
        import torch
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        want_gpu = (torch.cuda.is_available() if self.targets is None
                    else ProfilerTarget.GPU in self.targets)
        if want_gpu:
            acts.append(ProfilerActivity.CUDA)
        return acts

    def start(self):
        if not self.timer_only:
            from torch.profiler import profile
            prof = profile(activities=self._activities(),
                           record_shapes=self.record_shapes,
                           profile_memory=self.profile_memory,
                           with_flops=self.with_flops)
            prof.start()
            self._prof, self._running = prof, True
        _recording[0] = True

    def stop(self):
        _recording[0] = False
        if self._running:
            self._running = False
            self._prof.stop()
        if self.on_trace_ready:
            self.on_trace_ready(self)

    def step(self, num_samples=None):
        self.step_num += 1

    def step_info(self, unit=None):
        return f"step {self.step_num}"

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms", top_k=30):
        """The host span table, the device kernel table of this run's
        torch.profiler (or the line saying why there is none), the
        metrics table while recording is on, and the registered
        sections. Printed and returned."""
        out = statistic_report(
            list(_recorder.events), prof=self._prof,
            sorted_by=sorted_by or SortedKeys.CPUTotal, top_k=top_k)
        if metrics._enabled:
            out = out + "\n\n" + metrics.REGISTRY.render_table()
        extra = _extra_summary_sections()
        if extra:
            out = "\n\n".join([out] + extra)
        print(out)
        return out


from .statistic import (SortedKeys, device_statistic_table,  # noqa: E402
                        host_statistic_table, statistic_report)
from .timer import Benchmark, benchmark  # noqa: E402,F401


def summary(sorted_by=None, prof=None, top_k=30):
    """One merged report without a Profiler instance: the host span
    table, the device kernel table of `prof` (a finished `Profiler` or
    `torch.profiler.profile`) when given, a note of dropped spans, the
    metrics registry table, and the registered sections (the serving
    tracer's and flight recorders')."""
    if isinstance(prof, Profiler):
        prof = prof._prof
    parts = [statistic_report(list(_recorder.events), prof=prof,
                              sorted_by=sorted_by or SortedKeys.CPUTotal,
                              top_k=top_k)]
    if _recorder.dropped:
        parts.append(f"(host ring buffer dropped {_recorder.dropped} "
                     f"spans; raise PADDLE_TPU_PROFILER_EVENTS_MAX)")
    parts.append(metrics.REGISTRY.render_table())
    parts.extend(_extra_summary_sections())
    return "\n\n".join(parts)


__all__ = ["Benchmark", "Profiler", "ProfilerState", "ProfilerTarget",
           "RecordEvent", "SortedKeys", "benchmark",
           "device_statistic_table", "export_chrome_tracing",
           "host_statistic_table", "make_scheduler", "metrics",
           "metrics_registry", "register_chrome_source",
           "register_summary_section", "statistic_report", "summary"]
