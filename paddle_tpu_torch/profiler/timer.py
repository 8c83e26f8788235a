"""Throughput benchmark timer.

Port of `paddle_tpu/profiler/timer.py`: the `benchmark()` singleton
that reports reader cost, batch cost and ips a step, and sets the
training throughput gauges while recording is on.
"""
from __future__ import annotations

import time

from . import metrics as _metrics


class _Stat:
    def __init__(self):
        self.total = 0.0
        self.count = 0
        self.window = []

    def add(self, v, win=20):
        self.total += v
        self.count += 1
        self.window.append(v)
        if len(self.window) > win:
            self.window.pop(0)

    @property
    def avg(self):
        return self.total / max(self.count, 1)

    @property
    def window_avg(self):
        return sum(self.window) / max(len(self.window), 1)


class Benchmark:
    def __init__(self):
        self.reset()

    def reset(self):
        self._reader = _Stat()
        self._batch = _Stat()
        self._ips = _Stat()
        self._last = None
        self._reader_start = None
        self.current_event = None

    # ---- hooks (reference timer.py Event protocol) ----
    def begin(self):
        self.reset()
        self._last = time.perf_counter()
        self._reader_start = self._last

    def before_reader(self):
        self._reader_start = time.perf_counter()

    def after_reader(self):
        if self._reader_start is not None:
            self._reader.add(time.perf_counter() - self._reader_start)

    def after_step(self, num_samples=None, num_steps=1):
        """num_steps > 1 when one dispatch covered a grouped flush of
        several train steps (hapi's run_many path)."""
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self._batch.add(dt)
            if num_samples and dt > 0:
                self._ips.add(num_samples / dt)
            if _metrics._enabled:
                # every fit path funnels through this hook, so the
                # throughput gauges cover per-step AND grouped dispatch
                b = self._batch.window_avg
                if b > 0:
                    _metrics.STEPS_PER_SEC.set(max(num_steps, 1) / b)
                _metrics.SAMPLES_PER_SEC.set(self._ips.window_avg)
        self._last = now
        self._reader_start = now

    step = after_step

    def step_info(self, unit="samples"):
        r = self._reader.window_avg
        b = self._batch.window_avg
        ips = self._ips.window_avg
        return (f"reader_cost: {r:.5f} s, batch_cost: {b:.5f} s, "
                f"ips: {ips:.3f} {unit}/s")

    # summary over the full run
    def report(self, unit="samples"):
        return {
            "reader_cost_avg": self._reader.avg,
            "batch_cost_avg": self._batch.avg,
            "ips_avg": self._ips.avg,
            "steps": self._batch.count,
            "unit": f"{unit}/s",
        }


_benchmark = Benchmark()


def benchmark() -> Benchmark:
    return _benchmark
