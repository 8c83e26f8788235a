"""Replica health for the multi-replica router.

Port of `paddle_tpu/serving/distributed/health.py`. A replica is one
`ServingFrontend` (its background step-loop task drives one engine). A
replica is DISPATCHABLE while its step-loop task exists, has not
finished, and the frontend has not been closed: exactly the conditions
under which a submitted request will be served. A step loop that died on
an engine exception, a stopped frontend or a cancelled task all probe
as down.

Two consumers: the router's dispatch calls `alive(i)` for each request,
so a death is noticed at the next dispatch; the async prober (`run()`)
sweeps every `interval` seconds and fires the replica's `down_event`,
which the router's in-flight streams wait on beside their token queue
(the rescue of requests stranded on a replica that died without failing
its handles). `snapshot()` gives the up/down split; every change to it
(`add`, `mark_down`, `mark_up`) sets the
`paddle_tpu_serving_router_replicas_up` gauge while
`profiler.metrics._enabled` is on.
"""
from __future__ import annotations

import asyncio

from ...profiler import metrics as _pmetrics
from ..metrics import ROUTER_REPLICAS_UP


class ReplicaHealth:
    def __init__(self, frontends):
        self.frontends = list(frontends)
        n = len(self.frontends)
        self._down = [False] * n
        self._events = [None] * n      # created lazily (they need a loop)
        self.probes = 0

    def __len__(self):
        return len(self.frontends)

    def add(self, frontend):
        """Track one more replica. Indices are append-only (a retired
        replica keeps its index, marked down), so in-flight streams'
        watchers stay valid. Returns the new replica's index."""
        self.frontends.append(frontend)
        self._down.append(False)
        self._events.append(None)
        self._export()
        return len(self.frontends) - 1

    def probe(self, i):
        """True when replica `i`'s step loop is running now."""
        self.probes += 1
        fe = self.frontends[i]
        task = fe._task
        return not fe._closed and task is not None and not task.done()

    def alive(self, i):
        """Dispatchable: not marked down and probing healthy. A failed
        probe marks the replica down, so dispatch never races the
        prober."""
        if self._down[i]:
            return False
        if not self.probe(i):
            self.mark_down(i)
            return False
        return True

    @property
    def num_up(self):
        return sum(self.alive(i) for i in range(len(self.frontends)))

    def mark_down(self, i):
        if not self._down[i]:
            self._down[i] = True
            ev = self._events[i]
            if ev is not None:
                ev.set()
        self._export()

    def mark_up(self, i):
        """Revive a replica by hand (a restarted frontend). The SAME Event
        is cleared rather than replaced: in-flight watchers hold it, and
        a fresh one would leave them waiting on the old one at the next
        death."""
        self._down[i] = False
        ev = self._events[i]
        if ev is not None:
            ev.clear()
        self._export()

    def down_event(self, i):
        """The asyncio.Event fired when replica `i` goes down."""
        ev = self._events[i]
        if ev is None:
            ev = self._events[i] = asyncio.Event()
            if self._down[i]:
                ev.set()
        return ev

    def snapshot(self):
        return {"up": [i for i, d in enumerate(self._down) if not d],
                "down": [i for i, d in enumerate(self._down) if d],
                "probes": self.probes}

    def _export(self):
        if _pmetrics._enabled:
            ROUTER_REPLICAS_UP.set(sum(1 for d in self._down if not d))

    async def run(self, interval=0.05):
        """Background sweep: fire the down events of replicas whose step
        loop died without failing its handles. The router cancels it on
        stop."""
        while True:
            for i in range(len(self.frontends)):
                if not self._down[i] and not self.probe(i):
                    self.mark_down(i)
            await asyncio.sleep(interval)
