"""FleetController: boot, drain, upgrade and retire replicas through the
router's quiesce plane.

Port of `paddle_tpu/serving/fleet/controller.py`. One controller runs
one `ReplicaRouter` against one `FleetBundle`. Replica indices are
append-only: a retired replica is stopped and marked down, never
reindexed, so streams, metric labels and the health plane stay
coherent.

* `boot_replica()` — an engine from the bundle (an optional prefix
  spill restored), an optional probe prompt whose first token closes
  the measured cold start, then `router.add_replica`.
* `drain(idx)` — quiesce and wait until the replica holds no work.
* `retire(idx)` — drain, stop the frontend, spill the prefix cache
  (with a `spill_dir`), close the engine, mark it down.
* `rolling_upgrade(weights, version)` — `upgrade.rolling_upgrade`,
  then the census.
* `scale_up(reason)` / `scale_down(reason)` — the autoscaler's
  actuators (scale-down retires the last booted replica first).

While `profiler.metrics` records: `FLEET_BOOTS{kind}`,
`FLEET_COLD_START`, `FLEET_REPLICAS{role, version}` (pairs that empty
out read 0), `FLEET_SCALE_EVENTS{direction, reason}`; the upgrade
counts `FLEET_UPGRADES`.
"""
from __future__ import annotations

import asyncio
import os

import torch

from ...profiler import metrics as _pmetrics
from .. import metrics as smetrics
from .export import FleetBundle, boot_engine_from_bundle


class FleetController:
    def __init__(self, router, bundle=None, *, spill_dir=None, clock=None,
                 max_pending=256, device=None):
        self.router = router
        self.bundle = (FleetBundle(bundle) if isinstance(bundle, str)
                       else bundle)
        self.spill_dir = spill_dir
        self.clock = clock if clock is not None else router.clock
        self.max_pending = int(max_pending)
        #: where booted replicas run (default: replica 0's device)
        self.device = (torch.device(device) if device is not None
                       else router.frontends[0].engine.device)
        self.retired = set()
        self.booted = []          # indices this controller booted
        self._census_seen = set()
        self._census()

    # ------------------------------------------------------------ state
    def active_replicas(self):
        """Indices in rotation: not retired, not marked down (the health
        plane's flags, read without probing)."""
        return [i for i in range(len(self.router.frontends))
                if i not in self.retired
                and not self.router.health._down[i]]

    def _census(self):
        """`FLEET_REPLICAS{role, version}` from the live fleet; label
        pairs that emptied out are set to 0, not dropped."""
        if not _pmetrics._enabled:
            return
        counts = {}
        for i in self.active_replicas():
            key = (self.router.roles[i], self.router._version(i))
            counts[key] = counts.get(key, 0) + 1
        for key in self._census_seen - set(counts):
            smetrics.FLEET_REPLICAS.labels(*key).set(0)
        for key, n in counts.items():
            smetrics.FLEET_REPLICAS.labels(*key).set(n)
        self._census_seen |= set(counts)

    def _spill_path(self, engine):
        if self.spill_dir is None or engine.prefix_cache is None:
            return None
        os.makedirs(self.spill_dir, exist_ok=True)
        return os.path.join(self.spill_dir, f"prefix_{engine.name}.pkl")

    # ------------------------------------------------------------- boot
    async def boot_replica(self, *, aot=True, warm_prefix=None, name=None,
                           probe_prompt=None, probe_tokens=1, **overrides):
        """Boot one replica from the bundle and put it in rotation;
        returns its index. `warm_prefix` restores a prefix spill (a warm
        boot). A `probe_prompt` serves `probe_tokens` through the fresh
        engine first, so the recorded cold start runs from boot to its
        first token. `aot` changes nothing (the port has no bundled
        executable)."""
        from ..frontend import ServingFrontend
        if self.bundle is None:
            raise ValueError("boot_replica needs a FleetBundle")
        t0 = self.clock()
        engine = boot_engine_from_bundle(
            self.bundle, aot=aot, warm_prefix=warm_prefix, name=name,
            device=self.device, **overrides)
        if probe_prompt is not None:
            engine.generate_batch([list(probe_prompt)],
                                  max_new_tokens=int(probe_tokens))
        dt = self.clock() - t0
        warm = (warm_prefix is not None and engine.prefix_cache is not None
                and engine.prefix_cache.cached_blocks > 0)
        if _pmetrics._enabled:
            smetrics.FLEET_BOOTS.labels("warm" if warm else "cold").inc()
            smetrics.FLEET_COLD_START.observe(dt)
        fe = ServingFrontend(engine, max_pending=self.max_pending)
        idx = await self.router.add_replica(fe, engine.role)
        self.booted.append(idx)
        self._census()
        return idx

    # ------------------------------------------------------ drain/retire
    async def drain(self, idx, *, poll_s=0.005, timeout_s=30.0):
        """Quiesce replica `idx` and wait until its in-flight work has
        finished on its current weights. It stays healthy and
        quiesced."""
        self.router.quiesce(idx)
        deadline = self.clock() + float(timeout_s)
        while not self.router.is_drained(idx):
            if self.clock() > deadline:
                raise TimeoutError(
                    f"replica {idx} did not drain within {timeout_s}s")
            await asyncio.sleep(poll_s)

    async def retire(self, idx, *, spill_prefix=None):
        """Drain, stop and close replica `idx`, spilling its prefix cache
        when configured; its index stays allocated and marked down.
        Returns the blocks spilled."""
        await self.drain(idx)
        fe = self.router.frontends[idx]
        await fe.stop()
        spill = (spill_prefix if spill_prefix is not None
                 else self._spill_path(fe.engine))
        spilled = fe.engine.close(spill_prefix=spill)
        self.retired.add(idx)
        self.router.health.mark_down(idx)
        self._census()
        return spilled

    # ---------------------------------------------------------- upgrade
    async def rolling_upgrade(self, weights, version, **kw):
        """Flip the fleet to (`weights`, `version`), one drained replica
        at a time; returns the flipped indices. The bundle is not
        rewritten: export one for each version that should boot."""
        from .upgrade import rolling_upgrade
        flipped = await rolling_upgrade(self.router, weights, version, **kw)
        self._census()
        return flipped

    # ------------------------------------------------------------ scale
    async def scale_up(self, reason, **boot_kw):
        idx = await self.boot_replica(**boot_kw)
        if _pmetrics._enabled:
            smetrics.FLEET_SCALE_EVENTS.labels("up", str(reason)).inc()
        return idx

    async def scale_down(self, reason):
        """Retire the last booted active replica (the hand-built fleet
        stays whole at the smallest scale)."""
        active = set(self.active_replicas())
        cands = [i for i in self.booted if i in active]
        idx = cands[-1] if cands else max(active)
        await self.retire(idx)
        if _pmetrics._enabled:
            smetrics.FLEET_SCALE_EVENTS.labels("down", str(reason)).inc()
        return idx
