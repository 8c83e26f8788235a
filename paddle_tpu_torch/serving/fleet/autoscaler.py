"""SLO-burn-driven autoscaling.

Port of `paddle_tpu/serving/fleet/autoscaler.py`. A decision reads host
state only: the SLO monitor's windows, the router's queue depths and
the flight recorders' step times (no device read). It is gated by a
cost model:

* `predict_ttft(extra)` — queued requests a replica x the mean step
  time, with `extra` more (or fewer) replicas sharing the load;
* `predict_inter_token()` — the mean step time (a decode emits at most
  one token a slot a step);

and hysteresis keeps the fleet from flapping:

* scale up only when some objective's burn rate has exceeded
  `burn_threshold` for `sustain_s` without a break;
* scale down only after `recovery_s` with every objective healthy, and
  only when the predicted TTFT after the removal meets the strictest
  `ttft_p95` target;
* `cooldown_s` between any two applied decisions.

`SLOAutoscaler.step()` evaluates once and applies at most one decision
through the controller (`scale_up` / `scale_down`); `run()` loops it.
Applied decisions land in `decisions`.
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import Optional


@dataclasses.dataclass
class AutoscalerPolicy:
    """The bounds and the hysteresis."""
    min_replicas: int = 1
    max_replicas: int = 4
    burn_threshold: float = 1.0   # a burn rate above this is burning
    sustain_s: float = 0.1        # the burn must last this long
    recovery_s: float = 0.3       # all healthy this long to scale down
    cooldown_s: float = 0.5       # the least gap between decisions


class SLOAutoscaler:
    def __init__(self, controller, monitor, *, policy=None, clock=None):
        self.controller = controller
        self.monitor = monitor
        self.policy = policy or AutoscalerPolicy()
        self.clock = clock or controller.clock
        self._burn_since: Optional[float] = None
        self._ok_since: Optional[float] = None
        self._last_applied: Optional[float] = None
        #: applied decisions: dicts of ts, direction, reason, replicas,
        #: the predictions and the replica acted on
        self.decisions = []

    # ------------------------------------------------------ cost model
    def mean_step_seconds(self):
        """The mean step duration in the active replicas' flight records
        (host floats the engines noted; 0.0 before any record)."""
        durs = []
        for idx in self.controller.active_replicas():
            rec = getattr(self.controller.router.frontends[idx].engine,
                          "flight", None)
            if rec is not None:
                durs.extend(r.get("dur", 0.0) for r in rec.records)
        return sum(durs) / len(durs) if durs else 0.0

    def queued_requests(self):
        r = self.controller.router
        return sum(r.queue_depth(i)
                   for i in self.controller.active_replicas())

    def predict_ttft(self, extra_replicas=0):
        """Queued requests a replica x the mean step time, with
        `extra_replicas` more (negative: fewer) replicas."""
        n = len(self.controller.active_replicas()) + extra_replicas
        if n <= 0:
            return float("inf")
        return (self.queued_requests() / n) * self.mean_step_seconds()

    def predict_inter_token(self):
        return self.mean_step_seconds()

    def _strictest_ttft_target(self):
        """The tightest `ttft_p95` target across tenants (0.5 when none is
        set): the bar a scale-down's predicted TTFT must clear."""
        cfg = self.monitor.config
        vals = [cfg.default.get("ttft_p95")]
        vals += [t.get("ttft_p95") for t in cfg.tenants.values()]
        vals = [v for v in vals if v is not None]
        return min(vals) if vals else 0.5

    # ------------------------------------------------------- decisions
    def _burning(self, report):
        """(tenant, objective, burn) of every objective above the
        threshold."""
        return [(tenant, obj, d["burn_rate"])
                for tenant, objs in report.items()
                for obj, d in objs.items()
                if d.get("burn_rate", 0.0) > self.policy.burn_threshold]

    def evaluate(self, now=None):
        """One decision or None: policy arithmetic over the monitor's
        report and the router's depths, nothing applied."""
        now = self.clock() if now is None else now
        pol = self.policy
        burning = self._burning(self.monitor.evaluate(now))
        n = len(self.controller.active_replicas())
        cooled = (self._last_applied is None
                  or now - self._last_applied >= pol.cooldown_s)
        if burning:
            self._ok_since = None
            if self._burn_since is None:
                self._burn_since = now
            sustained = now - self._burn_since >= pol.sustain_s
            if sustained and cooled and n < pol.max_replicas:
                tenant, obj, burn = max(burning, key=lambda t: t[2])
                return {"ts": now, "direction": "up", "reason": obj,
                        "tenant": tenant, "burn": burn, "replicas": n,
                        "predicted_ttft": self.predict_ttft(+1),
                        "predicted_inter_token":
                            self.predict_inter_token()}
            return None
        self._burn_since = None
        if self._ok_since is None:
            self._ok_since = now
        recovered = now - self._ok_since >= pol.recovery_s
        if recovered and cooled and n > pol.min_replicas:
            after = self.predict_ttft(-1)
            if after <= self._strictest_ttft_target():
                return {"ts": now, "direction": "down",
                        "reason": "recovered", "replicas": n,
                        "predicted_ttft": after,
                        "predicted_inter_token":
                            self.predict_inter_token()}
        return None

    async def step(self):
        """Evaluate once and apply at most one decision; returns it (or
        None)."""
        decision = self.evaluate()
        if decision is None:
            return None
        if decision["direction"] == "up":
            decision["replica"] = await self.controller.scale_up(
                decision["reason"])
        else:
            decision["replica"] = await self.controller.scale_down(
                decision["reason"])
        self._last_applied = decision["ts"]
        # both hysteresis clocks restart: the new census earns its next
        # decision from scratch
        self._burn_since = None
        self._ok_since = None
        self.decisions.append(decision)
        return decision

    async def run(self, interval=0.05):
        """Step every `interval` seconds until cancelled."""
        while True:
            await self.step()
            await asyncio.sleep(interval)
