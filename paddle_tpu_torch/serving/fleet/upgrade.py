"""Live weight swap and the rolling upgrade.

Port of `paddle_tpu/serving/fleet/upgrade.py`. The swap itself is
`ServingEngine.swap_weights` (the cast `__init__` applies, copied into
the engine's tensors between steps). This module holds the checkpoint
plumbing and the fleet-level policy:

    for each replica, one at a time:
        router.quiesce(idx)        # no new dispatch lands here
        wait until router.is_drained(idx)   # in-flight requests finish
        engine.swap_weights(new, version)   # on the old weights
        router.unquiesce(idx)      # back in rotation on the new ones

Every request runs start to finish on one version, and with two or more
replicas the fleet keeps serving throughout.
"""
from __future__ import annotations

import asyncio

from ...profiler import metrics as _pmetrics
from .. import metrics as smetrics
from .export import FleetBundle, _to_numpy


def weights_from_model(model):
    """A checkpoint from a (new-version) model: its `_gen_tensors()` as
    host numpy arrays, what `swap_weights` and bundles consume."""
    return [_to_numpy(t) for t in model._gen_tensors()]


def weights_from_bundle(bundle):
    """(arrays, version) of a `FleetBundle` (or a bundle path)."""
    if isinstance(bundle, str):
        bundle = FleetBundle(bundle)
    return bundle.weights(), bundle.version


async def rolling_upgrade(router, weights, version, *, drain_poll_s=0.005,
                          drain_timeout_s=30.0, replicas=None,
                          on_flip=None):
    """Flip the live replicas of `router` to (`weights`, `version`) one at
    a time through the quiesce / drain protocol; returns the flipped
    indices. `replicas` restricts the roll (default: every live replica
    not quiesced); `on_flip(idx)` runs after each replica is back in
    rotation. A fleet with fewer than two replicas in rotation is
    refused: nothing would serve during the drain. The replica is
    unquiesced even when its drain or swap raises."""
    targets = ([i for i in range(len(router.frontends))
                if i not in router._quiesced and router.health.alive(i)]
               if replicas is None else list(replicas))
    if len(targets) < 2 and replicas is None:
        raise ValueError(
            "rolling upgrade needs >= 2 replicas in rotation so the fleet "
            "keeps serving through each drain")
    flipped = []
    for idx in targets:
        router.quiesce(idx)
        try:
            deadline = router.clock() + float(drain_timeout_s)
            while not router.is_drained(idx):
                if router.clock() > deadline:
                    raise TimeoutError(f"replica {idx} did not drain within "
                                       f"{drain_timeout_s}s")
                await asyncio.sleep(drain_poll_s)
            # drained: the frontend's step loop touches the engine only
            # when its scheduler has work, so the swap runs race-free
            router.frontends[idx].engine.swap_weights(weights, version)
        finally:
            router.unquiesce(idx)
        flipped.append(idx)
        if _pmetrics._enabled:
            smetrics.FLEET_UPGRADES.inc()
        if on_flip is not None:
            on_flip(idx)
    return flipped
