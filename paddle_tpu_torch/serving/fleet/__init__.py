"""The fleet control plane: replicas booted, upgraded and scaled.

Port of `paddle_tpu/serving/fleet/`:

* `export` — versioned boot bundles (model config, engine knobs,
  kv_meta and the canonical weights, in the JAX package's on-disk
  format); `boot_engine_from_bundle` brings a `ServingEngine` up from
  one. The port bundles no executable: its replicas run eagerly, and a
  boot in a process that has built the kernels runs no `nvcc`.
* `upgrade` — the live weight swap's checkpoint plumbing and the
  rolling upgrade through the router's quiesce / drain plane.
* `autoscaler` — SLO-burn-driven scale decisions from host state only,
  with sustained-burn, recovery and cooldown hysteresis and a cost
  model's gate on scale-down.
* `controller.FleetController` — boot, drain, retire, upgrade and
  scale a live `ReplicaRouter`, recording the `FLEET_*` metrics.
"""
from . import autoscaler, controller, export, upgrade  # noqa: F401
from .autoscaler import AutoscalerPolicy, SLOAutoscaler
from .controller import FleetController
from .export import FleetBundle, boot_engine_from_bundle, export_bundle
from .upgrade import rolling_upgrade, weights_from_bundle, weights_from_model

__all__ = [
    "FleetBundle", "export_bundle", "boot_engine_from_bundle",
    "FleetController", "SLOAutoscaler", "AutoscalerPolicy",
    "weights_from_model", "weights_from_bundle", "rolling_upgrade",
    "export", "upgrade", "autoscaler", "controller",
]
