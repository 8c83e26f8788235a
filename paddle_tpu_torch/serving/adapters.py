"""Multi-LoRA adapter slots for the serving engine's mixed step.

Port of `paddle_tpu/serving/adapters.py`. Many finetunes of one base
model are served side by side at a small marginal device cost each:

* **Fixed slot tensors.** Each hooked projection (fused qkv, attention
  out and, on dense stacks, ffn1 / ffn2) owns two device tensors
  `A [L, max_adapters, d_in, r]` and `B [L, max_adapters, r, d_out]` in
  the compute dtype. Their shapes never change: a load writes one slot
  in place, so the per-layer views the step reads stay valid.
* **Per-token adapter ids.** The engine builds a `[T]` vector of slot
  ids from the scheduler's slot table each step (each token takes its
  request's pinned slot, padding takes 0) and the step turns it into
  one `[T, K]` one-hot that every layer's `_lora_delta` reuses.
* **Slot 0 is the null adapter**: all-zero A and B, never assigned,
  never evicted. Base-model requests and padding carry slot 0, their
  delta is exactly 0.0, and their tokens equal those of an engine built
  without adapters.
* **The host cache**: reference-counted pins (every resident request
  pins its adapter, a pinned slot is never evicted, so admission blocks
  instead of overwriting a neighbour's slot), LRU eviction over
  unpinned slots, and a cold load that writes the slot in place on the
  engine's device.

LoRA changes the K/V a request writes, so requests under a non-null
adapter bypass the radix prefix cache (lookup and publish); base-model
requests keep full sharing. Preemption needs nothing more: the victim
re-prefills under the same adapter. MoE stacks hook qkv and attention
out only.

Under tensor parallelism a rank's slot tensors hold its share of each
projection (`parallel.mp_layers.SERVING_LORA_TP_SPECS`): the TP engine
reallocates them at the rank's widths and sets `prepare(name, payload)`,
which cuts a registered adapter's full host payload (and permutes
`lora_qkv_b` shard-major) before the in-place load. Registration still
takes and checks the full widths. The raw counters (`cache_hits`,
`cache_misses`, `evictions`, `load_seconds`) are always on; while
`profiler.metrics._enabled` is on they are mirrored into the
`paddle_tpu_serving_adapter_*` metrics.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .._device import resolve_device
from ..profiler import metrics as _pmetrics
from . import metrics as smetrics

#: hooked projection names, in the order the slot tensors are kept
DENSE_HOOKS = ("qkv", "out", "ffn1", "ffn2")
MOE_HOOKS = ("qkv", "out")


def hook_dims(decoder):
    """[(name, d_in, d_out)] of the decoder's hooked projections."""
    D = decoder.embed_dim
    inner = decoder.num_heads * decoder.head_dim
    hooks = [("qkv", D, 3 * inner), ("out", inner, D)]
    if not int(getattr(decoder, "num_expert", 0)):
        F = decoder.dim_feedforward
        hooks += [("ffn1", D, F), ("ffn2", F, D)]
    return hooks


class AdapterCache:
    """Fixed device slot tensors plus host pin / LRU bookkeeping for K
    LoRA adapters served through one mixed step.

    `max_adapters` counts slot 0 (the null adapter), so
    `max_adapters - 1` finetunes can be resident at once; any number can
    be registered, and a cold one loads into a free or evicted slot on
    demand."""

    def __init__(self, decoder, *, max_adapters, rank, alpha=None,
                 dtype=torch.float32, device="cuda", clock=time.monotonic):
        K = int(max_adapters)
        if K < 2:
            raise ValueError(
                f"max_adapters={K} leaves no usable slot past the "
                "reserved null adapter (slot 0); need >= 2")
        r = int(rank)
        if r < 1:
            raise ValueError(f"lora_rank must be >= 1, got {r}")
        self.max_adapters = K
        self.rank = r
        self.alpha = float(alpha) if alpha is not None else float(r)
        self.scaling = self.alpha / r      # folded into B at load time
        self.clock = clock
        self.hooks = hook_dims(decoder)
        self.num_layers = decoder.num_layers
        self.dtype = dtype
        self.device = resolve_device(device)
        L = self.num_layers
        #: {"lora_<hook>_a" / "lora_<hook>_b": the [L, K, ...] slot tensor}
        self.tensors = {}
        for name, di, do in self.hooks:
            self.tensors[f"lora_{name}_a"] = torch.zeros(
                (L, K, di, r), dtype=dtype, device=self.device)
            self.tensors[f"lora_{name}_b"] = torch.zeros(
                (L, K, r, do), dtype=dtype, device=self.device)
        # host ledger: slot 0 is the null adapter for good
        self._registry = {}                # adapter_id -> host weights
        self._resident = {}                # adapter_id -> slot
        self._slot_ids = [None] * K        # slot -> adapter_id
        self._pins = np.zeros(K, np.int64)
        self._stamp = np.zeros(K, np.int64)
        self._tick = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.evictions = 0
        self.load_seconds = 0.0
        #: prepare(name, payload) -> the payload as this cache's slot
        #: tensor `name` holds it (a TP rank's cut); None: as it is
        self.prepare = None

    # -------------------------------------------------------- inspection
    def layer_tensors(self, li):
        """Layer `li`'s slot tensors as `{name: [K, ...] view}`: views of
        tensors that loads write in place, so they stay current."""
        return {n: t[li] for n, t in self.tensors.items()}

    def known(self, adapter_id):
        return adapter_id in self._registry

    def resident(self, adapter_id):
        """True when the adapter sits in a device slot now (the null
        adapter always does)."""
        return adapter_id is None or adapter_id in self._resident

    @property
    def resident_count(self):
        """Assigned (non-null) slots."""
        return len(self._resident)

    @property
    def total_pins(self):
        return int(self._pins[1:].sum())

    @property
    def bytes_per_slot(self):
        """The device bytes one resident tenant costs: its slice of every
        slot tensor, r (d_in + d_out) L x the element size summed over
        the hooked projections (at a TP rank's widths on a rank)."""
        return sum(t[:, 0].numel() * t.element_size()
                   for t in self.tensors.values())

    # ------------------------------------------------------ registration
    def register(self, adapter_id, weights):
        """Register a finetune's host weights: `weights` maps each hooked
        projection name to an `(a, b)` pair shaped `[L, d_in, r]` /
        `[L, r, d_out]` (numpy arrays or CPU tensors). Host only: device
        slots are claimed at admission."""
        if adapter_id is None:
            raise ValueError("adapter_id None is the reserved null "
                             "adapter; it needs no registration")
        got = set(weights)
        want = {n for n, _, _ in self.hooks}
        if got != want:
            raise ValueError(
                f"adapter {adapter_id!r} must provide exactly "
                f"{sorted(want)}, got {sorted(got)}")
        L, r = self.num_layers, self.rank
        host = {}
        for name, di, do in self.hooks:
            a, b = (np.asarray(x) for x in weights[name])
            if a.shape != (L, di, r) or b.shape != (L, r, do):
                raise ValueError(
                    f"adapter {adapter_id!r} {name}: want a "
                    f"{(L, di, r)} / b {(L, r, do)}, got "
                    f"{a.shape} / {b.shape}")
            host[name] = (a, b)
        self._registry[adapter_id] = host
        return adapter_id

    # --------------------------------------------------------- residency
    def _touch(self, slot):
        self._tick += 1
        self._stamp[slot] = self._tick

    def acquire(self, adapter_id):
        """Pin `adapter_id` into a device slot for one resident request.
        Returns the slot, or None when every non-null slot is pinned by
        in-flight requests (the scheduler then leaves the request
        queued)."""
        if adapter_id is None:
            return 0
        host = self._registry.get(adapter_id)
        if host is None:
            raise ValueError(f"adapter {adapter_id!r} is not "
                             "registered on this engine")
        slot = self._resident.get(adapter_id)
        if slot is not None:
            self._pins[slot] += 1
            self._touch(slot)
            self.cache_hits += 1
            if _pmetrics._enabled:
                smetrics.SERVING_ADAPTER_CACHE_HITS.inc()
            return slot
        # cold: a free slot first, else the least recently used unpinned
        evicted = False
        free = [s for s in range(1, self.max_adapters)
                if self._slot_ids[s] is None]
        if free:
            slot = free[0]
        else:
            cands = [s for s in range(1, self.max_adapters)
                     if self._pins[s] == 0]
            if not cands:
                return None
            slot = min(cands, key=lambda s: self._stamp[s])
            del self._resident[self._slot_ids[slot]]
            self._slot_ids[slot] = None
            self.evictions += 1
            evicted = True
        self.cache_misses += 1
        t0 = self.clock()
        self._load(slot, host)
        dt = self.clock() - t0
        self.load_seconds += dt
        self._slot_ids[slot] = adapter_id
        self._resident[adapter_id] = slot
        self._pins[slot] += 1
        self._touch(slot)
        if _pmetrics._enabled:
            smetrics.SERVING_ADAPTER_CACHE_MISSES.inc()
            smetrics.SERVING_ADAPTER_LOAD_SECONDS.inc(max(dt, 0.0))
            if evicted:
                smetrics.SERVING_ADAPTER_EVICTIONS.inc()
            smetrics.SERVING_ADAPTERS_RESIDENT.set(self.resident_count)
        return slot

    def release(self, adapter_id):
        """Drop one resident request's pin (finish, preempt, expire,
        cancel). The adapter stays resident until LRU eviction needs its
        slot."""
        if adapter_id is None:
            return
        slot = self._resident.get(adapter_id)
        if slot is None or self._pins[slot] <= 0:
            raise ValueError(
                f"release of adapter {adapter_id!r} without a pin")
        self._pins[slot] -= 1

    # -------------------------------------------------------- device load
    def _load(self, slot, host):
        """Write one adapter's weights into `slot` of every slot tensor,
        in place on the cache's device. B is scaled by alpha / r in
        float64 on the host first, then cast to the compute dtype, as the
        JAX cache does."""
        with torch.no_grad():
            for name, _, _ in self.hooks:
                a, b = host[name]
                b = np.asarray(b, np.float64) * self.scaling
                for kind, arr in (("a", a), ("b", b)):
                    key = f"lora_{name}_{kind}"
                    payload = torch.from_numpy(np.ascontiguousarray(arr))
                    if self.prepare is not None:
                        payload = self.prepare(key, payload)
                    self.tensors[key][:, slot].copy_(payload.to(self.dtype))

    # ----------------------------------------------------------- metrics
    def hit_ratio(self):
        t = self.cache_hits + self.cache_misses
        return self.cache_hits / t if t else 0.0


def make_random_adapter(decoder, rank, seed=0, scale=0.02):
    """A deterministic random adapter (the JAX package's, the same numpy
    draws): nonzero A and B for every hooked projection, so a wrong slot
    or a missed delta visibly changes tokens."""
    rng = np.random.RandomState(seed)
    L = decoder.num_layers
    out = {}
    for name, di, do in hook_dims(decoder):
        a = rng.randn(L, di, rank).astype(np.float32) * scale
        b = rng.randn(L, rank, do).astype(np.float32) * scale
        out[name] = (a, b)
    return out
