"""Serving metrics, registered in the port's process-wide registry.

Port of `paddle_tpu/serving/metrics.py`: the same names, label names,
bucket bounds and help strings (the JAX package's, verbatim), so a
dashboard built on the JAX server reads the port unchanged. The engine,
scheduler, adapter cache, transport, router and health layer record
only while `profiler.metrics._enabled` is on: a serving loop with
recording off pays one branch a call site. The fleet-plane metrics
(`paddle_tpu_serving_fleet_*`) are registered and recorded by nothing
until `serving/fleet/` is ported.
"""
from __future__ import annotations

from ..profiler.metrics import (REGISTRY, exponential_buckets,
                                COMPILE_WATCHDOG_BUDGET_EXCEEDED,
                                MOE_AUX_LOSS, MOE_DROPPED_TOKENS,
                                MOE_EXPERT_TOKENS,
                                MOE_EXPERT_UTILIZATION,
                                TRANSFER_GUARD_TRIPS)  # noqa: F401
# (the MoE routing metrics live in profiler.metrics because the hybrid
# trainer records them too, and the guard counters because
# analysis.guards watches TRAINING jits as much as serving ones —
# re-exported here so the serving contract below registers them by
# import, like every other serving metric)

# 100us .. ~100s in x4 steps: TTFT on a loaded queue can sit behind
# whole prefill rounds, far above the dispatch-scale default buckets
_LATENCY_BUCKETS = exponential_buckets(1e-4, 4.0, 10)

SERVING_TTFT_SECONDS = REGISTRY.histogram(
    "paddle_tpu_serving_ttft_seconds",
    "Submit-to-first-token latency per request",
    buckets=_LATENCY_BUCKETS)
SERVING_INTER_TOKEN_SECONDS = REGISTRY.histogram(
    "paddle_tpu_serving_inter_token_seconds",
    "Gap between consecutive generated tokens of one request",
    buckets=_LATENCY_BUCKETS)
SERVING_QUEUE_DEPTH = REGISTRY.gauge(
    "paddle_tpu_serving_queue_depth",
    "Requests waiting for a slot (admission queue length)")
SERVING_ACTIVE_SLOTS = REGISTRY.gauge(
    "paddle_tpu_serving_active_slots",
    "Slots holding a resident (prefill or decode) request")
SERVING_KV_BLOCKS_IN_USE = REGISTRY.gauge(
    "paddle_tpu_serving_kv_blocks_in_use",
    "Allocated KV-cache blocks")
SERVING_KV_BLOCK_UTILIZATION = REGISTRY.gauge(
    "paddle_tpu_serving_kv_block_utilization",
    "Allocated fraction of the allocatable KV block pool")
SERVING_KV_BYTES_PER_TOKEN = REGISTRY.gauge(
    "paddle_tpu_serving_kv_bytes_per_token",
    "HBM bytes one cached token costs across K+V and all layers "
    "(int8 pools include their per-entry-per-head fp32 scales)")
SERVING_PREEMPTIONS = REGISTRY.counter(
    "paddle_tpu_serving_preemptions_total",
    "Decode requests evicted (blocks reclaimed, request requeued)")
SERVING_REQUESTS = REGISTRY.counter(
    "paddle_tpu_serving_requests_total",
    "Requests by terminal outcome",
    ("outcome",))   # finished|expired|cancelled
SERVING_TOKENS = REGISTRY.counter(
    "paddle_tpu_serving_tokens_total",
    "Tokens processed by the mixed step", ("kind",))  # prefill|decode
SERVING_STEPS = REGISTRY.counter(
    "paddle_tpu_serving_steps_total",
    "Mixed-step invocations")

# ---- radix prefix cache (prefix_caching=True) ------------------------
SERVING_PREFIX_HIT_TOKENS = REGISTRY.counter(
    "paddle_tpu_serving_prefix_cache_hit_tokens_total",
    "Prompt tokens whose KV was served from the radix prefix cache "
    "(never re-prefilled)")
SERVING_PREFIX_MISS_TOKENS = REGISTRY.counter(
    "paddle_tpu_serving_prefix_cache_miss_tokens_total",
    "Prompt tokens that had to be prefilled (no cached prefix)")
SERVING_PREFIX_EVICTIONS = REGISTRY.counter(
    "paddle_tpu_serving_prefix_cache_evictions_total",
    "Cached KV blocks reclaimed by LRU eviction under pool pressure")

# ---- block-sparse paged decode attention -----------------------------
SERVING_KV_BLOCKS_SKIPPED = REGISTRY.counter(
    "paddle_tpu_serving_kv_blocks_skipped_total",
    "Candidate KV blocks the sparse decode path did NOT read (summary "
    "scoring kept a fixed top-B + sink + recency budget instead)")
SERVING_SPARSE_ATTENTION_RATIO = REGISTRY.gauge(
    "paddle_tpu_serving_sparse_attention_ratio",
    "Cumulative fraction of candidate KV blocks the sparse decode "
    "path actually attended (1.0 = dense; lower = sparser)")

# ---- disaggregated serving (serving.distributed.transport) -----------
SERVING_KV_BLOCKS_MIGRATED = REGISTRY.counter(
    "paddle_tpu_serving_kv_blocks_migrated_total",
    "KV blocks imported into a replica's pool from a prefill handoff "
    "or a load-shedding migration (int8 scale rows ride along)")
SERVING_KV_TRANSPORT_BYTES = REGISTRY.counter(
    "paddle_tpu_serving_kv_transport_bytes_total",
    "Bytes moved by the KV block transport (codec frames: headers + "
    "K/V payloads + scale rows + ticket state)",
    ("direction",))   # sent|received
SERVING_HANDOFF_LATENCY = REGISTRY.histogram(
    "paddle_tpu_serving_handoff_latency_seconds",
    "Stream gap a migration causes: ticket extraction on the source "
    "to the first token emitted by the destination replica",
    buckets=exponential_buckets(1e-4, 4.0, 10))

# ---- multi-LoRA adapter cache ----------------------------------------
SERVING_ADAPTER_CACHE_HITS = REGISTRY.counter(
    "paddle_tpu_serving_adapter_cache_hits_total",
    "Admissions whose adapter was already resident in a device slot")
SERVING_ADAPTER_CACHE_MISSES = REGISTRY.counter(
    "paddle_tpu_serving_adapter_cache_misses_total",
    "Admissions that loaded a cold adapter into a device slot (one "
    "donated jitted slot-write each — never a recompile)")
SERVING_ADAPTER_EVICTIONS = REGISTRY.counter(
    "paddle_tpu_serving_adapter_evictions_total",
    "Resident adapters LRU-evicted from their slot to admit a cold one")
SERVING_ADAPTER_LOAD_SECONDS = REGISTRY.counter(
    "paddle_tpu_serving_adapter_load_seconds_total",
    "Wall seconds spent in adapter slot-write loads")
SERVING_ADAPTERS_RESIDENT = REGISTRY.gauge(
    "paddle_tpu_serving_adapters_resident",
    "Non-null adapters currently holding a device slot")

# ---- multi-replica router (serving.distributed.router) ---------------
# (the help text below is the JAX package's exported string, verbatim)
ROUTER_REQUESTS = REGISTRY.counter(
    "paddle_tpu_serving_router_requests_total",
    "Router dispatches by replica, outcome and the serving replica's "
    "checkpoint version (ISSUE 17: a rolling upgrade is observable "
    "as the version label migrating across the fleet)",
    ("replica", "outcome", "version"))
# outcomes: finished|failover|expired|cancelled|error|migrated
ROUTER_MIGRATIONS = REGISTRY.counter(
    "paddle_tpu_serving_router_migrations_total",
    "Live-request migrations the router orchestrated",
    ("reason",))   # handoff (prefill->decode) | shed (load balancing)
ROUTER_DISPATCH_ROLE = REGISTRY.counter(
    "paddle_tpu_serving_router_prefill_decode_dispatch_total",
    "Dispatches by target replica role (disaggregated fleets count "
    "one prefill and one decode dispatch per handed-off request)",
    ("role",))   # prefill|decode|mixed
ROUTER_AFFINITY_HITS = REGISTRY.counter(
    "paddle_tpu_serving_router_affinity_hits_total",
    "Dispatches routed to a replica whose shadow radix index already "
    "held at least one full block of the prompt")
ROUTER_ADAPTER_AFFINITY_HITS = REGISTRY.counter(
    "paddle_tpu_serving_router_adapter_affinity_hits_total",
    "Dispatches steered to a replica whose AdapterCache already held "
    "the request's LoRA adapter resident")
ROUTER_FAILOVERS = REGISTRY.counter(
    "paddle_tpu_serving_router_failovers_total",
    "In-flight requests re-submitted to another replica after their "
    "replica died")
ROUTER_REPLICA_QUEUE_DEPTH = REGISTRY.gauge(
    "paddle_tpu_serving_router_replica_queue_depth",
    "Per-replica load the router balances on: frontend admission "
    "queue + engine FIFO + resident slots", ("replica",))
ROUTER_REPLICAS_UP = REGISTRY.gauge(
    "paddle_tpu_serving_router_replicas_up",
    "Replicas the health layer currently considers dispatchable")

# ---- speculative decoding (draft_k > 0) ------------------------------
SERVING_ACCEPT_LENGTH = REGISTRY.histogram(
    "paddle_tpu_serving_accept_length",
    "Tokens emitted per verify group (accepted draft prefix + the "
    "model's own next token: 1 .. draft_k+1)",
    buckets=(1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0))
SERVING_DRAFT_TOKENS = REGISTRY.counter(
    "paddle_tpu_serving_draft_tokens_total",
    "Draft tokens by verify outcome", ("outcome",))  # proposed|accepted
SERVING_SPEC_ROLLBACKS = REGISTRY.counter(
    "paddle_tpu_serving_spec_rollbacks_total",
    "Verify groups whose rejected draft tokens forced a KV rollback")
SERVING_SPEC_ROLLBACK_BLOCKS = REGISTRY.counter(
    "paddle_tpu_serving_spec_rollback_blocks_total",
    "KV blocks returned to the free list by draft rollbacks")

# ---- fleet-wide request tracing --------------------------------------
SERVING_TRACES = REGISTRY.counter(
    "paddle_tpu_serving_trace_requests_total",
    "Stitched request traces closed, by terminal outcome",
    ("outcome",))   # finished|expired|cancelled|error
SERVING_TRACE_EVENTS = REGISTRY.counter(
    "paddle_tpu_serving_trace_events_total",
    "Span events recorded into request traces, by event name",
    ("event",))
SERVING_TRACE_EVENTS_DROPPED = REGISTRY.counter(
    "paddle_tpu_serving_trace_events_dropped_total",
    "Span events dropped by the per-trace bound "
    "(PADDLE_TPU_TRACE_EVENTS_MAX) or by trace-table eviction")
SERVING_TRACE_ACTIVE = REGISTRY.gauge(
    "paddle_tpu_serving_trace_active",
    "Open (not yet terminal) request traces — nonzero after a drain "
    "means orphaned spans")
SERVING_TRACE_QUEUE_WAIT = REGISTRY.histogram(
    "paddle_tpu_serving_trace_queue_wait_seconds",
    "Submit-to-first-admission wait derived at the admission span "
    "(fresh prefill admissions only: imports and re-prefills after "
    "preemption do not re-observe)",
    buckets=_LATENCY_BUCKETS)

# ---- SLO plane -------------------------------------------------------
SERVING_SLO_TTFT_P95 = REGISTRY.gauge(
    "paddle_tpu_serving_slo_ttft_p95_seconds",
    "Sliding-window p95 of submit-to-first-token latency", ("tenant",))
SERVING_SLO_INTER_TOKEN_P99 = REGISTRY.gauge(
    "paddle_tpu_serving_slo_inter_token_p99_seconds",
    "Sliding-window p99 of the inter-token gap", ("tenant",))
SERVING_SLO_DEADLINE_MISS_RATIO = REGISTRY.gauge(
    "paddle_tpu_serving_slo_deadline_miss_ratio",
    "Fraction of requests in the window that expired or finished past "
    "their deadline", ("tenant",))
SERVING_SLO_BURN_RATE = REGISTRY.gauge(
    "paddle_tpu_serving_slo_burn_rate",
    "measured / target per objective (>1 = the objective is burning)",
    ("tenant", "objective"))
SERVING_SLO_BREACHES = REGISTRY.counter(
    "paddle_tpu_serving_slo_breaches_total",
    "Edge-triggered objective breaches (ok -> burning transitions "
    "observed by SLOMonitor.evaluate)",
    ("tenant", "objective"))

# ---- fleet control plane ---------------------------------------------
FLEET_REPLICAS = REGISTRY.gauge(
    "paddle_tpu_serving_fleet_replicas",
    "Replicas the fleet controller currently operates, by role and "
    "checkpoint version (a rolling upgrade is the old version's count "
    "draining to zero while the new one's rises)",
    ("role", "version"))
FLEET_BOOTS = REGISTRY.counter(
    "paddle_tpu_serving_fleet_boots_total",
    "Replica boots by kind: cold (fresh engine, empty caches) vs "
    "warm (AOT bundle + restored prefix spill)",
    ("kind",))   # cold|warm
FLEET_UPGRADES = REGISTRY.counter(
    "paddle_tpu_serving_fleet_upgrades_total",
    "Per-replica weight-version flips completed by rolling upgrades "
    "(one drained jitted serving_weight_swap load each)")
FLEET_SCALE_EVENTS = REGISTRY.counter(
    "paddle_tpu_serving_fleet_scale_events_total",
    "Autoscaler decisions applied, by direction and the objective "
    "(or recovery) that drove them",
    ("direction", "reason"))   # up|down x objective|recovered
FLEET_COLD_START = REGISTRY.histogram(
    "paddle_tpu_serving_fleet_cold_start_seconds",
    "Boot-to-ready latency of controller-booted replicas (through "
    "first probe token when the boot carries a probe prompt): the "
    "AOT-vs-jit A/B bench.py's serving_fleet_ops lane measures",
    buckets=exponential_buckets(1e-3, 4.0, 10))

# ---- device-resident multi-tick decode -------------------------------
SERVING_TICKS_PER_DISPATCH = REGISTRY.histogram(
    "paddle_tpu_serving_ticks_per_dispatch",
    "Decode ticks the device ran per host dispatch (the lax.while_loop "
    "trip count: ticks_per_dispatch unless an early-exit event — "
    "finish/overflow — returned control to the scheduler sooner)",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0))
SERVING_HOST_STALL_SECONDS = REGISTRY.counter(
    "paddle_tpu_serving_host_stall_seconds_total",
    "Wall seconds the host loop spent blocked on device readback of a "
    "tick batch (staging buffer + event bitmask): the dispatch-wall "
    "share the async device_get path is meant to hide")
SERVING_EARLY_EXITS = REGISTRY.counter(
    "paddle_tpu_serving_early_exits_total",
    "Per-slot events that returned control to the scheduler before the "
    "dispatch's tick budget ran out",
    ("reason",))   # finish (EOS/horizon) | overflow (blocks) | reject (draft)

# ---- on-device speculation -------------------------------------------
SERVING_SPECULATION_STATE = REGISTRY.gauge(
    "paddle_tpu_serving_speculation_state",
    "Why this replica is or isn't speculating: 1 on exactly one mode — "
    "off (draft_k=0), host (1-tick host n-gram drafting), device "
    "(drafting + verify + sampling history resident in the multi-tick "
    "while_loop; composes with TP and penalized sampling)",
    ("mode",))   # off|host|device

#: every name above, for the smoke-tool contract check
CONTRACT_METRICS = (
    "paddle_tpu_serving_ttft_seconds",
    "paddle_tpu_serving_inter_token_seconds",
    "paddle_tpu_serving_queue_depth",
    "paddle_tpu_serving_active_slots",
    "paddle_tpu_serving_kv_blocks_in_use",
    "paddle_tpu_serving_kv_block_utilization",
    "paddle_tpu_serving_kv_bytes_per_token",
    "paddle_tpu_serving_preemptions_total",
    "paddle_tpu_serving_requests_total",
    "paddle_tpu_serving_tokens_total",
    "paddle_tpu_serving_steps_total",
    "paddle_tpu_serving_accept_length",
    "paddle_tpu_serving_draft_tokens_total",
    "paddle_tpu_serving_spec_rollbacks_total",
    "paddle_tpu_serving_spec_rollback_blocks_total",
    "paddle_tpu_serving_prefix_cache_hit_tokens_total",
    "paddle_tpu_serving_prefix_cache_miss_tokens_total",
    "paddle_tpu_serving_prefix_cache_evictions_total",
    # block-sparse paged decode attention: blocks the
    # summary scorer skipped + the cumulative attended fraction
    "paddle_tpu_serving_kv_blocks_skipped_total",
    "paddle_tpu_serving_sparse_attention_ratio",
    "paddle_tpu_serving_router_requests_total",
    "paddle_tpu_serving_router_affinity_hits_total",
    "paddle_tpu_serving_router_failovers_total",
    "paddle_tpu_serving_router_replica_queue_depth",
    "paddle_tpu_serving_router_replicas_up",
    # disaggregated prefill/decode serving: block transport
    # volume, migration counts by reason, per-role dispatch, and the
    # stream gap a handoff/shed costs the caller
    "paddle_tpu_serving_kv_blocks_migrated_total",
    "paddle_tpu_serving_kv_transport_bytes_total",
    "paddle_tpu_serving_handoff_latency_seconds",
    "paddle_tpu_serving_router_migrations_total",
    "paddle_tpu_serving_router_prefill_decode_dispatch_total",
    # multi-LoRA adapters: slot-cache traffic, eviction
    # churn, load cost, residency, and the router's adapter-affinity
    # steering
    "paddle_tpu_serving_adapter_cache_hits_total",
    "paddle_tpu_serving_adapter_cache_misses_total",
    "paddle_tpu_serving_adapter_evictions_total",
    "paddle_tpu_serving_adapter_load_seconds_total",
    "paddle_tpu_serving_adapters_resident",
    "paddle_tpu_serving_router_adapter_affinity_hits_total",
    # MoE serving: per-expert routing volume, capacity
    # drops, cumulative utilization entropy, latest balance loss
    "paddle_tpu_moe_expert_tokens_total",
    "paddle_tpu_moe_dropped_tokens_total",
    "paddle_tpu_moe_expert_utilization",
    "paddle_tpu_moe_aux_loss",
    # fleet-wide request tracing + SLO plane: stitched-trace
    # outcomes/volume, orphan gauge, span-derived queue wait, and the
    # per-tenant sliding-window objective gauges the future autoscaler
    # consumes
    "paddle_tpu_serving_trace_requests_total",
    "paddle_tpu_serving_trace_events_total",
    "paddle_tpu_serving_trace_events_dropped_total",
    "paddle_tpu_serving_trace_active",
    "paddle_tpu_serving_trace_queue_wait_seconds",
    "paddle_tpu_serving_slo_ttft_p95_seconds",
    "paddle_tpu_serving_slo_inter_token_p99_seconds",
    "paddle_tpu_serving_slo_deadline_miss_ratio",
    "paddle_tpu_serving_slo_burn_rate",
    "paddle_tpu_serving_slo_breaches_total",
    # trace-discipline guards: compile-budget violations +
    # transfer-guard trips observed by analysis.guards.sanitize — the
    # serving one-compile contract's runtime tripwire
    "paddle_tpu_compile_watchdog_budget_exceeded_total",
    "paddle_tpu_compile_watchdog_transfer_guard_trips_total",
    # fleet control plane: replica census by role/version,
    # boot kinds, upgrade flips, autoscaler decisions, and the
    # cold-start lane the AOT-boot A/B is judged on
    "paddle_tpu_serving_fleet_replicas",
    "paddle_tpu_serving_fleet_boots_total",
    "paddle_tpu_serving_fleet_upgrades_total",
    "paddle_tpu_serving_fleet_scale_events_total",
    "paddle_tpu_serving_fleet_cold_start_seconds",
    # device-resident multi-tick decode: while_loop trip
    # counts per dispatch, the readback stall the async host runtime
    # hides, and the per-slot events that hand control back early
    "paddle_tpu_serving_ticks_per_dispatch",
    "paddle_tpu_serving_host_stall_seconds_total",
    "paddle_tpu_serving_early_exits_total",
    # on-device speculation: which speculation mode each
    # replica runs — the operator-facing answer to "why is this
    # replica (not) speculating"
    "paddle_tpu_serving_speculation_state",
)

#: draft-hit ratio = accepted / proposed from SERVING_DRAFT_TOKENS —
#: exported as a plain function so dashboards and the smoke tool agree
#: on the definition
def draft_hit_ratio():
    ch = dict(SERVING_DRAFT_TOKENS.samples())
    prop = ch.get(("proposed",))
    acc = ch.get(("accepted",))
    p = prop.value if prop else 0.0
    return (acc.value if acc else 0.0) / p if p else 0.0
