"""paddle.inference — the serving API surface.

Port of `paddle_tpu/inference.py`: `Config` (the AnalysisConfig knobs
that mean something here, and the continuous-batching knobs of
`enable_continuous_batching`), and the factories over the port's
serving stack: `create_serving_engine`, `create_serving_router`,
`create_serving_frontend` and `create_fleet_controller`. Each takes a
`device=` that reaches every engine it builds (default: the engine's
own, "cuda"; a tensor-parallel engine's, its rank's card).

Not ported: `Predictor` / `create_predictor`, which run `jit.save`'s
exported program (the port has no `jit` yet); both raise. A fleet of
tensor- or expert-parallel replicas needs a process per rank behind
each frontend, and `create_serving_router` raises for it.
"""
from __future__ import annotations

from .serving.batcher import SamplingConfig
from .serving.kv_cache import KV_DTYPES


def _int_at_least(value, lo):
    return (isinstance(value, int) and not isinstance(value, bool)
            and value >= lo)


class Config:
    """AnalysisConfig's surface, plus the continuous-batching serving
    knobs (`enable_continuous_batching` -> `create_serving_engine`)."""

    def __init__(self, model_prefix=None, params_file=None):
        self.model_prefix = model_prefix
        self._threads = 1
        self._ir_optim = True
        self._serving = None
        self._max_pending = None
        self._tensor_parallel = None
        self._expert_parallel = None
        self._num_replicas = None
        self._router_policy = None
        self._sampling = None
        self._prefill_replicas = None
        self._decode_replicas = None
        self._migration = None

    # -- continuous batching ----------------------------------------------
    def enable_continuous_batching(self, max_slots=None, block_size=None,
                                   num_blocks=None, max_seq_len=None,
                                   token_budget=None, eos_token_id=None,
                                   cache_dtype=None, kv_dtype=None,
                                   draft_k=None, draft_ngram=None,
                                   draft_ring=None, penalty_vocab_bins=None,
                                   prefix_caching=None, max_pending=None,
                                   sampling=None, tensor_parallel=None,
                                   expert_parallel=None, num_replicas=None,
                                   router_policy=None,
                                   prefill_replicas=None,
                                   decode_replicas=None, migration=None,
                                   max_adapters=None, lora_rank=None,
                                   lora_alpha=None, moe_weight_dtype=None,
                                   sparse_blocks=None, sparse_recent=None,
                                   ticks_per_dispatch=None):
        """Opt into the paged-KV continuous-batching engine. The engine
        knobs mirror `serving.ServingEngine` (None keeps its default).
        `max_pending` bounds a frontend's admission queue; `sampling` is
        a `SamplingConfig` or a dict of its fields; `tensor_parallel` /
        `expert_parallel` > 1 make the engine a `TPServingEngine`;
        `num_replicas` (with `router_policy`: "affinity" |
        "round_robin") sizes a `create_serving_router` fleet, or
        `prefill_replicas` / `decode_replicas` (a pair, both >= 1) a
        disaggregated one, where `migration=True` (or a dict of
        `ReplicaRouter.MIGRATION_DEFAULTS` overrides) lets loaded decode
        replicas shed live requests. Invalid knobs raise ValueError
        before anything is stored, so a raising call leaves the config
        as it was."""
        if kv_dtype is not None and str(kv_dtype) not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype={kv_dtype!r} not supported; pick one of "
                f"{sorted(KV_DTYPES)}")
        if (prefill_replicas is not None) != (decode_replicas is not None):
            raise ValueError(
                "prefill_replicas and decode_replicas come as a pair "
                "(a disaggregated fleet needs both roles)")
        if prefill_replicas is not None and num_replicas is not None:
            raise ValueError(
                "pass either num_replicas (monolithic fleet) or "
                "prefill_replicas/decode_replicas (disaggregated), "
                "not both")
        if ticks_per_dispatch is not None and ticks_per_dispatch != "auto" \
                and not _int_at_least(ticks_per_dispatch, 1):
            raise ValueError(
                f"ticks_per_dispatch={ticks_per_dispatch!r} must be an "
                "int >= 1 or 'auto'")
        if draft_k is not None and not _int_at_least(draft_k, 0):
            raise ValueError(f"draft_k={draft_k!r} must be an int >= 0")
        if draft_ring is not None and not _int_at_least(draft_ring, 2):
            raise ValueError(
                f"draft_ring={draft_ring!r} must be an int >= 2 (the "
                "n-gram scan needs at least one earlier token besides "
                "the tail)")
        if penalty_vocab_bins is not None \
                and not _int_at_least(penalty_vocab_bins, 1):
            raise ValueError(f"penalty_vocab_bins={penalty_vocab_bins!r} "
                             "must be an int >= 1")
        self._serving = dict(
            max_slots=max_slots, block_size=block_size,
            num_blocks=num_blocks, max_seq_len=max_seq_len,
            token_budget=token_budget, eos_token_id=eos_token_id,
            cache_dtype=cache_dtype, kv_dtype=kv_dtype, draft_k=draft_k,
            draft_ngram=draft_ngram, draft_ring=draft_ring,
            penalty_vocab_bins=penalty_vocab_bins,
            prefix_caching=prefix_caching, max_adapters=max_adapters,
            lora_rank=lora_rank, lora_alpha=lora_alpha,
            moe_weight_dtype=moe_weight_dtype, sparse_blocks=sparse_blocks,
            sparse_recent=sparse_recent,
            ticks_per_dispatch=ticks_per_dispatch)
        self._max_pending = max_pending
        self._tensor_parallel = tensor_parallel
        self._expert_parallel = expert_parallel
        self._num_replicas = num_replicas
        self._router_policy = router_policy
        self._sampling = sampling
        self._prefill_replicas = prefill_replicas
        self._decode_replicas = decode_replicas
        self._migration = migration
        return self

    def continuous_batching_enabled(self):
        return self._serving is not None

    def serving_config(self):
        return dict(self._serving) if self._serving else None

    # AnalysisConfig switches accepted as no-ops
    def enable_use_gpu(self, memory_mb=100, device_id=0):
        pass

    def disable_gpu(self):
        pass

    def enable_tensorrt_engine(self, *a, **k):
        pass

    def enable_mkldnn(self):
        pass

    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag

    def set_cpu_math_library_num_threads(self, n):
        self._threads = n

    def enable_memory_optim(self):
        pass


class Predictor:
    """Not ported: the predictor runs `jit.save`'s exported program, and
    the port has no `jit` yet."""

    def __init__(self, config: Config):
        raise NotImplementedError(
            "Predictor is not ported: it loads jit.save's exported "
            "program, which waits for the port of jit/")


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


def _resolve_sampling(config: Config, sampling):
    if sampling is not None:
        return sampling
    sc = config._sampling
    if isinstance(sc, dict):
        return SamplingConfig(**sc)
    return sc


def _engine_kwargs(config):
    if not config.continuous_batching_enabled():
        raise ValueError(
            "call config.enable_continuous_batching(...) first")
    return {k: v for k, v in config.serving_config().items()
            if v is not None}


def create_serving_engine(config: Config, model, sampling=None, seed=0,
                          device=None, **overrides):
    """A continuous-batching engine from an `enable_continuous_batching`
    config and a serving model (`models.gpt.GPTForGeneration`).
    `overrides` replace single engine kwargs after the config (the
    disaggregated router gives each replica its role this way). With
    `tensor_parallel` or `expert_parallel` > 1 the engine is this rank's
    `TPServingEngine` over the caller's default process group: every
    rank calls the factory with the same arguments (under torchrun)."""
    kw = _engine_kwargs(config)
    kw.update(overrides)
    if device is not None:
        kw["device"] = device
    sampling = _resolve_sampling(config, sampling)
    tp = int(config._tensor_parallel or 1)
    ep = int(config._expert_parallel or 1)
    if tp > 1 or ep > 1:
        from .serving.distributed.tp_engine import TPServingEngine
        return TPServingEngine(model, tensor_parallel=tp,
                               expert_parallel=ep, sampling=sampling,
                               seed=seed, **kw)
    from .serving.engine import ServingEngine
    return ServingEngine(model, sampling=sampling, seed=seed, **kw)


def _replica_overrides(config, roles, r):
    """Replica r's engine overrides in a disaggregated fleet: a prefill
    replica never decodes past the first token, so it takes no drafts
    and one tick (and in a block-sparse fleet keeps the block summaries
    without the sparse decode region, so its exported blocks fit a
    decode replica's geometry); a decode replica defaults to 4 ticks a
    dispatch."""
    if roles is None:
        return {}
    sparse = (config.serving_config() or {}).get("sparse_blocks")
    if roles[r] == "prefill":
        ov = {"role": "prefill", "draft_k": 0, "ticks_per_dispatch": 1}
        if sparse:
            ov.update(sparse_blocks=None, track_summaries=True)
        return ov
    ov = {"role": "decode"}
    if (config.serving_config() or {}).get("ticks_per_dispatch") is None:
        ov["ticks_per_dispatch"] = 4
    return ov


def create_serving_router(config: Config, model, sampling=None, seed=0,
                          device=None):
    """`num_replicas` engines, each behind a `ServingFrontend`, fronted by
    a prefix-affinity `serving.distributed.ReplicaRouter` (`async with
    router:` starts the replicas' step loops and the health prober).
    With `prefill_replicas` / `decode_replicas` the fleet is
    disaggregated: prefill-role engines hand requests off at the first
    token over the KV transport to decode-role engines, and `migration=`
    turns on load shedding between decode replicas. Every replica runs
    in this process on `device`. Tensor- or expert-parallel replicas
    raise: each needs a process per rank."""
    _engine_kwargs(config)
    roles = None
    if config._prefill_replicas is not None:
        p, d = int(config._prefill_replicas), int(config._decode_replicas)
        if p < 1 or d < 1:
            raise ValueError(
                f"a disaggregated fleet needs prefill_replicas >= 1 and "
                f"decode_replicas >= 1, got {p}/{d}")
        roles = ["prefill"] * p + ["decode"] * d
        n = p + d
    else:
        n = int(config._num_replicas or 1)
        if n < 1:
            raise ValueError(f"num_replicas must be >= 1, got {n}")
    if int(config._tensor_parallel or 1) > 1 \
            or int(config._expert_parallel or 1) > 1:
        raise NotImplementedError(
            "a router over tensor- or expert-parallel replicas is not "
            "ported: each replica needs a process per rank behind its "
            "frontend (the process-per-rank fleet)")
    from .serving.distributed.router import ReplicaRouter
    from .serving.frontend import ServingFrontend
    fkw = {}
    if config._max_pending is not None:
        fkw["max_pending"] = int(config._max_pending)
    frontends = [ServingFrontend(
        create_serving_engine(config, model, sampling=sampling, seed=seed,
                              device=device,
                              **_replica_overrides(config, roles, r)),
        **fkw) for r in range(n)]
    rkw = {}
    if config._router_policy is not None:
        rkw["policy"] = config._router_policy
    if roles is not None:
        rkw["roles"] = roles
    if config._migration is not None:
        rkw["migration"] = config._migration
    return ReplicaRouter(frontends, **rkw)


def create_serving_frontend(config: Config, model, sampling=None, seed=0,
                            device=None):
    """The asyncio multi-tenant ingress over a fresh engine (`async with
    frontend:` runs its step loop; `submit()` / `stream()` a request);
    `max_pending` bounds its admission queue."""
    from .serving.frontend import ServingFrontend
    engine = create_serving_engine(config, model, sampling=sampling,
                                   seed=seed, device=device)
    kw = {}
    if config._max_pending is not None:
        kw["max_pending"] = int(config._max_pending)
    return ServingFrontend(engine, **kw)


def create_fleet_controller(config: Config, model, sampling=None, seed=0,
                            *, bundle=None, bundle_root=None, version="v1",
                            spill_dir=None, export=True, device=None):
    """The fleet control plane over a `create_serving_router` fleet:
    returns (router, `serving.fleet.FleetController`). `bundle` names a
    bundle directory (or is a loaded `FleetBundle`); otherwise, with
    `export=True`, replica 0's engine exports one for `version` under
    `bundle_root` (default `serving.fleet.export.default_bundle_root()`).
    Boot the fleet with `async with router:`, then drive
    `boot_replica()`, `rolling_upgrade()` or an `SLOAutoscaler`."""
    from .serving.fleet import FleetBundle, FleetController, export_bundle
    router = create_serving_router(config, model, sampling=sampling,
                                   seed=seed, device=device)
    if bundle is None and export:
        bundle = FleetBundle(export_bundle(router.frontends[0].engine,
                                           bundle_root,
                                           version=str(version), seed=seed))
    kw = {}
    if config._max_pending is not None:
        kw["max_pending"] = int(config._max_pending)
    return router, FleetController(router, bundle, spill_dir=spill_dir,
                                   device=device, **kw)
