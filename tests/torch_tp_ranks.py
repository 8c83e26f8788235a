"""Rank processes for the tensor-parallel serving parity tests.

Imports torch, numpy and the port only, so the spawned ranks never
import jax. `run_ranks` spawns `world` CPU processes over gloo, which
rendezvous at a file under the test's tmp_path (xdist workers never
share a port), run every scenario on `TPServingEngine` and save their
results; the tests compare them with the JAX package's engine, which
runs the same scenarios (`SCENARIOS`, `serve`) in the test process.
The "observed" job records metrics and traces on each rank under a
`ManualClock` (`drive_observed`, `observed`), which the observability
tests also drive either framework's single engine with.
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch

VOCAB, HEADS = 211, 4
MOE = dict(num_expert=4, top_k=2, capacity_factor=2.0)
NEW = 8

#: name -> (model kind, engine kwargs, traffic); every engine also gets
#: `BASE_KW`
BASE_KW = dict(max_slots=4, block_size=4, max_seq_len=64,
               cache_dtype="float32", seed=0)
SCENARIOS = {
    "dense": ("float", {}, "batch"),
    "draft3": ("float", dict(draft_k=3), "repeat"),
    "prefix": ("float", dict(prefix_caching=True, max_slots=2), "waves"),
    "preempt": ("float", dict(num_blocks=10, max_seq_len=48), "long"),
    "int8": ("float", dict(kv_dtype="int8"), "batch"),
    "ticks4": ("float", dict(ticks_per_dispatch=4), "batch"),
    "sparse": ("float", dict(sparse_blocks=1, sparse_recent=1), "sparse"),
    "sparse_draft3": ("float", dict(sparse_blocks=1, sparse_recent=1,
                                    draft_k=3), "sparse"),
    "lora": ("float", dict(max_adapters=3, lora_rank=4), "lora"),
    "weight_only": ("weight_only", {}, "batch"),
}
#: MoE scenarios: (tp, ep) -> [(name, engine kwargs)]
MOE_SCENARIOS = {
    (1, 2): [("moe_tp1_ep2", {})],
    (2, 1): [("moe_tp2_ep1", {})],
    (2, 2): [("moe_tp2_ep2", {}),
             ("moe_tp2_ep2_int8", dict(moe_weight_dtype="int8")),
             ("moe_tp2_ep2_draft3", dict(draft_k=3))],
}


def prompts(lens=(3, 9, 17, 5), seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, int(n)).tolist() for n in lens]


def _waves(eng):
    """Two waves on a shared 10-token head; the second replays three
    conversations with a new suffix and one prompt exactly (a whole
    prompt cached: the copy-on-write path)."""
    rng = np.random.RandomState(0)
    head = rng.randint(1, VOCAB, 10).tolist()
    first = [head + rng.randint(1, VOCAB, n).tolist()
             for n in (3, 5, 2, 6, 4, 7)]
    r1 = [eng.submit(p, NEW) for p in first]
    eng.run()
    rng2 = np.random.RandomState(1)
    second = ([first[i] + list(r1[i].output)
               + rng2.randint(1, VOCAB, 3).tolist() for i in (0, 2, 3)]
              + [first[3]])
    r2 = [eng.submit(p, NEW) for p in second]
    eng.run()
    return r1 + r2


def _adapter(decoder, seed):
    """The JAX package's `make_random_adapter` draws for `decoder`'s
    hooked projections (the port's function makes the same ones)."""
    from paddle_tpu_torch.serving.adapters import make_random_adapter
    return make_random_adapter(decoder, 4, seed=seed, scale=0.3)


def serve(eng, traffic, adapters=None):
    """Run one scenario's requests on `eng` (either framework's engine);
    returns what the tests compare across ranks and frameworks."""
    if traffic == "waves":
        reqs = _waves(eng)
    elif traffic == "lora":
        for name, ad in adapters.items():
            eng.register_adapter(name, ad)
        ids = [None, "t1", "t2", "t1", None, "t2"]
        reqs = [eng.submit(p, NEW, adapter_id=a) for p, a in
                zip(prompts((3, 9, 17, 5, 12, 7)), ids)]
        eng.run()
    else:
        ps = {"batch": prompts(),
              "repeat": prompts()[:3] + [[5, 6, 7, 8] * 4],
              "long": prompts((3, 9, 17, 5, 12, 7, 21, 4)),
              "sparse": prompts((30, 9, 38, 3, 21, 14), seed=5)}[traffic]
        reqs = [eng.submit(p, 6 if traffic == "long" else NEW) for p in ps]
        eng.run()
    out = dict(tokens=[[int(t) for t in r.output] for r in reqs],
               states=[r.state for r in reqs],
               preemptions=int(eng.scheduler.preemption_count),
               spec=(int(eng.spec_proposed_total),
                     int(eng.spec_accepted_total)))
    if eng.num_experts:
        out["moe_counts"] = np.asarray(eng.moe_expert_counts).tolist()
        out["moe_dropped"] = float(eng.moe_dropped_total)
    if eng.prefix_cache is not None:
        pc = eng.prefix_cache
        out["hits"] = [int(r.cache_hit_tokens) for r in reqs]
        out["cache"] = (int(pc.hit_tokens), int(pc.miss_tokens),
                        int(pc.evictions), int(pc.cow_copies))
        pc.evict_all()
    out["blocks_in_use"] = int(eng.kv.blocks_in_use)
    return out


class ManualClock:
    """A clock the test sets before each step: every read inside one
    step returns the same time, in either framework's engine."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def drive_observed(eng, clock, waves, new, dt=0.125):
    """Serve `waves` (lists of (prompt, adapter id)) on `eng` under the
    manual `clock`: a wave is submitted at the current time once the one
    before has drained, and the clock advances `dt` before every step.
    Returns the requests in submission order."""
    reqs = []
    for wave in waves:
        reqs += [eng.submit(p, new, adapter_id=a) if a is not None
                 else eng.submit(p, new) for p, a in wave]
        while eng.scheduler.has_work:
            clock.t += dt
            assert eng.step()
    eng.flush_observability()
    return reqs


def observed(eng, reqs, metrics, serving_metrics, tracing):
    """What the observability parity tests compare: tokens, the registry
    over the serving contract, each request's trace and the flight
    records (either framework's modules)."""
    snap = metrics.REGISTRY.snapshot()
    return dict(
        tokens=[[int(t) for t in r.output] for r in reqs],
        preemptions=int(eng.scheduler.preemption_count),
        metrics={n: snap[n] for n in serving_metrics.CONTRACT_METRICS},
        traces=[tracing.TRACER.get(r.trace_id).as_dict() for r in reqs],
        flight=[dict(r) for r in eng.flight.records],
        flight_steps=eng.flight.steps)


def _observed_case(model, kw):
    """The tp = 2 observability case on this rank: recording on, the
    manual clock, prompts() at NEW tokens."""
    from paddle_tpu_torch.profiler import metrics
    from paddle_tpu_torch.serving import metrics as serving_metrics
    from paddle_tpu_torch.serving import tracing
    from paddle_tpu_torch.serving.distributed import TPServingEngine
    metrics.REGISTRY.reset()
    tracing.TRACER.reset()
    metrics.enable()
    tracing.enable()
    clock = ManualClock()
    eng = TPServingEngine(model, tensor_parallel=2, device="cpu",
                          clock=clock, name="e0", **kw)
    reqs = drive_observed(eng, clock, [[(p, None) for p in prompts()]],
                          NEW)
    return observed(eng, reqs, metrics, serving_metrics, tracing)


def seeded_model(device, hidden=32):
    """A small float GPT drawn from torch seed 0 on the CPU (the same
    weights in every process), on `device`. The card's paged kernel
    takes head_dim 64 or 128: a card job asks for `hidden` 256."""
    from paddle_tpu_torch.models.gpt import GPTForGeneration
    torch.manual_seed(0)
    model = GPTForGeneration(vocab_size=VOCAB, hidden_size=hidden,
                             num_layers=2,
                             num_attention_heads=HEADS,
                             max_position_embeddings=128, device="cpu")
    return model.to(device)


def _allocator(eng):
    """The rank's allocator state and block tables (host ledger)."""
    kv = eng.kv
    return dict(tables=np.asarray(kv.block_tables).tolist(),
                lens=np.asarray(kv.slot_lens).tolist(),
                free=int(kv.allocator.num_free),
                ok=bool(kv.allocator.invariant_ok))


def _rank_main(rank, world, rdv, data_dir, jobs):
    import torch.distributed as dist

    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.serving.distributed import TPServingEngine
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        models, results = {}, {}
        for job in jobs:
            kind = job["model"]
            device = job.get("device", "cpu")
            if kind == "seeded":
                models[kind] = seeded_model(device, job.get("hidden", 32))
            elif kind not in models:
                with np.load(os.path.join(data_dir, f"{kind}.npz")) as z:
                    arrays = dict(z)
                models[kind] = load_jax_gpt(
                    arrays, HEADS, moe=MOE if kind == "moe" else None,
                    device="cpu")
            model = models[kind]
            kw = dict(BASE_KW, **job["kw"])
            if job["traffic"] == "clock":
                results[job["name"]] = _clock_case(model, rank, kw)
                continue
            if job["traffic"] == "observed":
                results[job["name"]] = _observed_case(model, kw)
                continue
            eng = TPServingEngine(model, tensor_parallel=job["tp"],
                                  expert_parallel=job["ep"], device=device,
                                  **kw)
            adapters = ({"t1": _adapter(model.decoder, 1),
                         "t2": _adapter(model.decoder, 2)}
                        if job["traffic"] == "lora" else None)
            res = serve(eng, job["traffic"], adapters)
            res["allocator"] = _allocator(eng)
            if job.get("layer0"):
                res["layer0"] = {n: t.clone() for n, t in
                                 eng._layers[0].items()}
            results[job["name"]] = res
        torch.save(results, os.path.join(data_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _clock_case(model, rank, kw):
    """Rank 1's clock runs 1000 s ahead of rank 0's; a request whose
    deadline passes mid-decode by rank 0's clock must expire on every
    rank at the same step."""
    from paddle_tpu_torch.serving.distributed import TPServingEngine
    ticks = [1000.0 * rank]

    def clock():
        ticks[0] += 1.0
        return ticks[0]

    eng = TPServingEngine(model, tensor_parallel=2, device="cpu",
                          clock=clock, **kw)
    ps = prompts((17, 5, 9))
    reqs = [eng.submit(ps[0], 16, deadline=7.0),
            eng.submit(ps[1], 16), eng.submit(ps[2], 16)]
    eng.run()
    return dict(tokens=[[int(t) for t in r.output] for r in reqs],
                states=[r.state for r in reqs],
                finish=[r.finish_time for r in reqs],
                allocator=_allocator(eng))


def run_ranks(world, data_dir, jobs):
    """Spawn `world` ranks that run `jobs` (dicts: name, model, tp, ep,
    kw, traffic[, layer0]); returns each rank's results."""
    import torch.multiprocessing as mp
    rdv = os.path.join(data_dir, "rendezvous")
    mp.spawn(_rank_main, args=(world, rdv, data_dir, jobs), nprocs=world,
             join=True)
    return [torch.load(os.path.join(data_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]
