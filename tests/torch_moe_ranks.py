"""Rank processes for the MoE trainer's dp x ep parity tests.

Imports torch, numpy and the port only, so the spawned ranks never
import jax. `run_ranks` spawns `world` CPU processes over gloo, which
rendezvous at a file under the test's tmp_path; each rank loads the JAX
trainer's initial state from `inputs.pt` (numpy arrays the test wrote),
cuts its shard (`convert.shard_jax_hybrid_gpt`), runs every job's
steps on the same global batches and saves what the tests compare with
the JAX package's `HybridGPT` at the same mesh and with the port's
1-rank trainer, which run in the test process.
"""
from __future__ import annotations

import copy
import datetime
import os

import numpy as np
import torch

#: tests/test_moe.py's `_make_cfg` widths at 2 layers (capacity factor
#: 4.0: nothing is dropped)
WIDTHS = dict(vocab_size=64, seq_len=16, d_model=32, n_heads=4,
              n_layers=2, d_ff=64, learning_rate=1e-3, grad_clip=1.0,
              moe_num_experts=4, moe_top_k=2, moe_capacity_factor=4.0)
BATCH, STEPS = 8, 3
#: world -> [(job name, GPTConfig overrides)]
MESH_JOBS = {
    2: [("dp2", dict(dp=2, zero_stage=0, remat=False)),
        ("dp2_zero1", dict(dp=2, zero_stage=1, remat=False)),
        ("ep2", dict(ep=2, zero_stage=0, remat=False)),
        ("ep2_zero1", dict(ep=2, zero_stage=1, remat=False))],
    4: [("dp2_ep2", dict(dp=2, ep=2, zero_stage=0, remat=False)),
        ("dp2_ep2_zero1", dict(dp=2, ep=2, zero_stage=1, remat=False)),
        ("dp2_ep2_remat", dict(dp=2, ep=2, zero_stage=1, remat=True,
                               remat_policy="save_splash_residuals"))],
}
#: the job that also records the metrics and runs train_many
METRICS_JOB = "dp2_ep2_zero1"
MANY_K = 3


def batches(seed=0, n=STEPS):
    """n (tokens, labels) global batches [BATCH, seq_len], int32."""
    rng = np.random.RandomState(seed)
    shape = (BATCH, WIDTHS["seq_len"])
    return [(rng.randint(0, WIDTHS["vocab_size"], shape).astype(np.int32),
             rng.randint(0, WIDTHS["vocab_size"], shape).astype(np.int32))
            for _ in range(n)]


def config(**kw):
    from paddle_tpu_torch.parallel.hybrid_gpt import GPTConfig
    return GPTConfig(**{**WIDTHS, "compute_dtype": torch.float32, **kw})


def metric_samples(pm):
    """{metric: {labels: value}} of the collective and MoE train series
    of a registry module (either package's `profiler.metrics`)."""
    out = {}
    for name in ("COLLECTIVE_CALLS", "COLLECTIVE_BYTES",
                 "MOE_EXPERT_TOKENS", "MOE_DROPPED_TOKENS",
                 "MOE_AUX_LOSS"):
        out[name] = {tuple(k): float(c.value)
                     for k, c in getattr(pm, name).samples()}
    return out


def train(trainer, params, opt, steps):
    """Every step of `steps` on (params, opt); returns losses, each
    step's stats, and params and opt after the first step (copies)."""
    res = dict(losses=[], stats=[])
    for i, (tok, lab) in enumerate(steps, 1):
        params, opt, loss = trainer.train_step(
            params, opt, *trainer.shard_data(tok, lab), step_num=i)
        res["losses"].append(float(loss))
        res["stats"].append({k: v.clone() for k, v in
                             trainer.last_moe_stats.items()})
        if i == 1:
            res["params1"] = copy.deepcopy(params)
            res["opt1"] = copy.deepcopy(opt)
    return params, opt, res


def _rank_main(rank, world, rdv, data_dir):
    import torch.distributed as dist

    from paddle_tpu_torch.convert import shard_jax_hybrid_gpt
    from paddle_tpu_torch.parallel.hybrid_gpt import HybridGPT
    from paddle_tpu_torch.profiler import metrics as pm
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        inputs = torch.load(os.path.join(data_dir, "inputs.pt"),
                            weights_only=False)
        steps = inputs["batches"]
        results = {}
        for name, kw in MESH_JOBS[world]:
            cfg = config(**kw)
            trainer = HybridGPT(cfg, device="cpu")
            params, opt = shard_jax_hybrid_gpt(
                inputs["params"], inputs["opt"], cfg=cfg, rank=rank,
                device="cpu")
            if name == METRICS_JOB:
                pm.enable()
                pm.REGISTRY.reset()
            params, opt, res = train(trainer, params, opt, steps)
            res["eval"] = trainer.loss_and_moe_stats(
                params, *trainer.shard_data(*inputs["eval"]))
            if name == METRICS_JOB:
                trainer.flush_moe_metrics()
                res["metrics_steps"] = metric_samples(pm)
                pm.REGISTRY.reset()
                params, opt, losses = trainer.train_many(
                    params, opt, *trainer.shard_data(*steps[0]), k=MANY_K,
                    start_step=STEPS + 1)
                res["many_losses"] = losses.tolist()
                res["many_last"] = dict(trainer.last_moe_stats)
                res["metrics_many"] = metric_samples(pm)
                pm.REGISTRY.reset()
                pm.disable()
                res["params_end"] = params
            results[name] = res
        torch.save(results, os.path.join(data_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(world, data_dir):
    """Spawn `world` ranks that run `MESH_JOBS[world]` from
    `data_dir/inputs.pt`; returns each rank's results."""
    import torch.multiprocessing as mp
    rdv = os.path.join(data_dir, "rendezvous")
    mp.spawn(_rank_main, args=(world, rdv, data_dir), nprocs=world,
             join=True)
    return [torch.load(os.path.join(data_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]
