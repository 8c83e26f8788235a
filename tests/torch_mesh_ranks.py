"""Rank processes for the (dp, pp, mp, ep) mesh parity tests of the
port's `HybridGPT` and for its `ring_attention`.

Imports torch, numpy and the port only, so the spawned ranks never
import jax. `run_ranks` spawns `world` CPU processes over gloo, which
rendezvous at a file under the test's tmp_path; each rank reads the
jobs and their inputs from `inputs.pt` (numpy arrays the test wrote),
runs every job and saves what the tests compare with the JAX package at
the same mesh and with the port's 1-rank trainer, which run in the test
process.

Job kinds: "train" (the JAX trainer's initial state cut to the rank by
`convert.shard_jax_hybrid_gpt`, a step on each of the same global
batches, the loss of a held-out batch after them, the train kernels'
launches; the collective, bucket and MoE metrics where the job is in
`inputs["metrics_jobs"]`), "train_many" (a "train" job with its
metrics, then `train_many` of `inputs["many_k"]` steps on the first
batch, its losses, last MoE stats, metrics and parameters), "loss" (one
loss of given weights) and "ring" (`ring_attention` over the world,
this rank's block, forward and gradients). A job's config overrides
WIDTHS; the ranks run on `inputs["device"]` (the CPU if absent;
"cuda:0": every rank on the one card, as gloo allows).
"""
from __future__ import annotations

import copy
import datetime
import os

import numpy as np
import torch

#: tests/test_hybrid_gpt.py's `_make_cfg` widths
WIDTHS = dict(vocab_size=64, seq_len=16, d_model=32, n_heads=4,
              n_layers=4, d_ff=64, learning_rate=1e-3, grad_clip=1.0)
#: the MoE meshes' experts (capacity factor 4: nothing drops, so a
#: rank's capacity, which comes from its own tokens, changes nothing)
MOE = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=4.0)
BATCH, STEPS = 8, 2


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
    """{metric: {labels: value}} of the collective, gradient-bucket and
    MoE train series of a registry module (either package's
    `profiler.metrics`)."""
    return {name: {tuple(k): float(c.value)
                   for k, c in getattr(pm, name).samples()}
            for name in ("COLLECTIVE_CALLS", "COLLECTIVE_BYTES",
                         "GRAD_BUCKETS", "MOE_EXPERT_TOKENS",
                         "MOE_DROPPED_TOKENS", "MOE_AUX_LOSS")}


def train(trainer, params, opt, steps):
    """Every step of `steps` on (params, opt); returns losses, each
    step's MoE stats, and params and opt after the first step
    (copies)."""
    res = dict(losses=[], stats=[])
    for i, (tok, lab) in enumerate(steps, 1):
        params, opt, loss = trainer.train_step(
            params, opt, *trainer.shard_data(tok, lab), step_num=i)
        res["losses"].append(float(loss))
        if trainer.last_moe_stats is not None:
            res["stats"].append({k: v.cpu().clone() for k, v in
                                 trainer.last_moe_stats.items()})
        if i == 1:
            res["params1"] = copy.deepcopy(params)
            res["opt1"] = copy.deepcopy(opt)
    return params, opt, res


def launches():
    """The train kernels' launch counts of this process."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import layer_norm as ln
    return {"flash_fwd": fa.fwd_launch_count,
            "flash_bwd": fa.bwd_launch_count,
            "add_ln_fwd": ln.fwd_launch_count,
            "add_ln_bwd": ln.bwd_launch_count}


def _train_job(inputs, kw, metrics, many=0):
    from paddle_tpu_torch.convert import shard_jax_hybrid_gpt
    from paddle_tpu_torch.parallel.hybrid_gpt import HybridGPT
    from paddle_tpu_torch.profiler import metrics as pm
    cfg = config(**kw)
    device = inputs.get("device", "cpu")
    trainer = HybridGPT(cfg, device=device)
    state = inputs["moe_state" if cfg.moe_experts else "state"]
    params, opt = shard_jax_hybrid_gpt(*state, cfg=cfg,
                                       rank=trainer.mesh.rank, device=device)
    steps = inputs["batches"]
    before = launches()
    if metrics:
        pm.enable()
        pm.REGISTRY.reset()
    try:
        params, opt, res = train(trainer, params, opt, steps)
        res["launches"] = {k: n - before[k] for k, n in launches().items()}
        out = trainer._loss(params, *trainer.shard_data(*inputs["eval"]))
        res["eval"] = _to_cpu(out if cfg.moe_experts else (out, None))
        if many and cfg.moe_experts:
            trainer.flush_moe_metrics()
        if metrics:
            res["metrics"] = metric_samples(pm)
        if many:
            pm.REGISTRY.reset()
            params, opt, losses = trainer.train_many(
                params, opt, *trainer.shard_data(*steps[0]), k=many,
                start_step=len(steps) + 1)
            res["many_losses"] = losses.tolist()
            if cfg.moe_experts:
                res["many_last"] = _to_cpu(dict(trainer.last_moe_stats))
            res["metrics_many"] = metric_samples(pm)
            res["params_end"] = _to_cpu(params)
    finally:
        if metrics:
            pm.REGISTRY.reset()
            pm.disable()
    res["buckets"] = trainer.last_grad_buckets
    res["params1"], res["opt1"] = _to_cpu(res["params1"]), _to_cpu(
        res["opt1"])
    return res


def _to_cpu(x):
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_to_cpu(v) for v in x)
    return x.cpu() if torch.is_tensor(x) else x


def _loss_job(inputs, kw):
    from paddle_tpu_torch.convert import shard_jax_hybrid_gpt
    from paddle_tpu_torch.parallel.hybrid_gpt import HybridGPT
    cfg = config(**kw)
    device = inputs.get("device", "cpu")
    trainer = HybridGPT(cfg, device=device)
    params = shard_jax_hybrid_gpt(inputs["loss_params"], cfg=cfg,
                                  rank=trainer.mesh.rank, device=device)
    return float(trainer.loss(params, *inputs["batches"][0]))


def _ring_job(inputs, kw):
    """This rank's block of q, k, v through `ring_attention`; returns
    its output block and the gradients of (out * g).sum()."""
    import torch.distributed as dist

    from paddle_tpu_torch.parallel.ring_attention import ring_attention
    n, r = dist.get_world_size(), dist.get_rank()
    blocks = []
    for name in ("q", "k", "v", "g"):
        a = torch.tensor(inputs["ring"][name])
        k = a.shape[1] // n
        blocks.append(a[:, r * k:(r + 1) * k].to(inputs.get("device",
                                                            "cpu")))
    q, k, v, g = blocks
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = ring_attention(q, k, v, causal=kw["causal"])
    dq, dk, dv = torch.autograd.grad((out * g).sum(), (q, k, v))
    return _to_cpu(dict(out=out.detach(), dq=dq, dk=dk, dv=dv))


def _rank_main(rank, world, rdv, data_dir, device):
    import torch.distributed as dist
    torch.set_num_threads(1)
    if str(device).startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=180))
    try:
        inputs = torch.load(os.path.join(data_dir, "inputs.pt"),
                            weights_only=False)
        results = {}
        for name, kind, kw in inputs["jobs"][world]:
            if kind == "train":
                results[name] = _train_job(
                    inputs, kw, name in inputs.get("metrics_jobs", ()))
            elif kind == "train_many":
                results[name] = _train_job(inputs, kw, True,
                                           inputs["many_k"])
            elif kind == "loss":
                results[name] = _loss_job(inputs, kw)
            else:
                results[name] = _ring_job(inputs, kw)
        torch.save(results,
                   os.path.join(data_dir, f"rank{world}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(world, data_dir):
    """Spawn `world` ranks that run the jobs of `world` in
    `data_dir/inputs.pt`; returns each rank's results."""
    import torch.multiprocessing as mp
    inputs = torch.load(os.path.join(data_dir, "inputs.pt"),
                        weights_only=False)
    rdv = os.path.join(data_dir, f"rendezvous{world}")
    mp.spawn(_rank_main, args=(world, rdv, data_dir,
                               inputs.get("device", "cpu")),
             nprocs=world, join=True)
    return [torch.load(os.path.join(data_dir, f"rank{world}_{r}.pt"),
                       weights_only=False) for r in range(world)]
