"""CPU parity of the port's `HybridGPT` on the MoE meshes and the
bucketed dense-DP reduction (`paddle_tpu_torch.parallel.hybrid_gpt`)
against the JAX package: dp 2 x mp 2 MoE with ZeRO-1;
`dryrun_multichip(8)`'s pp 2 x mp 2 x ep 2 MoE with 2 micro-batches,
sequence parallelism, remat and ZeRO-1; dp 2 with gradient buckets,
unbucketed, at two bucket sizes with ZeRO-1, and with bf16 grads.

Widths are tests/test_hybrid_gpt.py's `_make_cfg`'s, with 4 experts,
top-2, capacity factor 4 (nothing drops, so a rank's capacity changes
nothing). The ranks run in `torch_mesh_ranks` processes over gloo;
JAX's trainer at the same mesh (on `shard_major_qkv`-permuted qkv
leaves where mp > 1, see tests/test_torch_hybrid_mesh.py) and the
port's 1-rank trainer run in the test process. A micro-batch is cut
from a data rank's rows, so the 1-rank trainer takes the global batch
with its rows in the order that puts the mesh's micro-batch m (over
all data ranks) in its own micro-batch m: the router's balance loss is
a function of each micro-batch's token set.

Tolerances are tests/test_torch_moe_train.py's: losses rtol 1e-4,
parameters after step 1 within 5e-2 lr, Adam's first moment within
1e-4 of its tensor's largest |m|, `counts` and `dropped` exactly,
`balance` and `z` within rtol 1e-5; bf16 grads: the loss within rtol
1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as mr
from paddle_tpu.parallel import hybrid_gpt as jh
from paddle_tpu.profiler import metrics as jpm
from paddle_tpu_torch.convert import shard_jax_hybrid_gpt
from paddle_tpu_torch.parallel import hybrid_gpt as th
from test_torch_hybrid_mesh import (MESH_KEYS, _assert_first_moments,
                                    _assert_params, _jax_start, _np)

#: world -> [(job, GPTConfig overrides)]
JOBS = {
    2: [("dp2", dict(dp=2, zero_stage=0)),
        ("dp2_buckets", dict(dp=2, grad_bucket_bytes=4096, zero_stage=0)),
        ("dp2_buckets_zero1", dict(dp=2, grad_bucket_bytes=8192,
                                   zero_stage=1)),
        ("dp2_buckets_bf16", dict(dp=2, grad_bucket_bytes=8192,
                                  zero_stage=1, bf16_grads=True))],
    4: [("dp2_mp2_moe", dict(dp=2, mp=2, zero_stage=1, **mr.MOE))],
    8: [("pp2_mp2_ep2_moe_sp", dict(pp=2, mp=2, ep=2, micro_batches=2,
                                    sequence_parallel=True, remat=True,
                                    zero_stage=1, **mr.MOE))],
}
#: the jobs held against JAX's trainer at their mesh and the port's 1-rank
#: trainer (dp2 is the bucketed jobs' unbucketed twin; the bf16 job is
#: held by its loss)
ALL = [(w, n, kw) for w, jobs in JOBS.items() for n, kw in jobs
       if n not in ("dp2", "dp2_buckets_bf16")]
METRICS_JOB = "dp2_buckets_zero1"


def _kw(kw):
    return {"remat": False, **kw}


def _dtype(kw, jax_side):
    bf16 = kw.get("bf16_grads", False)
    if jax_side:
        return jnp.bfloat16 if bf16 else jnp.float32
    return torch.bfloat16 if bf16 else torch.float32


def _jax_trainer(**kw):
    cfg = jh.GPTConfig(**mr.WIDTHS, **kw, compute_dtype=_dtype(kw, True))
    n = cfg.dp * cfg.pp * cfg.mp * cfg.ep
    return jh.HybridGPT(cfg, devices=jax.devices()[:n])


def _jax_run(jt, jp, jo, steps, moe):
    res = dict(losses=[], stats=[])
    for i, (tok, lab) in enumerate(steps, 1):
        jp, jo, jl = jt.train_step(jp, jo, *jt.shard_data(tok, lab),
                                   step_num=i)
        res["losses"].append(float(jl))
        if moe:
            res["stats"].append(_np(jt.last_moe_stats))
        if i == 1:
            res["params1"], res["opt1"] = _np(jp), _np(jo)
    return jp, jo, res


def _assert_stats(got, want, what=""):
    for k in ("counts", "dropped"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=what + k)
    for k in ("balance", "z"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-5, err_msg=what + k)


def _micro_order(kw):
    """The global batch's rows in the order of the mesh's micro-batches
    (micro-batch m of every data rank, in data-rank order)."""
    n = kw.get("dp", 1) * kw.get("ep", 1)
    M = kw.get("micro_batches", 1)
    b = mr.BATCH // n
    return [r * b + m * (b // M) + j for m in range(M) for r in range(n)
            for j in range(b // M)]


@pytest.fixture(scope="module")
def states():
    """The JAX trainer's initial (params, opt), dense and MoE, numpy."""
    out = {}
    for moe in (False, True):
        extra = mr.MOE if moe else {}
        out[moe] = _np(_jax_trainer(remat=False, zero_stage=0,
                                    **extra).init(jax.random.PRNGKey(0)))
    return out


@pytest.fixture(scope="module")
def mesh_runs(states, tmp_path_factory):
    steps, ev = mr.batches(), mr.batches(seed=9, n=1)[0]
    jobs = {w: [(n, "train", _kw({**kw, "compute_dtype": _dtype(kw, False)}))
                for n, kw in js] for w, js in JOBS.items()}
    d = tmp_path_factory.mktemp("mesh_moe")
    torch.save(dict(jobs=jobs, state=states[False], moe_state=states[True],
                    batches=steps, eval=ev, metrics_jobs=(METRICS_JOB,)),
               d / "inputs.pt")
    ranks = {}
    for world in jobs:
        for res in mr.run_ranks(world, str(d)):
            for name, r in res.items():
                ranks.setdefault(name, []).append(r)
    jax_runs, one = {}, {}
    for world, jobs_w in JOBS.items():
        for name, kw in jobs_w:
            if name == "dp2":               # the port's unbucketed twin
                continue
            moe = "moe_num_experts" in kw
            jt = _jax_trainer(**_kw(kw))
            jp, jo = _jax_start(jt)
            if name == METRICS_JOB:
                jpm.enable()
                jpm.REGISTRY.reset()
            try:
                jp, _, jax_runs[name] = _jax_run(jt, jp, jo, steps, moe)
                if name == METRICS_JOB:
                    jax_runs[name]["metrics"] = mr.metric_samples(jpm)
                    jax_runs[name]["count"] = jh.grad_bucket_count(
                        jp, kw["grad_bucket_bytes"])
            finally:
                if name == METRICS_JOB:
                    jpm.REGISTRY.reset()
                    jpm.disable()
            if moe:
                jax_runs[name]["eval"] = _np(jt.loss_and_moe_stats(
                    jp, *jt.shard_data(*ev)))
            if any(name == n for _, n, _ in ALL):
                cfg = mr.config(**{k: v for k, v in _kw(kw).items()
                                   if k not in MESH_KEYS})
                tt = th.HybridGPT(cfg, device="cpu")
                p, o = shard_jax_hybrid_gpt(*states[moe], cfg=cfg, rank=0,
                                            device="cpu")
                order = _micro_order(kw)
                one[name] = mr.train(tt, p, o, [(t[order], l[order])
                                                for t, l in steps])[2]
    return ranks, jax_runs, one


@pytest.mark.parametrize("world,name,kw", ALL, ids=[j[1] for j in ALL])
def test_mesh_matches_jax_and_one_rank(mesh_runs, world, name, kw):
    ranks, jax_runs, one = mesh_runs
    want, results = jax_runs[name], ranks[name]
    assert len(results) == world
    cfg = mr.config(**_kw(kw))
    for r, got in enumerate(results):
        assert got["losses"] == results[0]["losses"], f"rank {r}"
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        np.testing.assert_allclose(got["losses"], one[name]["losses"],
                                   rtol=1e-4)
        for i, st in enumerate(got["stats"]):
            _assert_stats(st, want["stats"][i], f"rank {r} step {i + 1}: ")
            _assert_stats(st, one[name]["stats"][i],
                          f"rank {r} step {i + 1} vs 1 rank: ")
        jp1, jo1 = shard_jax_hybrid_gpt(want["params1"], want["opt1"],
                                        cfg=cfg, rank=r, device="cpu",
                                        jax_mp=cfg.mp)
        _assert_params(got["params1"], jp1, f"rank {r} vs JAX: ")
        _assert_first_moments(got["opt1"], jo1, f"rank {r} vs JAX: ")
        _assert_params(got["params1"],
                       th.shard_state(cfg, one[name]["params1"], rank=r),
                       f"rank {r} vs 1 rank: ")
        if cfg.moe_experts:
            loss, st = got["eval"]
            np.testing.assert_allclose(float(loss), float(want["eval"][0]),
                                       rtol=1e-5)
            _assert_stats(st, want["eval"][1], f"rank {r} eval: ")


def test_buckets_match_the_unbucketed_step_and_jax_count(mesh_runs):
    """The bucketed dp 2 step issues `grad_bucket_count` all-reduces
    (JAX's count of its plan) and equals the unbucketed step; the
    GRAD_BUCKETS gauge and the COLLECTIVE_* series equal JAX's."""
    ranks, jax_runs, _ = mesh_runs
    for r, (plain, got) in enumerate(zip(ranks["dp2"], ranks["dp2_buckets"])):
        np.testing.assert_allclose(got["losses"], plain["losses"],
                                   rtol=1e-6)
        _assert_params(got["params1"], plain["params1"], f"rank {r}: ")
        assert plain["buckets"] is None
    want = jax_runs[METRICS_JOB]
    params = th.init_params(mr.config(dp=2), torch.Generator(), "cpu")
    for got in ranks[METRICS_JOB]:
        assert got["buckets"] == want["count"] == th.grad_bucket_count(
            params, 8192) > 1
        assert got["metrics"] == want["metrics"]
        assert got["metrics"]["GRAD_BUCKETS"] == {("compiled",): float(
            want["count"])}
    for got in ranks["dp2_buckets"]:
        assert got["buckets"] == th.grad_bucket_count(params, 4096)


def test_bucketed_bf16_grads_loss_follows_jax(mesh_runs):
    ranks, jax_runs, _ = mesh_runs
    want = jax_runs["dp2_buckets_bf16"]
    for r, got in enumerate(ranks["dp2_buckets_bf16"]):
        assert got["losses"] == ranks["dp2_buckets_bf16"][0]["losses"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3,
                                   err_msg=f"rank {r}")
        assert got["buckets"] == th.grad_bucket_count(
            got["params1"], 8192, torch.bfloat16)


@pytest.mark.parametrize("bucket_bytes", [4 * 10, 4 * 64, 4 * 194,
                                          1 << 20])
@pytest.mark.parametrize("grad_dtype", [None, "bfloat16"])
def test_grad_bucket_count_matches_jax(bucket_bytes, grad_dtype):
    """`grad_bucket_count` against JAX's on a tree of mixed sizes and
    dtypes, and the buckets `_GradBuckets` plans: as many, each within
    the byte limit, every element once."""
    rng = np.random.RandomState(0)
    tree = {"a": rng.rand(7, 13).astype(np.float32),
            "b": rng.rand(100).astype(np.float32),
            "c": {"d": rng.rand(3).astype(np.float32)}}
    jt = jax.tree.map(jnp.asarray, tree)
    tt = th._tree_map(lambda _, a: torch.tensor(a), tree)
    jd = None if grad_dtype is None else getattr(jnp, grad_dtype)
    td = None if grad_dtype is None else getattr(torch, grad_dtype)
    n = th.grad_bucket_count(tt, bucket_bytes, td)
    assert n == jh.grad_bucket_count(jt, bucket_bytes, jd)
    leaves = [t.to(td or t.dtype).requires_grad_()
              for _, t in th._leaves(tt)]
    plan = th._GradBuckets(leaves, bucket_bytes, None)
    for h in plan.hooks:
        h.remove()
    assert len(plan.buckets) == n
    size = leaves[0].element_size()
    seen = [torch.zeros(t.numel(), dtype=torch.int32) for t in leaves]
    for pieces in plan.buckets:
        assert sum(k for _, _, k in pieces) * size <= max(bucket_bytes,
                                                          size)
        for i, s, k in pieces:
            seen[i][s:s + k] += 1
    assert all(bool((x == 1).all()) for x in seen)
