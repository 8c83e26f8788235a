"""CPU parity of the port's `HybridGPT` over dense (dp, pp, mp) meshes
(`paddle_tpu_torch.parallel.hybrid_gpt`: Megatron tensor parallelism,
the GPipe pipeline, sequence parallelism) and of its `ring_attention`
against the JAX package.

The meshes are those of tests/test_hybrid_gpt.py at its `_make_cfg`
widths (vocab 64, S 16, d 32, 4 heads, 4 layers, d_ff 64, fp32): pp 2 x
2 micro-batches, mp 2 with and without sequence parallelism (the latter
with remat and the residual policy), 2 micro-batches at pp 1, and dp 2
x pp 2 x mp 2 with and without sequence parallelism. The ranks run in
`torch_mesh_ranks` processes over gloo (one spawn a world size); JAX's
trainer at the same mesh and the port's 1-rank trainer run in the test
process, all from the JAX trainer's initial state.

The port cuts the fused `w_qkv` and `b_qkv` by heads: the same
parameters define the same model at every mp. JAX's trainer cuts them
contiguously over mp, so at mp = k it computes another model; it is
held here on `shard_major_qkv`-permuted qkv leaves, on which it
computes the logical model, and `convert.load_jax_hybrid_gpt(...,
jax_mp=k)` puts its state back into the logical layout.
`test_qkv_departure` shows the difference.

Tolerances are tests/test_torch_moe_train.py's: losses rtol 1e-4,
parameters after step 1 within 5e-2 lr, Adam's first moment within
1e-4 of its tensor's largest |m|; every rank's losses are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import torch_mesh_ranks as mr
from paddle_tpu.parallel import hybrid_gpt as jh
from paddle_tpu.parallel.mp_layers import shard_major_qkv
from paddle_tpu.parallel.ring_attention import \
    ring_attention as jax_ring_attention
from paddle_tpu_torch.convert import load_jax_hybrid_gpt, shard_jax_hybrid_gpt
from paddle_tpu_torch.parallel import hybrid_gpt as th

LR = mr.WIDTHS["learning_rate"]
P_TOL = 5e-2 * LR
HD = mr.WIDTHS["d_model"] // mr.WIDTHS["n_heads"]
MESH_KEYS = ("dp", "pp", "mp", "ep", "sequence_parallel",
             "grad_bucket_bytes")
#: world -> [(job, GPTConfig overrides)]; zero_stage 0 and remat off
#: unless said, as `_make_cfg`
JOBS = {
    1: [("micro2", dict(micro_batches=2))],
    2: [("pp2_micro2", dict(pp=2, micro_batches=2)),
        ("mp2", dict(mp=2)),
        ("mp2_sp_remat", dict(mp=2, sequence_parallel=True, remat=True,
                              remat_policy="save_splash_residuals",
                              zero_stage=1))],
    8: [("dp2_pp2_mp2", dict(dp=2, pp=2, mp=2, micro_batches=2)),
        ("dp2_pp2_mp2_sp", dict(dp=2, pp=2, mp=2, micro_batches=2,
                                sequence_parallel=True, zero_stage=1))],
}
ALL = [(w, n, kw) for w, jobs in JOBS.items() for n, kw in jobs]


def _kw(kw):
    return {"remat": False, "zero_stage": 0, **kw}


def _jax_trainer(**kw):
    cfg = jh.GPTConfig(**mr.WIDTHS, **kw, compute_dtype=jnp.float32)
    n = cfg.dp * cfg.pp * cfg.mp * cfg.ep
    return jh.HybridGPT(cfg, devices=jax.devices()[:n])


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + k + ".")
        else:
            yield prefix + k, tree[k]


def _jax_start(jt, params=None):
    """JAX's initial (params, opt) at `jt`'s mesh: `params` (logical,
    numpy; the trainer's own init if None) with the qkv leaves permuted
    head-major over its mp, so it computes the logical model."""
    jp, jo = jt.init(jax.random.PRNGKey(0))
    src = _np(jp) if params is None else params
    k, H = jt.cfg.mp, jt.cfg.n_heads
    put = {n: (np.asarray(shard_major_qkv(src["blocks"][n], k, H, HD))
               if k > 1 else src["blocks"][n]) for n in ("w_qkv", "b_qkv")}
    new = dict(src, blocks=dict(src["blocks"], **put))
    return jax.tree.map(lambda a, b: jax.device_put(b, a.sharding), jp,
                        new), jo


def _jax_run(jt, jp, jo, steps):
    res = dict(losses=[])
    for i, (tok, lab) in enumerate(steps, 1):
        jp, jo, jl = jt.train_step(jp, jo, *jt.shard_data(tok, lab),
                                   step_num=i)
        res["losses"].append(float(jl))
        if i == 1:
            res["params1"], res["opt1"] = _np(jp), _np(jo)
    return jp, jo, res


def _assert_params(got, want, what=""):
    want = dict(_flat(want))
    for name, p in _flat(got):
        np.testing.assert_allclose(np.asarray(p), np.asarray(want[name]),
                                   rtol=0, atol=P_TOL, err_msg=what + name)


def _assert_first_moments(got, want, what=""):
    want = dict(_flat(want))
    for name, m in _flat(got):
        if name.endswith(".m"):
            e = np.asarray(want[name])
            np.testing.assert_allclose(
                np.asarray(m), e, rtol=0, atol=1e-4 * np.abs(e).max(),
                err_msg=what + name)


def _one_rank(state, kw, steps):
    """The port's 1-rank trainer of a job's config (its micro-batches
    kept) from `state`."""
    cfg = mr.config(**{k: v for k, v in _kw(kw).items()
                       if k not in MESH_KEYS})
    tt = th.HybridGPT(cfg, device="cpu")
    p, o = shard_jax_hybrid_gpt(*state, cfg=cfg, rank=0, device="cpu")
    return mr.train(tt, p, o, steps)[2]


@pytest.fixture(scope="module")
def jax_init():
    return _np(_jax_trainer(remat=False, zero_stage=0).init(
        jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def departure_weights(jax_init):
    """The initial parameters x 25 (Motivation of the qkv departure: at
    init scale the two cuts' models are too alike to tell apart)."""
    return jax.tree.map(lambda a: a * np.float32(25), jax_init[0])


@pytest.fixture(scope="module")
def ring_inputs():
    rng = np.random.RandomState(0)
    return {n: rng.randn(2, 64, 4, 16).astype(np.float32)
            for n in ("q", "k", "v", "g")}


@pytest.fixture(scope="module")
def mesh_runs(jax_init, departure_weights, ring_inputs, tmp_path_factory):
    """Each rank's results per job, JAX's trainer at each job's mesh and
    the port's 1-rank trainer, on the same state and batches."""
    steps, ev = mr.batches(), mr.batches(seed=9, n=1)[0]
    jobs = {w: [(n, "train", _kw(kw)) for n, kw in js]
            for w, js in JOBS.items() if w > 1}
    jobs[2].append(("departure_mp2", "loss", dict(mp=2)))
    jobs[4] = [(f"ring_causal{c}", "ring", dict(causal=c))
               for c in (False, True)]
    d = tmp_path_factory.mktemp("mesh")
    torch.save(dict(jobs=jobs, state=jax_init, batches=steps, eval=ev,
                    loss_params=departure_weights, ring=ring_inputs),
               d / "inputs.pt")
    ranks = {}
    for world in jobs:
        for res in mr.run_ranks(world, str(d)):
            for name, r in res.items():
                ranks.setdefault(name, []).append(r)
    jax_runs, one = {}, {}
    for world, name, kw in ALL:
        jt = _jax_trainer(**_kw(kw))
        jp, jo = _jax_start(jt)
        jp, _, jax_runs[name] = _jax_run(jt, jp, jo, steps)
        if name == "pp2_micro2":
            jax_runs[name]["eval"] = float(jt.loss(jp, *jt.shard_data(*ev)))
        one[name] = _one_rank(jax_init, kw, steps)
    for world in (1,):
        for name, kw in JOBS[world]:
            ranks[name] = [one[name]]
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
        jp1, jo1 = shard_jax_hybrid_gpt(want["params1"], want["opt1"],
                                        cfg=cfg, rank=r, device="cpu",
                                        jax_mp=cfg.mp)
        _assert_params(got["params1"], jp1, f"rank {r} vs JAX: ")
        _assert_first_moments(got["opt1"], jo1, f"rank {r} vs JAX: ")
        _assert_params(got["params1"],
                       th.shard_state(cfg, one[name]["params1"], rank=r),
                       f"rank {r} vs 1 rank: ")
        if "eval" in want:
            np.testing.assert_allclose(float(got["eval"][0]), want["eval"],
                                       rtol=1e-5)


def test_qkv_departure(mesh_runs, departure_weights):
    """JAX's trainer at mp = 2 cuts the fused qkv contiguously: on the
    same weights its loss differs from its mp = 1 loss; the port's mp = 2
    (heads cut) equals JAX's mp = 1. A JAX mp = 2 state put back through
    `jax_mp=2` gives JAX's mp = 2 loss in the port."""
    ranks, _, _ = mesh_runs
    tok, lab = mr.batches()[0]
    losses = {}
    for mp in (1, 2):
        jt = _jax_trainer(mp=mp, remat=False, zero_stage=0)
        jp, _ = jt.init(jax.random.PRNGKey(0))
        jp = jax.tree.map(lambda a, b: jax.device_put(b, a.sharding), jp,
                          departure_weights)
        losses[mp] = float(jt.loss(jp, *jt.shard_data(tok, lab)))
    assert abs(losses[2] - losses[1]) >= 0.1, losses
    for r, got in enumerate(ranks["departure_mp2"]):
        np.testing.assert_allclose(got, losses[1], rtol=1e-5,
                                   err_msg=f"rank {r}")
    cfg = mr.config(remat=False)
    tp = shard_jax_hybrid_gpt(departure_weights, cfg=cfg, rank=0,
                              device="cpu", jax_mp=2)
    np.testing.assert_allclose(
        float(th.HybridGPT(cfg, device="cpu").loss(tp, tok, lab)),
        losses[2], rtol=1e-5)
    # the moments come back with their parameters
    mom = {"m": np.arange(departure_weights["blocks"]["b_qkv"].size,
                          dtype=np.float32).reshape(
                              departure_weights["blocks"]["b_qkv"].shape)}
    mom["v"] = mom["m"]
    opt = jax.tree.map(lambda a: {"m": a, "v": a}, departure_weights)
    opt["blocks"]["b_qkv"] = mom
    _, to = load_jax_hybrid_gpt(departure_weights, opt, device="cpu",
                                jax_mp=2, n_heads=mr.WIDTHS["n_heads"])
    assert torch.equal(to["blocks"]["b_qkv"]["m"], tp["blocks"]["b_qkv"]
                       .new_tensor(mom["m"]).reshape(-1, 2, 3, 2, HD)
                       .transpose(1, 2).reshape(mom["m"].shape))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(mesh_runs, ring_inputs, causal):
    """`ring_attention` at cp 4 (4 ranks, a [2, 16, 4, 16] block each)
    against JAX's at cp 4: the output and the gradients of (out * g)
    .sum() with respect to q, k and v."""
    ranks, _, _ = mesh_runs
    q, k, v, g = (jnp.asarray(ring_inputs[n]) for n in "qkvg")
    mesh = JMesh(np.array(jax.devices()[:4]), ("cp",))

    out, vjp = jax.vjp(lambda q, k, v: jax_ring_attention(
        q, k, v, mesh=mesh, causal=causal), q, k, v)
    want = dict(zip(("out", "dq", "dk", "dv"),
                    map(np.asarray, (out,) + vjp(g))))
    blocks = ranks[f"ring_causal{causal}"]
    for key, w in want.items():
        got = np.concatenate([b[key].numpy() for b in blocks], axis=1)
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=2e-5,
                                   err_msg=key)


@pytest.mark.parametrize("kw", [
    dict(mp=2), dict(pp=2, micro_batches=2), dict(dp=2, pp=2, mp=2,
                                                  micro_batches=4),
    dict(mp=2, sequence_parallel=True, bf16_grads=True),
    dict(pp=4, mp=2, micro_batches=2, zero_stage=0),
    dict(dp=2, grad_bucket_bytes=4096),
    dict(pp=2, mp=2, ep=2, moe_experts=4, micro_batches=2,
         sequence_parallel=True)])
@pytest.mark.parametrize("batch", [8, 32])
def test_collective_bytes_match_jax(kw, batch):
    jcfg = jh.GPTConfig(**mr.WIDTHS, **kw)
    tcfg = th.GPTConfig(**mr.WIDTHS, **kw)
    got = th.collective_bytes_per_step(tcfg, batch)
    assert got == jh.collective_bytes_per_step(jcfg, batch)
    assert ("mp_psum_est" in got) == (tcfg.mp > 1)
    assert ("pp_ppermute_est" in got) == (tcfg.pp > 1)


@pytest.mark.parametrize("mesh", [dict(dp=2, pp=2, mp=2),
                                  dict(pp=2, mp=2, ep=2, moe_experts=4)],
                         ids=["dense", "moe"])
@pytest.mark.parametrize("zero_stage", [0, 1])
def test_shards_put_back_together(jax_init, mesh, zero_stage):
    """`shard_state` cuts every leaf of the logical state to each rank
    (its stage's layers, its mp slice with qkv by heads, its experts);
    the ranks' slices put back together give the leaf, and the ZeRO
    slices of the ranks holding one slice give its moments."""
    moe = "moe_experts" in mesh
    cfg = mr.config(zero_stage=zero_stage, **mesh, **(
        dict(moe_capacity_factor=4.0) if moe else {}))
    g = torch.Generator().manual_seed(0)
    full = th.init_params(cfg, g, "cpu")
    opt = th._tree_map(lambda _, p: {"m": torch.randn(p.shape,
                                                      generator=g),
                                     "v": torch.rand(p.shape,
                                                     generator=g)}, full)
    n = cfg.dp * cfg.pp * cfg.mp * cfg.ep
    sizes = th._mesh_sizes(cfg)
    shards = [th.shard_state(cfg, full, opt, r) for r in range(n)]
    for path, p in th._leaves(full):
        cut = th._cut_axes(cfg, path)
        axes = [a for a in th.AXES if a in cut]
        by_slice = {}                 # the slice's coordinates -> holders
        for r, (sp, so) in enumerate(shards):
            c = th._coords(r, sizes)
            by_slice.setdefault(tuple(c[a] for a in axes), []).append(
                (r, th._get(sp, path), th._get(so, path)))
        for held in by_slice.values():
            for _, t, _ in held:
                assert torch.equal(t, held[0][1]), path

        def join(prefix, depth):
            """The slices put back together along their axes."""
            if depth == len(axes):
                return by_slice[prefix][0][1]
            a = axes[depth]
            parts = [join(prefix + (i,), depth + 1)
                     for i in range(sizes[a])]
            if a == "mp" and path[-1] in ("w_qkv", "b_qkv"):
                lead = parts[0].shape[:-1]           # (3, H / mp, Dh) each
                return torch.stack([t.reshape(*lead, 3, -1) for t in parts],
                                   -2).reshape(*lead, -1)
            return torch.cat(parts, cut[a])
        assert torch.equal(join((), 0), p), path
        for k in ("m", "v"):
            for held in by_slice.values():
                local = th._cut(cfg, path, th._get(opt, path)[k], th.Mesh(
                    sizes=sizes, coords=th._coords(held[0][0], sizes)))
                if zero_stage == 0 or len(held) == 1:
                    for _, _, so in held:
                        assert torch.equal(so[k], local), path
                    continue
                flat = torch.cat([so[k] for _, _, so in held])
                assert torch.equal(flat[:local.numel()], local.reshape(-1))
                assert not flat[local.numel():].any()
