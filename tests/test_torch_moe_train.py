"""CPU parity of the port's MoE trainer and its dp x ep mesh
(`paddle_tpu_torch.parallel.hybrid_gpt.HybridGPT` with `moe_experts`)
against the JAX package's `HybridGPT`.

The JAX trainer's initial state is carried across with
`convert.shard_jax_hybrid_gpt` (JAX's ZeRO-flat Adam moments included),
then both take the same steps on the same numpy batches at
tests/test_moe.py's widths (4 experts, top-2, capacity factor 4.0: no
drops) at 2 layers, fp32. One rank runs in the test process. The
meshes run in rank processes over gloo (`torch_mesh_ranks`: one spawn of
two ranks for dp = 2 and ep = 2, one of four for dp = 2 x ep = 2, at
zero_stage 0 and 1), held against JAX's trainer at the same mesh on the
conftest's virtual devices and against the port's 1-rank trainer. JAX's
trainer runs at its default zero_stage 1; its ZeRO changes only where
its moments live, so its moments are cut to each port layout
(`hybrid_gpt.shard_state`) to be compared.

Tolerances are tests/test_torch_hybrid_gpt.py's: losses rtol 1e-4 over
3 steps, parameters after step 1 within 5e-2 lr, Adam's first moment
within 1e-4 of its tensor's largest |m|; `counts` and `dropped` exactly
equal, `balance` and `z` within rtol 1e-5; bf16 grads: the loss within
rtol 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as mr
from paddle_tpu.ops.pallas import grouped_matmul as jgmm
from paddle_tpu.parallel import hybrid_gpt as jh
from paddle_tpu.parallel import moe_utils as jmu
from paddle_tpu.profiler import metrics as jpm
from paddle_tpu_torch.convert import load_jax_hybrid_gpt, shard_jax_hybrid_gpt
from paddle_tpu_torch.ops import grouped_matmul as tgmm
from paddle_tpu_torch.parallel import hybrid_gpt as th
from paddle_tpu_torch.parallel import moe_utils as tmu
from paddle_tpu_torch.profiler import metrics as tpm
from test_torch_grouped_matmul import interpret  # noqa: F401 (fixture)

#: tests/test_moe.py's `_make_cfg` widths at 2 layers (capacity factor
#: 4.0: nothing is dropped)
MOE_KW = dict(n_layers=2, **mr.MOE)
WIDTHS = {**mr.WIDTHS, **MOE_KW}
STEPS = 3
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
LR = WIDTHS["learning_rate"]
P_TOL = 5e-2 * LR
MESHES = {"dp2": dict(dp=2), "ep2": dict(ep=2), "dp2_ep2": dict(dp=2, ep=2)}
JOBS = [(world, name, kw) for world, jobs in MESH_JOBS.items()
        for name, kw in jobs]


def _config(**kw):
    return mr.config(**{**MOE_KW, **kw})


def _batches(seed=0, n=STEPS):
    return mr.batches(seed, n)


def _jax_trainer(**kw):
    mesh = {k: kw.pop(k) for k in ("dp", "ep") if k in kw}
    cfg = jh.GPTConfig(**WIDTHS, **mesh, **kw, compute_dtype=jnp.float32)
    return jh.HybridGPT(cfg, devices=jax.devices()[:cfg.dp * cfg.ep])


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + k + ".")
        else:
            yield prefix + k, tree[k]


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


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


def _assert_stats(got, want, what=""):
    for k in ("counts", "dropped"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]),
                                      err_msg=what + k)
    for k in ("balance", "z"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-5, err_msg=what + k)


def _jax_run(jt, jp, jo, steps):
    """JAX's steps; returns losses, stats, and params / opt after step 1
    as numpy."""
    res = dict(losses=[], stats=[])
    for i, (tok, lab) in enumerate(steps, 1):
        jp, jo, jl = jt.train_step(jp, jo, *jt.shard_data(tok, lab),
                                   step_num=i)
        res["losses"].append(float(jl))
        res["stats"].append(_np(jt.last_moe_stats))
        if i == 1:
            # copy out now: the next step donates them
            res["params1"], res["opt1"] = _np(jp), _np(jo)
    return jp, jo, res


# ------------------------------------------------------------ one rank


@pytest.fixture(scope="module")
def jax_init():
    """The JAX trainer's initial (params, opt_state) as numpy: the same
    at every mesh (JAX initialises unsharded)."""
    jt = _jax_trainer(remat=False)
    return _np(jt.init(jax.random.PRNGKey(0)))


def _port_one_rank(jax_state, **kw):
    cfg = _config(**kw)
    tt = th.HybridGPT(cfg, device="cpu")
    return tt, *shard_jax_hybrid_gpt(*jax_state, cfg=cfg, rank=0,
                                     device="cpu")


@pytest.mark.parametrize("kw", [
    dict(remat=False),
    dict(remat=True, ce_seq_chunks=2),
    dict(remat=True, ce_seq_chunks=2, remat_policy="save_splash_residuals"),
    dict(remat=False, fused_add_ln=False, zero_stage=0),
], ids=["plain", "remat-chunked", "splash-residuals", "unfused-zero0"])
def test_moe_train_steps_match_jax(jax_init, kw):
    jt = _jax_trainer(**{k: v for k, v in kw.items() if k != "zero_stage"})
    jp, jo = jt.init(jax.random.PRNGKey(0))
    tt, tp, to = _port_one_rank(jax_init, **kw)
    steps = _batches()
    _, _, want = _jax_run(jt, jp, jo, steps)
    _, _, got = mr.train(tt, tp, to, steps)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    for i, (g, w) in enumerate(zip(got["stats"], want["stats"])):
        _assert_stats(g, w, f"step {i + 1}: ")
    _assert_params(got["params1"], want["params1"])
    _, jo1 = shard_jax_hybrid_gpt(want["params1"], want["opt1"], cfg=tt.cfg,
                                  rank=0, device="cpu")
    _assert_first_moments(got["opt1"], jo1)


def test_moe_bf16_grads_loss_follows_jax():
    kw = dict(remat=True, ce_seq_chunks=2, bf16_grads=True)
    jcfg = jh.GPTConfig(**WIDTHS, **kw, compute_dtype=jnp.bfloat16)
    jt = jh.HybridGPT(jcfg, devices=jax.devices()[:1])
    jp, jo = jt.init(jax.random.PRNGKey(1))
    tcfg = th.GPTConfig(**WIDTHS, **kw, compute_dtype=torch.bfloat16)
    tt = th.HybridGPT(tcfg, device="cpu")
    tp, to = shard_jax_hybrid_gpt(*_np((jp, jo)), cfg=tcfg, rank=0,
                                  device="cpu")
    for i, (tok, lab) in enumerate(_batches(seed=1), 1):
        jp, jo, jl = jt.train_step(jp, jo, *jt.shard_data(tok, lab),
                                   step_num=i)
        tp, to, tl = tt.train_step(tp, to, tok, lab, step_num=i)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3,
                                   err_msg=f"loss at step {i}")


def test_train_many_keeps_moe_stats(jax_init):
    """`train_many` (k steps, a loop in the port) keeps the routing
    stats: `last_moe_stats` the final step's, the metrics the k-step
    aggregate, the losses JAX's."""
    steps = _batches(seed=5, n=1)
    jt = _jax_trainer(remat=False)
    jp, jo = jt.init(jax.random.PRNGKey(0))
    tt, tp, to = _port_one_rank(jax_init, remat=False)
    got = {}
    for pm in (jpm, tpm):
        pm.enable()
        pm.REGISTRY.reset()
    try:
        jp, jo, jl = jt.train_many(jp, jo, *jt.shard_data(*steps[0]), k=3)
        tp, to, tl = tt.train_many(tp, to, *steps[0], k=3)
        want, got = mr.metric_samples(jpm), mr.metric_samples(tpm)
    finally:
        for pm in (jpm, tpm):
            pm.REGISTRY.reset()
            pm.disable()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    _assert_stats(tt.last_moe_stats, _np(jt.last_moe_stats))
    per_step = mr.BATCH * 16 * 2 * WIDTHS["n_layers"]
    st = tt.last_moe_stats
    assert float(st["counts"].sum()) + float(st["dropped"]) == per_step
    assert got.pop("MOE_AUX_LOSS") == pytest.approx(
        want.pop("MOE_AUX_LOSS"), rel=1e-5)
    assert got == want
    assert sum(got["MOE_EXPERT_TOKENS"].values()) == 3 * per_step


def test_loss_and_moe_stats_match_jax(jax_init):
    jt = _jax_trainer(remat=False)
    jp, _ = jt.init(jax.random.PRNGKey(0))
    tt, tp, _ = _port_one_rank(jax_init, remat=False)
    tok, lab = _batches(seed=3, n=1)[0]
    jl, js = jt.loss_and_moe_stats(jp, *jt.shard_data(tok, lab))
    tl, ts = tt.loss_and_moe_stats(tp, tok, lab)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_stats(ts, _np(js))
    assert float(tt.loss(tp, tok, lab)) == float(tl)


def test_moe_steps_are_reproducible():
    """Two identical steps give the same bits in every parameter and
    moment: the index dispatch / combine sum in a fixed order."""
    runs = []
    for _ in range(2):
        tt = th.HybridGPT(_config(remat=True), device="cpu")
        params, opt = tt.init(seed=3)
        params, opt, _ = tt.train_step(params, opt, *_batches()[0])
        runs.append((params, opt))
    for a, b in ((runs[0][0], runs[1][0]), (runs[0][1], runs[1][1])):
        for (n, x), (_, y) in zip(_flat(a), _flat(b)):
            assert torch.equal(x, y), n


def test_aux_losses_reach_the_gate_through_remat():
    """The balance and z losses' gradient reaches `gate` through the
    checkpointed blocks: raising their weights changes the gate's step
    and nothing else's first moment is zero."""
    grads = {}
    for w in (0.0, 1.0):
        tt = th.HybridGPT(_config(remat=True, zero_stage=0,
                                    moe_aux_weight=w, moe_z_weight=w,
                                    remat_policy="save_splash_residuals"),
                          device="cpu")
        params, opt = tt.init(seed=0)
        tt.train_step(params, opt, *_batches()[0])
        grads[w] = opt["blocks"]["gate"]["m"].clone()
    assert not torch.allclose(grads[0.0], grads[1.0])


# --------------------------------------------------------------- config


_BAD = [(dict(moe_experts=4, moe_num_experts=8), "conflicts"),
        (dict(moe_num_experts=3, ep=2), "divide"),
        (dict(ep=2), "MoE"),
        (dict(moe_num_experts=4, moe_top_k=5), "top_k")]


@pytest.mark.parametrize("kw,match", _BAD,
                         ids=["alias-conflict", "ep-divides", "ep-needs-moe",
                              "top-k"])
def test_config_refuses_what_jax_refuses(kw, match):
    base = dict(vocab_size=64, seq_len=16, d_model=32, n_heads=4,
                n_layers=2)
    with pytest.raises(AssertionError):
        jh.GPTConfig(**base, **kw)
    with pytest.raises(ValueError, match=match):
        th.GPTConfig(**base, **kw)


def test_config_alias_is_constructor_only():
    for mod in (jh, th):
        cfg = mod.GPTConfig(vocab_size=64, seq_len=16, d_model=32,
                            n_heads=4, n_layers=2, moe_num_experts=8)
        assert cfg.moe_experts == 8
        assert dataclasses.replace(cfg, moe_experts=0).moe_experts == 0
    assert th.GPTConfig().zero_stage == jh.GPTConfig().zero_stage == 1


@pytest.mark.parametrize("kw", [dict(dp=2), dict(moe_experts=4, ep=2),
                                dict(moe_experts=4, dp=2, ep=2)])
def test_mesh_needs_a_process_group(kw):
    cfg = _config(**{**kw, "moe_num_experts": 0})
    with pytest.raises(RuntimeError, match="init_process_group"):
        th.HybridGPT(cfg, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(dp=2, zero_stage=1), dict(dp=2, ep=2, zero_stage=0),
    dict(dp=4, ep=2, zero_stage=1, bf16_grads=True),
    dict(ep=2, zero_stage=1), dict(zero_stage=1), dict(zero_stage=0)])
@pytest.mark.parametrize("batch", [8, 32])
def test_collective_bytes_match_jax(kw, batch):
    jcfg = jh.GPTConfig(**WIDTHS, **kw)
    tcfg = th.GPTConfig(**WIDTHS, **kw)
    assert th.collective_bytes_per_step(tcfg, batch) \
        == jh.collective_bytes_per_step(jcfg, batch)


# ----------------------------------------------------- state carry-over


@pytest.fixture(scope="module")
def jax_init_zero0():
    """The JAX trainer's initial state at zero_stage 0 (moments shaped as
    their parameters)."""
    return _np(_jax_trainer(remat=False, zero_stage=0).init(
        jax.random.PRNGKey(0)))


@pytest.mark.parametrize("jax_zero", [0, 1])
@pytest.mark.parametrize("zero_stage", [0, 1])
@pytest.mark.parametrize("dp,ep", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_jax_state_cut_to_each_rank(jax_init, jax_init_zero0, jax_zero,
                                    zero_stage, dp, ep):
    """A JAX trainer's state (its moments shaped at zero_stage 0, flat at
    1) cut to every rank of a dp x ep mesh: the rank's experts, every
    other leaf whole; the ranks' moment slices put back together give
    the moments, and a leaf that one rank holds keeps them shaped."""
    params, opt = jax_init_zero0 if jax_zero == 0 else jax_init
    rng = np.random.RandomState(0)
    opt = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                       opt)
    cfg = _config(dp=dp, ep=ep, zero_stage=zero_stage)
    full_p, full_o = load_jax_hybrid_gpt(params, opt, device="cpu")
    shards = [shard_jax_hybrid_gpt(params, opt, cfg=cfg, rank=r,
                                   device="cpu") for r in range(dp * ep)]
    E_loc = 4 // ep
    for name, p in _flat(full_p):
        expert = name.split(".")[-1] in th.EXPERT_LEAVES
        for r, (sp, so) in enumerate(shards):
            got = dict(_flat(sp))[name]
            want = p[:, (r % ep) * E_loc:(r % ep + 1) * E_loc] \
                if expert else p
            assert torch.equal(got, want), name
        # ZeRO-1 shards the moments of a leaf held by more than one rank
        holders = dp if expert else dp * ep
        for k in ("m", "v"):
            full = dict(_flat(full_o))[f"{name}.{k}"]
            if zero_stage == 0 or holders == 1:
                for r, (_, so) in enumerate(shards):
                    want = full[:, (r % ep) * E_loc:(r % ep + 1) * E_loc] \
                        if expert else full
                    assert torch.equal(dict(_flat(so))[f"{name}.{k}"],
                                       want)
                continue
            # the holders' slices, in holder order, give the flat moments
            for e in range(ep if expert else 1):
                ranks = [i * ep + e for i in range(dp)] if expert \
                    else range(dp * ep)
                flat = torch.cat([dict(_flat(shards[r][1]))[f"{name}.{k}"]
                                  for r in ranks])
                want = (full[:, e * E_loc:(e + 1) * E_loc] if expert
                        else full).reshape(-1)
                assert torch.equal(flat[:want.numel()], want), name
                assert not flat[want.numel():].any()


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_jax_zero1_state_steps_a_default_trainer(moe):
    """`load_jax_hybrid_gpt` of a JAX trainer's ZeRO-1 state (JAX's
    default zero_stage) steps the port's trainer at its default
    zero_stage, the documented alternative to `init`, as JAX's step."""
    widths = {k: v for k, v in WIDTHS.items() if not k.startswith("moe")
              or moe}
    jcfg = jh.GPTConfig(**widths, remat=False, compute_dtype=jnp.float32)
    tcfg = th.GPTConfig(**widths, remat=False, compute_dtype=torch.float32)
    assert jcfg.zero_stage == tcfg.zero_stage == 1
    jt = jh.HybridGPT(jcfg, devices=jax.devices()[:1])
    jp, jo = jt.init(jax.random.PRNGKey(2))
    tp, to = load_jax_hybrid_gpt(*_np((jp, jo)), device="cpu")
    tt = th.HybridGPT(tcfg, device="cpu")
    for i, (tok, lab) in enumerate(_batches(seed=2, n=2), 1):
        jp, jo, jl = jt.train_step(jp, jo, *jt.shard_data(tok, lab),
                                   step_num=i)
        tp, to, tl = tt.train_step(tp, to, tok, lab, step_num=i)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4,
                                   err_msg=f"loss at step {i}")
        if i == 1:
            _assert_params(tp, _np(jp), "after step 1: ")


def test_load_jax_hybrid_gpt_checks_moe_moments(jax_init):
    params, opt = jax_init
    p, o = load_jax_hybrid_gpt(params, opt, device="cpu")
    assert tuple(p["blocks"]["w_fc1"].shape) == (2, 4, 32, 64)
    assert tuple(o["blocks"]["w_fc1"]["m"].shape) == (2, 4, 32, 64)
    bad = jax.tree.map(lambda a: a, opt)
    bad["blocks"]["gate"] = {"m": np.zeros(5, np.float32),
                             "v": np.zeros(5, np.float32)}
    with pytest.raises(ValueError, match="gate"):
        load_jax_hybrid_gpt(params, bad, device="cpu")


# ----------------------------------------------------------- the router


def test_routing_and_both_dispatch_pairs_match_jax():
    """The router's plan and losses, the one-hot einsum pair and the
    index pair against JAX's, forward and backward, at a capacity that
    drops choices."""
    rng = np.random.RandomState(0)
    T, E, k, d = 40, 4, 2, 8
    C = 12                                 # < T k / E: some choices drop
    logits = rng.randn(T, E).astype(np.float32)
    x = rng.randn(T, d).astype(np.float32)
    ge = rng.randn(E, C, d).astype(np.float32)     # cotangent of dispatch
    gt = rng.randn(T, d).astype(np.float32)        # cotangent of combine
    eout = rng.randn(E, C, d).astype(np.float32)

    jr = jmu.top_k_routing(jnp.asarray(logits), k, C, dtype=jnp.float32)

    def jdisp(x):
        return jnp.sum(jmu.dispatch_tokens(x, jr.plan) * ge)

    def jcomb(eout, logits):
        r = jmu.top_k_routing(logits, k, C, dtype=jnp.float32)
        return jnp.sum(jmu.combine_tokens(eout, r.plan) * gt)
    jdx = jax.grad(jdisp)(jnp.asarray(x))
    jde, jdl = jax.grad(jcomb, argnums=(0, 1))(jnp.asarray(eout),
                                               jnp.asarray(logits))

    lt = torch.tensor(logits, requires_grad=True)
    tr = tmu.top_k_routing(lt, k, C, dtype=torch.float32)
    assert float(tr.plan.dropped) == float(jr.plan.dropped) > 0
    np.testing.assert_array_equal(tr.plan.counts.numpy(),
                                  np.asarray(jr.plan.counts))
    np.testing.assert_allclose(tr.balance_loss.item(),
                               float(jr.balance_loss), rtol=1e-6)
    np.testing.assert_allclose(tr.z_loss.item(), float(jr.z_loss),
                               rtol=1e-6)
    for pair in ("einsum", "indexed"):
        xt = torch.tensor(x, requires_grad=True)
        et = torch.tensor(eout, requires_grad=True)
        if pair == "einsum":
            disp = tmu.dispatch_tokens(xt, tr.plan, C)
            comb = tmu.combine_tokens(et, tr.plan)
        else:
            disp = tmu.dispatch_tokens_indexed(xt, tr.plan, E, C)
            comb = tmu.combine_tokens_indexed(et, tr.plan)
        np.testing.assert_allclose(
            disp.detach().numpy(),
            np.asarray(jmu.dispatch_tokens(jnp.asarray(x), jr.plan)),
            rtol=1e-6, atol=1e-6, err_msg=pair)
        np.testing.assert_allclose(
            comb.detach().numpy(),
            np.asarray(jmu.combine_tokens(jnp.asarray(eout), jr.plan)),
            rtol=1e-5, atol=1e-6, err_msg=pair)
        dx, = torch.autograd.grad((disp * torch.tensor(ge)).sum(), xt)
        de, dl = torch.autograd.grad((comb * torch.tensor(gt)).sum(),
                                     (et, lt), retain_graph=True)
        np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5,
                                   atol=1e-6, err_msg=pair)
        np.testing.assert_allclose(de.numpy(), np.asarray(jde), rtol=1e-5,
                                   atol=1e-6, err_msg=pair)
        np.testing.assert_allclose(dl.numpy(), np.asarray(jdl), rtol=1e-4,
                                   atol=1e-6, err_msg=pair)
    # one ep rank's experts (serving's expert-parallel call): its rows,
    # and gradients to its rows only, which sum over the ranks to the
    # whole pair's
    ch = tmu.dispatch_choices(tr.plan, E, C)
    dx_sum, out_sum = 0, 0
    for r in range(2):
        xt = torch.tensor(x, requires_grad=True)
        et = torch.tensor(eout[2 * r:2 * r + 2], requires_grad=True)
        rows = tmu.local_indices(ch, r, 2)
        disp = tmu.dispatch_tokens_indexed(xt, tr.plan, E, C, choices=rows,
                                           e_offset=2 * r)
        comb = tmu.combine_tokens_indexed(et, tr.plan, e_offset=2 * r,
                                          num_local=2)
        np.testing.assert_allclose(
            disp.detach().numpy(),
            np.asarray(jmu.dispatch_tokens(jnp.asarray(x), jr.plan))[
                2 * r:2 * r + 2], rtol=1e-6, atol=1e-6)
        dx, = torch.autograd.grad(
            (disp * torch.tensor(ge[2 * r:2 * r + 2])).sum(), xt)
        de, = torch.autograd.grad((comb * torch.tensor(gt)).sum(), et,
                                  retain_graph=True)
        np.testing.assert_allclose(de.numpy(),
                                   np.asarray(jde)[2 * r:2 * r + 2],
                                   rtol=1e-5, atol=1e-6)
        dx_sum, out_sum = dx_sum + dx, out_sum + comb.detach()
    np.testing.assert_allclose(dx_sum.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        out_sum.numpy(),
        np.asarray(jmu.combine_tokens(jnp.asarray(eout), jr.plan)),
        rtol=1e-5, atol=1e-6)


# ----------------------------------------------- K4 under autograd (CPU)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_backward_matches_jax(interpret, dtype):
    """`grouped_expert_matmul` with float weights under autograd (its
    plain forward on the CPU, JAX's `_gmm_core_bwd` backward) against
    `jax.grad` through JAX's, its Pallas forward in interpret mode."""
    rng = np.random.RandomState(0)
    E, C, D, F = 2, 8, 16, 32
    x = rng.randn(E, C, D).astype(np.float32)
    w = (rng.randn(E, D, F) * 0.1).astype(np.float32)
    g = rng.randn(E, C, F).astype(np.float32)

    def jloss(x, w):
        out = jgmm.grouped_expert_matmul(x, w)
        return jnp.sum(out.astype(jnp.float32) * g)
    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype))
    td = getattr(torch, dtype)
    xt = torch.tensor(x).to(td).requires_grad_()
    wt = torch.tensor(w).to(td).requires_grad_()
    out = tgmm.grouped_expert_matmul(xt, wt)
    dx, dw = torch.autograd.grad((out.float() * torch.tensor(g)).sum(),
                                 (xt, wt))
    assert dx.dtype == dw.dtype == td
    tol = 2e-5 if dtype == "float32" else 2e-2
    for got, want in ((dx, jdx), (dw, jdw)):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol * np.abs(want).max())


def test_grouped_matmul_quantized_refuses_grad():
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(2, 4, 8).astype(np.float32))
    w = torch.tensor(rng.randint(-127, 128, (2, 8, 6)).astype(np.int8))
    s = torch.ones(2, 6)
    tgmm.grouped_expert_matmul(x, w, s)            # forward only: fine
    with pytest.raises(RuntimeError, match="gradient"):
        tgmm.grouped_expert_matmul(x.requires_grad_(), w, s)
    with torch.no_grad():
        tgmm.grouped_expert_matmul(x, w, s)


# ------------------------------------------------------ dp x ep ranks


@pytest.fixture(scope="module")
def mesh_runs(jax_init, tmp_path_factory):
    """Each rank's results per job (`torch_mesh_ranks`), JAX's trainer at
    each mesh, and the port's 1-rank trainer, on the same state and
    batches."""
    steps, ev = _batches(), _batches(seed=9, n=1)[0]
    jobs = {world: [(name, "train_many" if name == METRICS_JOB else "train",
                     {**MOE_KW, **kw}) for name, kw in js]
            for world, js in MESH_JOBS.items()}
    d = tmp_path_factory.mktemp("moe_mesh")
    torch.save(dict(jobs=jobs, moe_state=jax_init, batches=steps, eval=ev,
                    many_k=MANY_K), d / "inputs.pt")
    ranks = {}
    for world in jobs:
        for res in mr.run_ranks(world, str(d)):
            for name, r in res.items():
                ranks.setdefault(name, []).append(r)
    jax_runs = {}
    for mesh, kw in MESHES.items():
        jt = _jax_trainer(remat=False, **kw)
        jp, jo = jt.init(jax.random.PRNGKey(0))
        if mesh == "dp2_ep2":
            jpm.enable()
            jpm.REGISTRY.reset()
        jp, jo, res = _jax_run(jt, jp, jo, steps)
        res["eval"] = _np(jt.loss_and_moe_stats(jp, *jt.shard_data(*ev)))
        if mesh == "dp2_ep2":
            jt.flush_moe_metrics()
            res["metrics_steps"] = mr.metric_samples(jpm)
            jpm.REGISTRY.reset()
            jp, jo, losses = jt.train_many(jp, jo, *jt.shard_data(*steps[0]),
                                           k=MANY_K,
                                           start_step=STEPS + 1)
            res["many_losses"] = np.asarray(losses).tolist()
            res["many_last"] = _np(jt.last_moe_stats)
            res["metrics_many"] = mr.metric_samples(jpm)
            res["params_end"] = _np(jp)
            jpm.REGISTRY.reset()
            jpm.disable()
        jax_runs[mesh] = res
    tt, tp, to = _port_one_rank(jax_init, remat=False)
    _, _, one = mr.train(tt, tp, to, steps)
    return ranks, jax_runs, one


def _mesh_of(name):
    return next(m for m in sorted(MESHES, key=len, reverse=True)
                if name.startswith(m))


@pytest.mark.parametrize("world,name,kw", JOBS, ids=[j[1] for j in JOBS])
def test_mesh_matches_jax_and_one_rank(mesh_runs, world, name, kw):
    ranks, jax_runs, one = mesh_runs
    want = jax_runs[_mesh_of(name)]
    results = ranks[name]
    assert len(results) == world
    cfg = _config(**kw)
    for r, got in enumerate(results):
        assert got["losses"] == results[0]["losses"], f"rank {r}"
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-4)
        for i, st in enumerate(got["stats"]):
            _assert_stats(st, want["stats"][i], f"rank {r} step {i + 1}: ")
        jp1, jo1 = shard_jax_hybrid_gpt(want["params1"], want["opt1"],
                                        cfg=cfg, rank=r, device="cpu")
        _assert_params(got["params1"], jp1, f"rank {r} vs JAX: ")
        _assert_first_moments(got["opt1"], jo1, f"rank {r} vs JAX: ")
        _assert_params(got["params1"],
                       th.shard_state(cfg, one["params1"], rank=r),
                       f"rank {r} vs 1 rank: ")
        loss, st = got["eval"]
        np.testing.assert_allclose(float(loss), float(want["eval"][0]),
                                   rtol=1e-5)
        _assert_stats(st, want["eval"][1], f"rank {r} eval: ")


def test_mesh_metrics_and_train_many_match_jax(mesh_runs):
    """dp 2 x ep 2 at zero_stage 1: the COLLECTIVE_* estimates and the
    MOE_* "train" series after 3 steps and a flush, then after
    train_many(k=3), equal JAX's; train_many's losses and final stats
    and the parameters after it too."""
    ranks, jax_runs, _ = mesh_runs
    want = jax_runs["dp2_ep2"]
    cfg = _config(**dict(MESH_JOBS[4])[METRICS_JOB])
    for r, got in enumerate(ranks[METRICS_JOB]):
        for key, wkey in (("metrics", "metrics_steps"),
                          ("metrics_many", "metrics_many")):
            g, w = dict(got[key]), dict(want[wkey])
            assert g.pop("MOE_AUX_LOSS") == pytest.approx(
                w.pop("MOE_AUX_LOSS"), rel=1e-5)
            assert g == w, (r, key)
        assert g["COLLECTIVE_CALLS"] == {
            ("dp_grad_allreduce_est",): 3.0, ("ep_alltoall_est",): 3.0,
            ("zero_shard_est",): 3.0}
        np.testing.assert_allclose(got["many_losses"], want["many_losses"],
                                   rtol=1e-4)
        _assert_stats(got["many_last"], want["many_last"])
        end = th.shard_state(cfg, load_jax_hybrid_gpt(want["params_end"],
                                                      device="cpu"), rank=r)
        # after 6 steps the parameters have moved by up to 6 lr: each
        # within the step-1 bound for every step taken
        for (n, a), (_, b) in zip(_flat(got["params_end"]), _flat(end)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=6 * P_TOL, err_msg=n)
