"""CPU parity of the port's optimizer (`paddle_tpu_torch.optimizer`:
the base, `Lamb`, the schedulers of `optimizer.lr` and the clips of
`nn.clip`) against the JAX package's, on the same numpy parameters and
gradients: every parameter and moment after each of 3 steps, in fp32
and with bf16 parameters (AMP O2: no master copy, the update computed in
fp32 from the bf16 value and stored back in bf16)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.optimizer import Lamb, lr as tlr

SHAPES = [(6, 5), (5,), (4, 3, 2), (7,), (3, 8)]
STEPS = 3
# fp32: the same arithmetic summed in another order (the norms) and
# fused differently (fma), ~1 ulp a step on O(1) values: 1e-6 (observed
# 2.4e-7 on parameters, 3.7e-9 on moments). bf16 parameters: both round
# the same fp32 update to bf16, so they agree but where the fp32 results
# straddle a rounding boundary: one bf16 spacing (2^-7 relative at
# most; observed 0); moments stay fp32.
TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
       "bfloat16": dict(rtol=2 ** -7, atol=1e-6)}
CLIPS = {"global_norm": ("ClipGradByGlobalNorm", 0.5),
         "norm": ("ClipGradByNorm", 0.3),
         "value": ("ClipGradByValue", 0.05)}
CASES = ("plain", "wd", "exclude", "groups", "scheduler", *CLIPS)


def arrays(seed=0):
    """Parameters and, for each step, gradients (O(0.1), some exactly
    0 so a parameter of zeros and an element of zero gradient occur)."""
    rng = np.random.RandomState(seed)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    params[3][:] = 0.0                   # w_norm = 0: trust ratio 1
    grads = [[0.1 * rng.randn(*s).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    for g in grads:
        g[0][0] = 0.0
    return params, grads


def schedule(mod):
    return mod.LinearWarmup(mod.PolynomialDecay(0.02, decay_steps=10,
                                                end_lr=0.001),
                            warmup_steps=2, start_lr=0.0, end_lr=0.02)


def options(case, mod, params):
    """Lamb's keyword arguments for `case`, over the framework `mod`
    (its `nn` and `optimizer.lr`)."""
    kw = dict(learning_rate=0.01, lamb_weight_decay=0.0, parameters=params)
    if case in ("wd", "exclude", "groups"):
        kw["lamb_weight_decay"] = 0.01
    if case == "exclude":
        kw["exclude_from_weight_decay_fn"] = lambda p: len(p.shape) == 1
    if case == "groups":
        kw["parameters"] = [
            {"params": params[:2], "learning_rate": 0.5},
            {"params": params[2:4], "weight_decay": 0.05},
            {"params": params[4:]}]
    if case == "scheduler":
        kw["learning_rate"] = schedule(mod["lr"])
    if case in CLIPS:
        name, value = CLIPS[case]
        kw["grad_clip"] = getattr(mod["nn"], name)(value)
    return kw


def run_jax(case, dtype):
    params, grads = arrays()
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ps = [paddle.core.Parameter(jnp.asarray(a, dt)) for a in params]
    opt = paddle.optimizer.Lamb(**options(
        case, {"nn": paddle.nn, "lr": jlr}, ps))
    out = []
    for step in grads:
        for p, g in zip(ps, step):
            p.grad = paddle.to_tensor(jnp.asarray(g, dt))
        opt.step()
        opt.clear_grad()
        if case == "scheduler":
            opt._learning_rate.step()
        out.append([(np.asarray(p._data.astype(jnp.float32)),
                     np.asarray(opt._accumulators[id(p)]["moment1"]),
                     np.asarray(opt._accumulators[id(p)]["moment2"]))
                    for p in ps])
    return out


def port_params(dtype):
    params, grads = arrays()
    dt = getattr(torch, dtype)
    return [torch.nn.Parameter(torch.tensor(a).to(dt)) for a in params], \
        grads


def run_port(case, dtype, ps=None, opt=None, steps=None):
    if ps is None:
        ps, steps = port_params(dtype)
        opt = Lamb(**options(case, {"nn": tnn, "lr": tlr}, ps))
    out = []
    for step in steps:
        for p, g in zip(ps, step):
            p.grad = torch.tensor(g).to(p.dtype)
        opt.step()
        opt.clear_grad()
        if case == "scheduler":
            opt._learning_rate.step()
        out.append([(p.detach().float().numpy().copy(),
                     opt._accumulators[p]["moment1"].numpy().copy(),
                     opt._accumulators[p]["moment2"].numpy().copy())
                    for p in ps])
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_lamb_matches_jax(case, dtype):
    for step, (got, want) in enumerate(zip(run_port(case, dtype),
                                           run_jax(case, dtype))):
        for i, (a, e) in enumerate(zip(got, want)):
            for what, x, y in zip(("param", "moment1", "moment2"), a, e):
                np.testing.assert_allclose(
                    x, y, **(TOL["float32"] if what != "param" else
                             TOL[dtype]),
                    err_msg=f"{case} {dtype} step {step} parameter {i} "
                            f"{what}")


def test_lamb_moves_every_parameter():
    """Every parameter changes in 3 steps, the zero one too (its trust
    ratio is 1), and O2's stay bf16."""
    ps, steps = port_params("bfloat16")
    before = [p.detach().clone() for p in ps]
    run_port("wd", "bfloat16", ps, Lamb(0.01, parameters=ps), steps)
    for p, b in zip(ps, before):
        assert p.dtype == torch.bfloat16
        assert not torch.equal(p.detach(), b)


def test_schedulers_match_jax():
    """LinearWarmup(PolynomialDecay), BERT's LAMB schedule, over 20
    steps (past the warm-up and the decay), and PolynomialDecay with
    `cycle`: the same floats (plain Python on both sides)."""
    pairs = [(schedule(tlr), schedule(jlr)),
             (tlr.PolynomialDecay(0.1, 4, 0.01, power=2.0, cycle=True),
              jlr.PolynomialDecay(0.1, 4, 0.01, power=2.0, cycle=True))]
    for t, j in pairs:
        got, want = [], []
        for _ in range(20):
            got.append(t.get_lr())
            want.append(j.get_lr())
            t.step()
            j.step()
        assert got == want


def test_scheduler_state_dict_round_trip():
    a = schedule(tlr)
    for _ in range(5):
        a.step()
    b = schedule(tlr)
    b.set_state_dict(a.state_dict())
    for _ in range(8):
        assert a.get_lr() == b.get_lr()
        a.step()
        b.step()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lamb_state_dict_round_trip(dtype):
    """2 steps, state_dict into a fresh optimizer over copies of the
    parameters, then one more step on both: the same bits."""
    ps, steps = port_params(dtype)
    opt = Lamb(**options("scheduler", {"nn": tnn, "lr": tlr}, ps))
    run_port("scheduler", dtype, ps, opt, steps[:2])
    state = opt.state_dict()
    assert state["step_count"] == 2 and "LR_Scheduler" in state
    assert sorted(k for k in state if k.endswith("_moment1")) == sorted(
        f"{i}_moment1" for i in range(len(ps)))
    copies = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    fresh = Lamb(**options("scheduler", {"nn": tnn, "lr": tlr}, copies))
    fresh.set_state_dict(state)
    assert fresh.get_lr() == opt.get_lr()
    a = run_port("scheduler", dtype, ps, opt, steps[2:])
    b = run_port("scheduler", dtype, copies, fresh, steps[2:])
    for x, y in zip(a[0], b[0]):
        for u, v in zip(x, y):
            assert np.array_equal(u, v)


def test_set_lr_and_refusals():
    ps, _ = port_params("float32")
    opt = Lamb(0.01, parameters=ps)
    opt.set_lr(0.5)
    assert opt.get_lr() == 0.5
    with pytest.raises(RuntimeError):
        Lamb(schedule(tlr), parameters=ps).set_lr(0.1)
    with pytest.raises(ValueError):
        Lamb(0.01).step()                      # no parameter list
    for p in ps:
        p.grad = torch.ones_like(p)
    opt.clear_grad()
    assert all(p.grad is None for p in ps)
