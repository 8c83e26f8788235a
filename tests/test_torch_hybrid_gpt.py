"""CPU parity of the port's single-device train step
(`paddle_tpu_torch.parallel.hybrid_gpt.HybridGPT`) against the JAX
package's `HybridGPT` on one CPU device: the JAX trainer's initial
parameters are carried across with `convert.load_jax_hybrid_gpt`, then
both sides take the same steps on the same numpy tokens and labels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.parallel import hybrid_gpt as jh
from paddle_tpu_torch.convert import load_jax_hybrid_gpt
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import layer_norm as tln
from paddle_tpu_torch.ops import qkv_proj as tqp
from paddle_tpu_torch.parallel import hybrid_gpt as th

# vocab 256, seq 128, d_model 128, 2 heads of 64, 2 layers, batch 2:
# B*S = 256 rows and d = 128 also tile the JAX add_ln kernel
WIDTHS = dict(vocab_size=256, seq_len=128, d_model=128, n_heads=2,
              n_layers=2, zero_stage=0, learning_rate=1e-3)
BATCH = 2


def _pair(bf16=False, **kw):
    jcfg = jh.GPTConfig(**WIDTHS, **kw, bf16_grads=bf16,
                        compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tcfg = th.GPTConfig(**WIDTHS, **kw, bf16_grads=bf16,
                        compute_dtype=torch.bfloat16 if bf16
                        else torch.float32)
    jt = jh.HybridGPT(jcfg, devices=jax.devices()[:1])
    jp, jo = jt.init(jax.random.PRNGKey(0))
    # copy out BEFORE the first JAX step: train_step donates its inputs
    tp, to = load_jax_hybrid_gpt(jax.device_get(jp), jax.device_get(jo),
                                 device="cpu")
    tt = th.HybridGPT(tcfg, device="cpu")
    return jt, jp, jo, tt, tp, to


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    shape = (BATCH, WIDTHS["seq_len"])
    return (rng.randint(0, WIDTHS["vocab_size"], shape).astype(np.int32),
            rng.randint(0, WIDTHS["vocab_size"], shape).astype(np.int32))


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + k + ".")
        else:
            yield prefix + k, tree[k]


# fp32 losses: the same arithmetic in another summation order ->
# rtol 1e-4 (observed ~2e-7). After step 1, Adam's first moment is 0.1
# x the clipped gradient: each tensor within 1e-4 of its largest |m|
# (fp32 sums in another order leave ~1e-6 of it). Parameters after
# step 1: Adam's first step moves every element by lr * g / (|g| +
# eps), about +-lr whatever |g|, so where |g| is within a few eps of 0
# a different summation order changes the step by a sizeable part of
# lr: atol 5e-2 * lr (observed 1.5e-2 * lr), while a wrong sign would
# be 2 * lr.
#
# "splash-residuals" is bench_gpt's remat policy (JAX's CPU attention
# has no residuals to keep, so its step is a full remat); "qkv-kernel"
# runs the port's fused projection (its plain version here: one fp32
# rounding of product + bias) against JAX's einsum branch, which JAX
# takes off the TPU.
@pytest.mark.parametrize("kw", [
    dict(remat=False, ce_seq_chunks=1),
    dict(remat=True, ce_seq_chunks=2),
    dict(remat=True, ce_seq_chunks=2, fused_ce=False, fused_add_ln=False),
    dict(remat=True, ce_seq_chunks=2, remat_policy="save_splash_residuals"),
    dict(remat=True, ce_seq_chunks=2, qkv_kernel=True,
         remat_policy="save_splash_residuals"),
], ids=["plain", "remat-chunked", "unfused", "splash-residuals",
        "qkv-kernel"])
def test_train_steps_match_jax(kw):
    jt, jp, jo, tt, tp, to = _pair(**kw)
    tok, lab = _batch()
    atol = 5e-2 * WIDTHS["learning_rate"]
    for step in range(1, 4):
        jp, jo, jl = jt.train_step(jp, jo, *jt.shard_data(tok, lab),
                                   step_num=step)
        tp, to, tl = tt.train_step(tp, to, tok, lab, step_num=step)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4,
                                   err_msg=f"loss at step {step}")
        if step == 1:
            want = dict(_flat(jax.device_get(jp)))
            for name, p in _flat(tp):
                np.testing.assert_allclose(p.numpy(),
                                           np.asarray(want[name]),
                                           rtol=0, atol=atol, err_msg=name)
            want = dict(_flat(jax.device_get(jo)))
            for name, m in _flat(to):
                if name.endswith(".m"):
                    e = np.asarray(want[name])
                    np.testing.assert_allclose(
                        m.numpy(), e, rtol=0,
                        atol=1e-4 * np.abs(e).max(), err_msg=name)


# bf16 compute with bf16 grads: both sides round activations, logits
# and grads to bf16 at slightly different places (the port's add_ln
# normalises from the fp32 sum, the JAX CPU fallback from the rounded
# one; the port's fused-CE head grad is a bf16 product), so the loss
# follows JAX within rtol 1e-3 (observed 7e-5) over 3 steps.
def test_bf16_grads_loss_follows_jax():
    jt, jp, jo, tt, tp, to = _pair(bf16=True, remat=True, ce_seq_chunks=2)
    tok, lab = _batch(seed=1)
    for step in range(1, 4):
        jp, jo, jl = jt.train_step(jp, jo, *jt.shard_data(tok, lab),
                                   step_num=step)
        tp, to, tl = tt.train_step(tp, to, tok, lab, step_num=step)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3,
                                   err_msg=f"loss at step {step}")


def test_loss_matches_jax():
    jt, jp, _, tt, tp, _ = _pair(remat=True, ce_seq_chunks=2)
    tok, lab = _batch(seed=2)
    np.testing.assert_allclose(float(tt.loss(tp, tok, lab)),
                               float(jt.loss(jp, *jt.shard_data(tok, lab))),
                               rtol=1e-5)


def test_remat_runs_each_forward_twice(monkeypatch):
    """With remat the block forward (flash attention, add_ln) runs again
    in the backward: per step 2 * layers forwards and layers backwards —
    the launch counts chip_smoke.py expects of the kernels. Counted here
    on the plain versions, which the CPU path runs in their place."""
    calls = {}

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapper)
    for mod, name in ((tfa, "flash_fwd_reference"),
                      (tfa, "flash_bwd_reference"),
                      (tln, "add_ln_fwd_reference"),
                      (tln, "add_ln_bwd_reference")):
        counting(mod, name)
    cfg = th.GPTConfig(**WIDTHS, remat=True, compute_dtype=torch.float32)
    tt = th.HybridGPT(cfg, device="cpu")
    params, opt = tt.init(seed=0)
    tok, lab = _batch()
    tt.train_step(params, opt, tok, lab)
    L = WIDTHS["n_layers"]
    assert calls == {"flash_fwd_reference": 2 * L,
                     "flash_bwd_reference": L,
                     "add_ln_fwd_reference": 2 * L,
                     "add_ln_bwd_reference": L}


def _count_calls(monkeypatch, targets):
    """Wrap each (module, function) so its calls are counted by name."""
    calls = {}
    for mod, name in targets:
        fn = getattr(mod, name)

        def wrapper(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapper)
    return calls


def _one_step(monkeypatch, **kw):
    """One fp32 step of the port from seed-0 parameters; returns (calls
    of the plain versions, loss, params, opt)."""
    calls = _count_calls(monkeypatch, (
        (tfa, "flash_fwd_reference"), (tfa, "flash_bwd_reference"),
        (tln, "add_ln_fwd_reference"), (tln, "add_ln_bwd_reference"),
        (tqp, "qkv_proj_reference")))
    cfg = th.GPTConfig(**WIDTHS, remat=True, compute_dtype=torch.float32,
                       **kw)
    tt = th.HybridGPT(cfg, device="cpu")
    params, opt = tt.init(seed=0)
    params, opt, loss = tt.train_step(params, opt, *_batch())
    return dict(calls), loss, params, opt


def test_residual_policy_runs_flash_forward_once(monkeypatch):
    """Under "save_splash_residuals" the blocks still recompute in the
    backward (add_ln's forward runs twice a layer) but the flash
    forward runs once a layer: its (out, lse) are kept. The step equals
    the full-remat step exactly, the kept outputs being the ones the
    recompute would give, tok_emb included (its gradient sums each
    id's rows in a fixed order)."""
    L = WIDTHS["n_layers"]
    calls, loss, params, opt = _one_step(
        monkeypatch, remat_policy="save_splash_residuals")
    assert calls == {"flash_fwd_reference": L, "flash_bwd_reference": L,
                     "add_ln_fwd_reference": 2 * L,
                     "add_ln_bwd_reference": L}
    monkeypatch.undo()
    _, loss_full, params_full, opt_full = _one_step(monkeypatch)
    assert float(loss) == float(loss_full)
    for (name, a), (_, b) in zip(_flat(params), _flat(params_full)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    for (name, a), (_, b) in zip(_flat(opt), _flat(opt_full)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("policy", [None, "save_splash_residuals"])
def test_qkv_kernel_runs_the_fused_projection(monkeypatch, policy):
    """With `qkv_kernel` at hd = 64 every block's projection goes through
    `qkv_proj` (its plain version on the CPU): once in the forward and
    once in the recompute, whatever the policy keeps of attention."""
    L = WIDTHS["n_layers"]
    calls, *_ = _one_step(monkeypatch, qkv_kernel=True, remat_policy=policy)
    assert calls["qkv_proj_reference"] == 2 * L
    assert calls["flash_fwd_reference"] == (L if policy else 2 * L)


def test_qkv_kernel_gate_keeps_the_einsum_branch(monkeypatch):
    """Where JAX's shape gate refuses (head_dim 32 here) the step takes
    the einsum branch, as JAX's does."""
    calls = _count_calls(monkeypatch, ((tqp, "qkv_proj_reference"),))
    cfg = th.GPTConfig(**{**WIDTHS, "n_heads": 4}, qkv_kernel=True,
                       compute_dtype=torch.float32)
    tt = th.HybridGPT(cfg, device="cpu")
    params, opt = tt.init(seed=0)
    tt.train_step(params, opt, *_batch())
    assert calls == {}


@pytest.mark.parametrize("kw", [dict(remat_policy="save_splash_residuals"),
                                dict(qkv_kernel=True), dict(dp=2),
                                dict(moe_experts=4), dict(zero_stage=1)])
def test_config_takes_what_is_ported(kw):
    cfg = th.GPTConfig(**{**WIDTHS, **kw})
    assert all(getattr(cfg, k) == v for k, v in kw.items())


@pytest.mark.parametrize("field,value", [
    ("pp", 2), ("mp", 2), ("micro_batches", 2),
    ("sequence_parallel", True), ("grad_bucket_bytes", 1 << 20),
    ("remat_policy", "dots_saveable")])
def test_config_refuses_what_is_not_ported(field, value):
    with pytest.raises(NotImplementedError, match=field):
        th.GPTConfig(**{**WIDTHS, field: value})


def test_load_jax_hybrid_gpt_checks_names_and_shapes():
    jt = jh.HybridGPT(jh.GPTConfig(**WIDTHS, compute_dtype=jnp.float32),
                      devices=jax.devices()[:1])
    params = jax.device_get(jt.init(jax.random.PRNGKey(1))[0])
    tp = load_jax_hybrid_gpt(params, device="cpu")
    for name, p in _flat(tp):
        assert p.dtype == torch.float32
    bad = dict(params, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="unknown"):
        load_jax_hybrid_gpt(bad, device="cpu")
    bad = dict(params, blocks=dict(params["blocks"]))
    bad["blocks"]["w_o"] = np.zeros((2, 128, 64), np.float32)
    with pytest.raises(ValueError, match="w_o"):
        load_jax_hybrid_gpt(bad, device="cpu")
    bad = {k: v for k, v in params.items() if k != "head"}
    with pytest.raises(ValueError, match="missing"):
        load_jax_hybrid_gpt(bad, device="cpu")
