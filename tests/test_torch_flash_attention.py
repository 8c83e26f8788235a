"""CPU parity of the port's flash attention
(`paddle_tpu_torch.ops.flash_attention.splash_mha`, its plain path)
against the JAX package's `splash_mha` with jax's splash kernel
running in Pallas interpret mode — the same numpy inputs on both
sides, forward and the q/k/v gradients."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa


@pytest.fixture
def _interpret_splash():
    """The real splash kernel in interpret mode, as
    tests/test_flash_attention.py runs it."""
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = old


def _inputs(S, D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, 2, S, D).astype(np.float32) for _ in range(4)]


def _jax(q, k, v, g, causal, dtype):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    gj = jnp.asarray(g, dtype)
    out, vjp = jax.vjp(lambda q, k, v: jfa.splash_mha(q, k, v,
                                                       causal=causal), *args)
    return [np.asarray(a, np.float32) for a in (out, *vjp(gj))]


def _torch(fn, q, k, v, g, causal, dtype):
    args = [torch.tensor(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = fn(*args, causal)
    grads = torch.autograd.grad(out, args, torch.tensor(g).to(dtype))
    return [a.detach().float().numpy() for a in (out, *grads)]


def _port(q, k, v, causal):
    return tfa.splash_mha(q, k, v, causal=causal)


NAMES = ("out", "dq", "dk", "dv")

# fp32: both sides keep fp32 logits and softmax and differ only in the
# order of sums -> 2e-5 on O(1) values (observed 1.2e-6). bf16: both
# multiply bf16 operands in fp32, round p and ds to bf16 before the
# products they feed and round the outputs to bf16 (8 significant
# bits): one bf16 spacing of values up to ~4, 2^-6 (observed 1.56e-2).
CASES = [(S, D, causal, "float32", 2e-5) for S in (128, 256)
         for D in (64, 128) for causal in (True, False)] + \
        [(256, D, causal, "bfloat16", 2e-2) for D in (64, 128)
         for causal in (True, False)]


@pytest.mark.parametrize("S,D,causal,dtype,tol", CASES)
def test_splash_mha_matches_jax_splash(_interpret_splash, S, D, causal,
                                       dtype, tol):
    assert jfa.splash_supported(S, D)        # the interpret kernel runs
    q, k, v, g = _inputs(S, D, seed=S + D + causal)
    want = _jax(q, k, v, g, causal, getattr(jnp, dtype))
    got = _torch(_port, q, k, v, g, causal, getattr(torch, dtype))
    for name, a, e in zip(NAMES, got, want):
        np.testing.assert_allclose(a, e, rtol=tol, atol=tol, err_msg=name)


# The plain forward/backward pair (the kernels' plain versions, lse and
# delta included) against the whole function differentiated by
# autograd, at a ragged S and a small one; fp32 -> 1e-5.
@pytest.mark.parametrize("S,D,causal", [(200, 64, True), (200, 128, False),
                                        (1, 64, True), (65, 64, True)])
def test_plain_pair_matches_autograd_reference(S, D, causal):
    q, k, v, g = _inputs(S, D, seed=7)
    got = _torch(_port, q, k, v, g, causal, torch.float32)
    want = _torch(lambda q, k, v, c: tfa.attention_reference(
        q, k, v, 1.0 / math.sqrt(D), c), q, k, v, g, causal, torch.float32)
    for name, a, e in zip(NAMES, got, want):
        np.testing.assert_allclose(a, e, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_splash_mha_refuses_what_is_not_ported():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(NotImplementedError):
        tfa.splash_mha(q, q, q, kv_keep=torch.ones(1, 8))
    with pytest.raises(ValueError):
        tfa.splash_mha(q, q[:, :, :4], q)


@pytest.mark.parametrize("tagged", [True, False])
def test_residual_policy_keeps_only_tagged_forwards(monkeypatch, tagged):
    """A checkpoint under `save_only_these_names(SPLASH_RESIDUAL_NAME)`
    keeps the (out, lse) of a forward `splash_mha` tagged, so the
    forward runs once for forward + backward; an untagged forward is
    recomputed, as JAX recomputes an unnamed residual. The gradients
    equal the plain checkpoint's either way."""
    import functools
    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts)
    calls = []
    fwd = tfa.flash_fwd_reference
    monkeypatch.setattr(tfa, "flash_fwd_reference",
                        lambda *a: calls.append(1) or fwd(*a))
    q, k, v, g = _inputs(128, 64, seed=3)

    def run(context_fn=None):
        args = [torch.tensor(a).requires_grad_() for a in (q, k, v)]
        kw = {} if context_fn is None else {"context_fn": context_fn}
        out = checkpoint(lambda *t: tfa.splash_mha(
            *(x * 1.5 for x in t), save_residuals_for_remat=tagged),
            *args, use_reentrant=False, **kw)
        return torch.autograd.grad(out, args, torch.tensor(g))
    policy = tfa.save_only_these_names(tfa.SPLASH_RESIDUAL_NAME)
    got = run(functools.partial(create_selective_checkpoint_contexts,
                                policy))
    assert len(calls) == (1 if tagged else 2)
    calls.clear()
    want = run()
    assert len(calls) == 2
    for a, e in zip(got, want):
        assert torch.equal(a, e)
