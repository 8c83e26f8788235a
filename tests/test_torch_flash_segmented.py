"""CPU parity of the port's segmented flash attention
(`paddle_tpu_torch.ops.flash_attention.splash_mha(kv_keep=)`, K1c's
plain path) against the JAX package's `splash_mha(kv_keep=)` with jax's
segmented splash kernel running in Pallas interpret mode: the same numpy
inputs and segment ids on both sides, forward on every row and the
q/k/v gradients."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa

B, H, S = 2, 2, 128
PATTERNS = ("trailing", "left", "interleaved", "none", "packed")


@pytest.fixture
def _interpret_splash():
    """The real splash kernel in interpret mode, as
    tests/test_flash_attention.py runs it."""
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = old


def segments(pattern, rng):
    """[B, S] int32 segment ids: a key-padding mask (1 real, 0 padding)
    with the padding after the tokens, before them, or strewn among
    them, no padding, or a packed batch of segments 0-3."""
    if pattern == "packed":
        return np.sort(rng.randint(0, 4, (B, S)), axis=1).astype(np.int32)
    if pattern == "interleaved":
        keep = rng.rand(B, S) < 0.6
    elif pattern == "none":
        keep = np.ones((B, S), bool)
    else:
        lens = rng.randint(1, S, B)
        keep = np.arange(S)[None] < lens[:, None]
        if pattern == "left":
            keep = keep[:, ::-1]
    return keep.astype(np.int32)


def _inputs(D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, S, D).astype(np.float32) for _ in range(4)]


def _jax(q, k, v, g, seg, causal):
    out, vjp = jax.vjp(lambda q, k, v: jfa.splash_mha(
        q, k, v, causal=causal, kv_keep=jnp.asarray(seg)),
        *map(jnp.asarray, (q, k, v)))
    return [np.asarray(a) for a in (out, *vjp(jnp.asarray(g)))]


def _torch(q, k, v, g, seg, causal):
    args = [torch.tensor(a).requires_grad_() for a in (q, k, v)]
    out = tfa.splash_mha(*args, causal=causal, kv_keep=torch.tensor(seg))
    grads = torch.autograd.grad(out, args, torch.tensor(g))
    return [a.detach().numpy() for a in (out, *grads)]


# fp32 on both sides: fp32 logits and softmax, the same segment mask,
# sums in another order -> 1e-5 on O(1) values (observed ~1e-6). Every
# row is compared, padded ones too: both give a padded query the
# softmax over the padded keys.
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [64, 128])
def test_segmented_matches_jax_splash(_interpret_splash, D, causal,
                                      pattern):
    assert jfa.splash_supported(S, D)        # the interpret kernel runs
    seed = D + causal + 10 * PATTERNS.index(pattern)
    q, k, v, g = _inputs(D, seed)
    seg = segments(pattern, np.random.RandomState(seed))
    want = _jax(q, k, v, g, seg, causal)
    got = _torch(q, k, v, g, seg, causal)
    assert np.isfinite(got[0]).all()
    for name, a, e in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, e, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


# The segmented backward against jax.grad through the interpret kernel
# with the cotangent on the real rows only (padded rows' outputs are
# never read back, as in tests/test_flash_attention.py): fp32, 1e-5.
@pytest.mark.parametrize("pattern", ["trailing", "left", "interleaved"])
def test_segmented_backward_over_real_rows(_interpret_splash, pattern):
    q, k, v, g = _inputs(64, seed=5)
    seg = segments(pattern, np.random.RandomState(5))
    g = g * seg[:, None, :, None]
    want = _jax(q, k, v, g, seg, False)
    got = _torch(q, k, v, g, seg, False)
    for name, a, e in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a, e, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_kv_keep_none_is_unchanged(_interpret_splash, monkeypatch):
    """Without kv_keep the unsegmented forward runs, and one segment
    for every position gives the same numbers bit for bit."""
    q, k, v, _ = (torch.tensor(a) for a in _inputs(64, seed=2))
    calls = []
    monkeypatch.setattr(tfa, "flash_fwd_reference",
                        functools.partial(lambda f, *a: calls.append(
                            len(a)) or f(*a), tfa.flash_fwd_reference))
    out = tfa.splash_mha(q, k, v, causal=False)
    one = tfa.splash_mha(q, k, v, causal=False,
                         kv_keep=torch.ones(B, S, dtype=torch.int32))
    assert calls == [4, 5]                   # (q, k, v, causal[, seg])
    assert torch.equal(out, one)
    want = jfa.splash_mha(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                          causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_kv_keep_of_another_shape_is_refused():
    q = torch.zeros(B, H, S, 64)
    with pytest.raises(ValueError):
        tfa.splash_mha(q, q, q, kv_keep=torch.ones(B, S - 1))


def test_residual_policy_keeps_tagged_segmented_forward(monkeypatch):
    """`save_residuals_for_remat=True` with kv_keep tags the segmented
    forward as it tags the plain one: under
    `save_only_these_names(SPLASH_RESIDUAL_NAME)` it runs once for
    forward + backward, with the plain checkpoint's gradients."""
    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts)
    calls = []
    fwd = tfa.flash_fwd_reference
    monkeypatch.setattr(tfa, "flash_fwd_reference",
                        lambda *a: calls.append(1) or fwd(*a))
    q, k, v, g = _inputs(64, seed=3)
    seg = torch.tensor(segments("trailing", np.random.RandomState(3)))

    def run(context_fn=None):
        args = [torch.tensor(a).requires_grad_() for a in (q, k, v)]
        kw = {} if context_fn is None else {"context_fn": context_fn}
        out = checkpoint(lambda *t: tfa.splash_mha(
            *(x * 1.5 for x in t), kv_keep=seg,
            save_residuals_for_remat=True), *args, use_reentrant=False,
            **kw)
        return torch.autograd.grad(out, args, torch.tensor(g))
    policy = tfa.save_only_these_names(tfa.SPLASH_RESIDUAL_NAME)
    got = run(functools.partial(create_selective_checkpoint_contexts,
                                policy))
    assert len(calls) == 1
    calls.clear()
    want = run()
    assert len(calls) == 2
    for a, e in zip(got, want):
        assert torch.equal(a, e)
