"""CPU parity of the port's paddle-layout flash attention
(`paddle_tpu_torch.ops.flash_attention.flash_attention`, K1b's entry,
its plain path) against the JAX package's `flash_attention` with its
hand-written forward kernel in Pallas interpret mode and explicit
blocks — the same numpy inputs on both sides, output and the q/k/v
gradients — and of the shapes both refuse."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa


@pytest.fixture
def _interpret():
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = old


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


def _jax(q, k, v, g, causal, dtype, **kw):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    out, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
        q, k, v, causal=causal, **kw), *args)
    return [np.asarray(a, np.float32)
            for a in (out, *vjp(jnp.asarray(g, dtype)))]


def _port(q, k, v, g, causal, dtype, **kw):
    args = [torch.tensor(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*args, causal=causal, **kw)
    grads = torch.autograd.grad(out, args, torch.tensor(g).to(dtype))
    return [a.detach().float().numpy() for a in (out, *grads)]


NAMES = ("out", "dq", "dk", "dv")

# fp32: the forward keeps fp32 scores and softmax on both sides and sums
# in another order (the TPU kernel over 128-key blocks, the plain
# version over whole rows); the backward is the same fp32 recompute on
# both sides -> 2e-5 (observed ~1e-6). bf16: both scale q and round it
# to bf16 (JAX rounds the scale to bf16 first: 1/sqrt(128) moves by
# 1e-4 relative), round p to bf16 before p @ v and round the output to
# bf16; the grads are an fp32 recompute rounded once -> a bf16 spacing
# or two of values up to ~4, 2e-2.
CASES = [(shape, causal, dtype, tol)
         for shape in ((2, 256, 2, 128), (1, 256, 2, 256))
         for causal in (True, False)
         for dtype, tol in (("float32", 2e-5), ("bfloat16", 2e-2))]


@pytest.mark.parametrize("shape,causal,dtype,tol", CASES)
def test_flash_attention_matches_jax(_interpret, shape, causal, dtype, tol):
    q, k, v, g = _inputs(shape, seed=sum(shape) + causal)
    blocks = dict(block_q=128, block_k=128)
    want = _jax(q, k, v, g, causal, getattr(jnp, dtype), **blocks)
    got = _port(q, k, v, g, causal, getattr(torch, dtype), **blocks)
    for name, a, e in zip(NAMES, got, want):
        np.testing.assert_allclose(a, e, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("kw,shape", [
    (dict(bias=np.zeros((1, 1, 64, 64), np.float32)), (1, 64, 2, 128)),
    (dict(block_q=64), (1, 96, 2, 128)),
    (dict(block_k=64), (1, 96, 2, 128)),
    (dict(), (1, 64, 2, 64)),
    (dict(), (1, 64, 2, 192))])
def test_refuses_what_jax_refuses(_interpret, kw, shape):
    q = np.zeros(shape, np.float32)
    with pytest.raises(NotImplementedError):
        jfa.flash_attention(*(jnp.asarray(q),) * 3, **{
            k: jnp.asarray(v) if k == "bias" else v for k, v in kw.items()})
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(*(torch.tensor(q),) * 3, **{
            k: torch.tensor(v) if k == "bias" else v for k, v in kw.items()})


# The plain forward against the whole function in fp32 (the default
# blocks cover any S up to 256): the same softmax written two ways ->
# 1e-5.
@pytest.mark.parametrize("S,D,causal", [(200, 128, True), (1, 128, True),
                                        (64, 256, False), (130, 256, True)])
def test_plain_forward_matches_reference(S, D, causal):
    q, k, v, _ = (torch.tensor(a) for a in _inputs((2, S, 3, D), seed=S))
    scale = 1.0 / math.sqrt(D)
    got = tfa.flash_fwd_bshd_reference(q, k, v, scale, causal)
    want = tfa.attention_bshd_reference(q, k, v, scale, causal)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tfa.flash_attention(q, k, v, causal=causal),
                               got, rtol=0, atol=0)
