"""CPU parity of the port's fused QKV projection
(`paddle_tpu_torch.ops.qkv_proj`, its plain path) against the JAX
package's Pallas `qkv_proj` running in interpret mode — the same numpy
inputs on both sides, forward and the custom-VJP gradients — and of the
shape gate `qkv_proj_supported`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.pallas.flash_attention as jfa
import paddle_tpu.ops.pallas.qkv_proj as jqp
from paddle_tpu_torch.ops import qkv_proj as tqp


@pytest.fixture
def _interpret():
    """JAX's kernel in interpret mode, as tests/test_qkv_proj.py runs
    it."""
    old = jqp._INTERPRET
    jqp._INTERPRET = True
    yield
    jqp._INTERPRET = old


def _inputs(B, S, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, d).astype(np.float32),
            (rng.randn(d, 3 * d) * 0.05).astype(np.float32),
            (rng.randn(3 * d) * 0.05).astype(np.float32))


SHAPES = [(2, 64, 256, 4), (1, 32, 128, 2), (3, 16, 512, 8)]


def _within_one_bf16_spacing(a, e):
    """|a - e| at most one bf16 spacing at the larger of |a|, |e|
    (2^(k - 7) for magnitudes in [2^k, 2^(k+1)))."""
    m = np.maximum(np.maximum(np.abs(a), np.abs(e)), 2.0 ** -126)
    return bool(np.all(np.abs(a - e) <= 2.0 ** (np.floor(np.log2(m)) - 7)))


# fp32: both sides sum d products in fp32, in another order, and add the
# bias once -> atol 1e-4 (the JAX test's tolerance; observed ~1e-6).
@pytest.mark.parametrize("B,S,d,H", SHAPES)
def test_forward_matches_jax_fp32(_interpret, B, S, d, H):
    x, w, b = _inputs(B, S, d, seed=B + S + d)
    want = jqp.qkv_proj(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), H)
    got = tqp.qkv_proj(torch.tensor(x), torch.tensor(w), torch.tensor(b), H)
    for name, a, e in zip("qkv", got, want):
        assert a.shape == (B, H, S, d // H)
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=0,
                                   atol=1e-4, err_msg=name)


# bf16: both sides multiply the same bf16 operands in fp32, add the
# fp32 bias and round ONCE to bf16; fp32 sums in another order can land
# on either side of a rounding boundary -> at most one bf16 spacing.
@pytest.mark.parametrize("B,S,d,H", SHAPES)
def test_forward_matches_jax_bf16_within_one_ulp(_interpret, B, S, d, H):
    x, w, b = _inputs(B, S, d, seed=7 + d)
    want = jqp.qkv_proj(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)),
                        H)
    got = tqp.qkv_proj(*(torch.tensor(a).to(torch.bfloat16)
                         for a in (x, w, b)), H)
    for name, a, e in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16
        assert _within_one_bf16_spacing(a.float().numpy(),
                                        np.asarray(e, np.float32)), name


# grads: the JAX custom VJP (XLA einsums) against the port's backward,
# both fp32 products over the same operands -> atol 2e-4 (the JAX
# test's; observed ~1e-5 on sums of 64-256 terms).
@pytest.mark.parametrize("B,S,d,H", SHAPES)
def test_grads_match_jax_custom_vjp(_interpret, B, S, d, H):
    x, w, b = _inputs(B, S, d, seed=11 + S)

    def jloss(x, w, b):
        q, k, v = jqp.qkv_proj(x, w, b, H)
        return jnp.sum(jnp.sin(q) + 2.0 * jnp.cos(k) + v ** 2)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    args = [torch.tensor(a).requires_grad_() for a in (x, w, b)]
    q, k, v = tqp.qkv_proj(*args, H)
    loss = (torch.sin(q) + 2.0 * torch.cos(k) + v ** 2).sum()
    got = torch.autograd.grad(loss, args)
    for name, a, e in zip("xwb", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=0,
                                   atol=2e-4, err_msg=f"d{name}")


# the JAX gate test's cases (tests/test_qkv_proj.py) and a few more;
# JAX's gate also asks for a TPU backend, which its flash module's
# interpret flag stands in for here
GATE_CASES = [(16, 1024, 16 * 64, 1024), (3, 128, 3 * 64, None),
              (4, 128, 4 * 128, None), (4, 130, 4 * 64, None),
              (16, 4096, 16 * 64, 4096), (2, 128, 2 * 64, None),
              (0, 128, 64, None), (4, 2048, 4 * 64, 1024)]


@pytest.mark.parametrize("H,S,width,x_width", GATE_CASES)
def test_supported_gate_matches_jax(H, S, width, x_width):
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    try:
        want = jqp.qkv_proj_supported(H, S, width, x_width)
    finally:
        jfa._INTERPRET = old
    assert tqp.qkv_proj_supported(H, S, width, x_width) == want


def test_plain_version_rounds_once():
    """The plain version keeps product + bias in fp32 and rounds once,
    unlike the einsum branch (product rounded, then the sum)."""
    x, w, b = (torch.tensor(a).to(torch.bfloat16)
               for a in _inputs(2, 16, 128, seed=5))
    q, _, _ = tqp.qkv_proj_reference(x, w, b, 2)
    once = (x.float() @ w[:, :128].float() + b[:128].float()).to(
        torch.bfloat16)
    assert torch.equal(q, once.reshape(2, 16, 2, 64).transpose(1, 2))


def test_bf16_grads_round_once():
    """In bf16 the backward keeps fp32 sums and rounds dx and dw once,
    as JAX's fp32-accumulating einsums and single cast do: within one
    bf16 spacing of the exact (float64) products of the same bf16
    operands, rounded once. (Autograd through the plain forward would
    round each third's dx to bf16 before adding the three.)"""
    x, w, b = (torch.tensor(a).to(torch.bfloat16)
               for a in _inputs(2, 32, 256, seed=9))
    gs = [torch.tensor(a).to(torch.bfloat16).reshape(2, 4, 32, 64)
          for a in np.random.RandomState(10).randn(3, 2 * 4 * 32 * 64)
          .astype(np.float32)]
    args = [t.clone().requires_grad_() for t in (x, w, b)]
    got = torch.autograd.grad(tqp.qkv_proj(*args, 4), args, gs)
    g = torch.cat(gs, 1).permute(0, 2, 1, 3).reshape(64, 768).double()
    exact = ((g @ w.double().t()).reshape(2, 32, 256),
             x.reshape(64, 256).double().t() @ g, g.sum(0))
    for name, a, e in zip("xwb", got, exact):
        assert a.dtype == torch.bfloat16
        assert _within_one_bf16_spacing(
            a.float().numpy(), e.to(torch.bfloat16).float().numpy()), \
            f"d{name}"


# ------------------------------ the wgmma kernel's plan (no card)


def test_plan_at_the_train_step():
    """x [8, 1024, 1024] @ w_qkv [1024, 3072]: 64 row tiles of 128 x 12
    column tiles of 256, walked by a block on each of the H100's 132
    SMs."""
    p = tqp.plan(8, 1024, 16)
    assert (p["row_tiles"], p["col_tiles"], p["tiles"]) == (64, 12, 768)
    assert p["grid"] == 132


@pytest.mark.parametrize("B,S,H,rows,cols", [
    (1, 1, 2, 1, 2),          # one row; 384 columns: two tiles, the
                              # second half empty
    (3, 33, 6, 1, 5),         # 99 rows in one tile; 1152 columns
    (2, 200, 2, 4, 2),        # 400 rows: the last tile 16 rows
    (5, 1, 16, 1, 12),
    (4, 1024, 32, 32, 24),
])
def test_plan_at_edge_shapes(B, S, H, rows, cols):
    """Tiles cover B * S rows and 3 H 64 columns (a tile may straddle the
    q / k / v thirds: at H = 2 a third is 128 columns); never more
    blocks than tiles."""
    p = tqp.plan(B, S, H)
    assert (p["row_tiles"], p["col_tiles"]) == (rows, cols)
    assert p["tiles"] == rows * cols
    assert p["grid"] == min(rows * cols, tqp.H100_SMS)
    assert rows * tqp.TILE_M >= B * S > (rows - 1) * tqp.TILE_M
    assert cols * tqp.TILE_N >= 3 * H * 64 > (cols - 1) * tqp.TILE_N


def test_plan_follows_the_sm_count():
    """The grid is one block for each SM of the card the wrapper names,
    never more than there are tiles."""
    for sms in (132, 114, 66, 8):
        assert tqp.plan(8, 1024, 16, sms=sms)["grid"] == sms
    assert tqp.plan(1, 1, 2, sms=132)["grid"] == 2
