"""CPU parity of the port's fused residual-add + LayerNorm
(`paddle_tpu_torch.ops.layer_norm.add_ln`, its plain path) against the
JAX package's `add_ln` with its Pallas forward and backward kernels
running in interpret mode — the same numpy inputs on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.pallas.layer_norm as jln
from paddle_tpu_torch.ops import layer_norm as tln


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    d = shape[-1]
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32),
            rng.rand(d).astype(np.float32),
            rng.randn(d).astype(np.float32))


def _weighted(out, z):
    # the JAX kernel test's loss: both outputs carry a gradient, so the
    # residual cotangent g_z is non-zero
    return (out * 1.3).sum() + (z * 0.7).sum()


def _jax_add_ln(x, r, w, b, dtype):
    xj, rj = jnp.asarray(x, dtype), jnp.asarray(r, dtype)
    wj, bj = jnp.asarray(w), jnp.asarray(b)
    out, z = jln.add_ln(xj, rj, wj, bj)

    def loss(x, r, w, b):
        o, zz = jln.add_ln(x, r, w, b)
        return _weighted(o.astype(jnp.float32), zz.astype(jnp.float32))
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(xj, rj, wj, bj)
    return [np.asarray(a, np.float32) for a in (out, z, *grads)]


def _torch_add_ln(fn, x, r, w, b, dtype):
    xt = torch.tensor(x).to(dtype).requires_grad_()
    rt = torch.tensor(r).to(dtype).requires_grad_()
    wt = torch.tensor(w).requires_grad_()
    bt = torch.tensor(b).requires_grad_()
    out, z = fn(xt, rt, wt, bt)
    grads = torch.autograd.grad(_weighted(out.float(), z.float()),
                                (xt, rt, wt, bt))
    return [a.detach().float().numpy() for a in (out, z, *grads)]


NAMES = ("out", "z", "dx", "dr", "dw", "db")


# fp32: both sides sum in fp32, in another order -> 1e-4, relative on
# the row-summed dw/db (observed 2.4e-4 on db ~ 666). bf16: both round
# out, z and dz to bf16 (8 significant bits) from fp32 math; the JAX
# kernel path adds g_z to the ROUNDED dz in bf16 while the port adds it
# in fp32 and rounds once, so out and dx/dr may differ by one bf16
# spacing, 2^-7 relative: 1e-2 + 1e-2 |x| covers it at every magnitude
# (observed 7.8e-3).
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 1e-2)])
def test_add_ln_matches_jax_pallas_kernels(monkeypatch, dtype, tol):
    monkeypatch.setattr(jln, "_INTERPRET", True)
    x, r, w, b = _inputs((2, 256, 128), seed=0)   # 512 rows: tiles by 256
    want = _jax_add_ln(x, r, w, b, getattr(jnp, dtype))
    got = _torch_add_ln(tln.add_ln, x, r, w, b, getattr(torch, dtype))
    for name, g, e in zip(NAMES, got, want):
        np.testing.assert_allclose(g, e, rtol=tol, atol=tol, err_msg=name)


def test_add_ln_z_is_stored_in_the_input_dtype():
    x, r, w, b = _inputs((4, 64), seed=1)
    xt, rt = torch.tensor(x).bfloat16(), torch.tensor(r).bfloat16()
    out, z = tln.add_ln(xt, rt, torch.tensor(w), torch.tensor(b))
    assert out.dtype == z.dtype == torch.bfloat16
    assert torch.equal(z, (xt.float() + rt.float()).bfloat16())


# fp32 only: any rows and any d (no tiling gate), against the whole
# function differentiated by autograd; both sum in fp32 -> 1e-5.
@pytest.mark.parametrize("shape", [(7, 100), (3, 5, 33), (1, 4096)])
def test_add_ln_any_shape_matches_autograd_reference(shape):
    x, r, w, b = _inputs(shape, seed=2)
    got = _torch_add_ln(tln.add_ln, x, r, w, b, torch.float32)
    want = _torch_add_ln(tln.add_ln_reference, x, r, w, b, torch.float32)
    for name, g, e in zip(NAMES, got, want):
        np.testing.assert_allclose(g, e, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_add_ln_cpu_path_launches_no_kernel():
    x, r, w, b = _inputs((8, 64), seed=3)
    before = (tln.fwd_launch_count, tln.bwd_launch_count)
    _torch_add_ln(tln.add_ln, x, r, w, b, torch.float32)
    assert (tln.fwd_launch_count, tln.bwd_launch_count) == before


# The backward's plain version returns dw and db itself (the kernel sums
# them as it walks the rows): held against the whole function
# differentiated by autograd, fp32 on both sides, summed in another
# order -> 1e-5.
@pytest.mark.parametrize("shape", [(7, 100), (3, 5, 33), (1, 4096)])
def test_add_ln_bwd_reference_dw_db_match_autograd(shape):
    x, r, w, b = _inputs(shape, seed=4)
    d = shape[-1]
    xt, rt, wt, bt = map(torch.tensor, (x, r, w, b))
    g = torch.tensor(np.random.RandomState(5).randn(*shape)
                     .astype(np.float32))
    gz = torch.tensor(np.random.RandomState(6).randn(*shape)
                      .astype(np.float32))
    _, z, mu, rs = tln.add_ln_fwd_reference(xt.reshape(-1, d),
                                            rt.reshape(-1, d), wt, bt, 1e-5)
    dz, dw, db = tln.add_ln_bwd_reference(z, wt, mu, rs, g.reshape(-1, d),
                                          gz.reshape(-1, d))
    args = [t.clone().requires_grad_() for t in (xt, rt, wt, bt)]
    want = torch.autograd.grad(tln.add_ln_reference(*args), args, (g, gz))
    assert dw.dtype == db.dtype == torch.float32
    for name, got, ref in (("dz", dz.view(shape), want[0]), ("dw", dw, want[2]),
                           ("db", db, want[3])):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
