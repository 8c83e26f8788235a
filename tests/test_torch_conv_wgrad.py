"""CPU parity of the port's split-K 1x1 weight gradient
(`paddle_tpu_torch.ops.conv_wgrad.wgrad_1x1`, its plain path) against
the JAX package's Pallas `wgrad_1x1` in interpret mode, on the same
numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.conv_wgrad import wgrad_1x1 as jwgrad
from paddle_tpu_torch.ops import conv_wgrad as tcw


def _inputs(N, Ci, Co, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, Ci).astype(np.float32),
            rng.randn(N, Co).astype(np.float32))


# fp32 products and fp32 sums on both sides (bf16 products are exact in
# fp32), the chunks added in the same order, the sums inside a chunk in
# another: the JAX test's rtol/atol 1e-4 on values of size ~sqrt(N)
# (observed ~1e-5).
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,Ci,Co,chunk", [(512, 128, 128, 128),
                                           (512, 64, 32, 512),
                                           (384, 8, 16, 32)])
def test_wgrad_matches_jax_interpret(N, Ci, Co, chunk, dtype):
    x, dy = _inputs(N, Ci, Co, seed=N + Ci + Co)
    want = jwgrad(jnp.asarray(x, getattr(jnp, dtype)),
                  jnp.asarray(dy, getattr(jnp, dtype)), chunk=chunk,
                  interpret=True)
    got = tcw.wgrad_1x1(torch.tensor(x).to(getattr(torch, dtype)),
                        torch.tensor(dy).to(getattr(torch, dtype)),
                        chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (Ci, Co)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_wgrad_refuses_a_ragged_chunk_as_jax_does():
    x, dy = _inputs(500, 8, 8, seed=0)
    with pytest.raises(ValueError) as want:
        jwgrad(jnp.asarray(x), jnp.asarray(dy), chunk=128, interpret=True)
    with pytest.raises(ValueError) as got:
        tcw.wgrad_1x1(torch.tensor(x), torch.tensor(dy), chunk=128)
    assert str(got.value) == str(want.value)


def test_plain_version_adds_chunks_in_order():
    """The plain version is the running fp32 sum of the chunks' products,
    chunk 0 first, as the TPU grid revisits its output block."""
    x, dy = (torch.tensor(a) for a in _inputs(64, 8, 8, seed=1))
    acc = torch.zeros(8, 8)
    for c in range(4):
        acc = acc + x[16 * c:16 * (c + 1)].t() @ dy[16 * c:16 * (c + 1)]
    assert torch.equal(tcw.wgrad_1x1(x, dy, chunk=16), acc)
    np.testing.assert_allclose(acc.numpy(), (x.double().t() @ dy.double())
                               .numpy(), rtol=1e-5, atol=1e-5)
