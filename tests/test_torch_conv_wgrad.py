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
                                           (384, 8, 16, 32),
                                           (256, 16, 64, 64),
                                           (192, 64, 16, 96)])
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


# The card's split (ops/conv_wgrad.py:plan, split_rows): at the shapes
# chip_smoke.py and the card tests run, and small ones, every row tile of
# N lies in exactly one split of a tile, the splits' counts differ by at
# most one, and the grid never asks for more than one block an SM.
@pytest.mark.parametrize("N,Ci,Co", [(401408, 256, 64), (25088, 1024, 256),
                                     (3136, 64, 256), (196, 2048, 512),
                                     (1000, 72, 40), (96, 8, 8),
                                     (2 ** 20, 16, 16), (40, 16, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_covers_every_row_once(N, Ci, Co, dtype):
    sms = 132
    bn, splits, grid = tcw.plan(N, Ci, Co, dtype, sms)
    walks = tcw.split_rows(N, splits, dtype)
    rows = tcw.ROWS_32 if dtype == torch.float32 else tcw.ROWS_16
    assert sorted(t for w in walks for t in w) == list(range(-(-N // rows)))
    sizes = [len(w) for w in walks]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    if dtype == torch.float32:
        tiles = -(-Ci // 64) * -(-Co // 64)
        assert bn == 64 and grid == tiles * splits
    else:
        tiles = -(-max(Ci, Co) // tcw.TILE_M) * -(-min(Ci, Co) // bn)
        assert bn == (64 if min(Ci, Co) <= 64 else 128)
        assert grid == min(tiles * splits, sms)
        assert tiles * splits <= sms or splits == 1


def test_plan_at_resnet50_takes_all_of_dw_a_block():
    """At [401408, 256] x [401408, 64] one 256 x 64 tile is all of dW:
    132 ranges, one a block, so x and dy are each read once."""
    assert tcw.plan(401408, 256, 64, torch.bfloat16, 132) == (64, 132, 132)
