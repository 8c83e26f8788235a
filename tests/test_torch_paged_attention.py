"""Paged attention of the PyTorch port against the JAX package.

The port's `ragged_paged_attention` on CPU tensors runs its plain
version; it is held against the JAX gather reference
(`flash_attention.ragged_gather_reference`) and against the JAX Pallas
kernel `_paged_attend_grouped` in interpret mode, on the same numpy
inputs. The Hopper kernel itself runs only on a card:
tests/test_torch_cuda.py holds it against the plain version there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu.ops.pallas import paged_attention as pa
from paddle_tpu_torch.ops import paged_attention as tpa

# the TestKernelOracleParity geometry of tests/test_paged_kernels.py
NB, BS, H, Dh, S, MB, T = 11, 4, 3, 16, 4, 6, 9


@pytest.fixture
def _interpret_paged(monkeypatch):
    monkeypatch.setattr(pa, "_INTERPRET", True)
    yield


def _case(seed, tables):
    """q/pools/tables/slots/positions as numpy. `tables="random"`
    draws every table entry (NULL included) at random; "null_padded"
    gives each slot a length and NULL past its last block, with every
    position inside its slot's length. Slot -1 pads; positions land
    mid-block."""
    rng = np.random.RandomState(seed)
    q = rng.randn(T, H, Dh).astype(np.float32)
    kp = rng.randn(NB, BS, H, Dh).astype(np.float32)
    vp = rng.randn(NB, BS, H, Dh).astype(np.float32)
    slots = rng.randint(-1, S, T).astype(np.int32)
    slots[0] = -1                                   # always one pad row
    if tables == "random":
        bt = rng.randint(0, NB, (S, MB)).astype(np.int32)
        pos = rng.randint(0, MB * BS, T).astype(np.int32)
    else:
        lens = rng.randint(1, MB * BS + 1, S)
        bt = np.zeros((S, MB), np.int32)
        for s in range(S):
            nb = -(-lens[s] // BS)
            bt[s, :nb] = rng.choice(np.arange(1, NB), nb, replace=False)
        pos = np.array([rng.randint(0, lens[max(s, 0)]) for s in slots],
                       np.int32)
    return q, kp, vp, bt, slots, pos


def _port(q, kp, vp, bt, slots, pos, dtype=torch.float32):
    args = [torch.tensor(q).to(dtype), torch.tensor(kp).to(dtype),
            torch.tensor(vp).to(dtype), torch.tensor(bt),
            torch.tensor(slots), torch.tensor(pos)]
    return tpa.ragged_paged_attention(*args).float().numpy()


def _jax_args(q, kp, vp, bt, slots, pos, dtype=jnp.float32):
    return (jnp.asarray(q).astype(dtype), jnp.asarray(kp).astype(dtype),
            jnp.asarray(vp).astype(dtype), jnp.asarray(bt),
            jnp.asarray(slots), jnp.asarray(pos))


def _pallas(q, kp, vp, bt, slots, pos):
    """The Pallas kernel in interpret mode; `tuning={}` keeps any
    autotune-cache entry away from the grid-layout compiler params."""
    out = pa._paged_attend_grouped(q[:, None], kp, vp, bt, slots,
                                   pos.reshape(-1, 1), tuning={})
    return np.asarray(out[:, 0].astype(jnp.float32))


@pytest.mark.parametrize("tables", ["random", "null_padded"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_jax_fp32(seed, tables, _interpret_paged):
    case = _case(seed, tables)
    got = _port(*case)
    jargs = _jax_args(*case)
    ref = np.asarray(fa.ragged_gather_reference(*jargs))
    kern = _pallas(*jargs)
    valid = case[4] >= 0                 # padding rows are garbage
    np.testing.assert_allclose(got[valid], ref[valid], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[valid], kern[valid], rtol=1e-5,
                               atol=1e-5)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("tables", ["random", "null_padded"])
def test_plain_matches_jax_bf16_pools(tables, _interpret_paged):
    """bf16 queries and pools. bf16 keeps 8 significant bits (spacing
    2^-8 relative); the two frameworks round logits, probabilities and
    outputs to bf16 at different points, and the Pallas kernel rounds
    the scaled query where the reference scales fp32 logits, so the
    results differ by a few bf16 spacings: 2e-2 absolute plus 2e-2
    relative."""
    case = _case(3, tables)
    got = _port(*case, dtype=torch.bfloat16)
    jargs = _jax_args(*case, dtype=jnp.bfloat16)
    ref = np.asarray(fa.ragged_gather_reference(*jargs).astype(
        jnp.float32))
    kern = _pallas(*jargs)
    valid = case[4] >= 0
    np.testing.assert_allclose(got[valid], ref[valid], rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(got[valid], kern[valid], rtol=2e-2,
                               atol=2e-2)


def test_cpu_path_launches_no_kernel():
    before = tpa.launch_count
    _port(*_case(0, "random"))
    assert tpa.launch_count == before


def test_head_mismatch_raises():
    q, kp, vp, bt, slots, pos = (torch.tensor(a) for a in _case(0, "random"))
    with pytest.raises(ValueError):
        tpa.ragged_paged_attention(q[:, :2], kp, vp, bt, slots, pos)
