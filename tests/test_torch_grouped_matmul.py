"""The port's grouped expert matmul against the JAX package's.

The plain version (what a CPU tensor runs) is held against JAX's
`grouped_expert_matmul` running its real Pallas kernels (`_gmm_kernel`,
`_gmm_kernel_quant`, `_gmm_kernel_quant4`) in interpret mode, as
tests/test_kernel_autotune.py runs them — the same numpy inputs on both
sides. The installed jax names the Pallas TPU compiler parameters
`CompilerParams`; the JAX module still asks for `TPUCompilerParams`, so
the fixture aliases the one to the other for the test's duration.
The host helpers (int4 packing, int4 and int8 expert quantization) must
produce the JAX package's bytes exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu.incubate.nn import fused_transformer as jft
from paddle_tpu.ops.pallas import autotune as jat
from paddle_tpu.ops.pallas import grouped_matmul as jgmm
from paddle_tpu_torch.incubate.nn import fused_transformer as tft
from paddle_tpu_torch.ops import grouped_matmul as tgmm

SHAPES = [(2, 8, 16, 32), (3, 5, 8, 24)]


@pytest.fixture
def interpret(monkeypatch, tmp_path):
    """JAX's grouped kernels in interpret mode, the autotune cache in a
    throwaway file (as test_kernel_autotune's `tmp_cache`)."""
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)
    monkeypatch.setattr(jgmm, "_INTERPRET", True)
    monkeypatch.setenv("PADDLE_TPU_KERNEL_CACHE", str(tmp_path / "c.json"))
    jat.reset_for_tests()
    yield
    jat.reset_for_tests()


def _int4_case(rng, E, D, F):
    q = rng.randint(-7, 8, (E, D, F)).astype(np.int8)
    s = (np.abs(rng.randn(E, F)) * 0.05 + 0.01).astype(np.float16)
    return np.asarray(jgmm.pack_int4(jnp.asarray(q), axis=-2)), s


# Tolerances are JAX's own for these kernels (test_kernel_autotune):
# fp32 2e-5 (sums in another order), bf16 5e-2 (the Pallas kernel
# multiplies in fp32 and rounds once, the plain version rounds its
# products' inputs to bf16), quantized 2e-4 (the Pallas kernel
# dequantizes in fp32, the plain version in the compute dtype).


@pytest.mark.parametrize("E,C,D,F", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp_matches_jax_kernel(interpret, E, C, D, F, dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(E, C, D).astype(np.float32)
    w = (rng.randn(E, D, F) * 0.1).astype(np.float32)
    want = jgmm.grouped_expert_matmul(jnp.asarray(x).astype(dtype),
                                      jnp.asarray(w).astype(dtype))
    tdt = getattr(torch, dtype)
    got = tgmm.grouped_expert_matmul(torch.tensor(x).to(tdt),
                                     torch.tensor(w).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (E, C, F)
    tol = 2e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("E,C,D,F", SHAPES)
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantized_matches_jax_kernel(interpret, E, C, D, F, fmt):
    rng = np.random.RandomState(1)
    x = rng.randn(E, C, D).astype(np.float32)
    if fmt == "int8":
        w = rng.randint(-127, 128, (E, D, F)).astype(np.int8)
        s = (np.abs(rng.randn(E, F)) * 0.05 + 0.01).astype(np.float32)
    else:
        w, s = _int4_case(rng, E, D, F)
    # qmax left to the format detection on both sides
    want = jgmm.grouped_expert_matmul(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(s))
    got = tgmm.grouped_expert_matmul(torch.tensor(x), torch.tensor(w),
                                     torch.tensor(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    # the plain version is the JAX einsum oracle to fp32 rounding
    oracle = jgmm.grouped_matmul_oracle(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle),
                               rtol=1e-5, atol=1e-5)


def test_int4_pack_unpack_byte_identical():
    rng = np.random.RandomState(3)
    for _ in range(10):
        nd = rng.randint(2, 5)
        shape = [int(rng.randint(1, 6)) for _ in range(nd)]
        axis = int(rng.randint(-nd, nd))
        shape[axis] = 2 * int(rng.randint(1, 6))
        q = rng.randint(-8, 8, shape).astype(np.int8)
        want = np.asarray(jgmm.pack_int4(jnp.asarray(q), axis=axis))
        got = tgmm.pack_int4(torch.tensor(q), axis=axis)
        assert got.dtype == torch.int8
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(tgmm.unpack_int4(got, axis=axis).numpy(), q)
    with pytest.raises(ValueError):
        tgmm.pack_int4(torch.zeros(3, 5, dtype=torch.int8), axis=-1)


def test_expert_quantization_byte_identical():
    """quantize_int4_experts and the int8 `_quantize_expert_stack` of an
    [L, E, In, Out] stack: the same bytes and scales as JAX's."""
    rng = np.random.RandomState(4)
    w = (rng.randn(2, 3, 8, 12) * 0.3).astype(np.float32)
    w[0, 1, :, 2] = 0.0                     # a zero column: scale 1e-9
    jq4, js4 = jgmm.quantize_int4_experts(jnp.asarray(w))
    tq4, ts4 = tgmm.quantize_int4_experts(torch.tensor(w))
    assert ts4.dtype == torch.float16
    assert np.array_equal(tq4.numpy(), np.asarray(jq4))
    assert np.array_equal(ts4.numpy(), np.asarray(js4))
    for bits in (8, 4):
        jq, js = jft._quantize_expert_stack(jnp.asarray(w), bits)
        tq, ts = tft._quantize_expert_stack(torch.tensor(w), bits)
        assert tq.dtype == torch.int8
        assert np.array_equal(tq.numpy(), np.asarray(jq))
        assert np.array_equal(ts.numpy(), np.asarray(js))
        assert str(ts.dtype).split(".")[-1] == str(js.dtype)


def test_expert_weight_bytes_and_format_detection():
    for dt in ("float32", "bfloat16", "int8", "int4"):
        assert tgmm.expert_weight_bytes(8, 1024, 4096, dt, 24) == \
            jgmm.expert_weight_bytes(8, 1024, 4096, dt, 24)
    with pytest.raises(ValueError):
        tgmm.expert_weight_bytes(8, 16, 16, "int2")
    packed = torch.zeros(2, 4, 6, dtype=torch.int8)
    assert tgmm.is_packed_int4(packed, 8)
    assert not tgmm.is_packed_int4(packed, 4)
    assert not tgmm.is_packed_int4(packed.float(), 8)


# ------------------------------------------- the kernel plan (no card)


@pytest.mark.parametrize("fmt", [0, 1, 2])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16,
                                 torch.float16])
def test_plan_routes_each_dtype_and_format(fmt, xdt):
    """Every weight format under 16-bit activations takes the wgmma
    kernel; fp32 activations of every format the CUDA-core kernel with
    its (expert, 64-column) blocks."""
    p = tgmm.plan(8, 80, 1024, 4096, fmt, xdt)
    q16 = xdt != torch.float32
    assert p["kernel"] == ("q16" if q16 else "mma")
    if not q16:
        assert (p["split"], p["cluster"], p["blocks"]) == (1, 1, 8 * 64)


@pytest.mark.parametrize("fmt", [1, 2])
def test_plan_at_the_serving_products(fmt):
    """ffn1 [8, 80, 1024] x [1024, 4096]: 8 x 32 tiles of 128 columns
    fill the card unsplit; ffn2 [8, 80, 4096] x [4096, 1024]: 8 x 8 = 64
    tiles, so D splits in 3 and at least 132 SMs' worth of blocks run,
    each tile's 3 blocks one cluster."""
    f1 = tgmm.plan(8, 80, 1024, 4096, fmt, torch.bfloat16)
    f2 = tgmm.plan(8, 80, 4096, 1024, fmt, torch.bfloat16)
    for p in (f1, f2):
        assert (p["m_tile"], p["n_tile"], p["k_tile"]) == (
            128, 80, 64 if fmt == 1 else 128)
    assert (f1["tiles"], f1["split"], f1["cluster"], f1["blocks"]) == (
        256, 1, 1, 256)
    assert (f2["tiles"], f2["split"], f2["cluster"], f2["blocks"]) == (
        64, 3, 3, 192)
    assert f2["blocks"] >= tgmm.H100_SMS


@pytest.mark.parametrize("E,C,D,F,fmt,tiles,split", [
    (1, 80, 128, 128, 1, 1, 2),       # two int8 stages: split 2
    (1, 80, 128, 128, 2, 1, 1),       # one int4 stage: no split
    (3, 38, 50, 50, 1, 3, 1),         # F off the tile, D one stage
    (2, 5, 16, 24, 2, 2, 1),
    (1, 300, 512, 136, 1, 8, 4),      # C over 4 row chunks
    (3, 256, 520, 264, 2, 36, 4),
    (8, 200, 4096, 1024, 1, 192, 1),  # enough tiles: no split
    (4, 80, 4096, 1024, 2, 32, 4),    # split capped at 4
    (2, 80, 4096, 4096, 1, 64, 3),
])
def test_plan_at_edge_shapes(E, C, D, F, fmt, tiles, split):
    """Tiles and split at shapes off the serving ones: the split never
    exceeds 4 or the stages D has, and is 1 once the tiles fill the
    SMs."""
    p = tgmm.plan(E, C, D, F, fmt, torch.float16)
    assert (p["tiles"], p["split"]) == (tiles, split)
    assert p["cluster"] == split and p["blocks"] == tiles * split
    assert p["tiles"] == E * -(-F // 128) * -(-C // 80)


@pytest.mark.parametrize("E,C,D,F,tiles,split", [
    (1, 80, 64, 128, 1, 1),           # one float stage: no split
    (1, 80, 128, 128, 1, 2),          # two stages: split 2
    (2, 81, 96, 200, 8, 2),           # C one past a chunk, F off the tile
    (1, 80, 200, 264, 3, 4),          # D and F off their tiles
    (3, 1, 256, 72, 3, 4),            # one capacity row
    (2, 300, 38, 136, 16, 1),         # D under one stage
    (4, 300, 64, 4096, 512, 1),       # enough tiles: unsplit
    (8, 80, 1024, 4096, 256, 1),      # the MoE step's ffn1
    (8, 80, 4096, 1024, 64, 2),       # its ffn2: 128 blocks, one an SM
    (4, 80, 1024, 1280, 40, 3),       # 40 tiles: split 3
])
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float16])
def test_plan_float_weights_at_edge_shapes(E, C, D, F, tiles, split, xdt):
    """Float weights under 16-bit activations: the wgmma kernel's 128 x 80
    tile and 64-row stage, and the split `plan` takes for them: the most
    parts that leave no SM two blocks (never more than 4 or than the
    stages D has; 1 once the tiles fill the SMs)."""
    p = tgmm.plan(E, C, D, F, 0, xdt)
    assert (p["kernel"], p["m_tile"], p["n_tile"], p["k_tile"]) == (
        "q16", 128, 80, 64)
    assert (p["tiles"], p["split"]) == (tiles, split)
    assert p["cluster"] == split and p["blocks"] == tiles * split


def test_plan_follows_the_sm_count():
    """The split is sized to a block on every SM of the card the wrapper
    names: a card with fewer SMs splits less."""
    assert tgmm.plan(8, 80, 4096, 1024, 1, torch.bfloat16,
                     sms=66)["split"] == 2
    assert tgmm.plan(8, 80, 4096, 1024, 1, torch.bfloat16,
                     sms=32)["split"] == 1
