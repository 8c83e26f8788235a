"""The verify entry and the quantized pools of the port's paged attention
against the JAX package.

On CPU tensors the port runs its plain versions; they are held against
the JAX gather references (`flash_attention.verify_gather_reference`,
`ragged_gather_reference` with scales) and against the JAX Pallas
kernel `_paged_attend_grouped` in interpret mode, on the same numpy
inputs: verify groups of G in {2, 4} queries (with a padded short group
and a group of slot -1), and the ragged entry, over float, int8 and
float8_e4m3fn pools. The Hopper kernels themselves run only on a card
(tests/test_torch_cuda.py).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu.ops.pallas import paged_attention as pa
from paddle_tpu_torch.ops import paged_attention as tpa

# the geometry of tests/test_torch_paged_attention.py
NB, BS, H, Dh, S, MB = 11, 4, 3, 16, 4, 6


@pytest.fixture
def _interpret_paged(monkeypatch):
    monkeypatch.setattr(pa, "_INTERPRET", True)
    yield


def _pools(rng, kind):
    """(k_pool, v_pool, k_scale, v_scale) as numpy: float32 pools and no
    scales, or int8 / float8_e4m3fn payloads (fp8 kept inside its finite
    range, as the JAX tuner's synthetic pools are) with fp32 scales."""
    shape = (NB, BS, H, Dh)
    if kind == "float":
        return (rng.randn(*shape).astype(np.float32),
                rng.randn(*shape).astype(np.float32), None, None)
    if kind == "int8":
        kp = rng.randint(-127, 128, shape).astype(np.int8)
        vp = rng.randint(-127, 128, shape).astype(np.int8)
    else:
        kp = np.clip(rng.randn(*shape) * 100, -440, 440).astype(
            np.float32).astype(ml_dtypes.float8_e4m3fn)
        vp = np.clip(rng.randn(*shape) * 100, -440, 440).astype(
            np.float32).astype(ml_dtypes.float8_e4m3fn)
    ks = (np.abs(rng.randn(NB, BS, H)) * 0.02 + 0.005).astype(np.float32)
    vs = (np.abs(rng.randn(NB, BS, H)) * 0.02 + 0.005).astype(np.float32)
    return kp, vp, ks, vs


def _tables(rng):
    """NULL-padded tables and each slot's length."""
    lens = rng.randint(1, MB * BS + 1, S)
    bt = np.zeros((S, MB), np.int32)
    for s in range(S):
        nb = -(-lens[s] // BS)
        bt[s, :nb] = rng.choice(np.arange(1, NB), nb, replace=False)
    return bt, lens


def _verify_case(seed, G, kind):
    """q [N, G, H, Dh] over N = S + 2 groups: one full group per slot
    ending inside its length, one short group [p, p+1, 0, ...] padded
    with position 0 (the verify region's layout), and one group of slot
    -1 at position 0."""
    rng = np.random.RandomState(seed)
    kp, vp, ks, vs = _pools(rng, kind)
    bt, lens = _tables(rng)
    slots, pos = [], []
    for s in range(S):
        top = rng.randint(0, lens[s])
        slots.append(s)
        pos.append([max(top - G + 1 + j, 0) for j in range(G)])
    p = rng.randint(0, lens[1] - 1) if lens[1] > 1 else 0
    slots.append(1)
    pos.append([p, p + 1][:G] + [0] * (G - 2))
    slots.append(-1)
    pos.append([0] * G)
    q = rng.randn(len(slots), G, H, Dh).astype(np.float32)
    return (q, kp, vp, bt, np.asarray(slots, np.int32),
            np.asarray(pos, np.int32), ks, vs)


def _ragged_case(seed, kind, T=9):
    rng = np.random.RandomState(seed)
    kp, vp, ks, vs = _pools(rng, kind)
    bt, lens = _tables(rng)
    slots = rng.randint(-1, S, T).astype(np.int32)
    slots[0] = -1                                   # always one pad row
    pos = np.array([rng.randint(0, lens[max(s, 0)]) for s in slots],
                   np.int32)
    q = rng.randn(T, H, Dh).astype(np.float32)
    return q, kp, vp, bt, slots, pos, ks, vs


def _torch(a, dtype=None):
    if a is None:
        return None
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    t = torch.from_numpy(a)
    return t.to(dtype) if dtype is not None else t


def _jax(a, dtype=None):
    if a is None:
        return None
    return jnp.asarray(a).astype(dtype) if dtype is not None \
        else jnp.asarray(a)


def _split(case, qdtype):
    q, kp, vp, bt, slots, pos, ks, vs = case
    fdt = {"float32": (torch.float32, jnp.float32),
           "bfloat16": (torch.bfloat16, jnp.bfloat16)}[qdtype]
    pool_t = fdt[0] if kp.dtype == np.float32 else None
    pool_j = fdt[1] if kp.dtype == np.float32 else None
    targs = [_torch(q, fdt[0]), _torch(kp, pool_t), _torch(vp, pool_t),
             _torch(bt), _torch(slots), _torch(pos), _torch(ks),
             _torch(vs)]
    jargs = [_jax(q, fdt[1]), _jax(kp, pool_j), _jax(vp, pool_j),
             _jax(bt), _jax(slots), _jax(pos), _jax(ks), _jax(vs)]
    return targs, jargs


def _pallas(jargs, ragged):
    """The Pallas kernel in interpret mode; `tuning={}` keeps any
    autotune-cache entry away from the grid-layout compiler params."""
    q, kp, vp, bt, slots, pos, ks, vs = jargs
    if ragged:
        out = pa._paged_attend_grouped(q[:, None], kp, vp, bt, slots,
                                       pos.reshape(-1, 1), ks, vs,
                                       tuning={})[:, 0]
    else:
        out = pa._paged_attend_grouped(q, kp, vp, bt, slots, pos, ks, vs,
                                       tuning={})
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("kind", ["float", "int8", "fp8"])
@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_verify_plain_matches_jax(seed, G, kind, _interpret_paged):
    """fp32 queries: the port, the JAX gather reference and the Pallas
    kernel dequantize in fp32 and differ only in summation order:
    1e-5 relative and absolute."""
    case = _verify_case(seed, G, kind)
    targs, jargs = _split(case, "float32")
    got = tpa.verify_paged_attention(*targs).numpy()
    ref = np.asarray(fa.verify_gather_reference(*jargs))
    kern = _pallas(jargs, ragged=False)
    valid = case[4] >= 0                 # padding groups are garbage
    np.testing.assert_allclose(got[valid], ref[valid], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[valid], kern[valid], rtol=1e-5,
                               atol=1e-5)
    assert np.isfinite(got).all()


def _context_case(G, kind, seed=5):
    """Groups whose walks end at 1 key, exactly one page (BS), one page
    + 1 key and the whole table (MB x BS), then a short group [p, p+1,
    0, ...] and a group of slot -1."""
    rng = np.random.RandomState(seed)
    kp, vp, ks, vs = _pools(rng, kind)
    lens = [1, BS, BS + 1, MB * BS]
    bt = np.zeros((S, MB), np.int32)
    for s in range(S):
        nb = -(-lens[s] // BS)
        bt[s, :nb] = rng.choice(np.arange(1, NB), nb, replace=False)
    slots = list(range(S)) + [3, -1]
    pos = [[max(lens[s] - G + j, 0) for j in range(G)] for s in range(S)]
    pos += [[9, 10] + [0] * (G - 2), [0] * G]
    q = rng.randn(len(slots), G, H, Dh).astype(np.float32)
    return (q, kp, vp, bt, np.asarray(slots, np.int32),
            np.asarray(pos, np.int32), ks, vs)


@pytest.mark.parametrize("kind", ["float", "int8", "fp8"])
@pytest.mark.parametrize("G", [2, 8])
def test_verify_plain_across_page_boundaries(G, kind, _interpret_paged):
    """fp32 queries, walks of 1, BS, BS + 1 and MB x BS keys: the port,
    the JAX gather reference and the Pallas kernel differ only in
    summation order (1e-5)."""
    case = _context_case(G, kind)
    targs, jargs = _split(case, "float32")
    got = tpa.verify_paged_attention(*targs).numpy()
    ref = np.asarray(fa.verify_gather_reference(*jargs))
    kern = _pallas(jargs, ragged=False)
    valid = case[4] >= 0
    np.testing.assert_allclose(got[valid], ref[valid], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[valid], kern[valid], rtol=1e-5,
                               atol=1e-5)


# The verify walk's split (ops/paged_attention.py:verify_plan,
# walk_ranges): at chip_smoke.py's verify shape (8 groups, H = 16, Dh =
# 64, BS = 16, contexts up to 1024 on 132 SMs), at Dh = 128 (two head
# blocks), at this file's small geometry, with more groups than SMs and
# with one group, every key tile of a walk up to its group's newest key
# lies in exactly one item of each head block, no item reaches past the
# walk, and the longest walk is cut into several items.
@pytest.mark.parametrize("N,H,Dh,BS,last", [
    (8, 16, 64, 16, [1023, 959, 776, 511, 299, 128, 63, 0]),
    (8, 16, 128, 16, [1023, 959, 776, 511, 299, 128, 63, 0]),
    (6, 3, 64, 4, [0, 3, 4, 23, 10, 0]),
    (200, 16, 64, 16, [5] * 199 + [1023]),
    (1, 20, 64, 12, [1023])])
def test_verify_plan_covers_every_tile_once(N, H, Dh, BS, last):
    sms = 132
    hb, hblk, ranges, items, grid = tpa.verify_plan(N, H, Dh, sms)
    assert hblk * hb >= H > (hblk - 1) * hb
    assert items == N * hblk * ranges and grid == min(items, sms)
    assert items <= sms or ranges == 1
    kt = tpa.walk_tiles(BS)
    assert BS % kt == 0 and 16 % kt == 0
    for top in last:
        tiles = top // kt + 1
        parts = tpa.walk_ranges(top, BS, ranges)
        covered = [t for a, b in parts for t in range(a, b)]
        assert covered == list(range(tiles))
        pages = sorted({t * kt // BS for t in covered})
        assert pages == list(range(top // BS + 1))
    if N * hblk < sms:   # the longest walk spread over several blocks
        parts = tpa.walk_ranges(max(last), BS, ranges)
        assert ranges >= 2
        assert max(b - a for a, b in parts) < max(last) // kt + 1


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ragged_quantized_plain_matches_jax(seed, kind, _interpret_paged):
    """The ragged entry with int8 / fp8 scales, fp32 queries: 1e-5 as
    above."""
    case = _ragged_case(seed, kind)
    targs, jargs = _split(case, "float32")
    got = tpa.ragged_paged_attention(*targs).numpy()
    ref = np.asarray(fa.ragged_gather_reference(*jargs))
    kern = _pallas(jargs, ragged=True)
    valid = case[4] >= 0
    np.testing.assert_allclose(got[valid], ref[valid], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[valid], kern[valid], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["float", "int8", "fp8"])
def test_verify_plain_matches_jax_bf16(kind):
    """bf16 queries (float pools in bf16 too): the port and the JAX
    gather reference dequantize in bf16 the same way (scale rounded to
    bf16, product rounded once) but round logits, probabilities and
    outputs at different points — a few bf16 spacings: 2e-2 absolute
    plus 2e-2 relative, as the ragged bf16 test."""
    case = _verify_case(3, 4, kind)
    targs, jargs = _split(case, "bfloat16")
    got = tpa.verify_paged_attention(*targs).float().numpy()
    ref = np.asarray(fa.verify_gather_reference(*jargs).astype(
        jnp.float32))
    valid = case[4] >= 0
    np.testing.assert_allclose(got[valid], ref[valid], rtol=2e-2,
                               atol=2e-2)


def test_verify_equals_ragged_over_the_same_queries():
    """A verify group is G ragged tokens of one slot: the two plain
    versions agree to fp32 summation order."""
    case = _verify_case(4, 4, "int8")
    targs, _ = _split(case, "float32")
    q, kp, vp, bt, slots, pos, ks, vs = targs
    N, G = pos.shape
    a = tpa.verify_paged_attention(*targs)
    b = tpa.ragged_paged_attention(
        q.reshape(N * G, H, Dh), kp, vp, bt, slots.repeat_interleave(G),
        pos.reshape(-1), ks, vs).reshape(N, G, H, Dh)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_cpu_path_launches_no_kernel():
    counters = ("launch_count", "int8_launch_count", "fp8_launch_count",
                "verify_launch_count", "verify_int8_launch_count",
                "verify_fp8_launch_count")
    before = [getattr(tpa, c) for c in counters]
    for kind in ("float", "int8", "fp8"):
        targs, _ = _split(_verify_case(0, 4, kind), "float32")
        tpa.verify_paged_attention(*targs)
        targs, _ = _split(_ragged_case(0, kind), "float32")
        tpa.ragged_paged_attention(*targs)
    assert [getattr(tpa, c) for c in counters] == before


def test_other_devices_and_head_mismatch_raise():
    targs, _ = _split(_verify_case(0, 2, "float"), "float32")
    q, kp, vp, bt, slots, pos, _, _ = targs
    with pytest.raises(ValueError, match="heads"):
        tpa.verify_paged_attention(q[:, :, :2], kp, vp, bt, slots, pos)
    with pytest.raises(ValueError, match="no kernel"):
        tpa.verify_paged_attention(q.to("meta"), kp.to("meta"),
                                   vp.to("meta"), bt, slots, pos)
