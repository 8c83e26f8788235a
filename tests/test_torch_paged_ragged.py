"""The ragged walk's plan and the decode-shaped entry of the port's paged
attention, against the JAX package.

`ragged_plan` is the Python twin of the kernel's on-card plan (runs of
one slot's consecutive tokens, at most 16 a group, each group's walk
cut into ranges of at most W key tiles): on `pack_step`'s own layouts
(chunks crossing page boundaries), on layouts with interleaved slots,
slot -1 beside slot 0, positions in no order, runs of 15 / 16 / 17 / 33
tokens and positions past the table, and on `chip_smoke.py`'s serving
step, every (row, key tile) a row needs lies in exactly one item of each
head block. The plain ragged version on those layouts, and the new
`paged_attention()` entry, are held against the JAX gather references
and the JAX Pallas kernel in interpret mode on the same numpy inputs.
The Hopper kernel runs only on a card (tests/test_torch_cuda.py).
"""
import collections

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu.ops.pallas import paged_attention as pa
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.serving.batcher import pack_step


@pytest.fixture
def _interpret_paged(monkeypatch):
    monkeypatch.setattr(pa, "_INTERPRET", True)
    yield


# ------------------------------------------------------------ layouts


def _pack_step_layout(scale=1):
    """`pack_step`'s layout of three decodes and three prefill chunks
    that cross page boundaries, padded with slot -1 at position 0;
    `scale` 1 fits a table of 32 keys, 10 one of 320."""
    lens = [30 * scale, 7 * scale, 13 * scale, 25 * scale, 18 * scale,
            9 * scale]
    plan = pack_step(16 * scale + 8, 6,
                     [(0, 5, lens[0] - 1), (1, 5, lens[1] - 1),
                      (2, 5, lens[2] - 1)],
                     [(3, np.arange(7 * scale), 5, False),
                      (4, np.arange(3 * scale + 2), 0, True),
                      (5, np.arange(2 * scale), lens[5] - 2 * scale,
                       True)])
    return plan.slot_ids, plan.positions, lens


def _mixed_layout(runs=(15, 16, 17, 33), top=32, seed=7):
    """Interleaved slots, slot -1 beside slot 0, runs of `runs` tokens of
    one slot at positions in no order (repeats included), a position
    past the table (`top` keys) and one past its slot's length, which
    reads a NULL block."""
    rng = np.random.RandomState(seed)
    lens = [top, 7, 13, 25, 18, 9]
    slots, pos = [], []
    for j in range(6):                           # interleaved slots
        slots.append(j % 2)
        pos.append(lens[j % 2] - 1 - j)
    slots += [-1, 0, 0, -1]                      # slot -1 beside slot 0
    pos += [0, 5, 3, 0]
    for s, n in zip((2, 3, 4, 2), runs):
        slots += [s] * n
        pos += rng.randint(0, lens[s], n).tolist()
    slots += [1, 4]
    pos += [top + 7, lens[4] + 5]                # past the table; NULL
    return np.asarray(slots, np.int32), np.asarray(pos, np.int32), lens


def _serving_layout():
    """`chip_smoke.py`'s `paged_case`: five decodes, chunks at 384-511,
    0-63 and 0-16, 42 padding tokens, T = 256."""
    ctx = [1024, 960, 777, 512, 300, 129, 64, 17]
    slots, pos = [], []
    for s in (0, 1, 2, 4, 5):
        slots.append(s)
        pos.append(ctx[s] - 1)
    for s, start in ((3, 384), (6, 0), (7, 0)):
        slots += [s] * (ctx[s] - start)
        pos += list(range(start, ctx[s]))
    slots += [-1] * (256 - len(slots))
    pos += [0] * (256 - len(pos))
    return np.asarray(slots, np.int32), np.asarray(pos, np.int32), ctx


_LAYOUTS = {"pack_step": lambda: _pack_step_layout(10),
            "mixed": lambda: _mixed_layout(top=320),
            "serving": _serving_layout}


# ------------------------------------------------------------ the plan


def _check_plan(slots, pos, S, MB, BS, H, Dh, target, wmin):
    """Every invariant of one plan; returns it."""
    plan = tpa.ragged_plan(slots, pos, S, MB, BS, H, Dh, target, wmin)
    kt = tpa.walk_tiles(BS)
    hblk = -(-H // tpa.heads_a_block(Dh))
    cs = np.clip(slots, 0, S - 1)
    top = MB * BS - 1
    groups = plan["groups"]
    # the groups tile the tokens in order: runs of one slot, 16 at most,
    # cut only where the slot changes or a group is full
    assert groups[0][0] == 0
    assert sum(rows for _, rows, _, _ in groups) == len(slots)
    for (a, ra, sa, _), (b, _, sb, _) in zip(groups, groups[1:]):
        assert a + ra == b
        assert sa != sb or ra == tpa.RAGGED_ROWS
    for start, rows, slot, last in groups:
        assert 1 <= rows <= tpa.RAGGED_ROWS
        assert (cs[start:start + rows] == slot).all()
        assert last == min(max(int(pos[start:start + rows].max()), 0), top)
    tiles = [last // kt + 1 for _, _, _, last in groups]
    W = plan["W"]
    # the fewest tiles an item from W0 up whose items fit `target`; a
    # group an item where none does
    w0 = max(wmin, -(-hblk * sum(tiles) // target))
    fits = [w for w in range(w0, max(w0, sum(tiles)) + 1)
            if hblk * sum(-(-t // w) for t in tiles) <= target]
    assert W == (fits[0] if fits else max(w0, sum(tiles)))
    assert len(plan["items"]) <= target or not fits
    cover = collections.Counter()
    units = collections.defaultdict(list)
    for g, hbk, t0, t1, sslot in plan["items"]:
        assert 0 <= hbk < hblk and 0 <= t0 < t1 <= tiles[g]
        assert t1 - t0 <= W
        units[(g, hbk)].append(sslot)
        cover.update((g, hbk, t) for t in range(t0, t1))
    # each (group, head block) walks every tile of its walk exactly once
    assert set(units) == {(g, h) for g in range(len(groups))
                          for h in range(hblk)}
    assert all(n == 1 for n in cover.values())
    assert set(cover) == {(g, h, t) for g in range(len(groups))
                          for h in range(hblk) for t in range(tiles[g])}
    # so every (row, key tile) a row needs, in each head block, once
    for g, (start, rows, _, _) in enumerate(groups):
        for i in range(start, start + rows):
            need = min(max(int(pos[i]), 0), top) // kt + 1
            for h in range(hblk):
                assert all(cover[(g, h, t)] == 1 for t in range(need))
        # a walk's tiles lie inside its pages
        assert (tiles[g] - 1) * kt // BS <= groups[g][3] // BS
    # state slots: only units of several items, distinct, under 2 x target
    used = [s for sl in units.values() for s in sl if s is not None]
    assert sorted(used) == list(range(plan["slots"]))
    assert plan["slots"] < 2 * target
    for sl in units.values():
        assert (len(sl) == 1) == (sl == [None])
    return plan


@pytest.mark.parametrize("target", [132, 7])
@pytest.mark.parametrize("H,Dh", [(16, 64), (20, 64), (12, 128)])
@pytest.mark.parametrize("BS", [4, 8, 12, 16, 32])
@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_ragged_plan_covers_every_row_tile_once(layout, BS, H, Dh, target):
    slots, pos, lens = _LAYOUTS[layout]()
    MB = -(-max(lens) // BS) + 1
    _check_plan(slots, pos, len(lens), MB, BS, H, Dh, target,
                tpa.RAGGED_MIN_TILES)


@pytest.mark.parametrize("wmin", [1, 8])
@pytest.mark.parametrize("runs", [(15, 16, 17, 33), (1, 31, 32, 48)])
def test_ragged_plan_runs_and_wmin(runs, wmin):
    """Runs of 15 / 16 / 17 / 33 (and 1 / 31 / 32 / 48) tokens are cut
    into groups of 16 from each run's start; wmin bounds W from below."""
    slots, pos, lens = _mixed_layout(runs=runs)
    plan = _check_plan(slots, pos, len(lens), 9, 4, 16, 64, 132, wmin)
    rows = [r for a, r, _, _ in plan["groups"] if 10 <= a < 10 + sum(runs)]
    want = []
    for n in runs:
        want += [16] * (n // 16) + ([n % 16] if n % 16 else [])
    assert rows == want


def test_ragged_plan_at_the_serving_step():
    """`paged_case` on an H100 (132 SMs): 22 groups (5 decodes, 8 + 4 +
    2 for the chunks, 3 of padding) walk 7,034 keys instead of the
    62,873 (query, key) pairs a walk a token reads; W = 4 tiles."""
    slots, pos, ctx = _serving_layout()
    plan = _check_plan(slots, pos, 8, 64, 16, 16, 64, 132,
                       tpa.RAGGED_MIN_TILES)
    groups = plan["groups"]
    assert len(groups) == 22
    assert [r for _, r, _, _ in groups] == \
        [1] * 5 + [16] * 8 + [16] * 4 + [16, 1] + [16, 16, 10]
    assert sum(last + 1 for _, _, _, last in groups) == 7034
    assert int((pos.astype(np.int64) + 1).sum()) == 62873
    assert plan["W"] == 4
    assert len(plan["items"]) <= 132


# -------------------------------------------------- plain against JAX

# the small geometry of tests/test_torch_paged_attention.py: a table of
# 32 keys a slot, 3 heads of 16
BS, H, Dh = 4, 3, 16
_SMALL = {"pack_step": lambda: _pack_step_layout(1),
          "mixed": lambda: _mixed_layout(runs=(15, 16, 17, 10), top=32)}


def _pools(rng, kind, NB):
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


def _tables(rng, lens, MB):
    """Each slot's pages at random, NULL (block 0) past its length."""
    S = len(lens)
    NB = S * MB + 1
    bt = np.zeros((S, MB), np.int32)
    perm = rng.permutation(NB - 1) + 1
    for s, n in enumerate(lens):
        nb = -(-n // BS)
        bt[s, :nb] = perm[s * MB:s * MB + nb]
    return bt, NB


def _ragged_case(layout, kind, seed=0):
    slots, pos, lens = _SMALL[layout]()
    rng = np.random.RandomState(seed)
    bt, NB = _tables(rng, lens, 8)
    kp, vp, ks, vs = _pools(rng, kind, NB)
    q = rng.randn(len(slots), H, Dh).astype(np.float32)
    return q, kp, vp, bt, slots, pos, ks, vs


def _torch(a, dtype=None):
    if a is None:
        return None
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dtype) if dtype is not None else t


def _jax(a, dtype=None):
    if a is None:
        return None
    return jnp.asarray(a).astype(dtype) if dtype is not None \
        else jnp.asarray(a)


def _split(case, qdtype):
    """The case as the port's and JAX's arguments, q (and float pools)
    in `qdtype`."""
    q, kp, vp, bt, slots, pos, ks, vs = case
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[qdtype]
    fl = kp.dtype == np.float32
    targs = [_torch(q, tdt), _torch(kp, tdt if fl else None),
             _torch(vp, tdt if fl else None), _torch(bt), _torch(slots),
             _torch(pos), _torch(ks), _torch(vs)]
    jargs = [_jax(q, jdt), _jax(kp, jdt if fl else None),
             _jax(vp, jdt if fl else None), _jax(bt), _jax(slots),
             _jax(pos), _jax(ks), _jax(vs)]
    return targs, jargs


def _pallas_ragged(jargs):
    """The Pallas kernel in interpret mode; `tuning={}` keeps any
    autotune-cache entry away from the grid-layout compiler params."""
    q, kp, vp, bt, slots, pos, ks, vs = jargs
    out = pa._paged_attend_grouped(q[:, None], kp, vp, bt, slots,
                                   pos.reshape(-1, 1), ks, vs,
                                   tuning={})[:, 0]
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("kind", ["float", "int8", "fp8"])
@pytest.mark.parametrize("layout", list(_SMALL))
def test_ragged_plain_matches_jax_fp32(layout, kind, _interpret_paged):
    """fp32 queries: the port, the JAX gather reference and the Pallas
    kernel dequantize in fp32 and differ only in summation order: 1e-5.
    Every row: a padding row reads slot 0 in all three."""
    case = _ragged_case(layout, kind)
    targs, jargs = _split(case, "float32")
    got = tpa.ragged_paged_attention(*targs).numpy()
    ref = np.asarray(fa.ragged_gather_reference(*jargs))
    kern = _pallas_ragged(jargs)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("layout", list(_SMALL))
def test_ragged_plain_matches_jax_bf16(layout, kind, _interpret_paged):
    """bf16 queries (float pools in bf16 too): the frameworks round
    logits, probabilities and outputs to bf16 at different points, and
    the Pallas kernel rounds the scaled query where the references scale
    fp32 logits: a few bf16 spacings, 2e-2 absolute plus 2e-2 relative
    (tests/test_torch_paged_attention.py's bf16 tolerance). Over int8
    pools the port and the JAX reference dequantize alike (in bf16), the
    Pallas kernel in fp32: about one more bf16 spacing of every key and
    value against the kernel, 3e-2 (chip_smoke.py's QTOL)."""
    case = _ragged_case(layout, kind, seed=1)
    targs, jargs = _split(case, "bfloat16")
    got = tpa.ragged_paged_attention(*targs).float().numpy()
    ref = np.asarray(fa.ragged_gather_reference(*jargs).astype(jnp.float32))
    kern = _pallas_ragged(jargs)
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)
    tol = 2e-2 if kind == "float" else 3e-2
    np.testing.assert_allclose(got, kern, rtol=tol, atol=tol)


# ---------------------------------------------- the decode-shaped entry


def _decode_case(kind, seed=2):
    """q [6, H, Dh] over the small tables, one query a slot at its
    context length (1 key, exactly a page, a page + 1 key, the whole
    table, ...)."""
    rng = np.random.RandomState(seed)
    lens = np.asarray([1, BS, BS + 1, 32, 13, 20], np.int32)
    bt, NB = _tables(rng, lens, 8)
    kp, vp, ks, vs = _pools(rng, kind, NB)
    q = rng.randn(len(lens), H, Dh).astype(np.float32)
    return q, kp, vp, bt, lens, ks, vs


@pytest.mark.parametrize("qdtype,kind,tol", [
    ("float32", "float", 1e-5), ("float32", "int8", 1e-5),
    ("float32", "fp8", 1e-5), ("bfloat16", "float", 2e-2)])
def test_decode_entry_matches_jax(qdtype, kind, tol, _interpret_paged):
    """`paged_attention()` against JAX's `paged_attention` on the CPU
    (its gather path: the ragged reference with slots arange(B) and
    positions context_lens - 1) and against `decode_attend`, the Pallas
    kernel's decode entry, in interpret mode: the tolerances above."""
    q, kp, vp, bt, lens, ks, vs = _decode_case(kind)
    targs, jargs = _split((q, kp, vp, bt, lens, lens, ks, vs), qdtype)
    tq, tk, tv, tbt, tlens, _, tks, tvs = targs
    jq, jk, jv, jbt, jlens, _, jks, jvs = jargs
    before = tpa.launch_count
    got = tpa.paged_attention(tq, tk, tv, tbt, tlens, tks, tvs)
    assert tpa.launch_count == before          # the CPU runs no kernel
    assert got.shape == tq.shape and got.dtype == tq.dtype
    got = got.float().numpy()
    kern = np.asarray(pa.decode_attend(jq, jk, jv, jbt, jlens, jks, jvs)
                      .astype(jnp.float32))
    pa._INTERPRET = False                      # now JAX's gather path
    ref = np.asarray(fa.paged_attention(jq, jk, jv, jbt, jlens, jks, jvs)
                     .astype(jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, kern, rtol=tol, atol=tol)


def test_decode_entry_is_the_ragged_entry():
    """The decode entry equals the ragged entry over slots arange(B) and
    positions context_lens - 1, bit for bit, on the CPU."""
    q, kp, vp, bt, lens, ks, vs = (_torch(a) for a in _decode_case("int8"))
    got = tpa.paged_attention(q, kp, vp, bt, lens, ks, vs)
    want = tpa.ragged_paged_attention(
        q, kp, vp, bt, torch.arange(len(lens), dtype=torch.int32),
        lens - 1, ks, vs)
    assert torch.equal(got, want)
