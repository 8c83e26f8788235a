"""Card-only checks of the PyTorch port (marker `cuda`), run on a
machine with the card by

    python -m pytest -m cuda tests/test_torch_*.py

Without a card every test here skips; the CPU parity tests live in the
other tests/test_torch_*.py files. This file imports torch and the port
only, no jax.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models.gpt import GPTForGeneration
from paddle_tpu_torch.ops import conv_wgrad as tcw
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import grouped_matmul as tgmm
from paddle_tpu_torch.ops import layer_norm as tln
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import qkv_proj as tqp
from paddle_tpu_torch.parallel import hybrid_gpt as th
from paddle_tpu_torch.serving.batcher import SamplingConfig
from paddle_tpu_torch.serving.engine import ServingEngine


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(dtype, device, seed=0):
    """A mixed decode/prefill flat axis with padding at the serving
    head geometry (H=16, Dh=64, BS=16), with a smaller T and context."""
    g = torch.Generator().manual_seed(seed)
    H, Dh, BS, S, MB, T = 16, 64, 16, 4, 16, 64
    NB = S * MB + 1
    lens = [256, 100, 37, 1]
    bt = torch.zeros(S, MB, dtype=torch.int32)
    perm = torch.randperm(NB - 1, generator=g) + 1
    for s, n in enumerate(lens):
        nb = -(-n // BS)
        bt[s, :nb] = perm[s * MB:s * MB + nb].int()
    slots = list(range(S))                     # one decode per slot
    pos = [n - 1 for n in lens]
    slots += [1] * 40                          # a 40-token prefill chunk
    pos += list(range(60, 100))
    slots += [-1] * (T - len(slots))           # padding
    pos += [0] * (T - len(pos))
    q = torch.randn(T, H, Dh, generator=g).to(dtype)
    kp = torch.randn(NB, BS, H, Dh, generator=g).to(dtype)
    vp = torch.randn(NB, BS, H, Dh, generator=g).to(dtype)
    args = [q, kp, vp, bt, torch.tensor(slots, dtype=torch.int32),
            torch.tensor(pos, dtype=torch.int32)]
    return [a.to(device) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain(dtype, tol, cuda_device):
    """The kernel against the plain version on the card: fp32 at 1e-5;
    bf16 at 2e-2 (the plain version rounds logits and probabilities to
    bf16, the kernel keeps them fp32 — a few bf16 spacings apart)."""
    args = _case(dtype, cuda_device)
    before = tpa.launch_count
    got = tpa.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert tpa.launch_count == before + 1
    ref = tpa.ragged_gather_reference(*args)
    valid = args[4] >= 0
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got[valid].float(), ref[valid].float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_kernel_refuses_unsupported_operands(cuda_device):
    q, kp, vp, bt, slots, pos = _case(torch.float32, cuda_device)
    with pytest.raises(TypeError):
        tpa.ragged_paged_attention(q.half(), kp.bfloat16(), vp.bfloat16(),
                                   bt, slots, pos)
    with pytest.raises(TypeError):
        tpa.ragged_paged_attention(q, kp, vp, bt.long(), slots, pos)
    with pytest.raises(ValueError):
        tpa.ragged_paged_attention(q.transpose(0, 1).contiguous()
                                   .transpose(0, 1), kp, vp, bt, slots,
                                   pos)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda_device):
    """A small fp32 model served on the card (kernel path) and on the
    CPU (plain path) from the same weights gives the same greedy
    tokens, and the card run launched one kernel per layer per step."""
    torch.manual_seed(0)
    cpu = GPTForGeneration(vocab_size=193, hidden_size=128, num_layers=2,
                           num_attention_heads=2,
                           max_position_embeddings=128, device="cpu")
    card = GPTForGeneration(vocab_size=193, hidden_size=128, num_layers=2,
                            num_attention_heads=2,
                            max_position_embeddings=128,
                            device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 193, n).tolist() for n in (9, 5, 30, 3)]
    kw = dict(max_slots=4, block_size=16, max_seq_len=64,
              cache_dtype="float32")
    want = ServingEngine(cpu, device="cpu", **kw).generate_batch(
        prompts, max_new_tokens=8)
    eng = ServingEngine(card, device=cuda_device, **kw)
    before = tpa.launch_count
    got = eng.generate_batch(prompts, max_new_tokens=8)
    assert got == want
    assert tpa.launch_count - before == eng.steps_run * 2


# ------------------------------------- paged verify and quantized pools


def _verify_case(G, Dh, qdtype, pool, device, seed=0):
    """A verify-shaped call at H=4 heads, BS=16, over 6 groups: four
    full groups of G consecutive queries ending at their slot's newest
    position, one short group [p, p+1, 0, ...] padded with position 0,
    and one group of slot -1 at positions 0. `pool`: "float" (pools in
    q's dtype), "int8" or "fp8" (payloads quantized per entry and head
    as the serving engine does, with fp32 scales)."""
    from paddle_tpu_torch.serving.engine import quantize_kv
    g = torch.Generator().manual_seed(seed)
    H, BS, S, MB = 4, 16, 5, 20
    NB = S * MB + 1
    lens = [300, 17, 64, 129, 90]
    bt = torch.zeros(S, MB, dtype=torch.int32)
    perm = torch.randperm(NB - 1, generator=g) + 1
    for s, n in enumerate(lens):
        nb = -(-n // BS)
        bt[s, :nb] = perm[s * MB:s * MB + nb].int()
    slots, pos = [], []
    for s in range(4):
        slots.append(s)
        pos.append([max(lens[s] - G + j, 0) for j in range(G)])
    slots.append(4)
    pos.append([70, 71][:G] + [0] * max(G - 2, 0))
    slots.append(-1)
    pos.append([0] * G)
    q = torch.randn(len(slots), G, H, Dh, generator=g).to(qdtype)
    kf = torch.randn(NB, BS, H, Dh, generator=g)
    vf = torch.randn(NB, BS, H, Dh, generator=g)
    if pool == "float":
        kp, vp, ks, vs = kf.to(qdtype), vf.to(qdtype), None, None
    else:
        kv_dtype = "int8" if pool == "int8" else "fp8_e4m3"
        kp, ks = quantize_kv(kf, kv_dtype)
        vp, vs = quantize_kv(vf, kv_dtype)
    args = [q, kp, vp, bt, torch.tensor(slots, dtype=torch.int32),
            torch.tensor(pos, dtype=torch.int32), ks, vs]
    return [None if a is None else a.to(device) for a in args]


# kernel-vs-plain tolerance, |kernel - plain| <= tol (1 + |plain|), by
# query dtype and pool kind. fp32: the same fp32 values summed in another
# order. bf16/fp16 float pools: the plain version rounds logits and
# probabilities to q's dtype before its products, the kernel keeps them
# fp32 (a few spacings: 2^-8 bf16, 2^-11 fp16). Quantized pools add the
# plain version's dequantization in q's dtype (the scale and the product
# each rounded once) where the kernel dequantizes in fp32: about one more
# spacing of every key and value.
_VERIFY_TOL = {(torch.float32, "float"): 1e-5, (torch.float32, "int8"): 1e-5,
               (torch.float32, "fp8"): 1e-5,
               (torch.bfloat16, "float"): 2e-2, (torch.bfloat16, "int8"): 3e-2,
               (torch.bfloat16, "fp8"): 3e-2,
               (torch.float16, "float"): 3e-3, (torch.float16, "int8"): 5e-3,
               (torch.float16, "fp8"): 5e-3}
_VERIFY_COUNTER = {"float": "verify_launch_count",
                   "int8": "verify_int8_launch_count",
                   "fp8": "verify_fp8_launch_count"}
_RAGGED_COUNTER = {"float": "launch_count", "int8": "int8_launch_count",
                   "fp8": "fp8_launch_count"}


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["float", "int8", "fp8"])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16,
                                    torch.float16])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("Dh", [64, 128])
def test_verify_kernel_matches_plain(Dh, G, qdtype, pool, cuda_device):
    """The verify entry (K3b; over int8/fp8 pools K3c) against its plain
    version, including the padded short group and the slot -1 group;
    only its own variant's counter moves."""
    args = _verify_case(G, Dh, qdtype, pool, cuda_device)
    before = {c: getattr(tpa, c) for c in
              list(_VERIFY_COUNTER.values()) + list(_RAGGED_COUNTER.values())}
    got = tpa.verify_paged_attention(*args)
    torch.cuda.synchronize()
    after = {c: getattr(tpa, c) for c in before}
    assert {c: after[c] - before[c] for c in before} == {
        c: int(c == _VERIFY_COUNTER[pool]) for c in before}
    ref = tpa.verify_gather_reference(*args)
    valid = args[4] >= 0
    assert torch.isfinite(got.float()).all()
    tol = _VERIFY_TOL[(qdtype, pool)]
    got, ref = got[valid].float(), ref[valid].float()
    assert bool(((got - ref).abs() <= tol * (1 + ref.abs())).all()), \
        float((got - ref).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["int8", "fp8"])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16,
                                    torch.float16])
@pytest.mark.parametrize("Dh", [64, 128])
def test_ragged_quantized_kernel_matches_plain(Dh, qdtype, pool,
                                               cuda_device):
    """The ragged entry over int8/fp8 pools (K3c): the verify case's
    queries flattened to one query per token."""
    q, kp, vp, bt, slots, pos, ks, vs = _verify_case(4, Dh, qdtype, pool,
                                                     cuda_device)
    N, G = pos.shape
    args = (q.reshape(N * G, *q.shape[2:]), kp, vp, bt,
            slots.repeat_interleave(G), pos.reshape(-1), ks, vs)
    before = getattr(tpa, _RAGGED_COUNTER[pool])
    got = tpa.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert getattr(tpa, _RAGGED_COUNTER[pool]) == before + 1
    ref = tpa.ragged_gather_reference(*args)
    valid = args[4] >= 0
    tol = _VERIFY_TOL[(qdtype, pool)]
    got, ref = got[valid].float(), ref[valid].float()
    assert bool(((got - ref).abs() <= tol * (1 + ref.abs())).all()), \
        float((got - ref).abs().max())


def _walk_case(G, Dh, H, BS, qdtype, pool, device, seed=0):
    """A verify call whose walks end at 1 key, exactly one page, one page
    + 1 key and 1024 keys (so the longest walk crosses many items), plus
    a short group [p, p+1, 0, ...] padded with position 0 and a group of
    slot -1, at H heads and block size BS."""
    from paddle_tpu_torch.serving.engine import quantize_kv
    g = torch.Generator().manual_seed(seed)
    lens = [1, BS, BS + 1, 1024, 300]
    S, MB = len(lens), -(-1024 // BS)
    NB = S * MB + 1
    bt = torch.zeros(S, MB, dtype=torch.int32)
    perm = torch.randperm(NB - 1, generator=g) + 1
    for s, n in enumerate(lens):
        nb = -(-n // BS)
        bt[s, :nb] = perm[s * MB:s * MB + nb].int()
    slots, pos = [], []
    for s in range(4):
        slots.append(s)
        pos.append([max(lens[s] - G + j, 0) for j in range(G)])
    slots.append(4)
    pos.append([70, 71] + [0] * (G - 2))
    slots.append(-1)
    pos.append([0] * G)
    q = torch.randn(len(slots), G, H, Dh, generator=g).to(qdtype)
    kf = torch.randn(NB, BS, H, Dh, generator=g)
    vf = torch.randn(NB, BS, H, Dh, generator=g)
    if pool == "float":
        kp, vp, ks, vs = kf.to(qdtype), vf.to(qdtype), None, None
    else:
        kv_dtype = "int8" if pool == "int8" else "fp8_e4m3"
        kp, ks = quantize_kv(kf, kv_dtype)
        vp, vs = quantize_kv(vf, kv_dtype)
    args = [q, kp, vp, bt, torch.tensor(slots, dtype=torch.int32),
            torch.tensor(pos, dtype=torch.int32), ks, vs]
    return [None if a is None else a.to(device) for a in args]


def _hold_walk(args, qdtype, pool):
    """One verify-walk launch against its plain version (its variant's
    counter moves by one), and a second launch to the same bits."""
    before = getattr(tpa, _VERIFY_COUNTER[pool])
    got = tpa.verify_paged_attention(*args)
    torch.cuda.synchronize()
    assert getattr(tpa, _VERIFY_COUNTER[pool]) == before + 1
    assert torch.equal(tpa.verify_paged_attention(*args), got)
    ref = tpa.verify_gather_reference(*args)
    valid = args[4] >= 0
    assert torch.isfinite(got.float()).all()
    tol = _VERIFY_TOL[(qdtype, pool)]
    got, ref = got[valid].float(), ref[valid].float()
    assert bool(((got - ref).abs() <= tol * (1 + ref.abs())).all()), \
        float((got - ref).abs().max())


# The verify walk (G >= 2 over 16-bit pools under their own type, and
# over int8 / fp8 pools) across its cuts: walks of 1, BS, BS + 1 and 1024
# keys; H = 20 at Dh = 64 and 12 at Dh = 128 make a full head block
# (16 / 8 heads, one bulk copy a pool entry) and a partial one (4 heads,
# threads past them idle). The tolerances of
# test_verify_kernel_matches_plain.
@pytest.mark.cuda
@pytest.mark.parametrize("qdtype,pool", [(torch.bfloat16, "float"),
                                         (torch.float16, "float"),
                                         (torch.bfloat16, "int8"),
                                         (torch.bfloat16, "fp8")])
@pytest.mark.parametrize("G", [2, 4, 5, 8])
@pytest.mark.parametrize("Dh", [64, 128])
def test_verify_walk_across_its_items(Dh, G, qdtype, pool, cuda_device):
    H = 20 if Dh == 64 else 12
    _hold_walk(_walk_case(G, Dh, H, 16, qdtype, pool, cuda_device),
               qdtype, pool)


@pytest.mark.cuda
@pytest.mark.parametrize("BS", [8, 32, 12])
def test_verify_walk_other_block_sizes(BS, cuda_device):
    """Key tiles of gcd(BS, 16) keys: 8 (a page a tile), 16 (two tiles a
    page) and 4 (three), with every head in one block (one bulk copy a
    tile)."""
    _hold_walk(_walk_case(4, 64, 16, BS, torch.bfloat16, "int8",
                          cuda_device), torch.bfloat16, "int8")


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype,pool,G,walk", [
    (torch.bfloat16, "float", 4, True), (torch.bfloat16, "int8", 4, True),
    (torch.float32, "fp8", 4, True), (torch.float32, "float", 4, False),
    (torch.bfloat16, "float", 1, True), (torch.bfloat16, "fp8", 1, True)])
def test_verify_routes_by_pair(qdtype, pool, G, walk, cuda_device):
    """Verify groups over 16-bit pools under their own type and over
    quantized pools reach verify_walk_kernel, groups of one query too
    (as the ragged walk's groups); fp32 pools keep paged_attend_kernel.
    Two calls in the profiled window, whose first kernel the profiler
    can miss."""
    args = _verify_case(G, 64, qdtype, pool, cuda_device)
    names = _device_kernels(
        lambda: [tpa.verify_paged_attention(*args) for _ in range(2)])
    assert any(("verify_walk_kernel" if walk else "paged_attend_kernel") in n
               for n in names), names
    assert not any(("paged_attend_kernel" if walk else "verify_walk_kernel")
                   in n for n in names), names


# ------------------------------------------- the ragged walk (K3a, K3c)


def _ragged_layout(layout, BS):
    """(slot_ids, positions, lens, MB) of a ragged call over 6 slots of
    lengths `lens`: "pack_step" — the port's pack_step of three decodes
    and three prefill chunks that cross page boundaries, padded with
    slot -1 to 160 tokens; "mixed" — interleaved slots, slot -1 beside
    slot 0, positions in no order, runs of 15, 16, 17 and 33 tokens of
    one slot, a position past the table and one past its slot's length
    (a NULL block)."""
    from paddle_tpu_torch.serving.batcher import pack_step
    lens = [300, 17, 64, 129, 90, 41]
    MB = -(-320 // BS)
    if layout == "pack_step":
        plan = pack_step(160, 6, [(0, 5, 299), (1, 5, 16), (2, 5, 63)],
                         [(3, np.arange(70), 37, False),
                          (4, np.arange(33), 0, True),
                          (5, np.arange(21), 20, True)])
        return plan.slot_ids, plan.positions, lens, MB
    rng = np.random.RandomState(7)
    slots, pos = [], []
    for j in range(6):                           # interleaved slots
        slots.append(j % 2)
        pos.append(lens[j % 2] - 1 - j)
    slots += [-1, 0, 0, -1]                      # slot -1 beside slot 0
    pos += [0, 5, 3, 0]
    for s, n in ((2, 15), (3, 16), (4, 17), (2, 33)):
        slots += [s] * n                         # positions in no order
        pos += rng.randint(0, lens[s], n).tolist()
    slots += [1, 4]
    pos += [MB * BS + 7, lens[4] + BS + 3]       # past the table; NULL
    return (np.asarray(slots, np.int32), np.asarray(pos, np.int32), lens,
            MB)


def _ragged_case(layout, Dh, H, BS, qdtype, pool, device, seed=0):
    """The ragged entry's operands over `_ragged_layout`, every slot's
    pages drawn at random, float pools in q's dtype or int8 / fp8 pools
    quantized as the engine quantizes."""
    from paddle_tpu_torch.serving.engine import quantize_kv
    slots, pos, lens, MB = _ragged_layout(layout, BS)
    g = torch.Generator().manual_seed(seed)
    S = len(lens)
    NB = S * MB + 1
    bt = torch.zeros(S, MB, dtype=torch.int32)
    perm = torch.randperm(NB - 1, generator=g) + 1
    for s, n in enumerate(lens):
        nb = -(-n // BS)
        bt[s, :nb] = perm[s * MB:s * MB + nb].int()
    q = torch.randn(len(slots), H, Dh, generator=g).to(qdtype)
    kf = torch.randn(NB, BS, H, Dh, generator=g)
    vf = torch.randn(NB, BS, H, Dh, generator=g)
    if pool == "float":
        kp, vp, ks, vs = kf.to(qdtype), vf.to(qdtype), None, None
    else:
        kv_dtype = "int8" if pool == "int8" else "fp8_e4m3"
        kp, ks = quantize_kv(kf, kv_dtype)
        vp, vs = quantize_kv(vf, kv_dtype)
    args = [q, kp, vp, bt, torch.from_numpy(slots), torch.from_numpy(pos),
            ks, vs]
    return [None if a is None else a.to(device) for a in args]


def _hold_ragged(args, qdtype, pool):
    """One ragged launch against its plain version (its variant's counter
    moves by one), every row (padding included: its slot clamps to 0),
    and a second launch to the same bits."""
    before = getattr(tpa, _RAGGED_COUNTER[pool])
    got = tpa.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert getattr(tpa, _RAGGED_COUNTER[pool]) == before + 1
    assert torch.equal(tpa.ragged_paged_attention(*args), got)
    ref = tpa.ragged_gather_reference(*args)
    assert torch.isfinite(got.float()).all()
    tol = _VERIFY_TOL[(qdtype, pool)]
    got, ref = got.float(), ref.float()
    assert bool(((got - ref).abs() <= tol * (1 + ref.abs())).all()), \
        float((got - ref).abs().max())


# The ragged walk (16-bit pools under their own type, int8 / fp8 pools
# under any float query) over both layouts: H = 20 at Dh = 64 and 12 at
# Dh = 128 make a full head block and a partial one. The tolerances of
# test_verify_kernel_matches_plain.
_RAGGED_PAIRS = [(torch.bfloat16, "float"), (torch.float16, "float"),
                 (torch.bfloat16, "int8"), (torch.float32, "int8"),
                 (torch.bfloat16, "fp8"), (torch.float32, "fp8")]


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype,pool", _RAGGED_PAIRS)
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("layout", ["pack_step", "mixed"])
def test_ragged_walk_matches_plain(layout, Dh, qdtype, pool, cuda_device):
    H = 20 if Dh == 64 else 12
    _hold_ragged(_ragged_case(layout, Dh, H, 16, qdtype, pool, cuda_device),
                 qdtype, pool)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype,pool", [(torch.bfloat16, "float"),
                                         (torch.bfloat16, "int8")])
@pytest.mark.parametrize("BS", [8, 12, 32])
@pytest.mark.parametrize("layout", ["pack_step", "mixed"])
def test_ragged_walk_other_block_sizes(layout, BS, qdtype, pool,
                                       cuda_device):
    """Key tiles of 8 (a page a tile), 4 (three a page) and 16 (two)."""
    _hold_ragged(_ragged_case(layout, 64, 16, BS, qdtype, pool,
                              cuda_device), qdtype, pool)


@pytest.mark.cuda
def test_ragged_walk_past_one_launch(cuda_device):
    """More tokens than one launch plans (RAGGED_MAX_TOKENS): the call is
    cut into launches, each counted, and still equals the plain
    version."""
    q, kp, vp, bt, slots, pos, _, _ = _ragged_case("pack_step", 64, 16, 16,
                                                   torch.bfloat16, "float",
                                                   cuda_device)
    reps = -(-(tpa.RAGGED_MAX_TOKENS + 100) // q.shape[0])
    args = [q.repeat(reps, 1, 1), kp, vp, bt, slots.repeat(reps),
            pos.repeat(reps)]
    before = tpa.launch_count
    got = tpa.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert tpa.launch_count - before == -(-args[0].shape[0]
                                          // tpa.RAGGED_MAX_TOKENS)
    ref = tpa.ragged_gather_reference(*args)
    tol = _VERIFY_TOL[(torch.bfloat16, "float")]
    assert bool(((got.float() - ref.float()).abs()
                 <= tol * (1 + ref.float().abs())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype,pool,walk", [
    (torch.bfloat16, "float", True), (torch.float16, "float", True),
    (torch.bfloat16, "int8", True), (torch.float32, "fp8", True),
    (torch.float32, "float", False)])
def test_ragged_routes_by_pair(qdtype, pool, walk, cuda_device):
    """The ragged entry's walk pairs reach verify_walk_kernel, fp32 pools
    keep paged_attend_kernel."""
    args = _ragged_case("pack_step", 64, 16, 16, qdtype, pool, cuda_device)
    names = _device_kernels(
        lambda: [tpa.ragged_paged_attention(*args) for _ in range(2)])
    assert any(("verify_walk_kernel" if walk else "paged_attend_kernel") in n
               for n in names), names
    assert not any(("paged_attend_kernel" if walk else "verify_walk_kernel")
                   in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype,pool", [(torch.bfloat16, "float"),
                                         (torch.float32, "float"),
                                         (torch.bfloat16, "int8"),
                                         (torch.bfloat16, "fp8")])
def test_decode_entry_matches_plain(qdtype, pool, cuda_device):
    """`paged_attention()` (one query a slot at its context length) on
    the card against the ragged entry's plain version of the same call."""
    _, kp, vp, bt, _, _, ks, vs = _ragged_case("pack_step", 64, 16, 16,
                                               qdtype, pool, cuda_device)
    lens = torch.tensor([300, 17, 64, 129, 90, 41], device=cuda_device)
    q = torch.randn(6, 16, 64, generator=torch.Generator().manual_seed(3)
                    ).to(qdtype).to(cuda_device)
    before = getattr(tpa, _RAGGED_COUNTER[pool])
    got = tpa.paged_attention(q, kp, vp, bt, lens, ks, vs)
    torch.cuda.synchronize()
    assert getattr(tpa, _RAGGED_COUNTER[pool]) == before + 1
    ref = tpa.ragged_gather_reference(
        q, kp, vp, bt, torch.arange(6, dtype=torch.int32,
                                    device=cuda_device),
        (lens - 1).int(), ks, vs)
    tol = _VERIFY_TOL[(qdtype, pool)]
    assert bool(((got.float() - ref.float()).abs()
                 <= tol * (1 + ref.float().abs())).all())


@pytest.mark.cuda
def test_verify_kernel_refuses_unsupported_operands(cuda_device):
    """A CUDA tensor the kernel does not take raises; it never runs the
    plain version instead."""
    q, kp, vp, bt, slots, pos, _, _ = _verify_case(4, 64, torch.float32,
                                                   "float", cuda_device)
    _, k8, v8, _, _, _, ks, vs = _verify_case(4, 64, torch.float32, "int8",
                                              cuda_device)
    counters = list(_VERIFY_COUNTER.values())
    before = [getattr(tpa, c) for c in counters]
    nine = q[:, :1].expand(-1, 9, -1, -1).contiguous()
    with pytest.raises(ValueError):             # G > 8
        tpa.verify_paged_attention(nine, kp, vp, bt, slots,
                                   pos[:, :1].expand(-1, 9).contiguous())
    with pytest.raises(ValueError):             # head_dim 96
        tpa.verify_paged_attention(q[..., :48].contiguous(),
                                   kp[..., :48].contiguous(),
                                   vp[..., :48].contiguous(), bt, slots,
                                   pos)
    with pytest.raises(TypeError):              # float pools with scales
        tpa.verify_paged_attention(q, kp, vp, bt, slots, pos, ks, vs)
    with pytest.raises(TypeError):              # int8 pools, no scales
        tpa.verify_paged_attention(q, k8, v8, bt, slots, pos)
    with pytest.raises(TypeError):              # int8 queries
        tpa.verify_paged_attention(q.to(torch.int8), k8, v8, bt, slots,
                                   pos, ks, vs)
    with pytest.raises(TypeError):              # fp16 scales
        tpa.verify_paged_attention(q, k8, v8, bt, slots, pos, ks.half(),
                                   vs.half())
    with pytest.raises(TypeError):              # int64 positions
        tpa.verify_paged_attention(q, kp, vp, bt, slots, pos.long())
    assert [getattr(tpa, c) for c in counters] == before


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8_e4m3"])
def test_speculative_engine_on_card(kv_dtype, cuda_device):
    """A small fp32 model served with draft_k=3 on the card: every step
    launched the engine's verify variant and its ragged variant once per
    layer, and no other paged variant. Float pools also give the CPU's
    greedy tokens and draft counts, and the card's draft_k=0 tokens."""
    torch.manual_seed(0)
    cpu = GPTForGeneration(vocab_size=193, hidden_size=128, num_layers=2,
                           num_attention_heads=2,
                           max_position_embeddings=128, device="cpu")
    card = GPTForGeneration(vocab_size=193, hidden_size=128, num_layers=2,
                            num_attention_heads=2,
                            max_position_embeddings=128,
                            device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 193, n).tolist() for n in (9, 5, 30, 3)]
    prompts[0] = [7, 8, 9] * 4                      # something to draft
    kw = dict(max_slots=4, block_size=16, max_seq_len=64,
              cache_dtype="float32", kv_dtype=kv_dtype, draft_k=3)
    eng = ServingEngine(card, device=cuda_device, **kw)
    pool = {None: "float", "int8": "int8", "fp8_e4m3": "fp8"}[kv_dtype]
    counters = list(_VERIFY_COUNTER.values()) + list(_RAGGED_COUNTER.values())
    before = {c: getattr(tpa, c) for c in counters}
    got = eng.generate_batch(prompts, max_new_tokens=12)
    moved = {c: getattr(tpa, c) - before[c] for c in counters}
    assert moved == {c: eng.steps_run * 2 if c in (
        _VERIFY_COUNTER[pool], _RAGGED_COUNTER[pool]) else 0
        for c in counters}
    assert all(len(o) == 12 for o in got)
    assert eng.kv.blocks_in_use == 0
    if kv_dtype is None:
        ref = ServingEngine(cpu, device="cpu", **kw)
        assert got == ref.generate_batch(prompts, max_new_tokens=12)
        assert (eng.spec_proposed_total, eng.spec_accepted_total) == \
            (ref.spec_proposed_total, ref.spec_accepted_total)
        plain = ServingEngine(card, device=cuda_device,
                              **dict(kw, draft_k=0))
        assert got == plain.generate_batch(prompts, max_new_tokens=12)


# --------------------------------------------- multi-tick dispatch


def _sync_guarded(eng):
    """Run every dispatch's ticks of `eng` under
    `set_sync_debug_mode("error")`: a synchronizing call between the
    ticks of a dispatch raises."""
    run_ticks = eng._run_ticks

    def guarded(d, n):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run_ticks(d, n)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    eng._run_ticks = guarded


def _small_models(device):
    torch.manual_seed(0)
    cpu = GPTForGeneration(vocab_size=193, hidden_size=128, num_layers=2,
                           num_attention_heads=2,
                           max_position_embeddings=128, device="cpu")
    card = GPTForGeneration(vocab_size=193, hidden_size=128, num_layers=2,
                            num_attention_heads=2,
                            max_position_embeddings=128, device=device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 193, n).tolist() for n in (9, 5, 30, 3)]
    prompts[0] = [7, 8, 9] * 4                      # something to draft
    return cpu, card, prompts


@pytest.mark.cuda
def test_multitick_engine_on_card_matches_cpu(cuda_device):
    """A small fp32 model, draft_k=3 with the penalties, 4 ticks a
    dispatch: the card (kernels, every dispatch's ticks under
    set_sync_debug_mode("error")) gives the CPU's greedy tokens and draft
    counts and the card's 1-tick tokens; the float verify and ragged
    variants launched once a layer a tick issued, no other variant."""
    cpu, card, prompts = _small_models(cuda_device)
    kw = dict(max_slots=4, block_size=16, max_seq_len=64,
              cache_dtype="float32", draft_k=3, ticks_per_dispatch=4,
              sampling=SamplingConfig(repetition_penalty=1.2,
                                      presence_penalty=0.5))
    eng = ServingEngine(card, device=cuda_device, **kw)
    _sync_guarded(eng)
    counters = list(_VERIFY_COUNTER.values()) + list(_RAGGED_COUNTER.values())
    before = {c: getattr(tpa, c) for c in counters}
    got = eng.generate_batch(prompts, max_new_tokens=12)
    moved = {c: getattr(tpa, c) - before[c] for c in counters}
    issued = eng.device_ticks_issued
    assert moved == {c: issued * 2 if c in (
        _VERIFY_COUNTER["float"], _RAGGED_COUNTER["float"]) else 0
        for c in counters}
    assert eng.device_ticks_run > eng.dispatches_run
    assert eng.kv.blocks_in_use == 0
    ref = ServingEngine(cpu, device="cpu", **kw)
    assert got == ref.generate_batch(prompts, max_new_tokens=12)
    assert (eng.spec_proposed_total, eng.spec_accepted_total) == \
        (ref.spec_proposed_total, ref.spec_accepted_total)
    one = ServingEngine(card, device=cuda_device,
                        **dict(kw, ticks_per_dispatch=1))
    assert got == one.generate_batch(prompts, max_new_tokens=12)


@pytest.mark.cuda
@pytest.mark.parametrize("draft_k", [0, 3])
def test_multitick_sampling_on_card_never_syncs(draft_k, cuda_device):
    """Seeded penalized top-p sampling at 4 ticks a dispatch, every
    dispatch's ticks under set_sync_debug_mode("error"), with an EOS
    taken from the 1-tick run at each of several places: the same
    tokens as the 1-tick engine on the card each time, and at least one
    dispatch issued ticks past its exit (the generator is set back
    there)."""
    _, card, prompts = _small_models(cuda_device)
    kw = dict(max_slots=4, block_size=16, max_seq_len=64,
              cache_dtype="float32", draft_k=draft_k, seed=3,
              sampling=SamplingConfig(strategy="sampling", temperature=0.9,
                                      top_p=0.95, repetition_penalty=1.2,
                                      frequency_penalty=0.3))
    free = ServingEngine(card, device=cuda_device, **kw).generate_batch(
        prompts, max_new_tokens=12)
    wasted = 0
    for req, at in ((1, 3), (0, 2), (2, 3), (3, 4)):
        eos = free[req][at]
        eng = ServingEngine(card, device=cuda_device, ticks_per_dispatch=4,
                            eos_token_id=eos, **kw)
        _sync_guarded(eng)
        got = eng.generate_batch(prompts, max_new_tokens=12)
        one = ServingEngine(card, device=cuda_device, eos_token_id=eos, **kw)
        assert got == one.generate_batch(prompts, max_new_tokens=12)
        assert got[req][-1] == eos
        assert eng.device_ticks_run > eng.dispatches_run
        assert eng.kv.blocks_in_use == 0
        wasted += eng.device_ticks_issued - eng.device_ticks_run
    assert wasted > 0


# ------------------------------------------------ the observability plane


@pytest.mark.cuda
@pytest.mark.parametrize("ticks,draft_k", [(1, 0), (4, 3)])
def test_recording_changes_no_token_or_launch_on_card(ticks, draft_k,
                                                      cuda_device):
    """A small fp32 engine with metrics and tracing on gives the tokens
    and paged-kernel launches it gives with them off; at 4 ticks a
    dispatch every dispatch's ticks run under set_sync_debug_mode(
    "error") with recording on (no hook reads the card). Every request's
    trace closes "finished" and the flight recorder notes every step."""
    from paddle_tpu_torch.serving import metrics as sm
    from paddle_tpu_torch.serving import tracing
    _, card, prompts = _small_models(cuda_device)
    kw = dict(max_slots=4, block_size=16, max_seq_len=64,
              cache_dtype="float32", draft_k=draft_k,
              ticks_per_dispatch=ticks)
    counters = list(_VERIFY_COUNTER.values()) + list(_RAGGED_COUNTER.values())
    runs = {}
    try:
        for on in (False, True):
            tracing.recording(on)
            eng = ServingEngine(card, device=cuda_device, **kw)
            if ticks > 1:
                _sync_guarded(eng)
            before = {c: getattr(tpa, c) for c in counters}
            out = eng.generate_batch(prompts, max_new_tokens=12)
            torch.cuda.synchronize()
            runs[on] = (out, {c: getattr(tpa, c) - before[c]
                              for c in counters}, eng)
        (off, off_n, _), (got, got_n, eng) = runs[False], runs[True]
        assert got == off and got_n == off_n
        assert sum(got_n.values()) > 0
        traces = tracing.TRACER.traces()
        assert len(traces) == len(prompts)
        assert all(t.outcome == "finished" and t.monotone() for t in traces)
        assert tracing.TRACER.active() == []
        assert eng.flight.steps == eng.steps_run
        assert sm.SERVING_STEPS.value == eng.steps_run
        assert sm.SERVING_TTFT_SECONDS.count == len(prompts)
    finally:
        tracing.recording(False)


@pytest.mark.cuda
def test_profiler_device_table_names_paged_kernel(cuda_device):
    """The port's Profiler over a few decode steps reads the paged
    kernel among the device kernels and names it in the summary."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.profiler import statistic
    _, card, prompts = _small_models(cuda_device)
    eng = ServingEngine(card, device=cuda_device, max_slots=4,
                        block_size=16, max_seq_len=64,
                        cache_dtype="float32")
    for p in prompts:
        eng.submit(p, 12)
    eng.step()
    prof = profiler.Profiler()
    with prof:
        for _ in range(4):
            with profiler.RecordEvent("decode_step"):
                eng.step()
        torch.cuda.synchronize()
    eng.run()
    kernels = statistic.device_kernel_times(prof._prof)
    paged = [k for k in kernels if any(n in k for n in (
        "paged_attend_kernel", "verify_walk_kernel", "ragged_plan_kernel"))]
    assert paged, sorted(kernels)
    text = prof.summary()
    assert statistic.NO_DEVICE_KERNELS not in text
    assert "decode_step" in text and paged[0][:64] in text


# ------------------------------------------------- add_ln (K2) kernels


def _ln_case(shape, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    d = shape[-1]
    x, r, gout, gz = (torch.randn(shape, generator=g).to(dtype)
                      for _ in range(4))
    w, b = torch.rand(d, generator=g), torch.randn(d, generator=g)
    return [t.to(device) for t in (x, r, w, b, gout, gz)]


# fp32: the same fp32 arithmetic in another summation order -> 1e-5.
# bf16: both round out, z and dz to bf16 from fp32 math, whose sums
# differ in order: one bf16 spacing (2^-7 relative) at worst.
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 200, 1024), (5, 100), (2, 4096),
                                   (7, 33)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_add_ln_kernels_match_plain(shape, dtype, tol, cuda_device):
    x, r, w, b, gout, gz = _ln_case(shape, dtype, cuda_device)
    d = shape[-1]
    x2, r2 = x.reshape(-1, d), r.reshape(-1, d)
    before = tln.fwd_launch_count
    got = tln._launch_fwd(x2, r2, w, b, 1e-5)
    torch.cuda.synchronize()
    assert tln.fwd_launch_count == before + 1
    want = tln.add_ln_fwd_reference(x2, r2, w, b, 1e-5)
    for a, e in zip(got, want):
        torch.testing.assert_close(a.float(), e.float(), rtol=tol, atol=tol)
    z, mu, rs = want[1], want[2], want[3]
    g2, gz2 = gout.reshape(-1, d), gz.reshape(-1, d)
    before = tln.bwd_launch_count
    dz = tln._launch_bwd(z, w, mu, rs, g2, gz2)[0]
    torch.cuda.synchronize()
    assert tln.bwd_launch_count == before + 1
    torch.testing.assert_close(
        dz.float(),
        tln.add_ln_bwd_reference(z, w, mu, rs, g2, gz2)[0].float(),
        rtol=tol, atol=tol)


# The persistent kernels where their cuts fall: row groups of one warp
# (d <= 1024), two and four (1 x 4096), rows that leave some groups idle
# (7, 15) or end off a wave (4097), the train step's 8192 x 1024, d off
# the 16-byte vector (33, 100 in bf16/fp16: V = 1) and views offset by one
# element (V = 1 at every d). out, z, mu, rstd and dz at the tolerances
# of test_add_ln_kernels_match_plain (fp16: one spacing, 2^-10
# relative); dw and db, fp32 sums over rows in another order, within
# 1e-6 of each column's sum of |terms| (chip_smoke.py's bound).
_LN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}


def _ln_offset(t, offset):
    """t's values in a contiguous view `offset` elements into a buffer."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8192, 1024), (7, 100), (15, 33),
                                   (1, 4096), (4097, 768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("offset", [0, 1])
def test_add_ln_persistent_kernels_match_plain(shape, dtype, offset,
                                               cuda_device):
    x, r, w, b, gout, gz = _ln_case(shape, dtype, cuda_device, seed=7)
    x, r, gout, gz = (_ln_offset(t, offset) for t in (x, r, gout, gz))
    tol = _LN_TOL[dtype]
    got = tln._launch_fwd(x, r, w, b, 1e-5)
    again = tln._launch_fwd(x, r, w, b, 1e-5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    want = tln.add_ln_fwd_reference(x, r, w, b, 1e-5)
    for a, e in zip(got, want):
        assert bool(torch.isfinite(a.float()).all())
        torch.testing.assert_close(a.float(), e.float(), rtol=tol, atol=tol)
    z, mu, rs = want[1], want[2], want[3]
    before = tln.bwd_launch_count
    dz, dw, db = tln._launch_bwd(z, w, mu, rs, gout, gz)
    again = tln._launch_bwd(z, w, mu, rs, gout, gz)
    torch.cuda.synchronize()
    assert tln.bwd_launch_count == before + 2
    assert all(torch.equal(a, c) for a, c in zip((dz, dw, db), again))
    ref_dz, ref_dw, ref_db = tln.add_ln_bwd_reference(z, w, mu, rs, gout, gz)
    torch.testing.assert_close(dz.float(), ref_dz.float(), rtol=tol,
                               atol=tol)
    zhat = (z.float() - mu[:, None]) * rs[:, None]
    for got_s, ref_s, terms in ((dw, ref_dw, gout.float() * zhat),
                                (db, ref_db, gout.float())):
        assert got_s.dtype == torch.float32 and got_s.shape == (shape[1],)
        bound = 1e-6 * terms.abs().sum(0)
        assert bool(((got_s - ref_s).abs() <= bound).all()), \
            float(((got_s - ref_s).abs() / bound).max())


@pytest.mark.cuda
def test_add_ln_grads_through_autograd_on_card(cuda_device):
    """`add_ln` differentiated on the card returns the backward kernel's
    dw and db (through the fp32 cast of bf16 w and b), one launch of
    each kernel, equal to the autograd reference's."""
    x, r, w, b, gout, gz = _ln_case((3, 50, 1024), torch.bfloat16,
                                    cuda_device, seed=8)
    args = [t.clone().requires_grad_() for t in (x, r, w.bfloat16(),
                                                 b.bfloat16())]
    before = (tln.fwd_launch_count, tln.bwd_launch_count)
    out, z = tln.add_ln(*args)
    got = torch.autograd.grad((out, z), args, (gout, gz))
    torch.cuda.synchronize()
    assert (tln.fwd_launch_count, tln.bwd_launch_count) == (
        before[0] + 1, before[1] + 1)
    ref = [t.detach().clone().requires_grad_() for t in args]
    want = torch.autograd.grad(tln.add_ln_reference(*ref), ref, (gout, gz))
    for a, e in zip(got, want):
        assert a.dtype == e.dtype
        torch.testing.assert_close(a.float(), e.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
def test_add_ln_kernel_refuses_unsupported_operands(cuda_device):
    x, r, w, b, _, _ = _ln_case((4, 64), torch.float32, cuda_device)
    with pytest.raises(TypeError):
        tln.add_ln(x.double(), r.double(), w, b)
    with pytest.raises(ValueError):
        tln.add_ln(*_ln_case((2, 4097), torch.float32, cuda_device)[:4])


# ------------------------------------------- flash attention (K1a)


def _fa_case(B, H, S, D, dtype, device, seed=0):
    """q, k, v, dout; q scaled by 1/sqrt(D) as `splash_mha` hands it to
    the kernels, so the logits are O(1) as in a model."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(B, H, S, D, generator=g) for _ in range(4))
    return [t.to(dtype).to(device) for t in (q * D ** -0.5, k, v, dout)]


# fp32: fp32 products and softmax on both sides, sums in another order
# -> rtol 2e-5; atol 1e-4 because ds = p * (dp - delta) subtracts two
# D-term dot products of size ~sqrt(D) that nearly cancel (exactly so
# at S = 1, where dq and dk are pure rounding: 2.3e-5 seen at D=128).
# bf16/fp16: the kernel and the plain version both multiply the same
# 16-bit operands in fp32, round p and ds to that dtype before the
# products they feed and round the outputs once: one or two spacings of
# values up to ~4 (bf16 2^-6, fp16 2^-9).
@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 64, 200, 256])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 1e-4),
                                             (torch.bfloat16, 3e-2, 3e-2),
                                             (torch.float16, 4e-3, 4e-3)])
def test_flash_kernels_match_plain(S, D, causal, dtype, rtol, atol,
                                   cuda_device):
    q, k, v, dout = _fa_case(2, 3, S, D, dtype, cuda_device, seed=S + D)
    before = tfa.fwd_launch_count
    out, lse = tfa._launch_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert tfa.fwd_launch_count == before + 1
    ref_out, ref_lse = tfa.flash_fwd_reference(q, k, v, causal)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(lse, ref_lse, rtol=2e-5, atol=2e-5)
    before = tfa.bwd_launch_count
    got = tfa._launch_bwd(q, k, v, ref_out, ref_lse, dout, causal)
    torch.cuda.synchronize()
    assert tfa.bwd_launch_count == before + 1
    want = tfa.flash_bwd_reference(q, k, v, ref_out, ref_lse, dout, causal)
    for a, e in zip(got, want):
        torch.testing.assert_close(a.float(), e.float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.cuda
def test_splash_mha_on_card_matches_autograd_reference(cuda_device):
    q, k, v, dout = _fa_case(2, 4, 200, 64, torch.float32, cuda_device)
    args = [t.requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(tfa.splash_mha(*args), args, dout)
    want = torch.autograd.grad(
        tfa.attention_reference(*args, 1 / 8, True), args, dout)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=2e-5, atol=1e-4)


@pytest.mark.cuda
def test_flash_kernel_refuses_unsupported_operands(cuda_device):
    q, k, v, _ = _fa_case(1, 2, 64, 64, torch.float32, cuda_device)
    with pytest.raises(TypeError):
        tfa.splash_mha(q.double(), k.double(), v.double())
    q, k, v, _ = _fa_case(1, 2, 64, 32, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.splash_mha(q, k, v)


# K1a's 16-bit kernels where their tiles cut: S off the forward's 128-row
# query and key tiles and the backward's 64-row walked tiles (1, 63, 65,
# 127, 129, 200, 1000: TMA zero-fills past S, the keys there get p = 0
# and only rows below S are stored), S on them (64, 128, 1024), D 64 and
# 128, causal and full; out, lse and the backward from the plain (out,
# lse). Tolerances of test_flash_kernels_match_plain.
@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 200, 1000,
                               1024])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2),
                                       (torch.float16, 4e-3)])
def test_flash_wgmma_across_its_tiles(S, D, causal, dtype, tol,
                                      cuda_device):
    q, k, v, dout = _fa_case(2, 3, S, D, dtype, cuda_device, seed=S + D + 2)
    before = (tfa.fwd_launch_count, tfa.bwd_launch_count)
    out, lse = tfa._launch_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    ref_out, ref_lse = tfa.flash_fwd_reference(q, k, v, causal)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=2e-5, atol=2e-5)
    got = tfa._launch_bwd(q, k, v, ref_out, ref_lse, dout, causal)
    torch.cuda.synchronize()
    assert (tfa.fwd_launch_count, tfa.bwd_launch_count) == (
        before[0] + 1, before[1] + 1)
    want = tfa.flash_bwd_reference(q, k, v, ref_out, ref_lse, dout, causal)
    for a, e in zip(got, want):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a.float(), e.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_flash_wgmma_bit_identical_across_launches(D, cuda_device):
    """At the train step's [8, 16, 1024, D] bf16 causal, two launches of
    K1a's forward (out, lse) and of its backward give the same bits."""
    q, k, v, dout = _fa_case(8, 16, 1024, D, torch.bfloat16, cuda_device)
    first = tfa._launch_fwd(q, k, v, True)
    second = tfa._launch_fwd(q, k, v, True)
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    out, lse = first
    first = tfa._launch_bwd(q, k, v, out, lse, dout, True)
    second = tfa._launch_bwd(q, k, v, out, lse, dout, True)
    assert all(torch.equal(a, c) for a, c in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_fwd_routes_by_dtype_and_segments(dtype, cuda_device):
    """K1a's and K1c's forwards: bf16 and fp16 reach the wgmma forward
    (flash_fwd_bshd_wgmma_kernel; K1c after its seg_ranges_kernel), fp32
    the CUDA-core flash_fwd_kernel; no flash_fwd_mma_kernel runs. Each
    forward runs twice in the profiled window: the profiler has been
    seen to miss the window's first kernel."""
    q, k, v, _ = _fa_case(2, 2, 200, 64, dtype, cuda_device)
    seg = torch.ones(2, 200, dtype=torch.int32, device=cuda_device)
    fp32 = dtype == torch.float32
    before = tfa.fwd_launch_count
    names = _device_kernels(
        lambda: [tfa._launch_fwd(q, k, v, True) for _ in range(2)])
    assert tfa.fwd_launch_count == before + 2
    assert any(("flash_fwd_kernel" if fp32 else "flash_fwd_bshd_wgmma_kernel")
               in n for n in names), names
    assert not any("flash_fwd_mma_kernel" in n for n in names), names
    assert any("flash_fwd_kernel" in n for n in names) == fp32, names
    before = tfa.seg_launch_count
    names = _device_kernels(
        lambda: [tfa._launch_fwd_seg(q, k, v, seg, True) for _ in range(2)])
    assert tfa.seg_launch_count == before + 2
    assert any(("flash_fwd_kernel" if fp32 else "flash_fwd_bshd_wgmma_kernel")
               in n for n in names), names
    assert any("seg_ranges_kernel" in n for n in names) == (not fp32), names
    assert not any("flash_fwd_mma_kernel" in n for n in names), names
    assert any("flash_fwd_kernel" in n for n in names) == fp32, names


# ---------------------------------------------- the train step (K1a+K2)


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device):
    """Three fp32 steps of a small model on the card (kernels) and on
    the CPU (plain versions) from the same parameters: losses within
    1e-4 relative, every kernel launched as remat predicts."""
    cfg = th.GPTConfig(vocab_size=193, seq_len=200, d_model=128,
                       n_heads=2, n_layers=2, remat=True, ce_seq_chunks=2,
                       compute_dtype=torch.float32, learning_rate=1e-3)
    cpu = th.HybridGPT(cfg, device="cpu")
    card = th.HybridGPT(cfg, device=cuda_device)
    pc, oc = cpu.init(seed=0)

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.to(cuda_device)
                for k, v in tree.items()}
    pg, og = to_card(pc), to_card(oc)
    rng = np.random.RandomState(0)
    tok = rng.randint(0, 193, (2, 200))
    lab = rng.randint(0, 193, (2, 200))
    counts = (tfa.fwd_launch_count, tfa.bwd_launch_count,
              tln.fwd_launch_count, tln.bwd_launch_count)
    for step in range(1, 4):
        pc, oc, lc = cpu.train_step(pc, oc, tok, lab, step_num=step)
        pg, og, lg = card.train_step(pg, og, tok, lab, step_num=step)
        assert math.isclose(float(lg), float(lc), rel_tol=1e-4)
    L = cfg.n_layers
    assert (tfa.fwd_launch_count - counts[0], tfa.bwd_launch_count
            - counts[1], tln.fwd_launch_count - counts[2],
            tln.bwd_launch_count - counts[3]) == (6 * L, 3 * L, 6 * L,
                                                  3 * L)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(remat_policy="save_splash_residuals"),
                                dict(remat_policy="save_splash_residuals",
                                     qkv_kernel=True),
                                dict(qkv_kernel=True)])
def test_train_step_variants_on_card_match_cpu(kw, cuda_device):
    """One fp32 step with bench_gpt's remat policy and/or the fused QKV
    projection on the card (kernels) and on the CPU (plain versions):
    losses within 1e-4 relative; per step the flash forward runs once a
    layer under the policy (twice without), the projection twice."""
    cfg = th.GPTConfig(vocab_size=193, seq_len=200, d_model=128,
                       n_heads=2, n_layers=2, remat=True, ce_seq_chunks=2,
                       compute_dtype=torch.float32, learning_rate=1e-3,
                       **kw)
    cpu = th.HybridGPT(cfg, device="cpu")
    card = th.HybridGPT(cfg, device=cuda_device)
    pc, oc = cpu.init(seed=0)

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.to(cuda_device)
                for k, v in tree.items()}
    pg, og = to_card(pc), to_card(oc)
    rng = np.random.RandomState(1)
    tok = rng.randint(0, 193, (2, 200))
    lab = rng.randint(0, 193, (2, 200))
    counts = (tfa.fwd_launch_count, tfa.bwd_launch_count,
              tqp.launch_count)
    _, _, lc = cpu.train_step(pc, oc, tok, lab)
    _, _, lg = card.train_step(pg, og, tok, lab)
    assert math.isclose(float(lg), float(lc), rel_tol=1e-4)
    L = cfg.n_layers
    fwd = L if kw.get("remat_policy") else 2 * L
    qkv = 2 * L if kw.get("qkv_kernel") else 0
    assert (tfa.fwd_launch_count - counts[0], tfa.bwd_launch_count
            - counts[1], tqp.launch_count - counts[2]) == (fwd, L, qkv)


# ------------------------------------------------ fused QKV projection (K5)


def _qkv_case(B, S, d, H, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, d, generator=g)
    w = torch.randn(d, 3 * H * 64, generator=g) * d ** -0.5
    b = torch.randn(3 * H * 64, generator=g) * 0.1
    return [t.to(dtype).to(device) for t in (x, w, b)]


# fp32: sums of d products in another order -> 1e-5 relative, atol 1e-4
# on values ~1. bf16/fp16: kernel and plain version both round
# fp32(product) + fp32(bias) once; summation order can flip that
# rounding: one spacing (bf16 2^-7 relative, fp16 2^-10).
@pytest.mark.cuda
@pytest.mark.parametrize("B,S,d,H", [(2, 64, 256, 4), (1, 200, 128, 2),
                                     (3, 33, 72, 6), (1, 1, 1024, 16)])
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-5, 1e-4),
                                             (torch.bfloat16, 1e-2, 1e-2),
                                             (torch.float16, 2e-3, 2e-3)])
def test_qkv_proj_kernel_matches_plain(B, S, d, H, dtype, rtol, atol,
                                       cuda_device):
    x, w, b = _qkv_case(B, S, d, H, dtype, cuda_device, seed=S + d)
    before = tqp.launch_count
    got = tqp.qkv_proj(x, w, b, H)
    torch.cuda.synchronize()
    assert tqp.launch_count == before + 1
    want = tqp.qkv_proj_reference(x, w, b, H)
    for a, e in zip(got, want):
        assert a.shape == (B, H, S, 64) and a.dtype == dtype
        torch.testing.assert_close(a.float(), e.float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.cuda
def test_qkv_proj_grads_on_card_match_cpu(cuda_device):
    x, w, b = _qkv_case(2, 64, 128, 2, torch.float32, "cpu", seed=3)
    grads = []
    for dev in ("cpu", cuda_device):
        args = [t.to(dev).requires_grad_() for t in (x, w, b)]
        q, k, v = tqp.qkv_proj(*args, 2)
        loss = (torch.sin(q) + 2 * torch.cos(k) + v ** 2).sum()
        grads.append(torch.autograd.grad(loss, args))
    for a, e in zip(grads[1], grads[0]):
        torch.testing.assert_close(a.cpu(), e, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_qkv_proj_kernel_refuses_unsupported_operands(cuda_device):
    x, w, b = _qkv_case(1, 8, 128, 2, torch.float32, cuda_device)
    with pytest.raises(TypeError):
        tqp.qkv_proj(x.double(), w.double(), b.double(), 2)
    with pytest.raises(TypeError):
        tqp.qkv_proj(x, w.half(), b, 2)
    with pytest.raises(ValueError, match="even H"):
        tqp.qkv_proj(x, w, b, 4)                  # head_dim 32
    x3, w3, b3 = _qkv_case(1, 8, 128, 3, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="even H"):
        tqp.qkv_proj(x3, w3, b3, 3)
    with pytest.raises(ValueError, match="16 bytes"):
        tqp.qkv_proj(x[..., :66].contiguous(), w[:66].contiguous(), b, 2)
    x2, _, _ = _qkv_case(2, 8, 128, 2, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tqp.qkv_proj(x2.transpose(0, 1), w, b, 2)


def _device_kernels(fn):
    """Names of the device kernels `fn` launched, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


# The wgmma kernel where its cuts fall: B * S off the 128-row tile with
# tiles whose rows cross a batch (S = 33, 100, 1: the row-by-row stores),
# d off the 64-deep stage (72, 200: TMA zero-fills past d), H = 2 (a
# third 128 columns wide, so 256-column tiles straddle q, k and v) and
# H = 6. The same operands and single rounding as the plain version,
# fp32 sums in another order: the tolerances of
# test_qkv_proj_kernel_matches_plain.
@pytest.mark.cuda
@pytest.mark.parametrize("B,S,d,H", [(3, 33, 72, 6), (2, 200, 200, 2),
                                     (4, 100, 136, 6), (5, 1, 200, 2)])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float16, 2e-3)])
def test_qkv_proj_wgmma_across_its_tiles(B, S, d, H, dtype, tol,
                                         cuda_device):
    x, w, b = _qkv_case(B, S, d, H, dtype, cuda_device, seed=B + S + d)
    got = tqp.qkv_proj(x, w, b, H)
    want = tqp.qkv_proj_reference(x, w, b, H)
    for a, e in zip(got, want):
        assert a.shape == (B, H, S, 64) and a.dtype == dtype
        torch.testing.assert_close(a.float(), e.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_qkv_proj_wgmma_bit_identical_across_launches(dtype, cuda_device):
    """At the train step's shape, two launches give the same bits (no
    atomics; each output element is one block's fixed-order sum)."""
    x, w, b = _qkv_case(8, 1024, 1024, 16, dtype, cuda_device)
    first = tqp.qkv_proj(x, w, b, 16)
    second = tqp.qkv_proj(x, w, b, 16)
    assert all(torch.equal(a, c) for a, c in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_qkv_proj_routes_by_dtype(dtype, cuda_device):
    """fp32 reaches the CUDA-core qkv_proj_kernel, bf16 and fp16 the
    wgmma kernel, and the counter counts one launch."""
    x, w, b = _qkv_case(2, 64, 128, 2, dtype, cuda_device)
    before = tqp.launch_count
    names = _device_kernels(lambda: tqp.qkv_proj(x, w, b, 2))
    assert tqp.launch_count == before + 1
    fp32 = dtype == torch.float32
    assert any(("qkv_proj_kernel" if fp32 else "qkv_proj_wgmma_kernel") in n
               for n in names), names
    assert not any(("qkv_proj_wgmma_kernel" if fp32 else "qkv_proj_kernel")
                   in n for n in names), names


# ------------------------------------- paddle-layout flash forward (K1b)


def _bshd_case(B, S, H, D, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, S, H, D, generator=g).to(dtype).to(device)
            for _ in range(4)]


# fp32: fp32 scores and softmax on both sides, sums in another order.
# bf16/fp16: both scale and round q, round p to the operand dtype
# before p @ v (the kernel relative to its running max, the plain
# version to the row's) and round the output once: a spacing or two.
@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 64, 200, 256])
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2),
                                       (torch.float16, 4e-3)])
def test_flash_bshd_kernel_matches_plain(S, D, causal, dtype, tol,
                                         cuda_device):
    q, k, v, _ = _bshd_case(2, S, 3, D, dtype, cuda_device, seed=S + D)
    scale = D ** -0.5
    before = tfa.bshd_launch_count
    got = tfa._launch_fwd_bshd(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert tfa.bshd_launch_count == before + 1
    want = tfa.flash_fwd_bshd_reference(q, k, v, scale, causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# The wgmma kernel where its cuts fall: S off the 128-row query tile and
# the key tiles (1, 127, 129, 200, 1000; TMA zero-fills past S and the
# keys there get -inf), D = 128 and 256, causal and full, with a scale
# that is not a power of two at both D (the query is scaled and rounded
# in its dtype before the products). Tolerances of
# test_flash_bshd_kernel_matches_plain.
@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 127, 129, 200, 1000])
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2),
                                       (torch.float16, 4e-3)])
def test_flash_bshd_wgmma_across_its_tiles(S, D, causal, dtype, tol,
                                           cuda_device):
    q, k, v, _ = _bshd_case(2, S, 3, D, dtype, cuda_device, seed=S + D + 1)
    scale = 0.0711 if D == 256 else D ** -0.5
    before = tfa.bshd_launch_count
    got = tfa._launch_fwd_bshd(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert tfa.bshd_launch_count == before + 1
    assert bool(torch.isfinite(got).all())
    want = tfa.flash_fwd_bshd_reference(q, k, v, scale, causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("H,D", [(16, 128), (8, 256)])
def test_flash_bshd_wgmma_bit_identical_across_launches(H, D, cuda_device):
    """At the entry's shapes, causal, two launches give the same bits."""
    q, k, v, _ = _bshd_case(8, 1024, H, D, torch.bfloat16, cuda_device)
    first = tfa._launch_fwd_bshd(q, k, v, D ** -0.5, True)
    second = tfa._launch_fwd_bshd(q, k, v, D ** -0.5, True)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_bshd_routes_by_dtype(dtype, cuda_device):
    """fp32 reaches the CUDA-core flash_fwd_kernel, bf16 and fp16 the
    wgmma kernel, and the counter counts one launch."""
    q, k, v, _ = _bshd_case(2, 200, 3, 128, dtype, cuda_device)
    before = tfa.bshd_launch_count
    names = _device_kernels(
        lambda: tfa._launch_fwd_bshd(q, k, v, 128 ** -0.5, True))
    assert tfa.bshd_launch_count == before + 1
    fp32 = dtype == torch.float32
    assert any(("flash_fwd_kernel" if fp32 else "flash_fwd_bshd_wgmma_kernel")
               in n for n in names), names
    assert not any(("flash_fwd_bshd_wgmma_kernel" if fp32 else
                    "flash_fwd_kernel") in n for n in names), names


@pytest.mark.cuda
def test_flash_attention_on_card_matches_autograd_reference(cuda_device):
    q, k, v, dout = _bshd_case(2, 256, 4, 128, torch.float32, cuda_device)
    args = [t.requires_grad_() for t in (q, k, v)]
    out = tfa.flash_attention(*args, causal=True)
    got = torch.autograd.grad(out, args, dout)
    ref = tfa.attention_bshd_reference(*args, 128 ** -0.5, True)
    want = torch.autograd.grad(ref, args, dout)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=0, atol=0)


@pytest.mark.cuda
def test_flash_bshd_kernel_refuses_unsupported_operands(cuda_device):
    q, k, v, _ = _bshd_case(1, 64, 2, 128, torch.float32, cuda_device)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.double(), k.double(), v.double())
    q, k, v, _ = _bshd_case(1, 64, 2, 384, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(q, k, v)
    q, k, v, _ = _bshd_case(2, 64, 2, 128, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q.transpose(0, 1), k.transpose(0, 1),
                            v.transpose(0, 1))


# ----------------------------------------------- split-K 1x1 wgrad (K6)


# fp32 sums on both sides (16-bit products are exact in fp32), the
# kernel's ranges and the plain version's chunks summed in other orders:
# 1e-5 relative on values ~sqrt(N), atol 1e-3. Beside small and ragged
# shapes, ResNet-50's 1x1 channel pairs (the output tile 256 x 64 or
# 128 along the wider side, transposed where Co > Ci) at small N, N off
# the 32-row stage where it is 1000 or 196.
@pytest.mark.cuda
@pytest.mark.parametrize("N,Ci,Co,chunk", [(512, 128, 128, 128),
                                           (4096, 256, 64, 4096),
                                           (1000, 72, 40, 200),
                                           (96, 8, 8, 48),
                                           (3136, 64, 256, 448),
                                           (3136, 256, 64, 3136),
                                           (784, 256, 512, 784),
                                           (784, 1024, 256, 392),
                                           (196, 512, 2048, 196),
                                           (196, 2048, 512, 49)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_wgrad_kernel_matches_plain(N, Ci, Co, chunk, dtype, cuda_device):
    g = torch.Generator().manual_seed(N + Ci)
    x = torch.randn(N, Ci, generator=g).to(dtype).to(cuda_device)
    dy = torch.randn(N, Co, generator=g).to(dtype).to(cuda_device)
    before = tcw.launch_count
    got = tcw.wgrad_1x1(x, dy, chunk=chunk)
    torch.cuda.synchronize()
    assert tcw.launch_count == before + 1
    want = tcw.wgrad_1x1_reference(x, dy, chunk=chunk)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    assert torch.equal(tcw.wgrad_1x1(x, dy, chunk=chunk), got)  # same bits


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_kernel_takes_more_than_65535_chunks(dtype, cuda_device):
    """N = 2^20 at chunk 16: 65536 chunks, which the kernel's split does
    not see (JAX takes any N % chunk == 0). The plain version adds 65536
    chunk products one after another into sums of ~1000, so its own
    rounding is held as chip_smoke.py holds K6: each element within 1e-6
    of its sum's absolute mass sum_n |x[n, i] dy[n, j]|."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2 ** 20, 16, generator=g).to(dtype).to(cuda_device)
    dy = torch.randn(2 ** 20, 16, generator=g).to(dtype).to(cuda_device)
    got = tcw.wgrad_1x1(x, dy, chunk=16)
    want = tcw.wgrad_1x1_reference(x, dy, chunk=16)
    mass = x.float().abs().t() @ dy.float().abs()
    assert bool(((got - want).abs() <= 1e-6 * mass).all()), \
        float(((got - want).abs() / mass).max())
    assert torch.equal(tcw.wgrad_1x1(x, dy, chunk=16), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_wgrad_routes_by_dtype(dtype, cuda_device):
    """bf16 and fp16 reach the one-launch wgmma kernel; fp32 the CUDA-core
    kernel and its sum of the ranges. Two calls in the profiled window:
    the profiler has been seen to miss the window's first kernel."""
    x = torch.randn(4096, 256, device=cuda_device).to(dtype)
    dy = torch.randn(4096, 64, device=cuda_device).to(dtype)
    names = _device_kernels(
        lambda: [tcw.wgrad_1x1(x, dy, chunk=512) for _ in range(2)])
    fp32 = dtype == torch.float32
    want = ({"wgrad_fp32_kernel", "wgrad_sum_kernel"} if fp32
            else {"wgrad_wgmma_kernel"})
    kernels = ("wgrad_fp32_kernel", "wgrad_sum_kernel", "wgrad_wgmma_kernel")
    assert {k for k in kernels if any(k in n for n in names)} == want, names


@pytest.mark.cuda
def test_wgrad_kernel_refuses_unsupported_operands(cuda_device):
    x = torch.randn(64, 16, device=cuda_device)
    dy = torch.randn(64, 16, device=cuda_device)
    with pytest.raises(TypeError):
        tcw.wgrad_1x1(x.double(), dy.double(), chunk=32)
    with pytest.raises(TypeError):
        tcw.wgrad_1x1(x, dy.half(), chunk=32)
    with pytest.raises(ValueError, match="16 bytes"):
        tcw.wgrad_1x1(x[:, :6].contiguous(), dy, chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        tcw.wgrad_1x1(x.t().contiguous().t(), dy, chunk=32)
    with pytest.raises(ValueError, match="divisible"):
        tcw.wgrad_1x1(x, dy, chunk=48)


# --------------------------------------------- grouped matmul (K4) kernels


_GMM_XDT = {"fp32": torch.float32, "fp16": torch.float16,
            "int8-fp16": torch.float16, "int4-fp16": torch.float16,
            "int8-fp32": torch.float32, "int4-fp32": torch.float32}


def _gmm_case(E, C, D, F, variant, device, seed=0):
    """(x, w, scale) of one variant: "fp32" / "bf16" / "fp16" float
    experts, "int8" / "int4" quantized experts under bf16 activations
    ("-fp16" / "-fp32" suffixed: under those)."""
    g = torch.Generator().manual_seed(seed)
    xdt = _GMM_XDT.get(variant, torch.bfloat16)
    variant = variant.split("-")[0]
    x = torch.randn(E, C, D, generator=g).to(xdt)
    w = torch.randn(E, D, F, generator=g) / math.sqrt(D)
    scale = None
    if variant in ("fp32", "bf16", "fp16"):
        w = w.to(xdt)
    elif variant == "int8":
        w = torch.randint(-127, 128, (E, D, F), generator=g,
                          dtype=torch.int8)
        scale = torch.rand(E, F, generator=g) * 0.05 + 0.01
    else:
        q = torch.randint(-7, 8, (E, D, F), generator=g, dtype=torch.int8)
        w = tgmm.pack_int4(q)
        scale = (torch.rand(E, F, generator=g) * 0.3 + 0.05).half()
    return [None if t is None else t.to(device) for t in (x, w, scale)]


_GMM_COUNTERS = {"fp32": "fp_launch_count", "bf16": "fp_launch_count",
                 "fp16": "fp_launch_count", "int8": "int8_launch_count",
                 "int4": "int4_launch_count"}


def _gmm_counter(variant):
    return _GMM_COUNTERS[variant.split("-")[0]]


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 5, 80, 200])
@pytest.mark.parametrize("E,D,F", [(2, 64, 72), (3, 38, 50), (1, 96, 8)])
@pytest.mark.parametrize("variant", ["fp32", "bf16", "fp16", "int8",
                                     "int4", "int8-fp16", "int4-fp16"])
def test_gmm_kernels_match_plain(C, E, D, F, variant, cuda_device):
    """Each K4 kernel against the plain version on the card, at ragged
    shapes (C across one and two 128-row passes of the mma kernel and
    three 80-row chunks of the wgmma one; D and F off the tiles; F = 50
    and D = 38 rows take the element-wise loads). fp32: sums in another
    order, 1e-4. 16-bit outputs: the same 16-bit operands (the quantized
    kernels round the dequantized weights where the plain version
    does), multiplied in fp32, one output rounding — 1e-2."""
    x, w, scale = _gmm_case(E, C, D, F, variant, cuda_device)
    counts = {n: getattr(tgmm, n) for n in set(_GMM_COUNTERS.values())}
    got = tgmm.grouped_expert_matmul(x, w, scale)
    torch.cuda.synchronize()
    for name, before in counts.items():
        assert getattr(tgmm, name) == before + (
            name == _gmm_counter(variant))
    want = tgmm.grouped_matmul_reference(x, w, scale)
    assert got.dtype == x.dtype and got.shape == (E, C, F)
    assert torch.isfinite(got.float()).all()
    tol = 1e-4 if variant == "fp32" else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


# (E, C, D, F) and the split `plan` gives int8 and int4 there
_Q16_SHAPES = [
    ((4, 300, 64, 4096), 1, 1),    # enough tiles: unsplit
    ((2, 256, 96, 200), 2, 1),     # F off the 128-column tile
    ((1, 80, 200, 264), 4, 2),     # D and F off their tiles
    ((1, 300, 1024, 72), 4, 4),    # 72-byte weight rows: no TMA
    ((3, 256, 512, 50), 4, 4),     # 50-byte weight rows
    ((2, 300, 38, 136), 1, 1),     # 76-byte x rows: no TMA for x
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,split8,split4", _Q16_SHAPES)
@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("xname", ["bf16", "fp16"])
def test_gmm_q16_kernel_across_its_tiles(shape, split8, split4, fmt, xname,
                                         cuda_device):
    """The wgmma kernel of the quantized formats against the plain
    version where its cuts fall: C = 256 and 300 over 4 chunks of 80
    rows, D in 1, 2 and 4 split parts, F off the 128-column tile, and
    weight or x rows that TMA cannot describe (copied by the producer
    warp). The same operands and roundings as the plain version, fp32
    sums in another order: 1e-2."""
    E, C, D, F = shape
    variant = fmt if xname == "bf16" else f"{fmt}-{xname}"
    x, w, scale = _gmm_case(E, C, D, F, variant, cuda_device)
    p = tgmm.plan(E, C, D, F, 1 if fmt == "int8" else 2, x.dtype,
                  tgmm._sms(cuda_device))
    assert p["kernel"] == "q16"
    assert p["split"] == (split8 if fmt == "int8" else split4)
    got = tgmm.grouped_expert_matmul(x, w, scale)
    want = tgmm.grouped_matmul_reference(x, w, scale)
    assert got.dtype == x.dtype and got.shape == (E, C, F)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("D,F", [(1024, 4096), (4096, 1024)])
def test_gmm_q16_kernel_bit_identical_across_launches(fmt, D, F,
                                                      cuda_device):
    """At the MoE step's two products (ffn2's split into parts added in
    rank order), two launches on the same inputs give the same bits."""
    x, w, scale = _gmm_case(8, 80, D, F, fmt, cuda_device)
    a = tgmm.grouped_expert_matmul(x, w, scale)
    b = tgmm.grouped_expert_matmul(x, w, scale)
    assert torch.equal(a, b)
    torch.testing.assert_close(
        a.float(), tgmm.grouped_matmul_reference(x, w, scale).float(),
        rtol=1e-2, atol=1e-2)


# Float weights on the wgmma kernel where its cuts fall: (E, C, D, F)
# and the split `plan` gives them. C = 1, 81, 256 and 300 over 80-row
# chunks, D and F off the 64-row stage and the 128-column tile (a
# second 64-column box wholly past F), 100-byte weight rows and 76-byte
# x rows that TMA cannot describe (copied by the producer warp), and D
# split in 1 to 4 parts (2 at the MoE step's ffn2).
_GMM_FP_SHAPES = [
    ((4, 300, 64, 4096), 1),   # enough tiles: unsplit
    ((2, 81, 96, 200), 2),     # C one past a chunk, F off the tile
    ((1, 80, 200, 264), 4),    # D and F off their tiles
    ((3, 1, 256, 72), 4),      # one capacity row; 144-byte rows
    ((3, 256, 512, 50), 4),    # 100-byte weight rows: no TMA for w
    ((2, 300, 38, 136), 1),    # 76-byte x rows: no TMA for x
    ((4, 80, 1024, 1280), 3),  # 40 tiles
    ((8, 80, 4096, 1024), 2),  # the MoE step's ffn2
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,split", _GMM_FP_SHAPES)
@pytest.mark.parametrize("xname", ["bf16", "fp16"])
def test_gmm_fp_wgmma_across_its_tiles(shape, split, xname, cuda_device):
    """The wgmma kernel with float weights (both operands from shared
    memory) against the plain version where its cuts fall. The same
    16-bit operands, fp32 sums in another order, one output rounding:
    1e-2, as test_gmm_kernels_match_plain."""
    E, C, D, F = shape
    x, w, _ = _gmm_case(E, C, D, F, xname, cuda_device)
    p = tgmm.plan(E, C, D, F, 0, x.dtype, tgmm._sms(cuda_device))
    assert (p["kernel"], p["k_tile"], p["split"]) == ("q16", 64, split)
    before = tgmm.fp_launch_count
    got = tgmm.grouped_expert_matmul(x, w)
    torch.cuda.synchronize()
    assert tgmm.fp_launch_count == before + 1
    want = tgmm.grouped_matmul_reference(x, w)
    assert got.dtype == x.dtype and got.shape == (E, C, F)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("xname", ["bf16", "fp16"])
@pytest.mark.parametrize("E,D,F", [(8, 1024, 4096), (8, 4096, 1024),
                                   (4, 1024, 1280)])
def test_gmm_fp_wgmma_bit_identical_across_launches(xname, E, D, F,
                                                    cuda_device):
    """At the MoE step's two products (ffn2 split in 2 parts added in
    rank order) and a product split in 3, two launches on the same
    inputs give the same bits."""
    x, w, _ = _gmm_case(E, 80, D, F, xname, cuda_device)
    a = tgmm.grouped_expert_matmul(x, w)
    b = tgmm.grouped_expert_matmul(x, w)
    assert torch.equal(a, b)
    torch.testing.assert_close(
        a.float(), tgmm.grouped_matmul_reference(x, w).float(), rtol=1e-2,
        atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["int8-fp32", "int4-fp32", "int8",
                                     "int4", "fp32", "bf16", "fp16"])
def test_gmm_routes_by_activation_dtype(variant, cuda_device, monkeypatch):
    """fp32 activations, with float, int8 or int4 weights, reach the mma
    entry's kernel (the wgmma entry must not run), and 16-bit ones the
    wgmma kernel (the mma entry must not run); either counts one launch
    of its format."""
    from paddle_tpu_torch.ops import _build
    lib = _build.load("grouped_matmul", tgmm._SIGNATURES)
    fp32 = variant.endswith("fp32")
    banned = ("paddle_tpu_torch_grouped_matmul_q16" if fp32
              else "paddle_tpu_torch_grouped_matmul")

    def refuse(*a):
        raise AssertionError(f"{banned} ran for {variant}")
    monkeypatch.setattr(lib, banned, refuse)
    x, w, scale = _gmm_case(3, 40, 96, 136, variant, cuda_device)
    counter = _gmm_counter(variant)
    before = getattr(tgmm, counter)
    got = tgmm.grouped_expert_matmul(x, w, scale)
    assert getattr(tgmm, counter) == before + 1
    tol = 1e-4 if fp32 else 1e-2
    torch.testing.assert_close(
        got.float(), tgmm.grouped_matmul_reference(x, w, scale).float(),
        rtol=tol, atol=tol)


@pytest.mark.cuda
def test_gmm_kernel_refuses_without_running_plain(cuda_device,
                                                  monkeypatch):
    def plain(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")
    monkeypatch.setattr(tgmm, "grouped_matmul_reference", plain)
    x, w, _ = _gmm_case(2, 5, 16, 24, "bf16", cuda_device)
    with pytest.raises(TypeError):                 # float64 activations
        tgmm.grouped_expert_matmul(x.double(), w.double())
    with pytest.raises(TypeError):                 # w of another dtype
        tgmm.grouped_expert_matmul(x, w.half())
    with pytest.raises(TypeError):                 # out_dtype not x's
        tgmm.grouped_expert_matmul(x, w, out_dtype=torch.float32)
    x4, w4, s4 = _gmm_case(2, 5, 16, 24, "int4", cuda_device)
    with pytest.raises(ValueError, match="even D"):  # odd D for int4
        tgmm.grouped_expert_matmul(x4[..., :15].contiguous(), w4, s4)
    with pytest.raises(TypeError):                 # scale of a wrong shape
        tgmm.grouped_expert_matmul(x4, w4, s4[:, :5].contiguous())
    x8, w8, s8 = _gmm_case(2, 5, 16, 24, "int8", cuda_device)
    with pytest.raises(RuntimeError, match="grad"):  # int8 is forward-only
        tgmm.grouped_expert_matmul(x8.requires_grad_(), w8, s8)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", [None, "int8", "int4"])
def test_moe_engine_on_card_matches_cpu(fmt, cuda_device):
    """A small fp32 MoE model served on the card (kernels) and on the CPU
    (plain versions) from the same weights: the same greedy tokens and
    routing counts; the engine's K4 variant launched twice per layer per
    step and the other two not at all."""
    torch.manual_seed(0)
    moe = dict(num_expert=4, top_k=2, capacity_factor=1.25)
    kw = dict(vocab_size=193, hidden_size=128, num_layers=2,
              num_attention_heads=2, max_position_embeddings=128, moe=moe)
    cpu = GPTForGeneration(device="cpu", **kw)
    card = GPTForGeneration(device=cuda_device, **kw)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 193, n).tolist() for n in (9, 5, 30, 3)]
    ekw = dict(max_slots=4, block_size=16, max_seq_len=64,
               cache_dtype="float32", moe_weight_dtype=fmt)
    ref = ServingEngine(cpu, device="cpu", **ekw)
    want = ref.generate_batch(prompts, max_new_tokens=8)
    eng = ServingEngine(card, device=cuda_device, **ekw)
    counts = {n: getattr(tgmm, n) for n in set(_GMM_COUNTERS.values())}
    got = eng.generate_batch(prompts, max_new_tokens=8)
    assert got == want
    assert np.array_equal(eng.moe_expert_counts, ref.moe_expert_counts)
    active = {None: "fp_launch_count", "int8": "int8_launch_count",
              "int4": "int4_launch_count"}[fmt]
    for name, before in counts.items():
        assert getattr(tgmm, name) - before == (
            eng.steps_run * 2 * 2 if name == active else 0)


# ------------------------------------ the segmented flash forward (K1c)


def _seg(pattern, B, S, rng):
    """[B, S] int32 segment ids: a key-padding mask at random lengths
    (the first sequence unpadded) with the padding after the tokens,
    before them or strewn among them, or a packed batch of ids 0-3."""
    if pattern == "packed":
        return np.sort(rng.randint(0, 4, (B, S)), axis=1).astype(np.int32)
    if pattern == "interleaved":
        keep = rng.rand(B, S) < 0.6
        keep[0] = True
    else:
        lens = rng.randint(1, S + 1, B)
        lens[0] = S
        keep = np.arange(S)[None] < lens[:, None]
        if pattern == "left":
            keep = keep[:, ::-1]
    return np.ascontiguousarray(keep, dtype=np.int32)


SEG_PATTERNS = ("trailing", "left", "interleaved", "packed")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,D", [(64, 12, 128, 64), (16, 12, 512, 64),
                                     (3, 2, 200, 128), (2, 3, 1, 64),
                                     (3, 2, 65, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("pattern", SEG_PATTERNS)
def test_flash_seg_kernel_matches_plain(B, H, S, D, causal, dtype, tol,
                                        pattern, cuda_device):
    """K1c against its plain version, out and lse, every row finite (a
    padded query meets tiles with no key of its segment): fp32 at 1e-5;
    bf16 at 2e-2 (both round p to bf16 before p v and round the output,
    a bf16 spacing or two)."""
    rng = np.random.RandomState(B + S + D)
    seg = torch.tensor(_seg(pattern, B, S, rng), device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(B, H, S, D, generator=g, device=cuda_device,
                           dtype=dtype) for _ in range(3))
    q = (q * D ** -0.5).to(dtype)
    before = tfa.seg_launch_count
    out, lse = tfa.flash_fwd_seg(q, k, v, seg, causal, "")
    torch.cuda.synchronize()
    assert tfa.seg_launch_count == before + 1
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    ref_out, ref_lse = tfa.flash_fwd_reference(q, k, v, causal, seg)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,D", [(64, 12, 128, 64), (16, 12, 512, 64),
                                     (3, 2, 200, 128), (2, 3, 1, 64),
                                     (3, 2, 65, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("pattern", SEG_PATTERNS)
def test_flash_seg_backward_matches_plain(B, H, S, D, causal, dtype, tol,
                                          pattern, cuda_device):
    """K1c's backward kernel against its plain version, dq, dk and dv on
    every row, all finite (a tile may hold no key of a row's segment:
    p is exactly 0 there). fp32 at 1e-4 (ds = p (dp - delta) subtracts
    two nearly equal D-term sums, as K1a's backward); bf16 at 2e-2 (both
    round p and ds to bf16 before the products they feed and round the
    outputs)."""
    rng = np.random.RandomState(B + S + D + 1)
    seg = torch.tensor(_seg(pattern, B, S, rng), device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v, dout = (torch.randn(B, H, S, D, generator=g,
                                 device=cuda_device, dtype=dtype)
                     for _ in range(4))
    q = (q * D ** -0.5).to(dtype)
    out, lse = tfa.flash_fwd_reference(q, k, v, causal, seg)
    before = (tfa.bwd_launch_count, tfa.seg_bwd_launch_count)
    got = tfa.flash_bwd_seg(q, k, v, out, lse, dout, seg, causal)
    torch.cuda.synchronize()
    assert (tfa.bwd_launch_count, tfa.seg_bwd_launch_count) == \
        (before[0], before[1] + 1)
    want = tfa.flash_bwd_reference(q, k, v, out, lse, dout, causal, seg)
    for a, e in zip(got, want):
        assert torch.isfinite(a.float()).all()
        torch.testing.assert_close(a.float(), e.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_seg_backward_through_autograd(cuda_device):
    """`splash_mha(kv_keep=)` differentiated on the card launches K1c's
    forward and backward once each (never K1a's), and its gradients
    equal the plain backward's on the same forward residuals."""
    rng = np.random.RandomState(5)
    keep = torch.tensor(_seg("trailing", 4, 128, rng), device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v, dout = (torch.randn(4, 2, 128, 64, generator=g,
                                 device=cuda_device) for _ in range(4))
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (tfa.fwd_launch_count, tfa.bwd_launch_count,
              tfa.seg_launch_count, tfa.seg_bwd_launch_count)
    out = tfa.splash_mha(*args, causal=False, kv_keep=keep)
    got = torch.autograd.grad(out, args, dout)
    torch.cuda.synchronize()
    assert (tfa.fwd_launch_count, tfa.bwd_launch_count,
            tfa.seg_launch_count, tfa.seg_bwd_launch_count) == \
        (before[0], before[1], before[2] + 1, before[3] + 1)
    qs = q * 64 ** -0.5
    ref_out, ref_lse = tfa.flash_fwd_reference(qs, k, v, False, keep)
    dqs, dk, dv = tfa.flash_bwd_reference(qs, k, v, ref_out, ref_lse, dout,
                                          False, keep)
    for a, e in zip(got, (dqs * 64 ** -0.5, dk, dv)):
        torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_flash_seg_kernel_refuses_unsupported_operands(cuda_device):
    q = torch.zeros(2, 2, 128, 64, device=cuda_device)
    seg = torch.ones(2, 128, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):        # head_dim 192: no kernel
        z = torch.zeros(2, 2, 128, 192, device=cuda_device)
        tfa.flash_fwd_seg(z, z, z, seg, False, "")
    with pytest.raises(ValueError):        # ids of another dtype
        tfa.flash_fwd_seg(q, q, q, seg.long(), False, "")
    with pytest.raises(ValueError):        # ids of another shape
        tfa.flash_fwd_seg(q, q, q, seg[:, :64].contiguous(), False, "")
    lse = torch.zeros(2, 2, 128, device=cuda_device)
    with pytest.raises(ValueError):        # the backward: the same checks
        tfa.flash_bwd_seg(q, q, q, q, lse, q, seg.long(), False)
    with pytest.raises(ValueError):
        tfa.flash_bwd_seg(q, q, q, q, lse.double(), q, seg, False)


# K1c's backward on its wgmma kernels (bf16, fp16), where their cuts
# fall: S off the 64-row walked tiles and the 128-row fixed ones, D 64
# and 128, causal or not, under trailing padding; then every id pattern
# at S = 512 and 200. The same tolerances as test_flash_kernels_match_
# plain: both sides multiply the same 16-bit operands in fp32, round p
# and ds to that dtype before the products they feed and round the
# outputs once.
_SEG_BWD_TOL = {torch.bfloat16: 3e-2, torch.float16: 4e-3}


def _seg_more(pattern, B, S, rng):
    """`_seg`'s patterns, and "one" (a single segment), "three" (packed
    ids 0-5, more than two in a tile) and "blocks" (ids that change
    every 128 rows, so whole tile pairs hold two segments and are
    skipped)."""
    if pattern == "one":
        return np.ones((B, S), dtype=np.int32)
    if pattern == "three":
        return np.sort(rng.randint(0, 6, (B, S)), axis=1).astype(np.int32)
    if pattern == "blocks":
        ids = np.arange(S) // 128 + np.arange(B)[:, None]
        return np.ascontiguousarray(ids, dtype=np.int32)
    return _seg(pattern, B, S, rng)


def _seg_bwd_case(B, H, S, D, dtype, pattern, causal, device, seed):
    rng = np.random.RandomState(seed)
    seg = torch.tensor(_seg_more(pattern, B, S, rng), device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, dout = (torch.randn(B, H, S, D, generator=g, device=device,
                                 dtype=dtype) for _ in range(4))
    q = (q * D ** -0.5).to(dtype)
    out, lse = tfa.flash_fwd_reference(q, k, v, causal, seg)
    return q, k, v, out, lse, dout, seg


def _check_seg_bwd(args, causal, dtype):
    before = tfa.seg_bwd_launch_count
    got = tfa.flash_bwd_seg(*args, causal)
    torch.cuda.synchronize()
    assert tfa.seg_bwd_launch_count == before + 1
    want = tfa.flash_bwd_reference(*args[:6], causal, args[6])
    tol = _SEG_BWD_TOL[dtype]
    for a, e in zip(got, want):
        assert torch.isfinite(a.float()).all()
        torch.testing.assert_close(a.float(), e.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 200, 512,
                               1000])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_seg_bwd_wgmma_across_its_tiles(S, D, causal, dtype,
                                              cuda_device):
    args = _seg_bwd_case(2, 2, S, D, dtype, "trailing", causal, cuda_device,
                         seed=S + D)
    _check_seg_bwd(args, causal, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["trailing", "left", "interleaved",
                                     "one", "three", "blocks"])
@pytest.mark.parametrize("S", [200, 512])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_seg_bwd_wgmma_id_patterns(pattern, S, causal, dtype,
                                         cuda_device):
    """Every id pattern, with the tile pairs the kernels skip counted:
    "blocks" skips whole pairs, "one" none."""
    args = _seg_bwd_case(3, 2, S, 64, dtype, pattern, causal, cuda_device,
                         seed=S + len(pattern))
    pairs = tfa.segment_tile_pairs(args[6], causal)
    if pattern == "blocks":
        assert not pairs.all()
    if pattern == "one":
        nt = pairs.shape[1]
        full = torch.ones(nt, nt, dtype=torch.bool, device=cuda_device)
        assert torch.equal(pairs[0], full.tril() if causal else full)
    _check_seg_bwd(args, causal, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(16, 512), (64, 128)])
def test_flash_seg_bwd_wgmma_bit_identical_across_launches(B, S,
                                                           cuda_device):
    """At the BERT shapes, two launches give the same bits (each
    gradient element is one block's fixed-order sum; no atomics)."""
    args = _seg_bwd_case(B, 12, S, 64, torch.bfloat16, "trailing", False,
                         cuda_device, seed=3)
    first = tfa.flash_bwd_seg(*args, False)
    second = tfa.flash_bwd_seg(*args, False)
    assert all(torch.equal(a, c) for a, c in zip(first, second))


# K1c's forward on the wgmma kernel (bf16, fp16) where its cuts fall: S
# off the 128-row query and key tiles (1, 63, 77, 200, 1000) and on them
# (128, 512), D 64 and 128, causal or not, under trailing padding; then
# every id pattern: trailing, left, interleaved, every token its own id
# (most key tiles skipped) and one segment (none). out and lse against
# the plain forward, every row finite (a row may meet loaded tiles with
# no key of its segment first). Tolerances of
# test_flash_wgmma_across_its_tiles.
def _seg_fwd_ids(pattern, B, S, rng):
    """`_seg_more`'s patterns and "own": every token its own segment."""
    if pattern == "own":
        return np.ascontiguousarray(np.broadcast_to(
            np.arange(S, dtype=np.int32), (B, S)))
    return _seg_more(pattern, B, S, rng)


def _check_seg_fwd(B, H, S, D, dtype, pattern, causal, device, seed):
    rng = np.random.RandomState(seed)
    seg = torch.tensor(_seg_fwd_ids(pattern, B, S, rng), device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(B, H, S, D, generator=g, device=device,
                           dtype=dtype) for _ in range(3))
    q = (q * D ** -0.5).to(dtype)
    before = tfa.seg_launch_count
    out, lse = tfa.flash_fwd_seg(q, k, v, seg, causal, "")
    torch.cuda.synchronize()
    assert tfa.seg_launch_count == before + 1
    assert bool(torch.isfinite(out.float()).all())
    assert bool(torch.isfinite(lse).all())
    ref_out, ref_lse = tfa.flash_fwd_reference(q, k, v, causal, seg)
    tol = _SEG_BWD_TOL[dtype]
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=2e-5, atol=2e-5)
    return seg


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 63, 77, 128, 200, 512, 1000])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_seg_fwd_wgmma_across_its_tiles(S, D, causal, dtype,
                                              cuda_device):
    _check_seg_fwd(2, 2, S, D, dtype, "trailing", causal, cuda_device,
                   seed=S + D + 5)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["trailing", "left", "interleaved",
                                     "own", "one"])
@pytest.mark.parametrize("S", [77, 200, 1000])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_seg_fwd_wgmma_id_patterns(pattern, S, D, causal, dtype,
                                         cuda_device):
    """Every id pattern, with the tile pairs the forward skips counted:
    "own" skips most, "one" none."""
    seg = _check_seg_fwd(3, 2, S, D, dtype, pattern, causal, cuda_device,
                         seed=S + D + len(pattern))
    pairs = tfa.segment_tile_pairs(seg, causal, tfa.SEG_TILE,
                                   tfa.SEG_FWD_KEY_TILE)
    if pattern == "own" and S >= 200:
        assert not pairs.all()
    if pattern == "one":
        full = tfa.segment_tile_pairs(torch.ones_like(seg), causal,
                                      tfa.SEG_TILE, tfa.SEG_FWD_KEY_TILE)
        assert torch.equal(pairs, full)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(16, 512), (64, 128)])
def test_flash_seg_fwd_wgmma_bit_identical_across_launches(B, S,
                                                           cuda_device):
    """At the BERT shapes, two launches of K1c's forward give the same
    out and lse."""
    rng = np.random.RandomState(S)
    seg = torch.tensor(_seg("trailing", B, S, rng), device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v = (torch.randn(B, 12, S, 64, generator=g, device=cuda_device,
                           dtype=torch.bfloat16) for _ in range(3))
    first = tfa.flash_fwd_seg(q, k, v, seg, False, "")
    second = tfa.flash_fwd_seg(q, k, v, seg, False, "")
    assert all(torch.equal(a, c) for a, c in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_bwd_routes_by_dtype_and_segments(dtype, cuda_device):
    """K1c's backward and K1a's (no segments): bf16 and fp16 reach
    flash_bwd_wgmma_kernel (and its pre-pass), fp32 the CUDA-core
    kernels. Each backward runs twice in the profiled window: the
    profiler has been seen to miss the window's first kernel."""
    args = _seg_bwd_case(2, 2, 200, 64, dtype, "trailing", False,
                         cuda_device, seed=7)
    names = _device_kernels(
        lambda: [tfa.flash_bwd_seg(*args, False) for _ in range(2)])
    wg = any("flash_bwd_wgmma_kernel" in n for n in names)
    assert wg == (dtype != torch.float32), names
    assert any("flash_delta_seg_kernel" in n for n in names) == wg, names
    assert any("flash_bwd_dkdv_kernel" in n for n in names) == (not wg)
    before = tfa.bwd_launch_count
    names = _device_kernels(
        lambda: [tfa.flash_bwd(*args[:6], False) for _ in range(2)])
    assert tfa.bwd_launch_count == before + 2
    assert any("flash_bwd_wgmma_kernel" in n for n in names) == wg, names
    assert any("flash_delta_seg_kernel" in n for n in names) == wg, names
    assert any("flash_bwd_dkdv_kernel" in n for n in names) == (not wg)
    assert any("flash_bwd_dq_kernel" in n for n in names) == (not wg)
    assert not any("_mma_kernel" in n for n in names), names


# --------------------------------------------------- BERT on the card


def _bert_pair(layers, device, dtype=torch.float32, seed=0):
    """(config, a two-class BERT classifier on `device`) at hidden 256,
    4 heads (head_dim 64: the kernel's route), from numpy parameters."""
    from paddle_tpu_torch.convert import load_jax_bert
    from paddle_tpu_torch.models import bert
    cfg = dict(vocab_size=193, hidden_size=256, num_hidden_layers=layers,
               num_attention_heads=4, intermediate_size=512,
               max_position_embeddings=512)
    rng = np.random.RandomState(seed)
    arrays = {n: (rng.randn(*p.shape) * 0.05 + (
        "norm" in n and n.endswith("weight"))).astype(np.float32)
        for n, p in bert.BertForSequenceClassification(bert.BertModel(
            **cfg, device="meta")).named_parameters()}
    return cfg, arrays, load_jax_bert(arrays, cfg,
                                      head="sequence_classification",
                                      device=device, dtype=dtype).eval()


def _bert_ids(B, S, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 193, (B, S))
    keep = np.concatenate([_seg(p, 2, S, rng) for p in (
        "trailing", "left", "interleaved")])[:B]
    return np.where(keep > 0, ids, 0)


@pytest.mark.cuda
def test_bert_fp32_on_card_matches_cpu(cuda_device):
    """A 2-layer fp32 BERT classifier on the card (kernels) against its
    CPU copy (plain versions), every row of the sequence output, the
    pooled output and the logits: fp32 sums in another order, 1e-4. The
    kernel launches once a layer."""
    from paddle_tpu_torch.convert import load_jax_bert
    cfg, arrays, card = _bert_pair(2, cuda_device)
    cpu = load_jax_bert(arrays, cfg, head="sequence_classification",
                        device="cpu").eval()
    ids = _bert_ids(6, 128)
    before = tfa.seg_launch_count
    with torch.no_grad():
        got = (*card.bert(torch.tensor(ids, device=cuda_device)),
               card(torch.tensor(ids, device=cuda_device)))
        want = (*cpu.bert(torch.tensor(ids)), cpu(torch.tensor(ids)))
    assert tfa.seg_launch_count == before + 2 * 2
    for a, e in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.cpu(), e, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -6)])
def test_bert_padding_invariance_on_card(dtype, tol, cuda_device):
    """The same sequences batched at S = 128 and at S = 512 give the
    same logits: real rows never see padding. fp32: sums in another
    order, 1e-5; bf16: products tiled and rounded at other places for
    the two batch sizes, a few bf16 spacings of O(1) logits."""
    _, _, model = _bert_pair(2, cuda_device, dtype)
    ids = torch.tensor(_bert_ids(4, 128), device=cuda_device)
    ids = ids[[0, 1, 1, 0]]
    ids[2:, 100:] = 0                  # trailing padding only
    ids512 = torch.zeros(4, 512, dtype=ids.dtype, device=cuda_device)
    ids512[:, :128] = ids
    with torch.no_grad():
        a, b = model(ids), model(ids512)
    assert torch.isfinite(a.float()).all() and torch.isfinite(b.float()).all()
    torch.testing.assert_close(b.float(), a.float(), rtol=tol, atol=tol)


# ------------------------------------------------ the two repairs


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all", "partly"])
def test_top_k_routing_ties_on_card(case, cuda_device):
    """Tied router logits route on the card as on the CPU (and as
    jax.lax.top_k: the lower expert first); ROADMAP Queue 3 item 1's
    input, T=6, E=8, k=2, C=2."""
    from paddle_tpu_torch.parallel import moe_utils as tmu
    logits = np.zeros((6, 8), np.float32)
    if case == "partly":
        logits[0, [6, 3]] = 2.0
        logits[1, [7, 1, 4]] = 1.5
        logits[2, 5], logits[2, [2, 0]] = 3.0, 1.0
        logits[3] = np.arange(8, dtype=np.float32)
        logits[4, 2] = -1.0
    cpu = tmu.top_k_routing(torch.tensor(logits), 2, 2)
    card = tmu.top_k_routing(torch.tensor(logits, device=cuda_device), 2, 2)
    if case == "all":
        assert card.plan.gate_idx.tolist() == [[0, 1]] * 6
        assert card.plan.counts.tolist() == [2, 2, 0, 0, 0, 0, 0, 0]
    for f in ("gate_idx", "slot", "in_cap", "counts", "dropped"):
        assert torch.equal(getattr(card.plan, f).cpu(),
                           getattr(cpu.plan, f)), f


@pytest.mark.cuda
def test_train_step_embedding_grad_is_reproducible_on_card(cuda_device):
    """Two identical fp32 steps on the card give the same bits in every
    parameter and moment, tok_emb included (tokens repeat, so its
    gradient sums several rows per id)."""
    cfg = th.GPTConfig(vocab_size=31, seq_len=128, d_model=128, n_heads=2,
                       n_layers=2, compute_dtype=torch.float32,
                       learning_rate=1e-3)
    trainer = th.HybridGPT(cfg, device=cuda_device)
    rng = np.random.RandomState(0)
    tok = rng.randint(0, 31, (4, 128))
    lab = rng.randint(0, 31, (4, 128))
    runs = []
    for _ in range(2):
        params, opt = trainer.init(seed=0)
        params, opt, _ = trainer.train_step(params, opt, tok, lab)
        runs.append((params, opt))

    def leaves(tree, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k], prefix + k + ".")
            else:
                yield prefix + k, tree[k]
    for (n, a), (_, b) in zip(leaves(runs[0][0]), leaves(runs[1][0])):
        assert torch.equal(a, b), n
    for (n, a), (_, b) in zip(leaves(runs[0][1]), leaves(runs[1][1])):
        assert torch.equal(a, b), n


# ------------------------------------------ the MoE train step (K1a+K2)


def _moe_train_cfg(**kw):
    return th.GPTConfig(**{**dict(
        vocab_size=193, seq_len=200, d_model=128, n_heads=2, n_layers=2,
        moe_num_experts=4, moe_top_k=2, moe_capacity_factor=0.75,
        remat=True, ce_seq_chunks=2, compute_dtype=torch.float32,
        learning_rate=1e-3), **kw})


def _leaves_of(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves_of(tree[k], prefix + k + ".")
        else:
            yield prefix + k, tree[k]


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [None, "save_splash_residuals"])
def test_moe_train_step_on_card_matches_cpu(policy, cuda_device):
    """One fp32 MoE step (capacity factor 0.75: 2 x 400 choices over 4 x
    150 slots, so choices drop) on the card (kernels) and on the CPU
    (plain versions) from the same parameters: the loss within 1e-4
    relative, the routing counts and drops exactly, balance and z within
    1e-5, every parameter within 0.25 lr; K1a and K2 launched as remat
    predicts."""
    cfg = _moe_train_cfg(remat_policy=policy)
    cpu = th.HybridGPT(cfg, device="cpu")
    card = th.HybridGPT(cfg, device=cuda_device)
    pc, oc = cpu.init(seed=0)
    pg, og = _to_card(pc, cuda_device), _to_card(oc, cuda_device)
    rng = np.random.RandomState(0)
    tok = rng.randint(0, 193, (2, 200))
    lab = rng.randint(0, 193, (2, 200))
    counts = (tfa.fwd_launch_count, tfa.bwd_launch_count,
              tln.fwd_launch_count, tln.bwd_launch_count)
    pc, oc, lc = cpu.train_step(pc, oc, tok, lab)
    pg, og, lg = card.train_step(pg, og, tok, lab)
    L = cfg.n_layers
    assert (tfa.fwd_launch_count - counts[0], tfa.bwd_launch_count
            - counts[1], tln.fwd_launch_count - counts[2],
            tln.bwd_launch_count - counts[3]) == (
                (L if policy else 2 * L), L, 2 * L, L)
    assert math.isclose(float(lg), float(lc), rel_tol=1e-4)
    sc, sg = cpu.last_moe_stats, card.last_moe_stats
    assert torch.equal(sc["counts"], sg["counts"].cpu())
    assert float(sc["dropped"]) == float(sg["dropped"]) > 0
    for k in ("balance", "z"):
        assert math.isclose(float(sg[k]), float(sc[k]), rel_tol=1e-5)
    for (n, a), (_, b) in zip(_leaves_of(pg), _leaves_of(pc)):
        assert float((a.cpu() - b).abs().max()) <= 0.25 * cfg.learning_rate, n


def _to_card(tree, device):
    return {k: _to_card(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.cuda
def test_moe_bf16_train_steps_bit_identical_on_card(cuda_device):
    """Two bf16 MoE steps from the same parameters give the same bits in
    every parameter and moment: the index dispatch and combine have
    gather backwards, with no atomic accumulation."""
    cfg = _moe_train_cfg(compute_dtype=torch.bfloat16, bf16_grads=True,
                         remat_policy="save_splash_residuals")
    trainer = th.HybridGPT(cfg, device=cuda_device)
    rng = np.random.RandomState(1)
    tok = rng.randint(0, 193, (4, 200))
    lab = rng.randint(0, 193, (4, 200))
    runs = []
    for _ in range(2):
        params, opt = trainer.init(seed=0)
        for step in (1, 2):
            params, opt, _ = trainer.train_step(params, opt, tok, lab,
                                                step_num=step)
        runs.append((params, opt))
    for a, b in ((runs[0][0], runs[1][0]), (runs[0][1], runs[1][1])):
        for (n, x), (_, y) in zip(_leaves_of(a), _leaves_of(b)):
            assert torch.equal(x, y), n


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["bf16", "fp32"])
def test_gmm_under_autograd_matches_plain(variant, cuda_device):
    """Float-weight K4 under autograd: the forward is the kernel (one
    launch a call), dx and dw are JAX's fp32 grouped contractions, both
    within K4's tolerance of the plain version's autograd."""
    x, w, _ = _gmm_case(4, 96, 128, 256, variant, cuda_device)
    g = torch.randn(4, 96, 256, device=cuda_device).to(x.dtype)
    before = tgmm.fp_launch_count
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = tgmm.grouped_expert_matmul(xa, wa)
    assert tgmm.fp_launch_count == before + 1
    dx, dw = torch.autograd.grad(out, (xa, wa), g)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    ref = tgmm.grouped_matmul_reference(xr, wr)
    rdx, rdw = torch.autograd.grad(ref, (xr, wr), g)
    tol = 2e-2 if variant == "bf16" else 1e-4
    for got, want in ((out, ref), (dx, rdx), (dw, rdw)):
        got, want = got.detach().float(), want.detach().float()
        torch.testing.assert_close(got, want, rtol=tol,
                                   atol=tol * float(want.abs().max()))
    assert dx.dtype == x.dtype and dw.dtype == w.dtype


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["int8", "int4"])
def test_gmm_quantized_refuses_grad_on_card(variant, cuda_device):
    x, w, scale = _gmm_case(2, 5, 16, 24, variant, cuda_device)
    before = tgmm.int8_launch_count + tgmm.int4_launch_count
    with pytest.raises(RuntimeError, match="gradient"):
        tgmm.grouped_expert_matmul(x.requires_grad_(), w, scale)
    assert tgmm.int8_launch_count + tgmm.int4_launch_count == before


# ------------------------------------------ BERT pretraining on the card


def _pretrainer(device, layers, dtype=torch.float32, attn_p=0.0,
                hidden_p=0.0, seed=0):
    """A `hapi.Model` over a BERT pretraining model at hidden 256, 4
    heads (head_dim 64), from numpy parameters, prepared as bench_bert
    prepares BERT-base: `amp.decorate(O2)` for bf16, LAMB (lr 1e-3,
    weight decay 0.01) and the pretraining criterion."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.convert import load_jax_bert
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.optimizer import Lamb
    cfg = dict(vocab_size=193, hidden_size=256, num_hidden_layers=layers,
               num_attention_heads=4, intermediate_size=512,
               max_position_embeddings=512,
               attention_probs_dropout_prob=attn_p,
               hidden_dropout_prob=hidden_p)
    rng = np.random.RandomState(seed)
    arrays = {n: (rng.randn(*p.shape) * 0.05 + (
        "norm" in n and n.endswith("weight"))).astype(np.float32)
        for n, p in bert.BertForPretraining(bert.BertModel(
            **cfg, device="meta")).named_parameters()}
    net = load_jax_bert(arrays, cfg, head="pretraining", device=device)
    if dtype == torch.bfloat16:
        amp.decorate(net, level="O2")
    return Model(net, device=device).prepare(
        Lamb(1e-3, lamb_weight_decay=0.01, parameters=net.parameters()),
        bert.BertPretrainingCriterion(193))


def _pretraining_batch(B, S, seed=1):
    """Ids with trailing, left and interleaved padding (the first
    sequence of each pair unpadded), MLM labels on 15% of real tokens,
    NSP labels."""
    rng = np.random.RandomState(seed)
    keep = np.concatenate([_seg(p, 2, S, rng) for p in (
        "trailing", "left", "interleaved")])[:B] > 0
    ids = np.where(keep, rng.randint(1, 193, (B, S)), 0)
    mlm = np.where(keep & (rng.rand(B, S) < 0.15),
                   rng.randint(0, 193, (B, S)), -1)
    return ids, mlm, rng.randint(0, 2, B)


@pytest.mark.cuda
def test_bert_train_step_fp32_on_card_matches_cpu(cuda_device):
    """One fp32 LAMB step of a 2-layer BERT through `Model.train_batch`
    on the card (K1c forward and backward) and on a CPU copy (plain
    versions): the loss and every parameter at 1e-5 (the same update
    summed in another order; LAMB divides each gradient element by its
    own scale). The key biases, whose gradient is zero up to rounding,
    move by a step of norm lr * ||w|| on both."""
    batch = _pretraining_batch(6, 128)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = _pretrainer(dev, 2)
        before = {n: p.detach().cpu().clone()
                  for n, p in model.network.named_parameters()}
        loss = float(model.train_batch([batch[0]], list(batch[1:]))[0])
        out[dev.type] = (loss, before, {
            n: p.detach().cpu() for n, p in model.network.named_parameters()})
    (lc, _, card), (lh, before, cpu) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    for n in cpu:
        if n.endswith("self_attn.k_proj.bias"):
            for side in (card, cpu):
                torch.testing.assert_close(
                    (side[n] - before[n]).norm(), 1e-3 * before[n].norm(),
                    rtol=1e-4, atol=0)
            continue
        torch.testing.assert_close(card[n], cpu[n], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_bert_train_steps_bf16_bit_identical(cuda_device):
    """Two bf16 (AMP O2) steps with hidden dropout 0.1 from the same
    weights after the same `seed()`: every parameter the same bits."""
    from paddle_tpu_torch import seed
    ids, mlm, nsp = _pretraining_batch(4, 256)
    runs = []
    for _ in range(2):
        model = _pretrainer(cuda_device, 2, torch.bfloat16, hidden_p=0.1)
        seed(7)
        model.train_batch([ids], [mlm, nsp])
        runs.append([p.detach().clone() for p in model.parameters()])
    for a, b in zip(*runs):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("attn_p,per_step", [(0.0, 12), (0.1, 0)])
def test_bert_train_launch_counts(attn_p, per_step, cuda_device):
    """A 12-layer bf16 step launches K1c's forward and backward once a
    layer with attention dropout 0 (config (A)), never with 0.1 (config
    (B), the additive path); K1a never."""
    model = _pretrainer(cuda_device, 12, torch.bfloat16, attn_p=attn_p,
                        hidden_p=0.1)
    ids, mlm, nsp = _pretraining_batch(4, 128)
    counts = ("fwd_launch_count", "bwd_launch_count", "seg_launch_count",
              "seg_bwd_launch_count")
    before = [getattr(tfa, c) for c in counts]
    loss = model.train_batch([ids], [mlm, nsp])[0]
    torch.cuda.synchronize()
    assert np.isfinite(loss)
    assert [getattr(tfa, c) - b for c, b in zip(counts, before)] == \
        [0, 0, per_step, per_step]


@pytest.mark.cuda
def test_seed_gives_the_same_dropout_masks(cuda_device):
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.nn import functional as F
    x = torch.ones(64, 1024, device=cuda_device)
    seed(3)
    a = F.dropout(x, 0.5)
    b = F.dropout(x, 0.5)
    seed(3)
    assert torch.equal(F.dropout(x, 0.5), a)
    assert not torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}


# ------------------------------ the prefix cache and block-sparse decode


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float32", "int8",
                                      "fp8_e4m3"])
def test_cow_block_on_card_copies_every_pool(kv_dtype, cuda_device):
    """`cow_block` on card pools (with key summaries): the private copy
    holds the shared block's K, V, scale columns and summary rows, bit
    for bit, and the source is untouched."""
    from paddle_tpu_torch.serving.kv_cache import PagedKVCache
    kv = PagedKVCache(2, 4, 64, num_blocks=12, block_size=16, max_slots=2,
                      max_blocks_per_slot=4, kv_dtype=kv_dtype,
                      summaries=True, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for p in kv._pools():
        if p.element_size() == 1:
            p.view(torch.uint8).copy_(torch.randint(
                0, 120, p.shape, generator=g, device=cuda_device,
                dtype=torch.uint8))
        else:
            p.copy_(torch.randn(p.shape, generator=g, device=cuda_device))
    assert kv.ensure_capacity(0, 32)
    src = kv.slot_blocks(0)[1]

    def bits(b):
        return [(p.view(torch.uint8) if p.element_size() == 1 else p)
                [:, b].clone() for p in kv._pools()]
    before = bits(src)
    kv.allocator.incref([src])
    assert kv.cow_block(0, 1)
    torch.cuda.synchronize()
    dst = kv.slot_blocks(0)[1]
    assert dst != src
    for a, b, c in zip(bits(dst), before, bits(src)):
        assert torch.equal(a, b) and torch.equal(c, b)


def _select_inputs(K, ties, seed=0):
    """Region inputs of 8 slots at contexts 700-1000 (BS 16, 64-block
    tables; one slot of two blocks, one at position 0) with summaries
    drawn at random; `ties`: blocks 1..4 of every slot share one summary
    row, so their scores tie exactly across the cut."""
    rng = np.random.RandomState(seed)
    S, BS, MB, H, Dh = 8, 16, 64, 16, 64
    NB = S * MB + 1
    last = rng.randint(700, 1000 - K, S)
    last[-2], last[-1] = 20, 0
    pos = (last[:, None] + np.arange(K)[None]).astype(np.int32)
    bt = np.zeros((S, MB), np.int32)
    perm = rng.permutation(np.arange(1, NB))
    for s in range(S):
        n = int(pos[s].max()) // BS + 1
        bt[s, :n] = perm[s * MB:s * MB + n]
    smin = rng.randn(NB, H, Dh).astype(np.float32)
    smax = smin + rng.rand(NB, H, Dh).astype(np.float32)
    if ties:
        for s in range(S):
            smin[bt[s, 2:5]] = smin[bt[s, 1]]
            smax[bt[s, 2:5]] = smax[bt[s, 1]]
    q = rng.randn(S, K, H, Dh).astype(np.float32)
    return [torch.from_numpy(a) for a in (q, pos, bt, smin, smax)]


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("ties", [False, True])
def test_select_blocks_on_card_matches_cpu(K, ties, cuda_device):
    """The selection on the card equals its CPU result on the same
    inputs, ties at the cut included (a stable sort on both)."""
    from paddle_tpu_torch.serving.engine import select_blocks
    args = _select_inputs(K, ties)
    want = select_blocks(*args, 11, 2, 16)
    got = select_blocks(*[a.to(cuda_device) for a in args], 11, 2, 16)
    for a, b in zip(got, want):
        assert a.device.type == "cuda"
        assert torch.equal(a.cpu(), b)


def _sparse_case(K, qdtype, pool, device):
    """The paged kernel over a shortened table: 8 slots at contexts
    700-1000, their [8, 11] tables and compacted positions from
    `select_blocks` over summaries of the pools' own keys, pools in q's
    dtype or quantized."""
    from paddle_tpu_torch.serving.engine import quantize_kv, select_blocks
    q, pos, bt, _, _ = _select_inputs(K, False, seed=1)
    S, MB = bt.shape
    NB, BS, H, Dh = S * MB + 1, 16, 16, 64
    g = torch.Generator().manual_seed(2)
    kf = torch.randn(NB, BS, H, Dh, generator=g)
    vf = torch.randn(NB, BS, H, Dh, generator=g)
    short, pos_c = select_blocks(q, pos, bt, kf.amin(1), kf.amax(1), 11, 2,
                                 BS)
    if pool == "float":
        kp, vp, ks, vs = kf.to(qdtype), vf.to(qdtype), None, None
    else:
        kv_dtype = "int8" if pool == "int8" else "fp8_e4m3"
        kp, ks = quantize_kv(kf, kv_dtype)
        vp, vs = quantize_kv(vf, kv_dtype)
    qq = q.to(qdtype) if K > 1 else q[:, 0].to(qdtype)
    pp = pos_c if K > 1 else pos_c[:, 0].contiguous()
    args = [qq, kp, vp, short, torch.arange(S, dtype=torch.int32), pp, ks,
            vs]
    return [None if a is None else a.to(device) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("qdtype,pool", [(torch.bfloat16, "float"),
                                         (torch.float32, "float"),
                                         (torch.bfloat16, "int8"),
                                         (torch.bfloat16, "fp8")])
def test_paged_sparse_matches_plain(K, qdtype, pool, cuda_device):
    """K3 over an [8, 11] shortened table (`kernel_name="paged_sparse"`):
    the ragged entry (K = 1) and the verify entry (K = 4) against their
    plain versions, two launches to the same bits, counted as the
    sparse variant's."""
    args = _sparse_case(K, qdtype, pool, cuda_device)
    entry = "sparse" if K == 1 else "sparse_verify"
    counter = tpa._COUNTERS[(entry, None if pool == "float"
                             else args[1].dtype)]
    fn = (tpa.ragged_paged_attention if K == 1
          else tpa.verify_paged_attention)
    plain = (tpa.ragged_gather_reference if K == 1
             else tpa.verify_gather_reference)
    before = getattr(tpa, counter)
    got = fn(*args, kernel_name="paged_sparse")
    torch.cuda.synchronize()
    assert getattr(tpa, counter) == before + 1
    assert torch.equal(fn(*args, kernel_name="paged_sparse"), got)
    ref = plain(*args)
    tol = _VERIFY_TOL[(qdtype, pool)]
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    assert bool(((got - ref).abs() <= tol * (1 + ref.abs())).all()), \
        float((got - ref).abs().max())


# --------------------- weight-only projections (K4 at one group), LoRA

_WO_SHAPES = {"qkv": (1024, 3072), "out": (1024, 1024),
              "ffn1": (1024, 4096), "ffn2": (4096, 1024)}


def _wo_case(T, D, F, xdt, device, seed=0):
    """(x [T, D], int8 w [D, F], scale [F]) as a weight-only stack holds
    them in an engine of compute dtype `xdt` (scales cast to it)."""
    from paddle_tpu_torch.incubate.nn.fused_transformer import \
        _quantize_stack
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, D, generator=g).to(xdt)
    q, s = _quantize_stack(torch.randn(1, D, F, generator=g) / math.sqrt(D),
                           8)
    return x.to(device), q[0].to(device), s[0].to(xdt).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [256, 1, 7])
@pytest.mark.parametrize("proj", list(_WO_SHAPES))
@pytest.mark.parametrize("xdt,tol", [(torch.bfloat16, 2e-2),
                                     (torch.float32, 1e-4)])
def test_weight_only_mm_runs_k4_and_matches_plain(T, proj, xdt, tol,
                                                  cuda_device):
    """`_mm` with a scale on a CUDA tensor launches K4 once at one group
    (counted as a dense launch, not an expert one), gives the same bits
    twice, and matches the plain formula on the card: |kernel - plain|
    <= tol (1 + |plain|), tol as the grouped products'."""
    from paddle_tpu_torch.incubate.nn.fused_transformer import _MTConfig, _mm
    D, F = _WO_SHAPES[proj]
    x, w, s = _wo_case(T, D, F, xdt, cuda_device)
    cfg = _MTConfig(num_layers=1, num_heads=16, head_dim=64, dim_ff=4096,
                    quant_bits=8)
    counts = {n: getattr(tgmm, n) for n in (
        "dense_launch_count", "int8_launch_count", "int4_launch_count",
        "fp_launch_count")}
    got = _mm(cfg, x, w, s)
    torch.cuda.synchronize()
    for name, before in counts.items():
        assert getattr(tgmm, name) == before + (name == "dense_launch_count")
    assert got.shape == (T, F) and got.dtype == xdt
    assert torch.equal(_mm(cfg, x, w, s), got)
    plain = torch.matmul(x, tgmm.dequantize(w, s, D, xdt, 127.0))
    got, plain = got.float(), plain.float()
    assert torch.isfinite(got).all()
    assert bool(((got - plain).abs() <= tol * (1 + plain.abs())).all()), \
        float((got - plain).abs().max())
    # a [B, S, D] input keeps its leading axes
    got3 = _mm(cfg, x[None], w, s)
    assert got3.shape == (1, T, F)


@pytest.mark.cuda
def test_weight_only_mm_refuses_on_card(cuda_device):
    """A CUDA operand K4 cannot take raises; nothing falls back."""
    x, w, s = _wo_case(8, 64, 48, torch.bfloat16, cuda_device)
    before = tgmm.dense_launch_count
    with pytest.raises(TypeError):               # a float weight
        tgmm.weight_only_matmul(x, w.to(torch.bfloat16), s)
    with pytest.raises(TypeError):               # a scale of the wrong width
        tgmm.weight_only_matmul(x, w, s[:-1].contiguous())
    with pytest.raises(ValueError):              # a weight of other depth
        tgmm.weight_only_matmul(x, w[:32].contiguous(), s)
    with pytest.raises(ValueError):              # operands on two devices
        tgmm.weight_only_matmul(x, w.cpu(), s)
    assert tgmm.dense_launch_count == before


@pytest.mark.cuda
@pytest.mark.parametrize("moe", [None, "int8", "int4"])
def test_engine_never_casts_integer_weights(moe, cuda_device):
    """A bf16 engine over a weight-only stack keeps the int8 (packed
    int4) weights as the model's own tensors, not copies, casts the fp32
    scales to bf16 (fp16 int4 scales stay), and every decode step runs
    the dense projections through K4: 4 a layer dense, 2 a layer MoE."""
    torch.manual_seed(0)
    kw = {} if moe is None else dict(moe=dict(
        num_expert=4, top_k=2, capacity_factor=1.25,
        moe_quant_bits=4 if moe == "int4" else None))
    m = GPTForGeneration(vocab_size=193, hidden_size=128, num_layers=2,
                         num_attention_heads=2, max_position_embeddings=128,
                         weight_only=True, compute_dtype="bfloat16",
                         device=cuda_device, **kw)
    eng = ServingEngine(m, max_slots=2, block_size=16, max_seq_len=64,
                        cache_dtype="bfloat16", device=cuda_device)
    for li, pl in enumerate(eng._layers):
        for n in ("qkv_w", "out_w", "ffn1_w", "ffn2_w"):
            assert pl[n].dtype == torch.int8
            assert pl[n].data_ptr() == getattr(m.decoder, n)[li].data_ptr()
        assert pl["qkv_s"].dtype == torch.bfloat16
        assert pl["ffn1_s"].dtype == (torch.float16 if moe == "int4"
                                      else torch.bfloat16)
    before = tgmm.dense_launch_count
    out = eng.generate_batch([[5, 9, 23], [7, 1]], max_new_tokens=4)
    assert all(len(o) == 4 for o in out)
    assert tgmm.dense_launch_count - before == \
        eng.steps_run * 2 * (4 if moe is None else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_lora_delta_on_card_matches_cpu(dtype, tol, cuda_device):
    """`_lora_delta` on the card against the CPU at the serving widths
    (T 256, d 1024 -> 3072, rank 16, 3 slots): fp32 within 1e-5 (1 +
    |x|); the null slot's rows exactly 0 on both."""
    from paddle_tpu_torch.incubate.nn.fused_transformer import _lora_delta
    g = torch.Generator().manual_seed(0)
    T, K, D, F, r = 256, 3, 1024, 3072, 16
    x = torch.randn(T, D, generator=g).to(dtype)
    a = (torch.randn(K, D, r, generator=g) * 0.05).to(dtype)
    b = (torch.randn(K, r, F, generator=g) * 0.05).to(dtype)
    a[0] = 0
    b[0] = 0
    ids = torch.randint(0, K, (T,), generator=g)
    oh = (ids[:, None] == torch.arange(K)).float()
    want = _lora_delta(x, a, b, oh)
    got = _lora_delta(*(t.to(cuda_device) for t in (x, a, b, oh))).cpu()
    assert got.dtype == dtype
    assert not got[ids == 0].any() and not want[ids == 0].any()
    got, want = got.float(), want.float()
    assert bool(((got - want).abs() <= tol * (1 + want.abs())).all()), \
        float((got - want).abs().max())


@pytest.mark.cuda
def test_adapter_engine_on_card_matches_cpu(cuda_device):
    """A small fp32 model with three tenants on two usable slots, served
    on the card and on the CPU at 1 and 4 ticks: the same greedy tokens
    and adapter counters; null requests equal to an engine without
    adapters; pins and blocks back after the drain."""
    from paddle_tpu_torch.serving.adapters import make_random_adapter
    torch.manual_seed(0)
    kw = dict(vocab_size=193, hidden_size=128, num_layers=2,
              num_attention_heads=2, max_position_embeddings=128)
    cpu = GPTForGeneration(device="cpu", **kw)
    card = GPTForGeneration(device=cuda_device, **kw)
    card.load_state_dict(cpu.state_dict())
    ads = {t: make_random_adapter(cpu.decoder, 8, seed=i, scale=0.2)
           for i, t in enumerate(("a", "b", "c"))}
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 193, n).tolist() for n in (9, 5, 30, 3, 17)]
    mix = ["a", None, "b", "c", "a"]
    for ticks in (1, 4):
        outs = {}
        for dev, m in ((cuda_device, card), ("cpu", cpu)):
            eng = ServingEngine(m, max_slots=3, block_size=16,
                                max_seq_len=64, cache_dtype="float32",
                                max_adapters=3, lora_rank=8,
                                ticks_per_dispatch=ticks, device=dev)
            for t, w in ads.items():
                eng.register_adapter(t, w)
            reqs = [eng.submit(p, 8, adapter_id=t)
                    for p, t in zip(prompts, mix)]
            eng.run()
            assert eng.adapters.total_pins == 0
            assert eng.kv.blocks_in_use == 0
            c = eng.adapters
            outs[str(dev)] = ([list(r.output) for r in reqs],
                              (c.cache_hits, c.cache_misses, c.evictions))
        assert outs[str(cuda_device)] == outs["cpu"]
        assert outs["cpu"][1][2] >= 1
    base = ServingEngine(card, max_slots=3, block_size=16, max_seq_len=64,
                         cache_dtype="float32", device=cuda_device)
    want = base.generate_batch([prompts[1]], max_new_tokens=8)
    assert outs[str(cuda_device)][0][1] == want[0]


@pytest.mark.cuda
@pytest.mark.parametrize("moe", [None, "int4"])
def test_weight_only_engine_on_card_matches_cpu(moe, cuda_device):
    """A small fp32 weight-only model (dense; int8 attention with int4
    experts) on the card (K4 for every projection) and on the CPU (the
    plain formula): the same greedy tokens."""
    torch.manual_seed(0)
    kw = dict(vocab_size=193, hidden_size=128, num_layers=2,
              num_attention_heads=2, max_position_embeddings=128,
              weight_only=True)
    if moe:
        kw["moe"] = dict(num_expert=4, top_k=2, capacity_factor=1.25,
                         moe_quant_bits=4)
    cpu = GPTForGeneration(device="cpu", **kw)
    card = GPTForGeneration(device=cuda_device, **kw)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 193, n).tolist() for n in (9, 5, 30, 3)]
    ekw = dict(max_slots=4, block_size=16, max_seq_len=64,
               cache_dtype="float32")
    want = ServingEngine(cpu, device="cpu", **ekw).generate_batch(
        prompts, max_new_tokens=8)
    got = ServingEngine(card, device=cuda_device, **ekw).generate_batch(
        prompts, max_new_tokens=8)
    assert got == want


# --------------------------------- tensor- and expert-parallel serving


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_ragged_kernel_at_a_tp_ranks_heads(dtype, tol, cuda_device):
    """A tp = 2 rank of GPT-350M attends 8 of the 16 heads: the ragged
    entry over the rank's half of the heads against its plain version."""
    args = _case(dtype, cuda_device)
    args = [a[..., :8, :].contiguous() if a.dim() >= 3 else a for a in args]
    got = tpa.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    ref = tpa.ragged_gather_reference(*args)
    valid = args[4] >= 0
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got[valid].float(), ref[valid].float(),
                               rtol=tol, atol=tol)


#: a tp = 2 rank's dense weight-only products (GPT-350M's shard widths)
_TP_WO_SHAPES = {"qkv": (1024, 1536), "out": (512, 1024),
                 "ffn1": (1024, 2048), "ffn2": (2048, 1024)}


@pytest.mark.cuda
@pytest.mark.parametrize("proj", list(_TP_WO_SHAPES))
@pytest.mark.parametrize("xdt,tol", [(torch.bfloat16, 2e-2),
                                     (torch.float32, 1e-4)])
def test_weight_only_mm_at_tp_shard_widths(proj, xdt, tol, cuda_device):
    D, F = _TP_WO_SHAPES[proj]
    x, w, s = _wo_case(256, D, F, xdt, cuda_device)
    got = tgmm.weight_only_matmul(x, w, s, qmax=127.0)
    torch.cuda.synchronize()
    plain = torch.matmul(x, tgmm.dequantize(w, s, D, xdt, 127.0))
    got, plain = got.float(), plain.float()
    assert torch.isfinite(got).all()
    assert bool(((got - plain).abs() <= tol * (1 + plain.abs())).all()), \
        float((got - plain).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["fp", "int8", "int4"])
@pytest.mark.parametrize("d_in,d_out", [(1024, 2048), (2048, 1024)])
def test_grouped_matmul_at_tp_ep_shard_widths(fmt, d_in, d_out,
                                              cuda_device):
    """A tp = 2 x ep = 2 rank of MoE-350M runs 4 of the 8 experts at half
    the FFN width: [4, 80, d_in] x [4, d_in, d_out] bf16 against the
    plain version."""
    from paddle_tpu_torch.incubate.nn.fused_transformer import \
        _quantize_expert_stack
    g = torch.Generator().manual_seed(d_in)
    x = torch.randn(4, 80, d_in, generator=g).to(torch.bfloat16)
    wf = torch.randn(4, d_in, d_out, generator=g) / math.sqrt(d_in)
    if fmt == "fp":
        w, s = wf.to(torch.bfloat16), None
    else:
        q, s = _quantize_expert_stack(wf[None], 8 if fmt == "int8" else 4)
        w, s = q[0], s[0]
    x, w = x.to(cuda_device), w.to(cuda_device)
    s = None if s is None else s.to(cuda_device)
    got = tgmm.grouped_expert_matmul(x, w, s)
    torch.cuda.synchronize()
    want = tgmm.grouped_matmul_reference(x, w, s)
    got, want = got.float(), want.float()
    assert bool(((got - want).abs() <= 2e-2 * (1 + want.abs())).all()), \
        float((got - want).abs().max())


@pytest.mark.cuda
def test_tp_engines_on_card_match_one_rank(cuda_device, tmp_path):
    """Two ranks on the one card over gloo (NCCL takes a card a rank):
    fp32 TP = 2 dense and draft_k=3 engines give the card's 1-rank
    engine's tokens, and every rank the same; `tensor_parallel=1`
    without a group is the 1-rank engine. The model is the rank
    worker's seeded one at hidden 256 (head_dim 64, 2 heads a rank)."""
    import torch_tp_ranks as tr
    from paddle_tpu_torch.serving.distributed import TPServingEngine
    cases = {"dense": {}, "draft3": dict(draft_k=3)}
    jobs = [dict(name=n, model="seeded", hidden=256, tp=2, ep=1, kw=kw,
                 traffic="batch", device="cuda:0")
            for n, kw in cases.items()]
    ranks = tr.run_ranks(2, str(tmp_path), jobs)
    model = tr.seeded_model("cuda:0", 256)
    for name, kw in cases.items():
        want = tr.serve(ServingEngine(model, device="cuda:0",
                                      **dict(tr.BASE_KW, **kw)), "batch")
        assert ranks[0][name]["tokens"] == ranks[1][name]["tokens"] \
            == want["tokens"], name
        one = TPServingEngine(model, tensor_parallel=1, device="cuda:0",
                              **dict(tr.BASE_KW, **kw))
        assert tr.serve(one, "batch")["tokens"] == want["tokens"]


def _fleet_model(device):
    torch.manual_seed(0)
    return GPTForGeneration(vocab_size=193, hidden_size=128, num_layers=2,
                            num_attention_heads=2,
                            max_position_embeddings=128, device=device)


_FLEET_KW = dict(max_slots=3, block_size=16, max_seq_len=128,
                 token_budget=64, cache_dtype="float32")


@pytest.mark.cuda
def test_disagg_fleet_on_card_matches_monolithic(cuda_device):
    """One prefill and one decode replica on the card behind the router
    (fp32, 2 layers, the same token budget everywhere) give the card's
    monolithic engine's greedy tokens; the paged kernel launched steps x
    layers over both replicas; every block back after the drain."""
    import asyncio
    from paddle_tpu_torch.serving.distributed import ReplicaRouter
    from paddle_tpu_torch.serving.frontend import ServingFrontend
    model = _fleet_model(cuda_device)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 193, n).tolist() for n in (9, 40, 75, 3)]
    want = ServingEngine(model, device=cuda_device,
                         **_FLEET_KW).generate_batch(prompts, 12)
    engines = [ServingEngine(model, role=role, device=cuda_device,
                             **_FLEET_KW) for role in ("prefill", "decode")]
    router = ReplicaRouter([ServingFrontend(e) for e in engines],
                           roles=["prefill", "decode"])

    async def run():
        async with router:
            return await asyncio.gather(*[router.submit(p, 12)
                                          for p in prompts])
    before = tpa.launch_count
    got = asyncio.run(run())
    torch.cuda.synchronize()
    assert got == want
    assert router.stats()["migrations"]["handoff"] == len(prompts)
    assert tpa.launch_count - before == 2 * sum(e.steps_run
                                                for e in engines)
    for e in engines:
        assert e.kv.blocks_in_use == 0 and e.kv.allocator.invariant_ok


@pytest.mark.cuda
def test_two_replicas_from_two_threads_keep_launch_counts(cuda_device):
    """Two engines stepped from two threads at once: their tokens are
    each engine's alone, the paged kernel's count is exactly steps x
    layers summed over both, and each thread's own tally is its
    engine's steps x layers."""
    import threading
    model = _fleet_model(cuda_device)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 193, n).tolist() for n in (17, 60, 5, 33)]
    want = ServingEngine(model, device=cuda_device,
                         **_FLEET_KW).generate_batch(prompts, 24)
    engines = [ServingEngine(model, device=cuda_device, **_FLEET_KW)
               for _ in range(2)]
    outs, mine = [None, None], [None, None]

    def serve(i):
        before = tpa.thread_counts().get("launch_count", 0)
        outs[i] = engines[i].generate_batch(prompts, 24)
        mine[i] = tpa.thread_counts()["launch_count"] - before
    torch.cuda.synchronize()
    before = tpa.launch_count
    threads = [threading.Thread(target=serve, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert outs == [want, want]
    assert tpa.launch_count - before == 2 * sum(e.steps_run
                                                for e in engines)
    assert mine == [2 * e.steps_run for e in engines]


@pytest.mark.cuda
def test_two_threads_build_an_unbuilt_kernel_once(cuda_device, tmp_path,
                                                  monkeypatch):
    """Two threads loading a kernel that is not built yet (a fresh build
    directory) run nvcc once and load one library."""
    import subprocess
    import threading
    from paddle_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    runs = []
    real = subprocess.run

    def counting(cmd, *a, **kw):
        runs.append(cmd[0])
        return real(cmd, *a, **kw)
    monkeypatch.setattr(_build.subprocess, "run", counting)
    libs = []
    threads = [threading.Thread(target=lambda: libs.append(_build.load(
        "paged_attention", tpa._SIGNATURES))) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(runs) == 1 and runs[0].endswith("nvcc")
    assert len(libs) == 2 and libs[0] is libs[1]
    assert [p.suffix for p in (tmp_path / "build").iterdir()] == [".so"]


# ------------------------------------------- generate(), swap and bundles


def _gen_pair(cuda_device, **kw):
    """The fp32 2-layer model on the CPU and the same weights on the
    card."""
    import copy
    torch.manual_seed(3)
    cpu = GPTForGeneration(vocab_size=193, hidden_size=128, num_layers=2,
                           num_attention_heads=2, max_position_embeddings=128,
                           device="cpu", **kw)
    return cpu, copy.deepcopy(cpu).to(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("stack", ["dense", "weight-only", "moe"])
def test_generate_on_card_matches_cpu(stack, cuda_device):
    """generate() on the card: the scan equals the loop, draft_k=3 equals
    greedy, and fp32 tokens and gen_lens equal the CPU's (tolerance 0);
    K4 launches exactly a forward's projections (weight-only: 4 a layer)
    or expert products (MoE: 2 a layer) for each of the M forwards of a
    scan, nothing on the dense stack."""
    kw = {"dense": {}, "weight-only": dict(weight_only=True),
          "moe": dict(moe=dict(num_expert=4, top_k=2,
                               capacity_factor=2.0))}[stack]
    cpu, card = _gen_pair(cuda_device, **kw)
    ids = np.array([[5, 6, 7, 0, 0], [8, 9, 1, 2, 3]], np.int64)
    gkw = dict(max_new_tokens=12, seq_lens=[3, 5], cache_dtype="float32")
    want = cpu.generate(ids, **gkw)
    eos = int(want[0][1, 4])
    counters = ("dense_launch_count", "fp_launch_count",
                "int8_launch_count", "int4_launch_count")
    before = {c: getattr(tgmm, c) for c in counters}
    scan = card.generate(ids, **gkw)
    torch.cuda.synchronize()
    got = {c: getattr(tgmm, c) - before[c] for c in counters}
    per = {"dense": {}, "weight-only": {"dense_launch_count": 4 * 2},
           "moe": {"fp_launch_count": 2 * 2}}[stack]
    assert got == {c: 12 * per.get(c, 0) for c in counters}
    for a, b in zip(scan, want):
        assert a.is_cuda and torch.equal(a.cpu(), b)
    for extra in (dict(use_scan=False), dict(draft_k=3)):
        for a, b in zip(card.generate(ids, **gkw, **extra), want):
            assert torch.equal(a.cpu(), b)
    e_cpu = cpu.generate(ids, eos_token_id=eos, **gkw)
    e_card = card.generate(ids, eos_token_id=eos, use_scan=False, **gkw)
    for a, b in zip(e_card, e_cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_swap_weights_on_card_equals_fresh_engine(cuda_device):
    """A card engine swapped to v2 holds a fresh v2 card engine's tensors
    bit for bit (bf16 compute: the cast runs on the card), keeps its
    buffers across swaps, and serves its tokens."""
    from paddle_tpu_torch.serving.fleet import weights_from_model
    kw = dict(max_slots=3, block_size=16, max_seq_len=128, token_budget=64,
              cache_dtype="bfloat16", device=cuda_device)

    def model(seed):
        torch.manual_seed(seed)
        return GPTForGeneration(vocab_size=193, hidden_size=128,
                                num_layers=2, num_attention_heads=2,
                                max_position_embeddings=128,
                                compute_dtype="bfloat16", device=cuda_device)
    m1, m2 = model(1), model(2)
    eng = ServingEngine(m1, **kw)
    prompts = [[5, 9, 23, 1], [7, 1, 3]]
    eng.generate_batch(prompts, 8)
    eng.swap_weights(weights_from_model(m2), "v2")
    ptrs = {k: t.data_ptr() for k, t in eng._weight_slots().items()}
    eng.swap_weights(m1._gen_tensors(), "v1")
    eng.swap_weights(m2._gen_tensors(), "v2")
    assert {k: t.data_ptr() for k, t in eng._weight_slots().items()} == ptrs
    fresh = ServingEngine(m2, **kw)
    for k, t in fresh._weight_slots().items():
        assert torch.equal(eng._weight_slots()[k], t), k
    assert eng.generate_batch(prompts, 8) == fresh.generate_batch(prompts, 8)


@pytest.mark.cuda
def test_bundle_boot_runs_no_nvcc(cuda_device, tmp_path):
    """A replica booted from a bundle in a process that has built the
    kernels runs no nvcc, and serves the exporting engine's tokens."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.serving.fleet import (boot_engine_from_bundle,
                                                export_bundle)
    model = _fleet_model(cuda_device)
    eng = ServingEngine(model, device=cuda_device, **_FLEET_KW)
    prompts = [[5, 9, 23, 1] * 5, [7, 1, 3]]
    want = eng.generate_batch(prompts, 8)
    bdir = export_bundle(eng, str(tmp_path), version="v1")
    runs = _build.nvcc_runs
    boot = boot_engine_from_bundle(bdir, device=cuda_device)
    assert boot.generate_batch(prompts, 8) == want
    assert _build.nvcc_runs == runs and boot.weights_version == "v1"


# the mesh card tests' widths: vocab and seq_len divide over mp = 2, one
# head of 64 a rank at mp = 2
_MESH_WIDTHS = dict(vocab_size=194, seq_len=200, d_model=128, n_heads=2,
                    n_layers=2, d_ff=512, learning_rate=1e-3, grad_clip=1.0,
                    remat=True, ce_seq_chunks=2, zero_stage=0)


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _mesh_ranks(tmp_path, jobs, device, **inputs):
    """Two `torch_mesh_ranks` ranks over gloo on `device` (both on the
    one card for "cuda:0") running `jobs`; returns each rank's
    results."""
    import torch_mesh_ranks as mr
    d = tmp_path / device.replace(":", "")
    d.mkdir()
    torch.save(dict(jobs={2: jobs}, device=device, **inputs),
               d / "inputs.pt")
    return mr.run_ranks(2, str(d))


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [dict(mp=2, sequence_parallel=True),
                                  dict(pp=2, micro_batches=2)],
                         ids=["mp2-sp", "pp2-micro2"])
def test_mesh_steps_on_card_match_cpu_ranks(mesh, cuda_device, tmp_path):
    """Two ranks on the one card over gloo (kernels) and two CPU ranks
    (plain versions) take the same two fp32 steps from the same
    parameters: every rank's losses equal, the card's within 1e-4
    relative of the CPU's, parameters after step 1 within 0.25 lr
    (`chip_smoke.py`'s phase 7 bound), and each card rank's K1a and K2
    launches as full remat predicts for its layers x micro-batches."""
    cfg = th.GPTConfig(**_MESH_WIDTHS, compute_dtype=torch.float32)
    params = th.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = (_numpy_tree(params),
             _numpy_tree(th.init_opt_state(cfg, params)))
    rng = np.random.RandomState(0)
    steps = [tuple(rng.randint(0, 194, (4, 200)) for _ in range(2))
             for _ in range(2)]
    job = [("job", "train", dict(_MESH_WIDTHS, **mesh))]
    res = {dev: [r["job"] for r in _mesh_ranks(
        tmp_path, job, dev, state=state, batches=steps, eval=steps[0])]
        for dev in ("cpu", "cuda:0")}
    per = len(steps) * cfg.n_layers // mesh.get("pp", 1) \
        * mesh.get("micro_batches", 1)
    for r, (c, g) in enumerate(zip(res["cpu"], res["cuda:0"])):
        assert g["losses"] == res["cuda:0"][0]["losses"], r
        np.testing.assert_allclose(g["losses"], c["losses"], rtol=1e-4)
        for (n, a), (_, b) in zip(th._leaves(g["params1"]),
                                  th._leaves(c["params1"])):
            assert float((a - b).abs().max()) <= 0.25 * cfg.learning_rate, n
        assert g["launches"] == {"flash_fwd": 2 * per, "flash_bwd": per,
                                 "add_ln_fwd": 2 * per, "add_ln_bwd": per}


@pytest.mark.cuda
def test_ring_attention_on_card_matches_cpu(cuda_device, tmp_path):
    """`ring_attention` at cp 2 with both ranks on the card (the blocks
    staged through the host by gloo) equals its CPU run: the output and
    the gradients of (out * g).sum(), causal and not."""
    rng = np.random.RandomState(0)
    ring = {n: rng.randn(2, 256, 4, 64).astype(np.float32)
            for n in ("q", "k", "v", "g")}
    jobs = [(f"causal{c}", "ring", dict(causal=c)) for c in (False, True)]
    res = {dev: _mesh_ranks(tmp_path, jobs, dev, ring=ring)
           for dev in ("cpu", "cuda:0")}
    for r, (c, g) in enumerate(zip(res["cpu"], res["cuda:0"])):
        for name, _, _ in jobs:
            for k in ("out", "dq", "dk", "dv"):
                torch.testing.assert_close(g[name][k], c[name][k],
                                           rtol=1e-5, atol=1e-5,
                                           msg=f"rank {r} {name} {k}")
