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
    dz = tln._launch_bwd(z, w, mu, rs, g2, gz2)
    torch.cuda.synchronize()
    assert tln.bwd_launch_count == before + 1
    torch.testing.assert_close(
        dz.float(), tln.add_ln_bwd_reference(z, w, mu, rs, g2, gz2).float(),
        rtol=tol, atol=tol)


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
# chunks added in the same order, the sums inside a chunk in another:
# 1e-5 relative on values ~sqrt(N), atol 1e-3.
@pytest.mark.cuda
@pytest.mark.parametrize("N,Ci,Co,chunk", [(512, 128, 128, 128),
                                           (4096, 256, 64, 4096),
                                           (1000, 72, 40, 200),
                                           (96, 8, 8, 48)])
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


def _gmm_case(E, C, D, F, variant, device, seed=0):
    """(x, w, scale) of one variant: "fp32" / "bf16" float experts,
    "int8" / "int4" quantized experts under bf16 activations."""
    g = torch.Generator().manual_seed(seed)
    xdt = torch.float32 if variant == "fp32" else torch.bfloat16
    x = torch.randn(E, C, D, generator=g).to(xdt)
    w = torch.randn(E, D, F, generator=g) / math.sqrt(D)
    scale = None
    if variant in ("fp32", "bf16"):
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
                 "int8": "int8_launch_count", "int4": "int4_launch_count"}


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 5, 80, 200])
@pytest.mark.parametrize("E,D,F", [(2, 64, 72), (3, 38, 50), (1, 96, 8)])
@pytest.mark.parametrize("variant", ["fp32", "bf16", "int8", "int4"])
def test_gmm_kernels_match_plain(C, E, D, F, variant, cuda_device):
    """Each K4 kernel against the plain version on the card, at ragged
    shapes (C across one and two 128-row passes; D and F off the 16 and
    64 tiles; F = 50 takes the element-wise loads). fp32: sums in
    another order, 1e-4. bf16 outputs: the same bf16 operands (the
    quantized kernels round the dequantized weights where the plain
    version does), multiplied in fp32, one output rounding — 1e-2."""
    x, w, scale = _gmm_case(E, C, D, F, variant, cuda_device)
    counts = {n: getattr(tgmm, n) for n in set(_GMM_COUNTERS.values())}
    got = tgmm.grouped_expert_matmul(x, w, scale)
    torch.cuda.synchronize()
    for name, before in counts.items():
        assert getattr(tgmm, name) == before + (
            name == _GMM_COUNTERS[variant])
    want = tgmm.grouped_matmul_reference(x, w, scale)
    assert got.dtype == x.dtype and got.shape == (E, C, F)
    assert torch.isfinite(got.float()).all()
    tol = 1e-4 if variant == "fp32" else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


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
    with pytest.raises(RuntimeError, match="grad"):
        tgmm.grouped_expert_matmul(x.requires_grad_(), w)


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
def test_flash_seg_backward_raises_on_card(cuda_device):
    q = torch.randn(2, 2, 128, 64, device=cuda_device, requires_grad=True)
    keep = torch.ones(2, 128, dtype=torch.int32, device=cuda_device)
    out = tfa.splash_mha(q, q, q, causal=False, kv_keep=keep)
    with pytest.raises(NotImplementedError, match="K1c backward"):
        out.sum().backward()


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
