"""Chip smoke of the PyTorch/CUDA port (`paddle_tpu_torch`) on one
NVIDIA card.

    python3 chip_smoke.py          # from the repository root

Drives the port's paths end to end — serving a dense GPT-350M, serving
it speculatively over bf16, int8 and fp8 KV pools, serving it with
several decode ticks a dispatch and with penalties, serving the
8-expert MoE-350M with float, int8 and int4 experts, the train step
(with and without the fused QKV projection), the paddle-layout
`flash_attention()` entry, the `wgrad_1x1` entry, BERT-base
inference over padded batches and BERT-base pretraining through
`hapi.Model` with LAMB and AMP O2 — and holds every
CUDA kernel on them against its plain PyTorch version. Phases, one line
each (or a few):

1. device — the card's name, count, and `nvidia-smi` name/power limit;
2. build — every kernel source compiled with nvcc (one process per
   source, all started together);
3. kernel check — each kernel against its plain version at the shapes
   its path gives it (paged attention at the serving step's: the ragged
   entry over float, int8 and fp8 pools, the verify entry (4 queries a
   group, a short group padded with position 0, a group of slot -1)
   over the same three, two launches of each bit-identical, and the
   dense engine's pure-decode step as `pack_step` lays it out (8
   decodes, padding to 256 tokens) over the same three, beside the
   decode entry `paged_attention()`; the three
   grouped expert matmuls — float, int8 and int4 experts — at the MoE
   step's two expert products, each with its bytes/s and share of its
   bound; flash attention forward/backward (with their TFLOP/s and share
   of the bound), add+LayerNorm forward/backward (dw and db included,
   two launches of each bit-identical, GB/s beside F.layer_norm's) and
   the fused QKV projection (forward, and its gradients through
   autograd) at the train step's; the
   paddle-layout flash forward at [8, 1024, 16, 128] causal and full,
   [8, 1024, 8, 256] causal, and forward + backward through
   `flash_attention()`, these two with their TFLOP/s and share of the
   bound; the split-K 1x1 weight gradient at ResNet-50's
   [401408, 256] x [401408, 64] and, timed beside `torch.mm` too, its
   stage-3 [25088, 1024] x [25088, 256] (two launches of each
   bit-identical); the segmented flash forward and its
   backward at BERT's [64, 12, 128, 64] and [16, 12, 512, 64] under
   trailing, left and interleaved padding, fp32 and causal too, the
   forward also at S = 77 and 200 and over a sequence of full length
   beside one of length 1, both with the share of tile pairs their
   segment ranges keep), with
   times (CUDA events,
   L2 flushed
   between launches), the card's bound for the same work and, where one
   PyTorch call computes the same function, that call's time as a
   yardstick the port never calls;
4. serve — a full-width GPT-350M (random weights from a numpy seed,
   carried in through `convert.load_jax_gpt`) served by the port's
   `ServingEngine`: 16 requests to completion; paged attention must
   have launched once per layer per step;
5. on-card correctness — two served requests re-scored by the plain
   dense causal forward in fp32, teacher-forced on the engine's output;
   then a short profiled window of decode steps (host vs device time,
   the paged kernels' share);
5a. serve spec — the same model served by three speculative engines
   (draft_k=3, n-gram drafting) over bf16, int8 and fp8_e4m3 KV pools,
   each taking the 16 requests: every request finishes, the engine's
   verify variant and its ragged variant launched once per layer per
   step (no other paged variant), the bf16 engine's every token is the
   fp32 argmax of the plain dense forward or within its near-tie
   margin, and the int8/fp8 engines' share of tokens equal to the bf16
   engine's is reported; then a profiled window of speculative decode
   steps;
5e. serve multitick — the same model served by engines that run up to
   4 decode ticks a dispatch without the host (`ticks_per_dispatch=4`
   and "auto"; draft_k=3 at 4 ticks over bf16, int8 and fp8 pools; a
   penalized greedy pair, repetition 1.2 and presence 0.5, at 1 and 4
   ticks), each on the 16 requests with every dispatch's ticks under
   `torch.cuda.set_sync_debug_mode("error")`: tokens equal to phase 4's
   1-tick engine, to phase 5a's engine of the same pool and to each
   other; launches held exactly (the paged variants issued ticks x 24,
   nothing else); more ticks than dispatches; dispatches, issued and
   executed ticks, early exits, tokens/s, TTFT and host ms a dispatch
   printed; then one profiled 4-tick dispatch (device ms a tick);
5d. on-card spec check — fp32, 2 layers at full width: the draft_k=3
   float-pool engine on the card (kernels) gives the same greedy tokens
   and draft counts as on a CPU copy (plain versions) and as the card's
   draft_k=0 engine, unless the first differing token sat at an fp32
   top-2 logit gap under 1e-5; int8 and fp8 pools reported, not held;
5f. on-card multi-tick check — the same 2-layer fp32 model, draft_k=3
   with the penalties at 4 ticks: the card's greedy tokens equal a CPU
   copy's and the card's 1-tick engine's; seeded penalized sampling at
   4 ticks equals its 1-tick twin on the card;
5b. serve MoE — MoE-350M (bench_gpt_moe's widths: GPT-350M with every
   FFN 8 experts, top-2, capacity factor 1.25; random weights from a
   numpy seed through `convert.load_jax_gpt(moe=...)`) served by three
   engines in turn, `moe_weight_dtype` None, "int8" and "int4", each
   taking the dense phase's 16 requests: every request finishes, paged
   attention launched once and the engine's grouped-matmul variant twice
   per layer per step (the other two never), and every valid token's
   two choices are counted or dropped; then a profiled decode window of
   each engine, with the grouped matmuls' share of its device time; and
   the float experts at 4 ticks a dispatch (sync debug on): the float
   1-tick engine's tokens, paged attention issued ticks x 24 and the
   float grouped matmul issued ticks x 48 launches, routed + dropped =
   2 x 24 x valid tokens over the ticks that counted;
5c. on-card MoE check — fp32, 2 layers at full width, float and int8
   experts: 4 requests served on the card (kernels) and on a CPU copy
   (plain versions) give the same greedy tokens, unless the first
   expert choice that differs, at or before the first differing token,
   sat at a near-tie of the top-k gate boundary (reported as the cause);
6. train — GPT-350M at full width in `bench_gpt`'s exact config (bf16,
   bf16 grads, remat with remat_policy="save_splash_residuals", fused
   CE in 4 chunks) trained by the port's `HybridGPT` at batch 8 for
   warm-up and timed steps on one fixed batch (random weights from a
   numpy seed through `convert.load_jax_hybrid_gpt`): finite, falling
   loss, and every train kernel launched exactly as the policy predicts
   per step (the flash forward once a layer); then one profiled step
   (K1a's forward and backward device ms on lines of their own),
   and the same steps timed at bench_gpt's batch 32; then batch 8 again
   with remat_policy None (the flash forward twice a layer) and with
   qkv_kernel=True (the fused projection twice a layer), side by side,
   the last with one profiled step (the fused projection's device ms and
   its share of the step's device time);
7. on-card train check — one fp32 step of the same widths at 2 layers
   on the card (kernels) and on a CPU copy (plain versions), remat off
   and with the residuals kept and the fused projection: loss and every
   parameter after the step must agree, and the card's step with the
   residuals kept must agree with its full-remat step;
7a. `flash_attention()` — three forward + backward calls at
   [8, 1024, 16, 128] bf16 causal: its forward kernel launched once a
   call, no other kernel;
7b. `wgrad_1x1` — three calls at ResNet-50's shape: one launch a call,
   the same bits each time;
7c. serve BERT — BERT-base (random weights from a numpy seed, carried
   in through `convert.load_jax_bert`, bf16, eval) as a two-class
   `BertForSequenceClassification` over padded batches: 64 sequences at
   S = 128, then 16 at S = 512, each forward timed; the segmented flash
   forward launched exactly once a layer a forward, no other kernel;
   one profiled forward of each batch;
7d. on-card BERT check — (a) the bf16 forward's logits, pooled output
   and real rows of the sequence output against an fp32 forward of the
   same weights written from plain tensor ops (the segmented kernel's
   plain version for attention); (b) a 2-layer fp32 BERT at full width,
   card (kernels) against a CPU copy (plain versions), every row;
   (c) the same 8 sequences batched at S = 128 and S = 512 give the same
   logits; (d) every output finite;
7e. train BERT — BERT-base pretraining (random weights from a numpy
   seed through `convert.load_jax_bert(head="pretraining")`,
   `amp.decorate(level="O2")`, `Lamb(1e-3, lamb_weight_decay=0.01)`,
   `Model.train_batch`, hidden dropout 0.1), 2 warm-up and 10 timed
   steps on one fixed batch in two configurations: (A) attention
   dropout 0, 16 sequences at S = 512 with lengths 64-512, every layer's
   attention through the segmented flash forward and backward (each
   exactly once a layer a step, no other kernel); (B) bench_bert's own
   step, attention dropout 0.1, 64 unpadded sequences at S = 128 (the
   additive path: no kernel); each a finite, falling loss; then one
   profiled step of (A);
7f. on-card train check — (a) one fp32 LAMB step of a 2-layer BERT at
   full width on the card (kernels) and on a CPU copy (plain versions):
   the loss and every parameter agree; (b) two bf16 (A) steps from the
   same weights after the same `seed()`: every parameter bit-identical;
8. a JSON line listing every kernel with its launches, error and times;
9. the last line, `{"ok": true, "device": {...}}`.

Any failed phase raises and exits non-zero; without a card the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# GPT-350M: bench.py's bench_decode config (GPT-2 medium widths)
VOCAB, HIDDEN, LAYERS, HEADS, MAXPOS = 50304, 1024, 24, 16, 2048
SLOTS, BLOCK, MAX_SEQ, BUDGET = 8, 16, 1024, 256
N_REQUESTS, PROMPT_LENS, NEW_TOKENS = 16, (64, 512), 64
SEED = 0

# MoE-350M: bench.py's bench_gpt_moe (GPT-350M widths, every FFN 8
# experts, top-2, capacity factor 1.25)
MOE = dict(num_expert=8, top_k=2, capacity_factor=1.25)

# GPT-350M train step: bench.py's bench_gpt TPU config at batch 8 (its
# own batch, 32, is timed after it)
TRAIN_BATCH, BENCH_BATCH, TRAIN_SEQ = 8, 32, 1024
WARMUP_STEPS, TIMED_STEPS = 3, 5

# the split-K 1x1 weight gradient at ResNet-50's largest 1x1 wgrad (the
# JAX kernel's docstring: N = B*H*W = 401408 rows, 256 -> 64 channels),
# and its tolerance relative to each sum's absolute mass (check_wgrad)
WGRAD_N, WGRAD_CI, WGRAD_CO, WGRAD_CHUNK = 401408, 256, 64, 4096
WGRAD_TOL = 1e-6
# a second ResNet-50 1x1 wgrad, stage 3 at batch 128 (N = 128 x 14 x 14,
# 1024 -> 256 channels), timed so the kernel is not tuned to one shape
WGRAD_SHAPE2 = (25088, 1024, 256, 3136)

# BERT-base (bench.py's bench_bert: `bert_base()`, BertModel's
# defaults) served in eval as a two-class sequence classifier: 64
# sequences at S = 128 with lengths uniform in 16-128 (bench_bert's B and
# S), then 16 at BERT's longest S = 512 with lengths 64-512; each batch
# warmed up, then BERT_FORWARDS forwards timed
BERT = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
            num_attention_heads=12, intermediate_size=3072,
            max_position_embeddings=512, type_vocab_size=2)
BERT_BATCHES = ((64, 128, 16), (16, 512, 64))   # (sequences, S, shortest)
BERT_FORWARDS = 10
# BERT-base pretraining through `hapi.Model` (bench.py's bench_bert step:
# AMP O2, LAMB(lr 1e-3, weight decay 0.01), BertPretrainingCriterion),
# hidden dropout 0.1: (A) attention dropout 0 (every layer's attention
# through K1c forward and backward), 16 sequences at S = 512 with lengths
# 64-512 (bench_bert's 8192 token slots), 15% of real tokens MLM labels;
# (B) bench_bert's own step, attention dropout 0.1 (the additive path),
# 64 unpadded sequences at S = 128. (label, attention dropout,
# sequences, S, shortest); BERT_WARMUP then BERT_STEPS steps on one
# fixed batch.
BERT_TRAIN = (("A", 0.0, 16, 512, 64), ("B", 0.1, 64, 128, 128))
BERT_WARMUP, BERT_STEPS = 2, 10
BERT_LR, BERT_WD = 1e-3, 0.01
# the bf16 card forward against an fp32 forward of the same (bf16-held)
# weights, |bf16 - fp32| <= tol (1 + |fp32|): each of 12 layers rounds
# the residual stream to bf16 twice where it reaches |x| ~ 5 (a bf16
# spacing of 2^-5 there) and every product's output once, and each
# LayerNorm carries those roundings onto its unit-scale output: a few
# such spacings at the worst of ~10^7 elements (the same forward in bf16
# on the CPU, 8 sequences at S = 128, reached 0.044).
BERT_TOL = 2 ** -4
# the same 8 sequences batched at S = 128 and at S = 512 (bf16): real
# rows never see padding, so the two differ only where cuBLAS tiles the
# two batch sizes' products differently and rounds them to bf16 at other
# places: a few bf16 spacings of the O(1) logits.
PAD_TOL = 2 ** -6

# NVIDIA H100 SXM data-sheet peaks (dense): device memory bytes/s, and
# flop/s by operand type (fp32 outside the tensor cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

# kernel-vs-plain tolerance on valid rows: |kernel - plain| <= tol +
# tol * |plain|. fp32: both sides sum in fp32 in another order. bf16:
# the plain version rounds logits and probabilities to bf16 (8
# significant bits) before its products, the kernel keeps them fp32,
# and both round the output — a bf16 spacing or two (2^-6 at |x| ~ 2).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# paged attention over int8/fp8 pools, same form: the plain version also
# dequantizes in q's dtype (the scale and the product each rounded to
# bf16) where the kernel dequantizes in fp32, about one more bf16 spacing
# of every key and value; in fp32 both dequantize alike.
QTOL = {"float32": 1e-5, "bfloat16": 3e-2}
# speculative serving: draft_k (bench.py's engine speculation lane) and
# the JAX engine's default n-gram order and drafting window
DRAFT_K, DRAFT_NGRAM, DRAFT_RING = 3, 3, 128
# the train kernels, same form. fp32: sums in another order; the flash
# backward subtracts two nearly equal D-term dot products (ds = p * (dp
# - delta)), so its fp32 error scales with their size. bf16: kernels
# and plain versions multiply bf16 operands in fp32, round p and ds to
# bf16 before the products they feed (as splash does) and round the
# outputs once: a bf16 spacing or two of values up to ~4.
TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the grouped expert matmuls, same form. fp32: sums of 1024-4096 terms
# in another order. bf16: both sides multiply the same bf16 operands
# (the quantized kernels round the dequantized weights where the plain
# version does) in fp32 and round the output once — a bf16 spacing.
GMM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


# the paged kernels' names, as the profiler reports them
PAGED_KERNELS = ("paged_attend_kernel", "verify_walk_kernel",
                 "ragged_plan_kernel")


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, iters=20, warmup=3, flush=None):
    """Mean device ms of `fn` over `iters` launches timed by CUDA
    events, with `flush` (a large buffer) rewritten before each launch
    so every launch finds L2 cold, as it does inside the 24-layer
    step. A ~2 ms spin of the card is queued before the start event, so
    the wrapper's host work has enqueued the launch by the time the
    card reaches the event: the time is the card's, not the host's."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(4_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# ------------------------------------------------------------- phase 3


def paged_case(dtype, device, seed=SEED):
    """The serving step's paged-attention inputs at full width: H=16,
    Dh=64, BS=16, T=256 flat tokens over 8 slots with contexts up to
    1024 — five decode tokens, three prefill chunks (one mid-sequence),
    and padding tokens of slot -1."""
    import torch
    g = torch.Generator().manual_seed(seed)
    H, Dh = HEADS, HIDDEN // HEADS
    MB = MAX_SEQ // BLOCK
    NB = SLOTS * MB + 1
    ctx = [1024, 960, 777, 512, 300, 129, 64, 17]
    bt = torch.zeros(SLOTS, MB, dtype=torch.int32)
    perm = torch.randperm(NB - 1, generator=g) + 1
    for s, n in enumerate(ctx):
        nb = -(-n // BLOCK)
        bt[s, :nb] = perm[s * MB:s * MB + nb].int()
    slots, pos = [], []
    for s in (0, 1, 2, 4, 5):                      # decodes
        slots.append(s)
        pos.append(ctx[s] - 1)
    for s, start in ((3, 384), (6, 0), (7, 0)):    # prefill chunks
        slots += [s] * (ctx[s] - start)
        pos += list(range(start, ctx[s]))
    pad = BUDGET - len(slots)
    slots += [-1] * pad
    pos += [0] * pad
    q = torch.randn(BUDGET, H, Dh, generator=g).to(dtype)
    kp = torch.randn(NB, BLOCK, H, Dh, generator=g).to(dtype)
    vp = torch.randn(NB, BLOCK, H, Dh, generator=g).to(dtype)
    args = [q, kp, vp, bt, torch.tensor(slots, dtype=torch.int32),
            torch.tensor(pos, dtype=torch.int32)]
    return [a.to(device) for a in args]


def verify_case(dtype, device, kind="float", seed=SEED):
    """The verify region's paged-attention inputs at full width: 8
    groups of K = DRAFT_K + 1 queries (H=16, Dh=64, BS=16) over the
    `paged_case` contexts — six full groups ending at their slot's
    newest position, one short group [p, p+1, 0, 0] padded with position
    0 (as `pack_step` pads it), one group of slot -1 at positions 0 —
    over float pools in `dtype`, or "int8" / "fp8" pools quantized as
    the engine quantizes on append. Returns [q, k, v, tables, slots,
    positions, k_scale, v_scale]."""
    import torch
    g = torch.Generator().manual_seed(seed)
    H, Dh, K = HEADS, HIDDEN // HEADS, DRAFT_K + 1
    MB = MAX_SEQ // BLOCK
    NB = SLOTS * MB + 1
    ctx = [1024, 960, 777, 512, 300, 129, 64, 17]
    bt = torch.zeros(SLOTS, MB, dtype=torch.int32)
    perm = torch.randperm(NB - 1, generator=g) + 1
    for s, n in enumerate(ctx):
        nb = -(-n // BLOCK)
        bt[s, :nb] = perm[s * MB:s * MB + nb].int()
    slots = list(range(6)) + [6, -1]
    pos = [[ctx[s] - K + j for j in range(K)] for s in range(6)]
    pos += [[ctx[6] - 2, ctx[6] - 1] + [0] * (K - 2), [0] * K]
    q = torch.randn(SLOTS, K, H, Dh, generator=g).to(dtype)
    kp, vp, ks, vs = quantized_pools(NB, dtype, kind, g)
    args = [q, kp, vp, bt, torch.tensor(slots, dtype=torch.int32),
            torch.tensor(pos, dtype=torch.int32), ks, vs]
    return [None if a is None else a.to(device) for a in args]


def paged_decode_case(dtype, device, kind="float", seed=SEED,
                      ctx=(1024, 960, 777, 512, 300, 129, 64, 17)):
    """The dense engine's pure-decode step at full width, as the port's
    `pack_step` lays it out: one decode token for each of the 8 slots at
    contexts `ctx` (`paged_case`'s), then padding of slot -1 at position
    0 to T = 256; float pools in `dtype`, or "int8" / "fp8" pools
    quantized as the engine quantizes. Returns the ragged entry's [q, k,
    v, tables, slots, positions, k_scale, v_scale]."""
    import torch
    from paddle_tpu_torch.serving.batcher import pack_step
    g = torch.Generator().manual_seed(seed)
    H, Dh = HEADS, HIDDEN // HEADS
    MB = MAX_SEQ // BLOCK
    NB = SLOTS * MB + 1
    bt = torch.zeros(SLOTS, MB, dtype=torch.int32)
    perm = torch.randperm(NB - 1, generator=g) + 1
    for s, n in enumerate(ctx):
        nb = -(-n // BLOCK)
        bt[s, :nb] = perm[s * MB:s * MB + nb].int()
    plan = pack_step(BUDGET, SLOTS, [(s, 0, ctx[s] - 1)
                                     for s in range(SLOTS)], [])
    q = torch.randn(BUDGET, H, Dh, generator=g).to(dtype)
    kp, vp, ks, vs = quantized_pools(NB, dtype, kind, g)
    args = [q, kp, vp, bt, torch.from_numpy(plan.slot_ids),
            torch.from_numpy(plan.positions), ks, vs]
    return [None if a is None else a.to(device) for a in args]


def quantized_pools(NB, dtype, kind, g):
    """(k_pool, v_pool, k_scale, v_scale) of random K/V rows: float pools
    in `dtype` without scales, or "int8" / "fp8" pools quantized per
    entry and head by the engine's `quantize_kv`."""
    import torch
    from paddle_tpu_torch.serving.engine import quantize_kv
    H, Dh = HEADS, HIDDEN // HEADS
    kf = torch.randn(NB, BLOCK, H, Dh, generator=g)
    vf = torch.randn(NB, BLOCK, H, Dh, generator=g)
    if kind == "float":
        return kf.to(dtype), vf.to(dtype), None, None
    kv_dtype = "int8" if kind == "int8" else "fp8_e4m3"
    (kp, ks), (vp, vs) = quantize_kv(kf, kv_dtype), quantize_kv(vf, kv_dtype)
    return kp, vp, ks, vs


def as_ragged(args):
    """A verify call's inputs as the ragged entry's: one query per
    token, each group's slot repeated."""
    q, kp, vp, bt, slots, pos, ks, vs = args
    N, G = pos.shape
    return [q.reshape(N * G, *q.shape[2:]), kp, vp, bt,
            slots.repeat_interleave(G), pos.reshape(-1), ks, vs]


def paged_bound(args):
    """(bound_ms, bound_by, per_token_bound_ms) for one paged-attention
    call, ragged or verify (q [N, G, H, Dh], positions [N, G]): the
    bytes it must move — each needed K/V row, and with quantized pools
    its two fp32 scales, read once (a slot's rows up to the furthest
    position any of its queries sees), q, tables, slots and positions
    read once, the output written once — over device bandwidth, against
    4*Dh flops per attended (query, key) over the query type's peak.
    The third number counts K/V bytes once per attended (query, key):
    what a kernel moves that re-walks a slot's pages for every query,
    as the ragged entry does."""
    q, kp, _vp, bt, slots, pos, ks, _vs = (list(args) + [None, None])[:8]
    H, Dh = q.shape[-2:]
    S, MB = bt.shape
    G = pos.shape[1] if pos.dim() == 2 else 1
    last = pos.reshape(-1).clamp(max=MB * BLOCK - 1).long()
    keys = int((last + 1).sum())
    furthest = {}
    for s, p in zip(slots.clamp(min=0).repeat_interleave(G).tolist(),
                    last.tolist()):
        furthest[s] = max(furthest.get(s, -1), p)
    rows = sum(p + 1 for p in furthest.values())
    kv_row = 2 * H * Dh * kp.element_size() + (0 if ks is None else 2 * H * 4)
    other = (2 * q.numel() * q.element_size() + bt.numel() * 4
             + slots.numel() * 4 + pos.numel() * 4)
    flops = 4 * keys * H * Dh
    t_flops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]]
    t_bytes = (rows * kv_row + other) / PEAK_BYTES
    t_token = (keys * kv_row + other) / PEAK_BYTES
    by = "bytes" if t_bytes >= t_flops else "operations"
    return (max(t_bytes, t_flops) * 1e3, by,
            max(t_token, t_flops) * 1e3)


def sdpa_yardstick(args):
    """A closure timing `scaled_dot_product_attention` over a
    pre-gathered contiguous copy of every slot's context (dequantized
    beforehand for quantized pools) with a position mask: a yardstick
    only — no single PyTorch call computes the paged function, and the
    gather and the dequantization are left out of the time. Takes the
    ragged entry's inputs (`as_ragged` for a verify call)."""
    import torch
    import torch.nn.functional as F
    q, kp, vp, bt, slots, pos, ks, vs = (list(args) + [None, None])[:8]
    if ks is not None:
        kp = (kp.float() * ks[..., None]).to(q.dtype)
        vp = (vp.float() * vs[..., None]).to(q.dtype)
    T, H, Dh = q.shape
    S, MB = bt.shape
    safe = slots.clamp(min=0).long()
    lens = torch.zeros(S, dtype=torch.long, device=q.device)
    lens.scatter_reduce_(0, safe, pos.long() + 1, "amax")
    ks_, vs_, offsets, off = [], [], [], 0
    for s in range(S):
        n = int(lens[s])
        if n == 0:
            offsets.append(off)
            continue
        blocks = bt[s, :-(-n // BLOCK)].long()
        ks_.append(kp[blocks].reshape(-1, H, Dh)[:n])
        vs_.append(vp[blocks].reshape(-1, H, Dh)[:n])
        offsets.append(off)
        off += n
    k = torch.cat(ks_).transpose(0, 1)[None]         # [1, H, N, Dh]
    v = torch.cat(vs_).transpose(0, 1)[None]
    col = torch.arange(off, device=q.device)[None, :]
    start = torch.tensor(offsets, device=q.device)[safe][:, None]
    mask = (col >= start) & (col <= start + pos.long()[:, None])
    qq = q.transpose(0, 1)[None]                     # [1, H, T, Dh]
    return lambda: F.scaled_dot_product_attention(qq, k, v,
                                                  attn_mask=mask)


def check_paged_attention(pa, device, flush):
    """Phase 3 for the paged-attention kernel: error and times in fp32
    and bf16; returns the bf16 (serving dtype) record."""
    import torch
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        args = paged_case(dtype, device)
        got = pa.ragged_paged_attention(*args)
        torch.cuda.synchronize()
        ref = pa.ragged_gather_reference(*args)
        valid = args[4] >= 0
        if not torch.isfinite(got.float()).all():
            fail(f"paged_attention {name}: non-finite output")
        ref = ref[valid].float()
        diff = (got[valid].float() - ref).abs()
        err = float(diff.max())
        if not bool((diff <= TOL[name] * (1 + ref.abs())).all()):
            fail(f"paged_attention {name}: max abs err {err} past "
                 f"{TOL[name]} (1 + |plain|)")
        if not torch.equal(pa.ragged_paged_attention(*args), got):
            fail(f"paged_attention {name}: two runs gave different bits")
        ms = cuda_ms(lambda: pa.ragged_paged_attention(*args),
                     flush=flush)
        plain_ms = cuda_ms(lambda: pa.ragged_gather_reference(*args),
                           iters=5, flush=flush)
        sdpa_ms = cuda_ms(sdpa_yardstick(args), flush=flush)
        bound_ms, bound_by, token_bound_ms = paged_bound(args)
        records[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             per_token_bound_ms=token_bound_ms,
                             sdpa_gathered_ms=sdpa_ms)
        print(f"kernel check: paged_attention {name} T={BUDGET} H={HEADS} "
              f"Dh={HIDDEN // HEADS} BS={BLOCK} max_abs_err={err:.3g} "
              f"(tol {TOL[name]} (1 + |plain|); two runs bit-identical) "
              f"kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({bound_by}; {token_bound_ms:.4f} counting K/V once per "
              f"attended token and key) yardstick: SDPA on a "
              f"pre-gathered copy {sdpa_ms:.4f} ms", flush=True)
    return records["bfloat16"]


def check_paged_variants(pa, device, flush):
    """Phase 3 for the paged kernel's verify entry (K3b) and its
    quantized pools (K3c): the verify entry over float, int8 and fp8
    pools, the ragged entry over int8 and fp8 pools, each in fp32 and
    bf16 queries against its plain version, timed beside its bound and
    the SDPA yardstick. Returns the bf16 (serving dtype) records."""
    import torch
    variants = (("paged_verify", "verify", "float"),
                ("paged_int8", "ragged", "int8"),
                ("paged_fp8", "ragged", "fp8"),
                ("paged_verify_int8", "verify", "int8"),
                ("paged_verify_fp8", "verify", "fp8"))
    records = {}
    for label, entry, kind in variants:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            if entry == "verify":
                args = verify_case(dtype, device, kind)
                fn, plain = pa.verify_paged_attention, \
                    pa.verify_gather_reference
                valid = args[4] >= 0
            else:
                q, kp, vp, bt, slots, pos = paged_case(dtype, device)
                kp, vp, ks, vs = quantized_pools(
                    kp.shape[0], dtype, kind,
                    torch.Generator().manual_seed(SEED + 12))
                args = [q, kp.to(device), vp.to(device), bt, slots, pos,
                        ks.to(device), vs.to(device)]
                fn, plain = pa.ragged_paged_attention, \
                    pa.ragged_gather_reference
                valid = slots >= 0
            tol = (TOL if kind == "float" else QTOL)[name]
            got = fn(*args)
            torch.cuda.synchronize()
            err = close_or_fail(f"{label} {name}", got[valid],
                                plain(*args)[valid], tol)
            if not torch.equal(fn(*args), got):
                fail(f"{label} {name}: two runs gave different bits")
            ms = cuda_ms(lambda: fn(*args), flush=flush)
            plain_ms = cuda_ms(lambda: plain(*args), iters=5, flush=flush)
            sdpa_ms = cuda_ms(sdpa_yardstick(
                as_ragged(args) if entry == "verify" else args),
                flush=flush)
            bound_ms, bound_by, token_bound_ms = paged_bound(args)
            records.setdefault(label, {})[name] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                per_token_bound_ms=token_bound_ms, sdpa_gathered_ms=sdpa_ms)
            shape = "x".join(str(d) for d in args[0].shape)
            print(f"kernel check: {label} {name} q [{shape}] over "
                  f"{str(args[1].dtype).split('.')[-1]} pools, H={HEADS} "
                  f"Dh={HIDDEN // HEADS} BS={BLOCK} max_abs_err={err:.3g} "
                  f"(tol {tol} (1 + |plain|); two runs bit-identical) "
                  f"kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
                  f"({bound_by}; {token_bound_ms:.4f} counting K/V once per "
                  f"attended query and key) yardstick: SDPA on a "
                  f"pre-gathered{'' if kind == 'float' else ', dequantized'}"
                  f" copy {sdpa_ms:.4f} ms", flush=True)
    return {label: r["bfloat16"] for label, r in records.items()}


def check_paged_decode(pa, device, flush):
    """Phase 3 for the decode-shaped step (`paged_decode_case`) over
    bf16, int8 and fp8 pools: the ragged entry in fp32 and bf16 queries
    against its plain version, two launches to the same bits, timed
    (bf16) beside its bound and the SDPA yardstick; and the decode entry
    `paged_attention()` over the 8 slots at their contexts."""
    import torch
    for kind in ("float", "int8", "fp8"):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            label = f"paged_decode {kind} {name}"
            args = paged_decode_case(dtype, device, kind)
            valid = args[4] >= 0
            tol = (TOL if kind == "float" else QTOL)[name]
            got = pa.ragged_paged_attention(*args)
            torch.cuda.synchronize()
            err = close_or_fail(label, got[valid],
                                pa.ragged_gather_reference(*args)[valid],
                                tol)
            if not torch.equal(pa.ragged_paged_attention(*args), got):
                fail(f"{label}: two runs gave different bits")
            q, kp, vp, bt, slots, pos, ks, vs = args
            dec = pa.paged_attention(q[valid], kp, vp, bt, pos[valid] + 1,
                                     ks, vs)
            close_or_fail(f"{label} paged_attention()", dec, got[valid],
                          tol)
            if name != "bfloat16":
                continue
            ms = cuda_ms(lambda: pa.ragged_paged_attention(*args),
                         flush=flush)
            sdpa_ms = cuda_ms(sdpa_yardstick(args), flush=flush)
            bound_ms, bound_by, _ = paged_bound(args)
            print(f"kernel check: {label} q [{BUDGET}x{HEADS}x"
                  f"{HIDDEN // HEADS}] ({int(valid.sum())} decodes, "
                  f"{int((~valid).sum())} padding tokens) over "
                  f"{str(kp.dtype).split('.')[-1]} pools BS={BLOCK} "
                  f"max_abs_err={err:.3g} (tol {tol} (1 + |plain|); two "
                  f"runs bit-identical; paged_attention() agrees) "
                  f"kernel_ms={ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})"
                  f" yardstick: SDPA on a pre-gathered"
                  f"{'' if kind == 'float' else ', dequantized'} copy "
                  f"{sdpa_ms:.4f} ms", flush=True)


# ------------------------------------------------------------- phase 4


def random_gpt_arrays(seed=SEED, layers=None, experts=0):
    """GPT-350M parameters in the JAX model's `_gen_tensors()` layout,
    drawn from a numpy seed as the JAX stack initialises: N(0, 0.02)
    embeddings, N(0, 1/fan_in) weights, unit LayerNorm scales, zero
    biases. `experts` > 0: the MoE stack's `gate_w` and expert-stacked
    FFN weights in place of the dense FFN."""
    import numpy as np
    rng = np.random.default_rng(seed)
    L, D, F, E = layers or LAYERS, HIDDEN, 4 * HIDDEN, experts

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    arrays = {
        "word_embeddings": normal((VOCAB, D), 0.02),
        "position_embeddings": normal((MAXPOS, D), 0.02),
        "ln_s": np.ones((L, D), np.float32),
        "ln_b": np.zeros((L, D), np.float32),
        "qkv_w": normal((L, D, 3 * D), D ** -0.5),
        "qkv_b": np.zeros((L, 3 * D), np.float32),
        "out_w": normal((L, D, D), D ** -0.5),
        "out_b": np.zeros((L, D), np.float32),
        "ffn_ln_s": np.ones((L, D), np.float32),
        "ffn_ln_b": np.zeros((L, D), np.float32)}
    if E:
        arrays.update(gate_w=normal((L, D, E), D ** -0.5),
                      ffn1_w=normal((L, E, D, F), D ** -0.5),
                      ffn1_b=np.zeros((L, E, F), np.float32),
                      ffn2_w=normal((L, E, F, D), F ** -0.5),
                      ffn2_b=np.zeros((L, E, D), np.float32))
    else:
        arrays.update(ffn1_w=normal((L, D, F), D ** -0.5),
                      ffn1_b=np.zeros((L, F), np.float32),
                      ffn2_w=normal((L, F, D), F ** -0.5),
                      ffn2_b=np.zeros((L, D), np.float32))
    arrays.update({"ln_f.weight": np.ones((D,), np.float32),
                   "ln_f.bias": np.zeros((D,), np.float32),
                   "lm_head.weight": normal((D, VOCAB), D ** -0.5)})
    return arrays


def serve_prompts():
    """The serve phases' N_REQUESTS random prompts, 64-512 tokens."""
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    return [rng.integers(0, VOCAB, int(n)).tolist() for n in
            rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, N_REQUESTS)]


def serve(device, counters):
    """Phase 4: returns (engine, requests, launches per kernel). `counters`
    lists every kernel's (module, attribute, name); all are zeroed just
    before the 16 requests and read just after."""
    import torch
    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.serving.engine import ServingEngine

    t0 = time.perf_counter()
    model = load_jax_gpt(random_gpt_arrays(), HEADS,
                         compute_dtype="bfloat16", device=device)
    eng = ServingEngine(model, max_slots=SLOTS, block_size=BLOCK,
                        max_seq_len=MAX_SEQ, token_budget=BUDGET,
                        cache_dtype="bfloat16", device=device)
    eng.generate_batch([[1, 2, 3]], max_new_tokens=2)     # warm-up
    torch.cuda.synchronize()
    print(f"serve: GPT-350M built in {time.perf_counter() - t0:.1f} s "
          f"(vocab {VOCAB}, hidden {HIDDEN}, {LAYERS} layers, {HEADS} "
          f"heads, bf16; max_slots={SLOTS} block_size={BLOCK} "
          f"max_seq_len={MAX_SEQ} token_budget={eng.token_budget})",
          flush=True)
    prompts = serve_prompts()
    torch.cuda.reset_peak_memory_stats(device)
    for c in counters:
        setattr(c[0], c[1], 0)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, NEW_TOKENS) for p in prompts]
    steps = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c[2]: getattr(c[0], c[1]) for c in counters}
    generated = sum(len(r.output) for r in reqs)
    ttft = sum(r.first_token_time - r.submit_time for r in reqs) / len(reqs)
    print(f"serve: {len(reqs)} requests, prompts {min(map(len, prompts))}"
          f"-{max(map(len, prompts))} tokens, {steps} steps, {generated} "
          f"generated tokens in {wall:.3f} s = {generated / wall:.1f} "
          f"tokens/s, mean TTFT {ttft * 1e3:.1f} ms, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated(device)}"
          f" B, preemptions {eng.scheduler.preemption_count}", flush=True)
    if any(r.state != "finished" or len(r.output) != NEW_TOKENS
           for r in reqs):
        fail("not every request finished with its full horizon")
    if launches["paged_attention"] != steps * LAYERS:
        fail(f"paged_attention launched {launches['paged_attention']} "
             f"times, expected steps x layers = {steps * LAYERS}")
    for name, n in launches.items():
        if name != "paged_attention" and n:
            fail(f"kernel {name} launched {n} times on the dense serving "
                 "path")
    return eng, reqs, launches


def check_outputs(model, reqs, device, label="check"):
    """Phase 5: teacher-force served requests through the plain dense
    causal forward in fp32. Each emitted token must be the fp32 argmax
    or within the near-tie margin of it: twice the largest |bf16 - fp32|
    logit difference of the same dense forward on the same rows (a bf16
    computation can swap two tokens whose fp32 logits differ by up to
    twice its error)."""
    import torch
    exact = total = 0
    worst = 0.0
    for req in reqs:
        seq = req.prompt + req.output[:-1]
        ids = torch.tensor([seq], device=device)
        rows = slice(len(req.prompt) - 1, len(seq))
        l32 = model(ids, dtype=torch.float32)[0, rows].float()
        l16 = model(ids, dtype=torch.bfloat16)[0, rows].float()
        if not torch.isfinite(l32).all():
            fail("fp32 reference logits are not finite")
        margin = 2 * float((l16 - l32).abs().max())
        tok = torch.tensor(req.output, device=device)
        gap = l32.max(dim=-1).values - l32.gather(1, tok[:, None])[:, 0]
        exact += int((l32.argmax(dim=-1) == tok).sum())
        total += len(req.output)
        worst = max(worst, float(gap.max()))
        if float(gap.max()) > margin:
            fail(f"{label}: request {req.req_id}: an emitted token's fp32 "
                 f"logit is {float(gap.max()):.4f} below the argmax, past "
                 f"the margin {margin:.4f}")
        print(f"{label}: request {req.req_id} ({len(req.prompt)} prompt "
              f"tokens): {int((gap == 0).sum())}/{len(req.output)} tokens "
              f"are the fp32 argmax, largest gap {float(gap.max()):.4f} "
              f"within margin {margin:.4f}", flush=True)
    print(f"{label}: agreement {exact}/{total} exact fp32 argmax, worst "
          f"near-tie gap {worst:.4f}", flush=True)


def profile_decode(eng, label, window=16, kernel=None):
    """Where a decode step's time goes: 8 requests with 256-token
    prompts are prefilled, then `window` pure-decode steps are timed on
    the host clock and the next `window` run under torch.profiler for
    their device time. Device busy share = device time / host time of
    the same kind of step (the profiler's own host overhead is kept out
    of the host time). A speculative engine's step may emit up to
    draft_k + 1 tokens, so the horizon leaves room for that. With
    `kernel`, also the device time of the kernels whose names hold that
    string and their share of the step's. Informational: prints "not
    measured" when the profiler records no device events. `kernel`
    may be a tuple of such strings."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 2)
    horizon = (eng.draft_k + 1) * 2 * window + 4
    reqs = [eng.submit(rng.integers(0, VOCAB, 256).tolist(), horizon)
            for _ in range(SLOTS)]
    while any(r.state != "decode" for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    emitted0 = sum(len(r.output) for r in reqs)
    t0 = time.perf_counter()
    for _ in range(window):
        eng.step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / window
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(window):
            eng.step()
        torch.cuda.synchronize()
    per_step = (sum(len(r.output) for r in reqs) - emitted0) / (2 * window)
    for r in reqs:
        eng.scheduler.cancel(r)
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    if not dev:
        print(f"profile: {label} decode step {host_ms:.3f} ms on the host "
              f"clock, {per_step:.2f} tokens a step; "
              "device time not measured (no device events)", flush=True)
        return
    device_ms = sum(e.self_device_time_total for e in dev) / 1e3 / window
    launches = sum(e.count for e in dev) / window
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    share = ""
    if kernel is not None:
        names = (kernel,) if isinstance(kernel, str) else kernel
        mine = [e for e in dev if any(n in e.key for n in names)]
        k_ms = sum(e.self_device_time_total for e in mine) / 1e3 / window
        share = (f"; {' / '.join(names)} kernels {k_ms:.3f} ms in "
                 f"{sum(e.count for e in mine) / window:.0f} launches, "
                 f"{k_ms / device_ms:.1%} of the device time")
    print(f"profile: {label} decode step, 8 slots at contexts 256-"
          f"{max(256 + len(r.output) for r in reqs)}"
          f", {per_step:.2f} tokens a step"
          f": {host_ms:.3f} ms per step on the host clock, {device_ms:.3f} "
          f"ms of device time in {launches:.0f} device launches, device "
          f"busy {device_ms / host_ms:.1%}; most device time: " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3 / window:.3f}"
              f" ms x{e.count // window}" for e in top) + share, flush=True)


# ---------------------------------------- phase 3, grouped expert matmuls


def gmm_case(gm, variant, xdt, d_in, d_out, device):
    """(x, w, scale) of one expert product at the MoE step's shapes: x
    [E, C, d_in] with C = the capacity of a 256-token step, float
    experts in x's dtype, or random float experts quantized as the
    engine quantizes them (int8 with fp32 scales, packed int4 with fp16
    scales)."""
    import torch
    from paddle_tpu_torch.incubate.nn.fused_transformer import \
        _quantize_expert_stack
    from paddle_tpu_torch.parallel.moe_utils import expert_capacity
    E = MOE["num_expert"]
    C = expert_capacity(BUDGET, E, MOE["top_k"], MOE["capacity_factor"])
    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(E, C, d_in, generator=g, device=device).to(xdt)
    wf = torch.randn(E, d_in, d_out, generator=g, device=device) \
        / d_in ** 0.5
    if variant == "fp":
        return x, wf.to(xdt), None
    if variant == "int8":
        q, scale = _quantize_expert_stack(wf[None], 8)
        return x, q[0], scale[0]
    return (x,) + gm.quantize_int4_experts(wf)


def gmm_bound(x, w, scale, d_out):
    """(bound_ms, bound_by) of one grouped product: x, w, the scales and
    the [E, C, d_out] output moved once, against 2 E C d_in d_out flops
    at the operand type's peak (the quantized kernels multiply in x's
    type)."""
    E, C, d_in = x.shape
    nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
              + E * C * d_out * x.element_size()
              + (0 if scale is None else
                 scale.numel() * scale.element_size()))
    t_bytes = nbytes / PEAK_BYTES
    t_flops = 2 * E * C * d_in * d_out / PEAK_FLOPS[
        str(x.dtype).split(".")[-1]]
    return (max(t_bytes, t_flops) * 1e3,
            "bytes" if t_bytes >= t_flops else "operations")


def check_gmm(gm, device, flush):
    """Phase 3 for the grouped expert matmuls at the MoE step's two
    products, ffn1 [8, 80, 1024] x [8, 1024, 4096] and ffn2 [8, 80, 4096]
    x [8, 4096, 1024]: fp in bf16 and fp32, int8 and int4 with bf16
    activations, each against its plain version. Returns the serving
    (bf16) records of gmm_fp, gmm_int8 and gmm_int4, each the mean per
    call over the two products. Yardstick: `torch.bmm` (for int8/int4 on
    a pre-dequantized bf16 copy, the dequant left out of its time)."""
    import torch
    D, F = HIDDEN, 4 * HIDDEN
    records = {}
    for variant, xdt in (("fp", torch.bfloat16), ("fp", torch.float32),
                         ("int8", torch.bfloat16),
                         ("int4", torch.bfloat16)):
        dname = str(xdt).split(".")[-1]
        tol = GMM_TOL[dname]
        calls = []
        for prod, (d_in, d_out) in (("ffn1", (D, F)), ("ffn2", (F, D))):
            x, w, scale = gmm_case(gm, variant, xdt, d_in, d_out, device)
            got = gm.grouped_expert_matmul(x, w, scale)
            torch.cuda.synchronize()
            err = close_or_fail(f"gmm_{variant} {dname} {prod}", got,
                                gm.grouped_matmul_reference(x, w, scale),
                                tol)
            ms = cuda_ms(lambda: gm.grouped_expert_matmul(x, w, scale),
                         flush=flush)
            plain = cuda_ms(lambda: gm.grouped_matmul_reference(
                x, w, scale), iters=5, flush=flush)
            w_lib = gm.dequantize(w, scale, d_in, xdt)
            lib = cuda_ms(lambda: torch.bmm(x, w_lib), flush=flush)
            bound_ms, bound_by = gmm_bound(x, w, scale, d_out)
            calls.append((err, ms, plain, lib, bound_ms, bound_by))
            moved = bound_ms * 1e-3 * PEAK_BYTES if bound_by == "bytes" \
                else None
            flops = 2 * x.shape[0] * x.shape[1] * d_in * d_out
            print(f"kernel check: gmm_{variant} {dname} {prod} "
                  f"[{x.shape[0]}, {x.shape[1]}, {d_in}] x [{d_in}, "
                  f"{d_out}] {str(w.dtype).split('.')[-1]} weights "
                  f"{tuple(w.shape)} max_abs_err={err:.3g} (tol {tol} "
                  f"(1 + |plain|)) kernel_ms={ms:.4f} plain_ms={plain:.4f}"
                  f" bound_ms={bound_ms:.4f} ({bound_by}), the kernel at "
                  f"{bound_ms / ms:.1%} of it, "
                  f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s"
                  + ("" if moved is None else
                     f", {moved / (ms * 1e-3) / 1e12:.3f} TB/s of "
                     f"{PEAK_BYTES / 1e12:.2f}")
                  + "; yardstick: torch.bmm"
                  f"{'' if scale is None else ' on a pre-dequantized copy'}"
                  f" {lib:.4f} ms", flush=True)
            del x, w, scale, got, w_lib
        if dname == "bfloat16":
            records[f"gmm_{variant}"] = dict(
                max_abs_err=max(c[0] for c in calls),
                ms=sum(c[1] for c in calls) / 2,
                plain_ms=sum(c[2] for c in calls) / 2,
                library_ms=sum(c[3] for c in calls) / 2,
                bound_ms=sum(c[4] for c in calls) / 2,
                bound_by=calls[0][5])
    return records


# ----------------------------------------------------- phases 5a and 5d

SPEC_POOLS = {None: ("paged_verify", "paged_attention"),
              "int8": ("paged_verify_int8", "paged_int8"),
              "fp8_e4m3": ("paged_verify_fp8", "paged_fp8")}


def serve_spec(device, counters):
    """Phase 5a: GPT-350M served by three speculative engines (draft_k=3)
    over bf16, int8 and fp8_e4m3 KV pools, each zeroing every kernel
    counter just before the 16 requests and reading them just after.
    Returns (each engine's verify and ragged variant launches (the float
    ragged entry's, paged_attention, stays the dense serve's), each
    pool's outputs, the model)."""
    import torch
    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.serving.engine import ServingEngine
    model = load_jax_gpt(random_gpt_arrays(), HEADS,
                         compute_dtype="bfloat16", device=device)
    prompts = serve_prompts()
    launches, bf16_out, pool_out = {}, None, {}
    for kv_dtype in (None, "int8", "fp8_e4m3"):
        t0 = time.perf_counter()
        eng = ServingEngine(model, max_slots=SLOTS, block_size=BLOCK,
                            max_seq_len=MAX_SEQ, token_budget=BUDGET,
                            cache_dtype="bfloat16", kv_dtype=kv_dtype,
                            draft_k=DRAFT_K, draft_ngram=DRAFT_NGRAM,
                            draft_ring=DRAFT_RING, device=device)
        eng.generate_batch([[1, 2, 3]], max_new_tokens=2)   # warm-up
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        prop0, acc0 = eng.spec_proposed_total, eng.spec_accepted_total
        torch.cuda.reset_peak_memory_stats(device)
        for mod, attr, _ in counters:
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        reqs = [eng.submit(p, NEW_TOKENS) for p in prompts]
        steps = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {name: getattr(mod, attr) for mod, attr, name in counters}
        outputs = [list(r.output) for r in reqs]
        pool_out[kv_dtype] = outputs
        generated = sum(map(len, outputs))
        if kv_dtype is None:
            bf16_out = outputs
        same = sum(a == b for o, f in zip(outputs, bf16_out)
                   for a, b in zip(o, f))
        ttft = sum(r.first_token_time - r.submit_time for r in reqs) \
            / len(reqs)
        proposed = eng.spec_proposed_total - prop0
        accepted = eng.spec_accepted_total - acc0
        pools = kv_dtype or "bfloat16"
        verify, ragged = SPEC_POOLS[kv_dtype]
        print(f"serve spec {pools} pools: draft_k={DRAFT_K} "
              f"(ngram {DRAFT_NGRAM}, window {DRAFT_RING}), token_budget "
              f"{eng.token_budget}, kv_bytes_per_token "
              f"{eng.kv.kv_bytes_per_token}; built in {build_s:.1f} s; "
              f"{steps} steps, {generated} generated tokens in {wall:.3f} s"
              f" = {generated / wall:.1f} tokens/s, mean TTFT "
              f"{ttft * 1e3:.1f} ms, drafts proposed {proposed} accepted "
              f"{accepted} ({accepted / max(proposed, 1):.1%}), "
              f"max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(device)} B, preemptions "
              f"{eng.scheduler.preemption_count}; tokens equal to the bf16"
              f"-pool engine's {same}/{generated}; launches {verify} "
              f"{got[verify]}, {ragged} {got[ragged]}", flush=True)
        if any(r.state != "finished" or len(r.output) != NEW_TOKENS
               for r in reqs):
            fail(f"serve spec {pools}: not every request finished with its "
                 "full horizon")
        if eng.kv.blocks_in_use:
            fail(f"serve spec {pools}: {eng.kv.blocks_in_use} KV blocks "
                 "still held after every request finished")
        want = {verify: steps * LAYERS, ragged: steps * LAYERS}
        for name, n in got.items():
            if n != want.get(name, 0):
                fail(f"serve spec {pools}: {name} launched {n} times, "
                     f"expected {want.get(name, 0)} ({steps} steps)")
        launches[verify] = got[verify]
        if kv_dtype is not None:
            launches[ragged] = got[ragged]
        else:
            check_outputs(model, reqs, device, label="check spec")
            profile_decode(eng, f"GPT-350M draft_k={DRAFT_K} bf16 pools")
        del eng, reqs
        torch.cuda.empty_cache()
    return launches, pool_out, model


def check_spec_on_card(device):
    """Phase 5d: fp32, 2 layers at full width: 4 requests of 16 new tokens
    (one prompt a repeated pattern, so drafts get accepted) served with
    draft_k=3 on the card (kernels) and on a CPU copy (plain versions),
    and by the card's draft_k=0 engine. Float pools: the tokens must be
    identical and the proposed/accepted counts equal, unless the first
    differing token sat at an fp32 top-2 logit gap under 1e-5 (of the
    plain dense forward, on the CPU, teacher-forced on the CPU run's
    tokens) — printed either way. int8 and fp8 pools: card against CPU
    reported, not held (the card's and the CPU's K/V can differ by an
    ulp that crosses an int8 or fp8 rounding step)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.serving.engine import ServingEngine
    layers = 2
    arrays = random_gpt_arrays(SEED + 11, layers=layers)
    rng = np.random.default_rng(SEED + 12)
    prompts = [rng.integers(0, VOCAB, int(n)).tolist()
               for n in (17, 40, 64, 9)]
    prompts[3] = prompts[3] * 5
    models = {str(d): load_jax_gpt(arrays, HEADS, device=d)
              for d in (device, "cpu")}

    def serve(dev, kv_dtype, draft_k):
        eng = ServingEngine(models[str(dev)], max_slots=4, block_size=BLOCK,
                            max_seq_len=128, token_budget=BUDGET,
                            cache_dtype="float32", kv_dtype=kv_dtype,
                            draft_k=draft_k, device=dev)
        out = eng.generate_batch(prompts, max_new_tokens=16)
        return out, (eng.spec_proposed_total, eng.spec_accepted_total)

    def first_gap(got, want):
        """(same tokens, total, the fp32 top-2 gap at the first
        differing token or None)."""
        same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
        total = sum(map(len, want))
        for p, g, w in zip(prompts, got, want):
            i = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                     None)
            if i is None:
                continue
            ids = torch.tensor([p + w[:i]])
            top = models["cpu"](ids, dtype=torch.float32)[0, -1].topk(2)
            return same, total, float(top.values[0] - top.values[1])
        return same, total, None

    for kv_dtype in (None, "int8", "fp8_e4m3"):
        got, card_counts = serve(device, kv_dtype, DRAFT_K)
        want, cpu_counts = serve("cpu", kv_dtype, DRAFT_K)
        same, total, gap = first_gap(got, want)
        line = (f"check spec: fp32, {layers} layers at full width, "
                f"{kv_dtype or 'float32'} pools, draft_k={DRAFT_K}: "
                f"{same}/{total} greedy tokens equal on the card and the "
                f"CPU; drafts proposed/accepted {card_counts} on the card, "
                f"{cpu_counts} on the CPU; first differing token's fp32 "
                f"top-2 gap {'none' if gap is None else f'{gap:.3g}'}")
        if kv_dtype is None:
            plain, _ = serve(device, None, 0)
            p_same, _, p_gap = first_gap(got, plain)
            line += (f"; {p_same}/{total} equal to the card's draft_k=0 "
                     f"engine (first gap "
                     f"{'none' if p_gap is None else f'{p_gap:.3g}'})")
            for g in (gap, p_gap):
                if g is not None and g >= 1e-5:
                    fail(line + " — tokens differ past a near-tie")
            if gap is None and card_counts != cpu_counts:
                fail(line + " — equal tokens but different draft counts")
        else:
            line += " (reported, not held)"
        print(line, flush=True)
    del models
    torch.cuda.empty_cache()


# ----------------------------------------------------- phases 5e and 5f

# the multi-tick engines: ticks a dispatch, and the penalties of the
# penalized pair (greedy, so N = 1 and N = 4 must agree token for token)
TICKS = 4
PENALTY = dict(repetition_penalty=1.2, presence_penalty=0.5)


def sync_guarded(eng):
    """Run every dispatch's ticks of `eng` under
    `torch.cuda.set_sync_debug_mode("error")`: a call that synchronizes
    the host with the card between the ticks of a dispatch raises."""
    import torch
    run_ticks = eng._run_ticks

    def guarded(d, n):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run_ticks(d, n)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    eng._run_ticks = guarded


def serve_counted(eng, prompts, counters, label):
    """Serve the prompts to completion with every kernel counter zeroed
    just before and read just after. Fails unless every request finished
    with its full horizon and every KV block came back. Returns
    (outputs, launches, the run's numbers)."""
    import torch
    for mod, attr, _ in counters:
        setattr(mod, attr, 0)
    before = (eng.steps_run, eng.dispatches_run, eng.device_ticks_run,
              eng.device_ticks_issued, dict(eng.early_exit_counts),
              eng.tokens_fed)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, NEW_TOKENS) for p in prompts]
    try:
        eng.run()
    except RuntimeError as e:
        fail(f"{label}: {e}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {name: getattr(mod, attr) for mod, attr, name in counters}
    outputs = [list(r.output) for r in reqs]
    if any(r.state != "finished" or len(r.output) != NEW_TOKENS
           for r in reqs):
        fail(f"{label}: not every request finished with its full horizon")
    if eng.kv.blocks_in_use:
        fail(f"{label}: {eng.kv.blocks_in_use} KV blocks still held after "
             "every request finished")
    steps, disp, ran, issued, ee, fed = before
    run = dict(
        steps=eng.steps_run - steps, dispatches=eng.dispatches_run - disp,
        ticks=eng.device_ticks_run - ran,
        issued=eng.device_ticks_issued - issued,
        finish=eng.early_exit_counts["finish"] - ee["finish"],
        overflow=eng.early_exit_counts["overflow"] - ee["overflow"],
        fed=eng.tokens_fed - fed, wall=wall,
        generated=sum(map(len, outputs)),
        ttft=sum(r.first_token_time - r.submit_time for r in reqs)
        / len(reqs))
    return outputs, got, run


def multitick_line(label, eng, run, same_as, same, launches):
    """One engine's line: dispatches, ticks issued and executed, early
    exits, tokens/s and TTFT on the host clock, host ms a dispatch."""
    if eng._multitick:
        disp = run["dispatches"]
        ticks = (f"{disp} dispatches, {run['issued']} ticks issued, "
                 f"{run['ticks']} executed ({run['issued'] - run['ticks']} "
                 f"past an exit), early exits finish {run['finish']} "
                 f"overflow {run['overflow']}")
    else:
        disp = run["steps"]
        ticks = f"{disp} dispatches of one tick"
    return (f"serve multitick {label}: ticks_per_dispatch="
            f"{'auto' if eng._ticks_auto else eng.ticks_per_dispatch}; "
            f"{ticks}; {run['generated']} generated tokens in "
            f"{run['wall']:.3f} s = {run['generated'] / run['wall']:.1f} "
            f"tokens/s, mean TTFT {run['ttft'] * 1e3:.1f} ms, "
            f"{run['wall'] * 1e3 / disp:.2f} ms per dispatch on the host "
            f"clock; tokens equal to {same_as} {same}/{run['generated']}; "
            "launches " + ", ".join(f"{n} {c}" for n, c in launches.items()
                                    if c))


def hold_multitick(label, eng, run, outputs, want_out, got, want):
    """The holds of a multi-tick run: the reference's tokens exactly,
    the launches exactly (every other counter 0), and more ticks than
    dispatches."""
    if outputs != want_out:
        fail(f"{label}: tokens differ from the 1-tick engine's")
    for name, n in got.items():
        if n != want.get(name, 0):
            fail(f"{label}: {name} launched {n} times, expected "
                 f"{want.get(name, 0)} ({run['issued']} ticks issued)")
    if eng._multitick and not eng._ticks_auto and \
            run["ticks"] <= run["dispatches"]:
        fail(f"{label}: {run['ticks']} ticks in {run['dispatches']} "
             "dispatches: the loop never ran more than one tick")


def serve_multitick(model, device, counters, dense_out, spec_out):
    """Phase 5e: GPT-350M (phase 5a's model) served by multi-tick engines
    on the 16 requests: ticks_per_dispatch=4 and "auto" (greedy tokens
    equal to phase 4's 1-tick engine, every dispatch's ticks under
    `set_sync_debug_mode("error")`), draft_k=3 at 4 ticks over bf16,
    int8 and fp8 pools (equal to phase 5a's engine of the same pool),
    and a penalized greedy pair at 1 and 4 ticks (equal to each other).
    Launches are held exactly: the paged variants issued ticks x 24
    (steps x 24 at one tick), nothing else. Then one profiled 4-tick
    dispatch."""
    import torch
    from paddle_tpu_torch.serving.batcher import SamplingConfig
    from paddle_tpu_torch.serving.engine import ServingEngine
    prompts = serve_prompts()
    base = dict(max_slots=SLOTS, block_size=BLOCK, max_seq_len=MAX_SEQ,
                token_budget=BUDGET, cache_dtype="bfloat16", device=device)
    runs = [("dense 4 ticks", dict(ticks_per_dispatch=TICKS), None,
             "phase 4's 1-tick engine"),
            ("dense auto", dict(ticks_per_dispatch="auto"), None,
             "phase 4's 1-tick engine")]
    for kv_dtype in (None, "int8", "fp8_e4m3"):
        runs.append((f"draft_k={DRAFT_K} {kv_dtype or 'bfloat16'} pools",
                     dict(ticks_per_dispatch=TICKS, kv_dtype=kv_dtype,
                          draft_k=DRAFT_K, draft_ngram=DRAFT_NGRAM,
                          draft_ring=DRAFT_RING), kv_dtype,
                     "phase 5a's engine"))
    pen = SamplingConfig(**PENALTY)
    t_phase = time.perf_counter()
    runs += [("penalized 1 tick", dict(sampling=pen), "pen", "itself"),
             ("penalized 4 ticks", dict(sampling=pen,
                                        ticks_per_dispatch=TICKS), "pen",
              "the penalized 1-tick engine")]
    pen_out = None
    for label, kw, ref, ref_label in runs:
        eng = ServingEngine(model, **base, **kw)
        eng.generate_batch([[1, 2, 3]], max_new_tokens=2)   # warm-up
        torch.cuda.synchronize()
        if eng._multitick:
            sync_guarded(eng)
        outputs, got, run = serve_counted(eng, prompts, counters,
                                          f"serve multitick {label}")
        if ref == "pen":
            want_out = pen_out = pen_out or outputs
        elif "draft_k" in kw:
            want_out = spec_out[ref]
        else:
            want_out = dense_out
        n = run["issued"] if eng._multitick else run["steps"]
        if eng.draft_k:
            verify, ragged = SPEC_POOLS[kw["kv_dtype"]]
            want = {verify: n * LAYERS, ragged: n * LAYERS}
        else:
            want = {"paged_attention": n * LAYERS}
        same = sum(a == b for o, w in zip(outputs, want_out)
                   for a, b in zip(o, w))
        print(multitick_line(label, eng, run, ref_label, same, got)
              + ("; every dispatch's ticks ran under "
                 "set_sync_debug_mode('error')" if eng._multitick else ""),
              flush=True)
        hold_multitick(f"serve multitick {label}", eng, run, outputs,
                       want_out, got, want)
        if label == "dense 4 ticks":
            profile_multitick(eng, "GPT-350M")
        del eng
        torch.cuda.empty_cache()
    print(f"serve multitick: phase took {time.perf_counter() - t_phase:.1f} "
          "s", flush=True)


def profile_multitick(eng, label, window=4):
    """Where a multi-tick dispatch's time goes: 8 requests with 256-token
    prompts are prefilled, `window` pure-decode dispatches are timed on
    the host clock and the next one runs under torch.profiler for its
    device time, a tick's share of it and the device's busy share."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 2)
    # the first request decodes while the others prefill: room for that
    # and for every timed dispatch to run all its ticks
    horizon = eng.ticks_per_dispatch * (window + 1) + 2 * SLOTS + 8
    reqs = [eng.submit(rng.integers(0, VOCAB, 256).tolist(), horizon)
            for _ in range(SLOTS)]
    while any(r.state in ("queued", "prefill") for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    issued0 = eng.device_ticks_issued
    t0 = time.perf_counter()
    for _ in range(window):
        eng.step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / window
    per = (eng.device_ticks_issued - issued0) / window
    issued0 = eng.device_ticks_issued
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    ticks = eng.device_ticks_issued - issued0
    for r in reqs:
        eng.scheduler.cancel(r)
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    head = (f"profile: {label} {ticks}-tick decode dispatch, 8 slots at "
            f"contexts 256-{max(256 + len(r.output) for r in reqs)}: "
            f"{host_ms:.3f} ms per dispatch on the host clock "
            f"({host_ms / per:.3f} ms a tick)")
    if not dev:
        print(head + "; device time not measured (no device events)",
              flush=True)
        return
    device_ms = sum(e.self_device_time_total for e in dev) / 1e3
    launches = sum(e.count for e in dev)
    print(head + f", {device_ms:.3f} ms of device time in {launches} "
          f"device launches = {device_ms / ticks:.3f} ms a tick, device "
          f"busy {device_ms / ticks / (host_ms / per):.1%}", flush=True)


def check_multitick_on_card(device):
    """Phase 5f: fp32, 2 layers at full width, draft_k=3 with the
    penalties (greedy), 4 ticks a dispatch: 4 requests of 16 new tokens
    give the same tokens on the card (kernels, every dispatch's ticks
    under `set_sync_debug_mode("error")`) as on a CPU copy (plain
    versions) and as the card's 1-tick engine; then a seeded penalized
    sampling engine with draft_k=3 at 4 ticks against its 1-tick twin
    on the card (the generator is set back after each early exit)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.serving.batcher import SamplingConfig
    from paddle_tpu_torch.serving.engine import ServingEngine
    t_phase = time.perf_counter()
    layers = 2
    arrays = random_gpt_arrays(SEED + 11, layers=layers)
    rng = np.random.default_rng(SEED + 12)
    prompts = [rng.integers(0, VOCAB, int(n)).tolist()
               for n in (17, 40, 64, 9)]
    prompts[3] = prompts[3] * 5
    models = {str(d): load_jax_gpt(arrays, HEADS, device=d)
              for d in (device, "cpu")}

    def serve(dev, ticks, sampling, guard=False, eos=None):
        eng = ServingEngine(models[str(dev)], max_slots=4, block_size=BLOCK,
                            max_seq_len=128, token_budget=BUDGET,
                            cache_dtype="float32", draft_k=DRAFT_K,
                            sampling=sampling, ticks_per_dispatch=ticks,
                            eos_token_id=eos, seed=5, device=dev)
        if guard:
            sync_guarded(eng)
        try:
            out = eng.generate_batch(prompts, max_new_tokens=16)
        except RuntimeError as e:
            fail(f"check multitick: {e}")
        return out, eng

    greedy = SamplingConfig(**PENALTY)
    got, eng = serve(device, TICKS, greedy, guard=True)
    want, _ = serve("cpu", TICKS, greedy)
    one, _ = serve(device, 1, greedy)
    same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    total = sum(map(len, want))
    line = (f"check multitick: fp32, {layers} layers at full width, "
            f"draft_k={DRAFT_K}, penalties {PENALTY}, {TICKS} ticks a "
            f"dispatch ({eng.dispatches_run} dispatches, "
            f"{eng.device_ticks_run} ticks executed, "
            f"{eng.device_ticks_issued} issued, every dispatch's ticks "
            f"under set_sync_debug_mode('error')): {same}/{total} greedy "
            "tokens equal on the card and the CPU")
    if got != want or got != one:
        fail(line + f"; {'equal' if got == one else 'not equal'} to the "
             "card's 1-tick engine")
    # seeded sampling, with an EOS from the free run so that a dispatch
    # ends mid-way and the generator is set back past its exit
    hot = SamplingConfig(strategy="sampling", temperature=0.9, top_p=0.95,
                         **PENALTY)
    eos = serve(device, 1, hot)[0][1][3]
    got, eng = serve(device, TICKS, hot, guard=True, eos=eos)
    one, _ = serve(device, 1, hot, eos=eos)
    if got != one:
        fail(line + "; seeded penalized sampling at 4 ticks differs from "
             "the 1-tick engine on the card")
    print(line + "; seeded penalized sampling (draft_k=3, top_p 0.95, "
          f"EOS {eos}) at {TICKS} ticks equal to its 1-tick twin on the card"
          f" ({eng.device_ticks_issued - eng.device_ticks_run} ticks past "
          f"an exit); phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    del models
    torch.cuda.empty_cache()


# ----------------------------------------------------- phases 5b and 5c


def serve_moe(device, counters):
    """Phase 5b: MoE-350M served by three engines (float, int8, int4
    experts), each zeroing every kernel counter just before its 16
    requests and reading them just after; returns each grouped-matmul
    variant's launches in its own engine's run."""
    import numpy as np
    import torch
    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.ops.grouped_matmul import expert_weight_bytes
    from paddle_tpu_torch.serving.engine import (ServingEngine,
                                                 moe_utilization_entropy)
    E, k = MOE["num_expert"], MOE["top_k"]
    D, F = HIDDEN, 4 * HIDDEN
    t0 = time.perf_counter()
    model = load_jax_gpt(random_gpt_arrays(SEED + 8, experts=E), HEADS,
                         moe=MOE, compute_dtype="bfloat16", device=device,
                         dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    n_expert = model.decoder.ffn1_w.numel() + model.decoder.ffn2_w.numel()
    print(f"serve MoE: MoE-350M built in {time.perf_counter() - t0:.1f} s: "
          f"{n_params} resident parameters, {n_expert} of them experts "
          f"({E} experts, top-{k}, capacity factor "
          f"{MOE['capacity_factor']}; vocab {VOCAB}, hidden {HIDDEN}, "
          f"{LAYERS} layers, {HEADS} heads, bf16)", flush=True)
    prompts = serve_prompts()
    variant = {None: "gmm_fp", "int8": "gmm_int8", "int4": "gmm_int4"}
    launches, float_out = {}, None
    for fmt in (None, "int8", "int4"):
        t0 = time.perf_counter()
        eng = ServingEngine(model, max_slots=SLOTS, block_size=BLOCK,
                            max_seq_len=MAX_SEQ, token_budget=BUDGET,
                            cache_dtype="bfloat16", moe_weight_dtype=fmt,
                            device=device)
        eng.generate_batch([[1, 2, 3]], max_new_tokens=2)   # warm-up
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        counts0 = eng.moe_expert_counts.copy()
        dropped0, fed0 = eng.moe_dropped_total, eng.tokens_fed
        torch.cuda.reset_peak_memory_stats(device)
        for mod, attr, _ in counters:
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        reqs = [eng.submit(p, NEW_TOKENS) for p in prompts]
        steps = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {name: getattr(mod, attr) for mod, attr, name in counters}
        counts = eng.moe_expert_counts - counts0
        dropped = eng.moe_dropped_total - dropped0
        fed = eng.tokens_fed - fed0
        outputs = [list(r.output) for r in reqs]
        generated = sum(map(len, outputs))
        if fmt is None:
            float_out = outputs
        same = sum(a == b for o, f in zip(outputs, float_out)
                   for a, b in zip(o, f))
        ttft = sum(r.first_token_time - r.submit_time for r in reqs) \
            / len(reqs)
        wdt = fmt or "bfloat16"
        wbytes = (expert_weight_bytes(E, D, F, wdt, LAYERS)
                  + expert_weight_bytes(E, F, D, wdt, LAYERS))
        print(f"serve MoE {wdt} experts: expert_weight_bytes {wbytes} "
              f"({n_params} resident parameters); built in {build_s:.1f} s;"
              f" {steps} steps, {generated} generated tokens in {wall:.3f} "
              f"s = {generated / wall:.1f} tokens/s, mean TTFT "
              f"{ttft * 1e3:.1f} ms, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(device)} B, preemptions "
              f"{eng.scheduler.preemption_count}; {fed} valid tokens fed, "
              f"expert utilization entropy "
              f"{moe_utilization_entropy(counts):.4f}, dropped {dropped:.0f}"
              f" of {k * LAYERS * fed} choices, last aux "
              f"{eng.moe_last_aux:.4f}; tokens equal to the float "
              f"engine's {same}/{generated}; launches " + ", ".join(
                  f"{n} {got[n]}" for n in ("paged_attention", "gmm_fp",
                                            "gmm_int8", "gmm_int4")),
              flush=True)
        if any(r.state != "finished" or len(r.output) != NEW_TOKENS
               for r in reqs):
            fail(f"serve MoE {wdt}: not every request finished with its "
                 "full horizon")
        want = {"paged_attention": steps * LAYERS,
                variant[fmt]: steps * 2 * LAYERS}
        for name, n in got.items():
            if n != want.get(name, 0):
                fail(f"serve MoE {wdt}: {name} launched {n} times, "
                     f"expected {want.get(name, 0)} ({steps} steps)")
        if not np.all(np.isfinite(counts)) or \
                counts.sum() + dropped != k * LAYERS * fed:
            fail(f"serve MoE {wdt}: {counts.sum()} routed + {dropped} "
                 f"dropped choices != {k} x {LAYERS} layers x {fed} tokens")
        launches[variant[fmt]] = got[variant[fmt]]
        profile_decode(eng, f"MoE-350M {fmt or 'float'} experts",
                       kernel="gmm")
        del eng, reqs
        torch.cuda.empty_cache()
        if fmt is None:
            serve_moe_multitick(model, device, counters, prompts, float_out)
    del model
    torch.cuda.empty_cache()
    return launches


def serve_moe_multitick(model, device, counters, prompts, want_out):
    """Phase 5b's multi-tick engine: MoE-350M with float experts at 4
    ticks a dispatch, every dispatch's ticks under
    `set_sync_debug_mode("error")`: the float 1-tick engine's tokens,
    paged attention issued ticks x 24 and the float grouped matmul issued
    ticks x 48 launches (nothing else), and routed + dropped = 2 x 24 x
    valid tokens over the ticks that counted."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving.engine import ServingEngine
    k = MOE["top_k"]
    eng = ServingEngine(model, max_slots=SLOTS, block_size=BLOCK,
                        max_seq_len=MAX_SEQ, token_budget=BUDGET,
                        cache_dtype="bfloat16", ticks_per_dispatch=TICKS,
                        device=device)
    eng.generate_batch([[1, 2, 3]], max_new_tokens=2)       # warm-up
    torch.cuda.synchronize()
    sync_guarded(eng)
    counts0 = eng.moe_expert_counts.copy()
    dropped0 = eng.moe_dropped_total
    label = "serve multitick MoE float experts"
    outputs, got, run = serve_counted(eng, prompts, counters, label)
    counts = eng.moe_expert_counts - counts0
    dropped = eng.moe_dropped_total - dropped0
    same = sum(a == b for o, w in zip(outputs, want_out)
               for a, b in zip(o, w))
    print(multitick_line("MoE float experts", eng, run,
                         "phase 5b's float 1-tick engine", same, got)
          + f"; {run['fed']} valid tokens fed, dropped {dropped:.0f} of "
          f"{k * LAYERS * run['fed']} choices; every dispatch's ticks ran "
          "under set_sync_debug_mode('error')", flush=True)
    hold_multitick(label, eng, run, outputs, want_out, got,
                   {"paged_attention": run["issued"] * LAYERS,
                    "gmm_fp": run["issued"] * 2 * LAYERS})
    if not np.all(np.isfinite(counts)) or \
            counts.sum() + dropped != k * LAYERS * run["fed"]:
        fail(f"{label}: {counts.sum()} routed + {dropped} dropped choices "
             f"!= {k} x {LAYERS} layers x {run['fed']} tokens")
    del eng
    torch.cuda.empty_cache()


def check_moe_on_card(device):
    """Phase 5c: fp32, 2 layers at full width, float and int8 experts: 4
    requests of 16 new tokens served on the card (kernels) and on a CPU
    copy (plain versions) must give the same greedy tokens. A near-tie
    at the top-k gate boundary turns an ulp into an expert flip
    (docs/MOE.md), so both runs record, per routed call, its engine
    step and each valid token's chosen experts, and the CPU run the
    token's gap between its k-th and (k+1)-th gate probability. Tokens
    that differ are forgiven only when the first routed call whose
    experts differ comes no later than the step where the tokens first
    differ, and every token whose experts differ there has a gap under
    1e-5; any other difference fails."""
    import numpy as np
    import torch
    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.parallel import moe_utils
    from paddle_tpu_torch.serving.engine import ServingEngine
    E, k, layers = MOE["num_expert"], MOE["top_k"], 2
    arrays = random_gpt_arrays(SEED + 9, layers=layers, experts=E)
    rng = np.random.default_rng(SEED + 10)
    prompts = [rng.integers(0, VOCAB, int(n)).tolist()
               for n in (17, 40, 64, 9)]
    routing = moe_utils.top_k_routing

    def recording(eng, log):
        def route(logits, top_k, capacity, valid=None, dtype=None):
            r = routing(logits, top_k, capacity, valid=valid, dtype=dtype)
            p = torch.softmax(logits.float(), -1).sort(-1, descending=True)[0]
            rows = slice(None) if valid is None else valid
            log.append((eng.steps_run,
                        r.plan.gate_idx[rows].sort(-1)[0].cpu(),
                        (p[:, top_k - 1] - p[:, top_k])[rows].cpu()))
            return r
        return route

    def serve(eng, log):
        """Serve the prompts; returns (outputs, the step of each token)."""
        reqs = [eng.submit(pr, 16) for pr in prompts]
        at = [[] for _ in reqs]
        moe_utils.top_k_routing = recording(eng, log)
        while eng.scheduler.has_work:
            n = [len(r.output) for r in reqs]
            if not eng.step():
                fail("check MoE: the engine stalled")
            for a, r, n0 in zip(at, reqs, n):
                a += [eng.steps_run - 1] * (len(r.output) - n0)
        moe_utils.top_k_routing = routing
        return [list(r.output) for r in reqs], at

    for fmt in (None, "int8"):
        out, logs = {}, {}
        for dev in (device, "cpu"):
            model = load_jax_gpt(arrays, HEADS, moe=MOE, device=dev)
            eng = ServingEngine(model, max_slots=4, block_size=BLOCK,
                                max_seq_len=128, token_budget=BUDGET,
                                cache_dtype="float32", moe_weight_dtype=fmt,
                                device=dev)
            logs[str(dev)] = []
            out[str(dev)] = serve(eng, logs[str(dev)])
            del eng, model
        (got, _), (want, want_at) = out[str(device)], out["cpu"]
        card_log, cpu_log = logs[str(device)], logs["cpu"]
        min_gap = min(float(g.min()) for _, _, g in cpu_log if g.numel())
        same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
        total = sum(map(len, want))
        line = (f"check MoE: fp32, {layers} layers at full width, "
                f"{fmt or 'float'} experts: {same}/{total} greedy tokens "
                f"equal on the card and the CPU; smallest top-{k} gate gap "
                f"on the CPU side {min_gap:.3g}")
        if got != want:
            # the step at which the first differing token was sampled
            step = min(a[next(i for i, (x, y) in enumerate(zip(g, w))
                              if x != y)]
                       for g, w, a in zip(got, want, want_at) if g != w)
            flip = next((i for i, (c, h) in enumerate(zip(card_log,
                                                           cpu_log))
                         if c[0] != h[0] or not torch.equal(c[1], h[1])),
                        None)
            if flip is None or cpu_log[flip][0] > step:
                fail(line + f" — tokens differ from step {step} with the "
                     "same experts chosen up to it")
            _, c_idx, _ = card_log[flip]
            _, h_idx, h_gap = cpu_log[flip]
            if c_idx.shape != h_idx.shape:
                fail(line + f" — routed call {flip} saw another token set")
            flip_gap = float(h_gap[(c_idx != h_idx).any(-1)].max())
            if flip_gap >= 1e-5:
                fail(line + f" — the first expert difference (routed call "
                     f"{flip}, step {cpu_log[flip][0]}) is at a gate gap of "
                     f"{flip_gap:.3g}, not a near-tie")
            line += (f" (tokens differ from step {step}; the first expert "
                     f"difference, at step {cpu_log[flip][0]}, has gate gap "
                     f"{flip_gap:.3g} < 1e-5: a near-tie expert flip)")
        print(line, flush=True)
    torch.cuda.empty_cache()


# ------------------------------------------------ phase 3, train kernels


def flash_flops(q, causal=True, backward=False):
    """Flops of flash attention over q's [B, H, S, D] shape: 4*D per
    visible (query, key) pair forward (two products), 2.5 times that
    backward (five products)."""
    B, H, S, D = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    return 4 * B * H * D * pairs * (2.5 if backward else 1)


def flash_bound(q, backward, causal=True, lse=True):
    """(bound_ms, bound_by) of flash attention over q's [B, H, S, D]
    shape: q, k, v and out (and, backward, dout, dq, dk, dv) moved once,
    the fp32 lse once where the kernel keeps it; `flash_flops`."""
    B, H, S, D = q.shape
    tensors = 8 if backward else 4
    nbytes = tensors * q.numel() * q.element_size() + (B * H * S * 4
                                                       if lse else 0)
    flops = flash_flops(q, causal, backward)
    t_bytes = nbytes / PEAK_BYTES
    t_flops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]]
    return (max(t_bytes, t_flops) * 1e3,
            "bytes" if t_bytes >= t_flops else "operations")


def add_ln_bound(x2):
    """(bound_ms, bound_by) of add+LN forward or backward over [N, d]:
    four [N, d] tensors moved once (x, r, out, z; or z, g, g_z, dz),
    w/b and the fp32 row statistics once; ~10 flops per element."""
    N, d = x2.shape
    nbytes = 4 * x2.numel() * x2.element_size() + 2 * d * 4 + 2 * N * 4
    t_bytes = nbytes / PEAK_BYTES
    t_flops = 10 * x2.numel() / PEAK_FLOPS["float32"]
    return (max(t_bytes, t_flops) * 1e3,
            "bytes" if t_bytes >= t_flops else "operations")


def close_or_fail(name, got, want, tol):
    """Max abs error of `got` against `want`; fails past tol (1 + |want|)."""
    import torch
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite output")
    diff = (got - want).abs()
    err = float(diff.max())
    if not bool((diff <= tol * (1 + want.abs())).all()):
        fail(f"{name}: max abs err {err} past {tol} (1 + |plain|)")
    return err


def check_flash(fa, device, flush):
    """Phase 3 for flash attention at the train step's [8, 16, 1024, 64]:
    forward kernel (out, lse) against its plain version, backward through
    torch.autograd.grad (dq, dk, dv) against the plain backward; returns
    the bf16 {"flash_fwd": ..., "flash_bwd": ...}."""
    import torch
    import torch.nn.functional as F
    B, H, S, D = TRAIN_BATCH, HEADS, TRAIN_SEQ, HIDDEN // HEADS
    scale = 1.0 / D ** 0.5
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = TRAIN_TOL[name]
        g = torch.Generator(device=device).manual_seed(SEED)
        q, k, v, dout = (torch.randn(B, H, S, D, generator=g, device=device,
                                     dtype=dtype) for _ in range(4))
        qs = (q * scale).to(dtype)
        out, lse = fa._launch_fwd(qs, k, v, True)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_fwd_reference(qs, k, v, True)
        err_f = max(close_or_fail(f"flash_fwd {name} out", out, ref_out, tol),
                    close_or_fail(f"flash_fwd {name} lse", lse, ref_lse,
                                  TOL["float32"]))
        # the backward through autograd (splash_mha scales q, the
        # kernels see the scaled q) against the plain backward, with
        # the scale carried into dq as autograd carries it
        args = [t.detach().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(fa.splash_mha(*args, causal=True), args,
                                  dout)
        torch.cuda.synchronize()
        dqs, dk, dv = fa.flash_bwd_reference(qs, k, v, ref_out, ref_lse,
                                             dout, True)
        want = ((dqs * scale).to(dtype), dk, dv)
        err_b = max(close_or_fail(f"flash_bwd {name} {n}", a, e, tol)
                    for n, a, e in zip(("dq", "dk", "dv"), got, want))
        del got, want, dqs, dk, dv, ref_out, ref_lse
        fwd_ms = cuda_ms(lambda: fa._launch_fwd(qs, k, v, True), flush=flush)
        bwd_ms = cuda_ms(lambda: fa._launch_bwd(qs, k, v, out, lse, dout,
                                                True), flush=flush)
        fwd_plain = cuda_ms(lambda: fa.flash_fwd_reference(qs, k, v, True),
                            iters=3, flush=flush)
        bwd_plain = cuda_ms(lambda: fa.flash_bwd_reference(
            qs, k, v, out, lse, dout, True), iters=3, flush=flush)
        # yardsticks: one library call for the same function (scale 1
        # on the pre-scaled q), backward through autograd
        fwd_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, k, v, is_causal=True, scale=1.0), flush=flush)
        sq = [t.detach().requires_grad_() for t in (qs, k, v)]
        so = F.scaled_dot_product_attention(*sq, is_causal=True, scale=1.0)
        bwd_lib = cuda_ms(lambda: torch.autograd.grad(
            so, sq, dout, retain_graph=True), flush=flush)
        del so, sq
        for kname, err, ms, plain, lib, bwd in (
                ("flash_fwd", err_f, fwd_ms, fwd_plain, fwd_lib, False),
                ("flash_bwd", err_b, bwd_ms, bwd_plain, bwd_lib, True)):
            bound_ms, bound_by = flash_bound(q, bwd)
            records.setdefault(name, {})[kname] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib)
            flops = flash_flops(q, True, bwd)
            print(f"kernel check: {kname} {name} [{B}, {H}, {S}, {D}] causal"
                  f" max_abs_err={err:.3g} (tol {tol} (1 + |plain|)) "
                  f"kernel_ms={ms:.4f} plain_ms={plain:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by}), "
                  f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
                  f"{bound_ms / ms:.1%} of the bound; yardstick: "
                  f"scaled_dot_product_attention"
                  f"{' backward' if bwd else ''} {lib:.4f} ms", flush=True)
        del q, k, v, dout, qs, out, lse, args
    return records["bfloat16"]


def check_add_ln(ln, device, flush):
    """Phase 3 for add+LayerNorm at the train step's 8192 rows x 1024:
    forward (out, z, mu, rstd) and backward (dz, and dw and db, the
    backward kernel's fp32 sums over rows) kernels against their plain
    versions, dw and db within 1e-6 of each column's sum of |terms| (as
    K6's check); two launches of each bit-identical. Times: the backward
    as the train step runs it, dw and db included; yardsticks F.layer_norm
    over the pre-added z and its backward with w and b requiring grad
    (dx, dw and db in one call), each with its GB/s (the kernels move 4
    tensors, the yardsticks 2 and 3). Returns the bf16 {"add_ln_fwd":
    ..., "add_ln_bwd": ...}."""
    import torch
    import torch.nn.functional as F
    N, d = TRAIN_BATCH * TRAIN_SEQ, HIDDEN
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = TRAIN_TOL[name]
        g = torch.Generator(device=device).manual_seed(SEED)
        x, r, gout, gz = (torch.randn(N, d, generator=g, device=device,
                                      dtype=dtype) for _ in range(4))
        w = torch.rand(d, generator=g, device=device)
        b = torch.randn(d, generator=g, device=device)
        got = ln._launch_fwd(x, r, w, b, 1e-5)
        again = ln._launch_fwd(x, r, w, b, 1e-5)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            fail(f"add_ln_fwd {name}: two launches differ")
        want = ln.add_ln_fwd_reference(x, r, w, b, 1e-5)
        err_f = max(close_or_fail(f"add_ln_fwd {name} {n}", a, e, tol)
                    for n, a, e in zip(("out", "z", "mu", "rstd"), got,
                                       want))
        z, mu, rs = want[1], want[2], want[3]
        dz, dw, db = ln._launch_bwd(z, w, mu, rs, gout, gz)
        again = ln._launch_bwd(z, w, mu, rs, gout, gz)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip((dz, dw, db), again)):
            fail(f"add_ln_bwd {name}: two launches differ")
        ref_dz, ref_dw, ref_db = ln.add_ln_bwd_reference(z, w, mu, rs, gout,
                                                         gz)
        err_b = close_or_fail(f"add_ln_bwd {name} dz", dz, ref_dz, tol)
        zhat = (z.float() - mu[:, None]) * rs[:, None]
        for n, a, e, terms in (("dw", dw, ref_dw, gout.float() * zhat),
                               ("db", db, ref_db, gout.float())):
            mass = terms.abs().sum(0)
            diff = (a - e).abs()
            if not bool(torch.isfinite(a).all()) or not bool(
                    (diff <= 1e-6 * mass).all()):
                fail(f"add_ln_bwd {name} {n}: past 1e-6 of a column's sum "
                     f"of |terms| ({float((diff / mass).max()):.3g})")
            err_b = max(err_b, float(diff.max()))
        del zhat, again
        fwd_ms = cuda_ms(lambda: ln._launch_fwd(x, r, w, b, 1e-5),
                         flush=flush)
        bwd_ms = cuda_ms(lambda: ln._launch_bwd(z, w, mu, rs, gout, gz),
                         flush=flush)
        fwd_plain = cuda_ms(lambda: ln.add_ln_fwd_reference(x, r, w, b,
                                                            1e-5),
                            flush=flush)
        bwd_plain = cuda_ms(lambda: ln.add_ln_bwd_reference(
            z, w, mu, rs, gout, gz), flush=flush)
        # yardsticks: F.layer_norm over the pre-added z (no single call
        # adds and normalises), and its backward through autograd with w
        # and b requiring grad: dx, dw and db in one call
        wd, bd = w.to(dtype), b.to(dtype)      # F.layer_norm's types
        fwd_lib = cuda_ms(lambda: F.layer_norm(z, (d,), wd, bd, 1e-5),
                          flush=flush)
        leaves = [t.detach().requires_grad_() for t in (z, wd, bd)]
        lo = F.layer_norm(leaves[0], (d,), leaves[1], leaves[2], 1e-5)
        bwd_lib = cuda_ms(lambda: torch.autograd.grad(
            lo, leaves, gout, retain_graph=True), flush=flush)
        del lo, leaves
        bound_ms, bound_by = add_ln_bound(x)
        nbytes = x.numel() * x.element_size()
        for kname, err, ms, plain, lib, lib_tensors in (
                ("add_ln_fwd", err_f, fwd_ms, fwd_plain, fwd_lib, 2),
                ("add_ln_bwd", err_b, bwd_ms, bwd_plain, bwd_lib, 3)):
            records.setdefault(name, {})[kname] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib)
            bwd = kname.endswith("bwd")
            print(f"kernel check: {kname} {name} [{N}, {d}] "
                  f"max_abs_err={err:.3g} (tol {tol} (1 + |plain|)"
                  f"{'; dw, db within 1e-6 of each sum of |terms|' if bwd else ''}"
                  f"), two launches bit-identical; kernel_ms={ms:.4f}"
                  f"{' (dw, db included)' if bwd else ''}, "
                  f"{4 * nbytes / (ms * 1e-3) / 1e9:.0f} GB/s over 4 tensors, "
                  f"{bound_ms / ms:.1%} of the bound; plain_ms={plain:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by}) yardstick: "
                  f"F.layer_norm{' backward (dx, dw, db)' if bwd else ''}"
                  f" over the pre-added z {lib:.4f} ms, "
                  f"{lib_tensors * nbytes / (lib * 1e-3) / 1e9:.0f} GB/s over "
                  f"{lib_tensors} tensors", flush=True)
    return records["bfloat16"]


def check_qkv_proj(qp, device, flush):
    """Phase 3 for the fused QKV projection (K5) at the train step's x
    [8, 1024, 1024] x w_qkv [1024, 3072] into 3 x [8, 16, 1024, 64], fp32
    and bf16: the forward kernel against its plain version, and the
    gradients through the autograd function (the kernel's forward, the
    plain-tensor backward) against the plain version differentiated by
    autograd on fp32 copies and rounded once; returns the bf16
    {"qkv_proj": ...}."""
    import torch
    B, S, d, H = TRAIN_BATCH, TRAIN_SEQ, HIDDEN, HEADS
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = TRAIN_TOL[name]
        g = torch.Generator(device=device).manual_seed(SEED)
        x = torch.randn(B, S, d, generator=g, device=device).to(dtype)
        w = (torch.randn(d, 3 * d, generator=g, device=device)
             * d ** -0.5).to(dtype)
        b = (torch.randn(3 * d, generator=g, device=device) * 0.1).to(dtype)
        got = qp.qkv_proj(x, w, b, H)
        torch.cuda.synchronize()
        want = qp.qkv_proj_reference(x, w, b, H)
        err_f = max(close_or_fail(f"qkv_proj {name} {n}", a, e, tol)
                    for n, a, e in zip("qkv", got, want))
        del got, want
        gq, gk, gv = (torch.randn(B, H, S, d // H, generator=g,
                                  device=device).to(dtype) for _ in range(3))
        args = [t.detach().requires_grad_() for t in (x, w, b)]
        got = torch.autograd.grad(qp.qkv_proj(*args, H), args, (gq, gk, gv))
        torch.cuda.synchronize()
        # the plain version differentiated on fp32 copies, each gradient
        # rounded once to the dtype: JAX's fp32 sums and single cast
        # (autograd on the bf16 operands would add the three thirds' dx
        # in bf16)
        a32 = [t.detach().float().requires_grad_() for t in (x, w, b)]
        want = [t.to(dtype) for t in torch.autograd.grad(
            qp.qkv_proj_reference(*a32, H), a32,
            (gq.float(), gk.float(), gv.float()))]
        err_b = max(close_or_fail(f"qkv_proj {name} d{n}", a, e, tol)
                    for n, a, e in zip("xwb", got, want))
        del got, want, args, a32, gq, gk, gv
        ms = cuda_ms(lambda: qp.qkv_proj(x, w, b, H), flush=flush)
        plain = cuda_ms(lambda: qp.qkv_proj_reference(x, w, b, H), iters=5,
                        flush=flush)
        x2 = x.view(-1, d)
        lib = cuda_ms(lambda: torch.addmm(b, x2, w), flush=flush)
        nbytes = (x.numel() + w.numel() + b.numel() + 3 * x.numel()) \
            * x.element_size()
        t_bytes = nbytes / PEAK_BYTES
        t_flops = 2 * B * S * d * 3 * d / PEAK_FLOPS[name]
        bound_ms = max(t_bytes, t_flops) * 1e3
        bound_by = "bytes" if t_bytes >= t_flops else "operations"
        err = max(err_f, err_b)
        records[name] = {"qkv_proj": dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib)}
        print(f"kernel check: qkv_proj {name} x [{B}, {S}, {d}] x w_qkv "
              f"[{d}, {3 * d}] -> 3 x [{B}, {H}, {S}, {d // H}] max_abs_err="
              f"{err_f:.3g} forward, {err_b:.3g} dx/dw/db (tol {tol} (1 + "
              f"|plain|)) kernel_ms={ms:.4f} plain_ms={plain:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}), "
              f"{2 * B * S * d * 3 * d / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
              f"{bound_ms / ms:.1%} of the bound; yardstick: torch.addmm"
              f" over [{B * S}, {d}] x [{d}, {3 * d}] (no head layout) "
              f"{lib:.4f} ms", flush=True)
        del x, w, b, x2
    return records["bfloat16"]


def check_flash_bshd(fa, device, flush):
    """Phase 3 for the paddle-layout flash forward (K1b): the kernel
    against its plain version at [8, 1024, 16, 128] bf16 causal and full,
    [8, 1024, 8, 256] bf16 causal and [8, 1024, 16, 128] fp32 causal;
    then forward + backward through `flash_attention()` (kernel forward,
    plain recompute backward) against the plain function differentiated
    by autograd. Returns the record of [8, 1024, 16, 128] bf16 causal,
    the shape the phase of its own runs."""
    import torch
    import torch.nn.functional as F
    B, S = TRAIN_BATCH, TRAIN_SEQ
    cases = ((16, 128, torch.bfloat16, True), (16, 128, torch.bfloat16,
                                                False),
             (8, 256, torch.bfloat16, True), (16, 128, torch.float32, True))
    records = {}
    for H, D, dtype, causal in cases:
        name = str(dtype).split(".")[-1]
        tol = TRAIN_TOL[name]
        scale = D ** -0.5
        g = torch.Generator(device=device).manual_seed(SEED + D)
        q, k, v = (torch.randn(B, S, H, D, generator=g, device=device,
                               dtype=dtype) for _ in range(3))
        got = fa._launch_fwd_bshd(q, k, v, scale, causal)
        torch.cuda.synchronize()
        err = close_or_fail(f"flash_bshd {name} D={D}", got,
                            fa.flash_fwd_bshd_reference(q, k, v, scale,
                                                        causal), tol)
        ms = cuda_ms(lambda: fa._launch_fwd_bshd(q, k, v, scale, causal),
                     flush=flush)
        plain = cuda_ms(lambda: fa.flash_fwd_bshd_reference(
            q, k, v, scale, causal), iters=3, flush=flush)
        # yardstick: SDPA over pre-transposed [B, H, S, D] copies
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale), flush=flush)
        bound_ms, bound_by = flash_bound(q.transpose(1, 2), False, causal,
                                         lse=False)
        key = (H, D, name, causal)
        records[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=lib)
        flops = flash_flops(q.transpose(1, 2), causal)
        print(f"kernel check: flash_bshd {name} [{B}, {S}, {H}, {D}] "
              f"{'causal' if causal else 'full'} max_abs_err={err:.3g} (tol "
              f"{tol} (1 + |plain|)) kernel_ms={ms:.4f} plain_ms="
              f"{plain:.4f} bound_ms={bound_ms:.4f} ({bound_by}), "
              f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
              f"{bound_ms / ms:.1%} of the bound; yardstick: "
              f"scaled_dot_product_attention on transposed copies "
              f"{lib:.4f} ms", flush=True)
        del q, k, v, got, qt, kt, vt
    # forward + backward through the entry
    H, D, dtype = HEADS, 128, torch.bfloat16
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    q, k, v, dout = (torch.randn(B, S, H, D, generator=g, device=device,
                                 dtype=dtype) for _ in range(4))
    args = [t.requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*args, causal=True)
    got = torch.autograd.grad(out, args, dout)
    torch.cuda.synchronize()
    ref = fa.attention_bshd_reference(*args, D ** -0.5, True)
    want = torch.autograd.grad(ref, args, dout)
    tol = TRAIN_TOL["bfloat16"]
    err = max([close_or_fail("flash_attention() bf16 out", out.detach(),
                             ref.detach(), tol)]
              + [close_or_fail(f"flash_attention() bf16 {n}", a, e, tol)
                 for n, a, e in zip(("dq", "dk", "dv"), got, want)])
    print(f"kernel check: flash_attention() bf16 [{B}, {S}, {H}, {D}] causal"
          f" forward + backward against the plain function under autograd: "
          f"max_abs_err={err:.3g} (tol {tol} (1 + |plain|))", flush=True)
    rec = records[(HEADS, 128, "bfloat16", True)]
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    return {"flash_bshd": rec}


def check_wgrad(cw, device, flush):
    """Phase 3 for the split-K 1x1 weight gradient (K6): the kernel
    against its plain version at ResNet-50's [401408, 256] x [401408,
    64] bf16 (chunk 4096), at its stage-3 [25088, 1024] x [25088, 256]
    bf16 (chunk 3136) and at a small fp32 shape; returns the first's
    {"wgrad_1x1": ...}. Both sides add exact fp32 products (16-bit
    products are exact in fp32) in fp32, the chunks in the same order
    and the terms inside a chunk in another: an element's error scales
    with the absolute mass of its sum, not with its value (terms of
    either sign cancel), so each element must lie within WGRAD_TOL x
    sum_n |x[n, i] dy[n, j]| (~8 fp32 spacings of that mass) of the
    plain version."""
    import torch
    record = None
    for (N, Ci, Co, chunk), dtype in (((WGRAD_N, WGRAD_CI, WGRAD_CO,
                                        WGRAD_CHUNK), torch.bfloat16),
                                      (WGRAD_SHAPE2, torch.bfloat16),
                                      ((8192, 72, 40, 1024), torch.float32)):
        name = str(dtype).split(".")[-1]
        g = torch.Generator(device=device).manual_seed(SEED + Ci)
        x = torch.randn(N, Ci, generator=g, device=device).to(dtype)
        dy = torch.randn(N, Co, generator=g, device=device).to(dtype)
        got = cw.wgrad_1x1(x, dy, chunk=chunk)
        torch.cuda.synchronize()
        want = cw.wgrad_1x1_reference(x, dy, chunk=chunk)
        mass = x.float().abs().t() @ dy.float().abs()
        diff = (got - want).abs()
        err = float(diff.max())
        if not bool(torch.isfinite(got).all()) \
                or not bool((diff <= WGRAD_TOL * mass).all()):
            fail(f"wgrad_1x1 {name}: max abs err {err}, worst "
                 f"{float((diff / mass).max()):.3g} of its sum's mass, past "
                 f"{WGRAD_TOL}")
        del want, mass, diff
        if not torch.equal(cw.wgrad_1x1(x, dy, chunk=chunk), got):
            fail(f"wgrad_1x1 {name}: two runs gave different bits")
        ms = cuda_ms(lambda: cw.wgrad_1x1(x, dy, chunk=chunk), flush=flush)
        plain = cuda_ms(lambda: cw.wgrad_1x1_reference(x, dy, chunk=chunk),
                        iters=5, flush=flush)
        xt = x.t()
        lib = cuda_ms(lambda: torch.mm(xt, dy), flush=flush)
        t_bytes = ((x.numel() + dy.numel()) * x.element_size()
                   + Ci * Co * 4) / PEAK_BYTES
        t_flops = 2 * N * Ci * Co / PEAK_FLOPS[name]
        bound_ms = max(t_bytes, t_flops) * 1e3
        bound_by = "bytes" if t_bytes >= t_flops else "operations"
        print(f"kernel check: wgrad_1x1 {name} x [{N}, {Ci}] dy [{N}, {Co}] "
              f"chunk {chunk} max_abs_err={err:.3g} (tol {WGRAD_TOL} x "
              f"sum |x dy|; two runs bit-identical) kernel_ms={ms:.4f} "
              f"plain_ms={plain:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
              f"yardstick: "
              f"torch.mm(x.t(), dy) {lib:.4f} ms", flush=True)
        if record is None:
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=lib)
        del x, dy, got, xt
    return {"wgrad_1x1": record}


def flash_bshd_phase(fa, device, counters, calls=3):
    """The `flash_attention()` entry's own path: `calls` forward +
    backward calls at [8, 1024, 16, 128] bf16 causal, every count zeroed
    just before and read just after; the K1b forward must have launched
    once a call and no other kernel at all. Returns the launches."""
    import torch
    B, S, H, D = TRAIN_BATCH, TRAIN_SEQ, HEADS, 128
    g = torch.Generator(device=device).manual_seed(SEED + 7)
    q, k, v, dout = (torch.randn(B, S, H, D, generator=g, device=device,
                                 dtype=torch.bfloat16) for _ in range(4))
    args = [t.requires_grad_() for t in (q, k, v)]
    for mod, attr, _ in counters:
        setattr(mod, attr, 0)
    for _ in range(calls):
        out = fa.flash_attention(*args, causal=True)
        grads = torch.autograd.grad(out, args, dout)
    torch.cuda.synchronize()
    launches = {name: getattr(mod, attr) for mod, attr, name in counters}
    if not all(bool(torch.isfinite(t.float()).all()) for t in (out, *grads)):
        fail("flash_attention(): non-finite output or gradient")
    hold_launches("flash_attention()", launches, {"flash_bshd": calls})
    print(f"flash_attention(): {calls} forward + backward calls at [{B}, {S}"
          f", {H}, {D}] bf16 causal; launches flash_bshd "
          f"{launches['flash_bshd']}, other kernels 0", flush=True)
    return {"flash_bshd": launches["flash_bshd"]}


def wgrad_phase(cw, device, counters, calls=3):
    """The `wgrad_1x1` entry's own path: `calls` calls at ResNet-50's
    shape, counts zeroed just before and read just after; K6 must have
    launched once a call and no other kernel. Returns the launches."""
    import torch
    g = torch.Generator(device=device).manual_seed(SEED + 8)
    x = torch.randn(WGRAD_N, WGRAD_CI, generator=g, device=device).to(
        torch.bfloat16)
    dy = torch.randn(WGRAD_N, WGRAD_CO, generator=g, device=device).to(
        torch.bfloat16)
    for mod, attr, _ in counters:
        setattr(mod, attr, 0)
    outs = [cw.wgrad_1x1(x, dy, chunk=WGRAD_CHUNK) for _ in range(calls)]
    torch.cuda.synchronize()
    launches = {name: getattr(mod, attr) for mod, attr, name in counters}
    if not all(torch.equal(o, outs[0]) for o in outs) \
            or not bool(torch.isfinite(outs[0]).all()):
        fail("wgrad_1x1: non-finite or run-to-run different output")
    hold_launches("wgrad_1x1", launches, {"wgrad_1x1": calls})
    print(f"wgrad_1x1: {calls} calls at x [{WGRAD_N}, {WGRAD_CI}] dy "
          f"[{WGRAD_N}, {WGRAD_CO}] bf16, chunk {WGRAD_CHUNK}, the same bits "
          f"each; launches wgrad_1x1 {launches['wgrad_1x1']}, other kernels "
          "0", flush=True)
    return {"wgrad_1x1": launches["wgrad_1x1"]}


def hold_launches(label, launches, want):
    """Fails unless each kernel in `want` launched exactly that often and
    every other kernel never."""
    for name, n in launches.items():
        if n != want.get(name, 0):
            fail(f"{label}: {name} launched {n} times, expected "
                 f"{want.get(name, 0)}")


# ------------------------------------------------------------- phase 6


def random_hybrid_params(layers, seed=SEED):
    """GPT-350M trainer parameters in the JAX `HybridGPT` layout (nested,
    blocks stacked on [L]), drawn from a numpy seed with the JAX
    trainer's init scales: N(0, 0.02), output projections N(0, 0.02 /
    sqrt(2L)), unit LayerNorm scales, zero biases."""
    import numpy as np
    rng = np.random.default_rng(seed)
    L, D, FF, V = layers, HIDDEN, 4 * HIDDEN, VOCAB
    proj = 0.02 / (2 * L) ** 0.5

    def normal(shape, std=0.02):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    return {"tok_emb": normal((V, D)), "pos_emb": normal((TRAIN_SEQ, D)),
            "ln_f_w": np.ones(D, np.float32), "ln_f_b": zeros(D),
            "head": normal((D, V)),
            "blocks": {"ln1_w": np.ones((L, D), np.float32),
                       "ln1_b": zeros(L, D),
                       "w_qkv": normal((L, D, 3 * D)),
                       "b_qkv": zeros(L, 3 * D),
                       "w_o": normal((L, D, D), proj), "b_o": zeros(L, D),
                       "ln2_w": np.ones((L, D), np.float32),
                       "ln2_b": zeros(L, D),
                       "w_fc1": normal((L, D, FF)), "b_fc1": zeros(L, FF),
                       "w_fc2": normal((L, FF, D), proj),
                       "b_fc2": zeros(L, D)}}


def train_config(**kw):
    """bench_gpt's TPU config (bench.py:45-54), `kw` overriding."""
    import torch
    from paddle_tpu_torch.parallel.hybrid_gpt import GPTConfig
    base = dict(vocab_size=VOCAB, seq_len=TRAIN_SEQ, d_model=HIDDEN,
                n_heads=HEADS, n_layers=LAYERS, remat=True,
                remat_policy="save_splash_residuals", fused_ce=True,
                ce_seq_chunks=4, bf16_grads=True,
                compute_dtype=torch.bfloat16)
    base.update(kw)
    return GPTConfig(**base)


def timed_steps(trainer, params, opt, batch, first_step, seed):
    """WARMUP_STEPS then TIMED_STEPS train steps on one fixed random
    batch; returns (params, opt, losses, seconds of the timed steps,
    peak bytes)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, VOCAB, (batch, TRAIN_SEQ))
    lab = rng.integers(0, VOCAB, (batch, TRAIN_SEQ))
    torch.cuda.reset_peak_memory_stats()
    losses = []
    step = first_step
    for _ in range(WARMUP_STEPS):
        params, opt, loss = trainer.train_step(params, opt, tok, lab,
                                               step_num=step)
        losses.append(float(loss))
        step += 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = []
    for _ in range(TIMED_STEPS):
        params, opt, loss = trainer.train_step(params, opt, tok, lab,
                                               step_num=step)
        timed.append(loss)
        step += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (params, opt, losses + [float(x) for x in timed], wall,
            torch.cuda.max_memory_allocated())


def train_line(label, batch, wall, peak, losses):
    """Prints one run's line; returns (ms/step, tokens/s, peak bytes)."""
    # bench.py's train flops per token: 6 N + 6 L S d
    n_flop = 12 * LAYERS * HIDDEN ** 2 + VOCAB * HIDDEN + TRAIN_SEQ * HIDDEN
    flops_tok = 6 * n_flop + 6 * LAYERS * TRAIN_SEQ * HIDDEN
    tps = batch * TRAIN_SEQ * TIMED_STEPS / wall
    print(f"train [{label}]: batch {batch}, {TIMED_STEPS} timed steps after "
          f"{WARMUP_STEPS} warm-up: {wall * 1e3 / TIMED_STEPS:.1f} ms/step, "
          f"{tps:.0f} tokens/s, "
          f"{tps * flops_tok / PEAK_FLOPS['bfloat16']:.1%} of the bf16 peak "
          f"({flops_tok} flops/token), max_memory_allocated {peak} B; "
          "losses " + " ".join(f"{x:.4f}" for x in losses), flush=True)
    return wall * 1e3 / TIMED_STEPS, tps, peak


# the train runs: (label, GPTConfig overrides, batch, launches per step
# held exactly; every other kernel 0). bench_gpt's own config first (the
# kernels line reads its launches), then full remat for comparison, then
# the fused QKV projection.
TRAIN_RUNS = (
    ("bench_gpt", {}, TRAIN_BATCH,
     {"flash_fwd": LAYERS, "flash_bwd": LAYERS, "add_ln_fwd": 2 * LAYERS,
      "add_ln_bwd": LAYERS}),
    ("remat_policy=None", {"remat_policy": None}, TRAIN_BATCH,
     {"flash_fwd": 2 * LAYERS, "flash_bwd": LAYERS,
      "add_ln_fwd": 2 * LAYERS, "add_ln_bwd": LAYERS}),
    ("qkv_kernel", {"qkv_kernel": True}, TRAIN_BATCH,
     {"flash_fwd": LAYERS, "flash_bwd": LAYERS, "add_ln_fwd": 2 * LAYERS,
      "add_ln_bwd": LAYERS, "qkv_proj": 2 * LAYERS}),
)


def train(device, counters):
    """Phase 6: GPT-350M trained in each of TRAIN_RUNS from one set of
    parameters (each run continues from the last), every count zeroed
    just before a run's first step and read after its last, and held
    exactly; bench_gpt's config then gets one profiled step and is timed
    at its own batch (BENCH_BATCH) as well. Returns the launches of the
    runs that carry each kernel (bench_gpt's, and the qkv_kernel run's
    for qkv_proj)."""
    import numpy as np
    from paddle_tpu_torch.convert import load_jax_hybrid_gpt
    from paddle_tpu_torch.parallel.hybrid_gpt import (HybridGPT,
                                                      init_opt_state)

    t0 = time.perf_counter()
    params = load_jax_hybrid_gpt(random_hybrid_params(LAYERS),
                                 device=device)
    opt = init_opt_state(train_config(), params)
    n_params = sum(p.numel() for p in params["blocks"].values()) + sum(
        params[k].numel() for k in params if k != "blocks")
    print(f"train: GPT-350M ({n_params} parameters) built in "
          f"{time.perf_counter() - t0:.1f} s: vocab {VOCAB}, seq "
          f"{TRAIN_SEQ}, d_model {HIDDEN}, {HEADS} heads, {LAYERS} layers,"
          f" bf16 compute, bf16_grads, remat, fused_ce, ce_seq_chunks=4; "
          f"bench_gpt's remat_policy='save_splash_residuals' unless a run "
          f"says otherwise", flush=True)
    steps = WARMUP_STEPS + TIMED_STEPS
    step = 1
    launches, table = {}, []
    for label, overrides, batch, want in TRAIN_RUNS:
        trainer = HybridGPT(train_config(**overrides), device=device)
        for mod, attr, _ in counters:
            setattr(mod, attr, 0)
        params, opt, losses, wall, peak = timed_steps(
            trainer, params, opt, batch, step, SEED + 3)
        step += steps
        got = {name: getattr(mod, attr) for mod, attr, name in counters}
        table.append((label, batch) + train_line(label, batch, wall, peak,
                                                 losses))
        if not all(np.isfinite(losses)):
            fail(f"train [{label}]: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            fail(f"train [{label}]: the loss did not fall ({losses[0]} -> "
                 f"{losses[-1]})")
        hold_launches(f"train [{label}]", got,
                      {n: steps * k for n, k in want.items()})
        print(f"train [{label}]: launches " + ", ".join(
            f"{n} {got[n]} ({got[n] // steps}/step)" for n in want)
            + "; other kernels 0", flush=True)
        for n in want:
            launches.setdefault(n, got[n])
        if label in ("bench_gpt", "qkv_kernel"):
            rng = np.random.default_rng(SEED + 3)
            tok = rng.integers(0, VOCAB, (batch, TRAIN_SEQ))
            lab = rng.integers(0, VOCAB, (batch, TRAIN_SEQ))
            profile_train(trainer, params, opt, tok, lab, step, label)
            step += 1
        if label == "bench_gpt":
            params, opt, losses, wall, peak = timed_steps(
                trainer, params, opt, BENCH_BATCH, step, SEED + 6)
            step += steps
            table.append((label, BENCH_BATCH) + train_line(
                label, BENCH_BATCH, wall, peak, losses))
            if not all(np.isfinite(losses)):
                fail(f"train: non-finite loss at batch {BENCH_BATCH} "
                     f"{losses}")
        del trainer
    print("train: side by side (ms/step, tokens/s, max_memory_allocated B): "
          + "; ".join(f"{label} batch {batch}: {ms:.1f}, {tps:.0f}, {peak}"
                      for label, batch, ms, tps, peak in table), flush=True)
    del params, opt
    return launches


def check_train_step(device):
    """Phase 7: one fp32 train step at the full widths, 2 layers, batch
    1, on the card (kernels) and on a CPU copy (plain versions), twice:
    remat off, and bench_gpt's remat policy with the fused QKV
    projection. Each pair must agree: the loss within 1e-4 relative;
    Adam's first moment after the step is 0.1 x the clipped gradient,
    each within 1e-4 of its tensor's largest |m| (fp32 sums in another
    order leave ~1e-6 of it); each parameter within 0.25 lr: Adam's first
    step moves an element by lr * g / (|g| + eps), so an element whose
    |g| is near eps moves by Δg / (4 eps) lr for gradient noise Δg
    (cancellation noise of 1e-9 shows as 0.025 lr), while a wrong sign
    is 2 lr apart. The card's step with the residuals kept must equal its
    full-remat step (the kept (out, lse) are what the recompute gives):
    the same loss, and parameters and moments within the same bounds
    (the count of bit-identical tensors is printed)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.convert import load_jax_hybrid_gpt
    from paddle_tpu_torch.parallel.hybrid_gpt import (HybridGPT,
                                                      init_opt_state)
    layers = 2
    arrays = random_hybrid_params(layers, seed=SEED + 4)
    rng = np.random.default_rng(SEED + 5)
    tok = rng.integers(0, VOCAB, (1, TRAIN_SEQ))
    lab = rng.integers(0, VOCAB, (1, TRAIN_SEQ))
    base = dict(n_layers=layers, bf16_grads=False,
                compute_dtype=torch.float32)

    def step(dev, **kw):
        cfg = train_config(**base, **kw)
        params = load_jax_hybrid_gpt(arrays, device=dev)
        opt = init_opt_state(cfg, params)
        params, opt, loss = HybridGPT(cfg, device=dev).train_step(
            params, opt, tok, lab)
        return float(loss), params, opt

    def compare(label, a, b):
        """Fails unless step results a and b agree as the docstring says;
        prints how closely they do."""
        (la, pa, oa), (lb, pb, ob) = a, b
        if not abs(la - lb) <= 1e-4 * abs(lb):
            fail(f"train check [{label}]: loss {la} vs {lb}")
        p_tol = 0.25 * train_config().learning_rate
        worst = {"param": 0.0, "moment": 0.0, "same": 0, "n": 0}

        def walk(a, b, oa, ob, path=""):
            for k in a:
                if isinstance(a[k], dict):
                    walk(a[k], b[k], oa[k], ob[k], path + k + ".")
                    continue
                x, y = a[k].cpu(), b[k].cpu()
                err = float((x - y).abs().max())
                worst["param"] = max(worst["param"], err)
                worst["same"] += int(torch.equal(x, y))
                worst["n"] += 1
                if err > p_tol:
                    fail(f"train check [{label}]: {path}{k} differs by "
                         f"{err} past {p_tol}")
                m_ref = ob[k]["m"].cpu()
                m_err = float((oa[k]["m"].cpu() - m_ref).abs().max()) / max(
                    float(m_ref.abs().max()), 1e-30)
                worst["moment"] = max(worst["moment"], m_err)
                if m_err > 1e-4:
                    fail(f"train check [{label}]: {path}{k} first moment "
                         f"differs by {m_err:.3g} of its largest value, past"
                         f" 1e-4")
        walk(pa, pb, oa, ob)
        print(f"check [{label}]: loss {la:.6f} vs {lb:.6f} (rel "
              f"{abs(la - lb) / abs(lb):.2e}, tol 1e-4); Adam first moments "
              f"within {worst['moment']:.3g} of their largest value (tol "
              f"1e-4); parameters within {worst['param']:.3g} (tol "
              f"{p_tol:.3g} = 0.25 lr); {worst['same']} of {worst['n']} "
              f"parameters bit-identical", flush=True)

    print(f"check: one fp32 train step, {layers} layers at full width, "
          f"batch 1", flush=True)
    compare("remat off: card vs CPU", step(device, remat=False),
            step("cpu", remat=False))
    kept = dict(remat=True, qkv_kernel=True)
    card = step(device, **kept)
    compare("save_splash_residuals + qkv_kernel: card vs CPU", card,
            step("cpu", **kept))
    compare("save_splash_residuals vs full remat, both qkv_kernel, card",
            card, step(device, remat=True, qkv_kernel=True,
                       remat_policy=None))


def profile_train(trainer, params, opt, tok, lab, step_num, label):
    """Where a train step's device time goes: one step under
    torch.profiler after the timed window, its host time against the
    device time of the kernels it launched, and each of the port's
    kernel families' device ms and share of it. Informational: prints
    "not measured" when the profiler records no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(params, opt, tok, lab, step_num=step_num)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    if not dev:
        print(f"profile: train step [{label}] {host_ms:.1f} ms on the host "
              "clock (profiled); device time not measured (no device "
              "events)", flush=True)
        return
    device_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    ours, k1a = {}, {"forward": [0.0, 0], "backward": [0.0, 0]}
    for e in dev:
        for fam in ("flash", "add_ln", "qkv_proj"):
            if f"{fam}_" in e.key:
                ours[fam] = ours.get(fam, 0.0) + e.self_device_time_total
        # K1a's kernels by name: the forward's, the backward's and its
        # delta pre-pass
        part = "forward" if "flash_fwd" in e.key else "backward" if (
            "flash_bwd" in e.key or "flash_delta" in e.key) else None
        if part:
            k1a[part][0] += e.self_device_time_total
            k1a[part][1] += e.count
    print(f"profile: one train step [{label}], {host_ms:.1f} ms on the host "
          f"clock (profiled), {device_ms:.1f} ms of device time in "
          f"{sum(e.count for e in dev)} device launches, device busy "
          f"{device_ms / host_ms:.1%}; the port's kernels: " + ", ".join(
              f"{fam}* {t / 1e3:.3f} ms ({t / 1e3 / device_ms:.1%} of the "
              f"step's device time)" for fam, t in sorted(ours.items()))
          + "; most device time: " + "; ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f} ms "
              f"x{e.count}" for e in top), flush=True)
    for part, (t, n) in k1a.items():
        print(f"profile: train step [{label}] K1a {part}: {t / 1e3:.3f} ms "
              f"of device time a step in {n} kernel launches "
              f"({t / 1e3 / device_ms:.1%} of the step's device time)",
              flush=True)
    k2 = [e for e in dev if "add_ln_" in e.key]
    print(f"profile: train step [{label}] K2: " + ", ".join(
        f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
        for e in k2), flush=True)


# --------------------------------------- phase 3, segmented flash (K1c)


def seg_ids(pattern, B, S, rng):
    """[B, S] 0/1 key-padding ids at random lengths (the first sequence
    unpadded): padding after the tokens, before them, or strewn among
    them."""
    import numpy as np
    if pattern == "interleaved":
        keep = rng.random((B, S)) < 0.6
        keep[0] = True
    else:
        lens = rng.integers(1, S + 1, B)
        lens[0] = S
        keep = np.arange(S)[None] < lens[:, None]
        if pattern == "left":
            keep = keep[:, ::-1]
    return np.ascontiguousarray(keep, dtype=np.int32)


def seg_bound(q, seg, causal=False, backward=False):
    """(bound_ms, bound_by) of the segmented forward: q, k, v, out, the
    fp32 lse and the int32 ids moved once; 4*D flops per (query, key)
    pair this run's ids make visible (the same segment, and not above
    the diagonal when causal). Backward: q, k, v, out, dout, lse and the
    ids read, dq, dk and dv written; 10*D flops a visible pair (five
    products)."""
    import torch
    B, H, S, D = q.shape
    nbytes = (8 if backward else 4) * q.numel() * q.element_size() \
        + B * H * S * 4 + seg.numel() * 4
    same = seg[:, :, None] == seg[:, None, :]
    if causal:
        same &= torch.ones(S, S, dtype=torch.bool, device=seg.device).tril()
    flops = (10 if backward else 4) * D * H * int(same.sum())
    t_bytes = nbytes / PEAK_BYTES
    t_flops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]]
    return (max(t_bytes, t_flops) * 1e3,
            "bytes" if t_bytes >= t_flops else "operations")


def check_flash_seg(fa, device, flush):
    """Phase 3 for the segmented flash forward (K1c) at the BERT phase's
    shapes, [64, 12, 128, 64] and [16, 12, 512, 64] bf16 full, under
    trailing, left and interleaved padding, at S = 77 and 200 (off its
    128-row tiles) under the same three, with one sequence of full
    length beside one of length 1, then fp32 and causal at the first:
    out and lse against the plain version (the K1a forward's tolerance),
    every row finite. Times at each BERT shape under the serve phase's
    trailing padding: kernel, plain version and, as the yardstick, SDPA
    with the same segment mask; with the kernel's TFLOP/s over the
    visible pairs, its share of the bound and of the (64-row query,
    128-row key) tile pairs it computes. Returns the record of
    [64, 12, 128, 64] bf16."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    H = BERT["num_attention_heads"]
    D = BERT["hidden_size"] // H
    rng = np.random.default_rng(SEED + 11)
    cases = [(B, S, torch.bfloat16, False, pat)
             for B, S in [(B, S) for B, S, _ in BERT_BATCHES] + [(8, 77),
                                                                (8, 200)]
             for pat in ("trailing", "left", "interleaved")]
    cases += [(2, 512, torch.bfloat16, False, "full and 1"),
              (64, 128, torch.float32, False, "interleaved"),
              (64, 128, torch.bfloat16, True, "trailing")]
    errs = {}
    for B, S, dtype, causal, pat in cases:
        name = str(dtype).split(".")[-1]
        tol = TRAIN_TOL[name]
        g = torch.Generator(device=device).manual_seed(SEED + S)
        q, k, v = (torch.randn(B, H, S, D, generator=g, device=device,
                               dtype=dtype) for _ in range(3))
        q = (q * D ** -0.5).to(dtype)
        if pat == "full and 1":
            ids = (np.arange(S)[None] < np.array([[S], [1]])).astype(np.int32)
        else:
            ids = seg_ids(pat, B, S, rng)
        seg = torch.tensor(ids, device=device)
        out, lse = fa._launch_fwd_seg(q, k, v, seg, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, causal, seg)
        label = f"flash_fwd_seg {name} [{B}, {H}, {S}, {D}] {pat}" + (
            " causal" if causal else "")
        err = max(close_or_fail(label + " out", out, ref_out, tol),
                  close_or_fail(label + " lse", lse, ref_lse,
                                TOL["float32"]))
        errs[(S, name)] = max(errs.get((S, name), 0.0), err)
        print(f"kernel check: {label}: every row finite, max_abs_err="
              f"{err:.3g} (tol {tol} (1 + |plain|))", flush=True)
        del q, k, v, out, lse, ref_out, ref_lse
    records = {}
    for B, S, shortest in BERT_BATCHES:
        g = torch.Generator(device=device).manual_seed(SEED + S)
        q, k, v = (torch.randn(B, H, S, D, generator=g, device=device,
                               dtype=torch.bfloat16) for _ in range(3))
        lens = rng.integers(shortest, S + 1, B)
        seg = torch.tensor((np.arange(S)[None] < lens[:, None]).astype(
            np.int32), device=device)
        ms = cuda_ms(lambda: fa._launch_fwd_seg(q, k, v, seg, False),
                     flush=flush)
        plain = cuda_ms(lambda: fa.flash_fwd_reference(q, k, v, False, seg),
                        iters=3, flush=flush)
        same = seg[:, None, :, None] == seg[:, None, None, :]
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=same, scale=1.0), flush=flush)
        bound_ms, bound_by = seg_bound(q, seg)
        records[S] = dict(max_abs_err=errs[(S, "bfloat16")], ms=ms,
                          plain_ms=plain, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=lib)
        flops = 4 * D * H * int(same.sum())
        kept = fa.segment_tile_pairs(seg, False, fa.SEG_TILE,
                                     fa.SEG_FWD_KEY_TILE).float().mean()
        print(f"kernel check: flash_fwd_seg bfloat16 [{B}, {H}, {S}, {D}] "
              f"full, lengths {shortest}-{S}: kernel_ms={ms:.4f} plain_ms="
              f"{plain:.4f} bound_ms={bound_ms:.4f} ({bound_by}), the "
              f"kernel at {bound_ms / ms:.1%} of it, "
              f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s over the visible "
              f"pairs, {float(kept):.1%} of the (64 x 128) tile pairs "
              f"computed; yardstick: scaled_dot_product_attention with the "
              f"segment mask {lib:.4f} ms", flush=True)
        del q, k, v, seg, same
    return {"flash_fwd_seg": records[BERT_BATCHES[0][1]]}


def check_flash_seg_bwd(fa, device, flush):
    """Phase 3 for K1c's backward at the BERT shapes, [64, 12, 128, 64]
    and [16, 12, 512, 64] bf16 full, under trailing, left and
    interleaved padding, then fp32 and causal at the first: dq, dk and
    dv of every row against the plain backward on the kernel forward's
    (out, lse) (K1a's backward tolerance), all finite. Times at each
    shape under trailing padding of the train phase's lengths: kernel,
    plain version and, as the yardstick, SDPA's backward with the same
    segment mask. Returns the record of [16, 12, 512, 64] bf16, the
    shape of train BERT (A)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    H = BERT["num_attention_heads"]
    D = BERT["hidden_size"] // H
    rng = np.random.default_rng(SEED + 13)
    cases = [(B, S, torch.bfloat16, False, pat)
             for B, S, _ in BERT_BATCHES
             for pat in ("trailing", "left", "interleaved")]
    cases += [(64, 128, torch.float32, False, "interleaved"),
              (64, 128, torch.bfloat16, True, "trailing")]

    def operands(B, S, dtype, seg, causal, seed):
        g = torch.Generator(device=device).manual_seed(seed)
        q, k, v, dout = (torch.randn(B, H, S, D, generator=g, device=device,
                                     dtype=dtype) for _ in range(4))
        q = (q * D ** -0.5).to(dtype)
        out, lse = fa._launch_fwd_seg(q, k, v, seg, causal)
        return q, k, v, out, lse, dout

    errs = {}
    for B, S, dtype, causal, pat in cases:
        name = str(dtype).split(".")[-1]
        tol = TRAIN_TOL[name]
        seg = torch.tensor(seg_ids(pat, B, S, rng), device=device)
        args = operands(B, S, dtype, seg, causal, SEED + S + 1)
        got = fa._launch_bwd(*args, causal, seg)
        torch.cuda.synchronize()
        want = fa.flash_bwd_reference(*args, causal, seg)
        label = f"flash_bwd_seg {name} [{B}, {H}, {S}, {D}] {pat}" + (
            " causal" if causal else "")
        err = max(close_or_fail(f"{label} {n}", a, e, tol)
                  for n, a, e in zip(("dq", "dk", "dv"), got, want))
        errs[(S, name)] = max(errs.get((S, name), 0.0), err)
        print(f"kernel check: {label}: dq, dk, dv every row finite, "
              f"max_abs_err={err:.3g} (tol {tol} (1 + |plain|))", flush=True)
        del args, got, want
    records = {}
    for B, S, shortest in BERT_BATCHES:
        lens = rng.integers(shortest, S + 1, B)
        seg = torch.tensor((np.arange(S)[None] < lens[:, None]).astype(
            np.int32), device=device)
        q, k, v, out, lse, dout = operands(B, S, torch.bfloat16, seg, False,
                                           SEED + S + 2)
        ms = cuda_ms(lambda: fa._launch_bwd(q, k, v, out, lse, dout, False,
                                            seg), flush=flush)
        plain = cuda_ms(lambda: fa.flash_bwd_reference(
            q, k, v, out, lse, dout, False, seg), iters=3, flush=flush)
        same = seg[:, None, :, None] == seg[:, None, None, :]
        sq = [t.detach().requires_grad_() for t in (q, k, v)]
        so = F.scaled_dot_product_attention(*sq, attn_mask=same, scale=1.0)
        lib = cuda_ms(lambda: torch.autograd.grad(so, sq, dout,
                                                  retain_graph=True),
                      flush=flush)
        bound_ms, bound_by = seg_bound(q, seg, backward=True)
        records[S] = dict(max_abs_err=errs[(S, "bfloat16")], ms=ms,
                          plain_ms=plain, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=lib)
        flops = 10 * D * H * int(same.sum())
        kept = fa.segment_tile_pairs(seg, False).float().mean().item()
        print(f"kernel check: flash_bwd_seg bfloat16 [{B}, {H}, {S}, {D}] "
              f"full, lengths {shortest}-{S}: kernel_ms={ms:.4f} plain_ms="
              f"{plain:.4f} bound_ms={bound_ms:.4f} ({bound_by}), the "
              f"kernel at {bound_ms / ms:.1%} of it, "
              f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s over the visible "
              f"pairs, {kept:.1%} of the 64-row tile pairs computed; "
              f"yardstick: scaled_dot_product_attention backward with the "
              f"segment mask {lib:.4f} ms", flush=True)
        del q, k, v, out, lse, dout, seg, same, sq, so
    return {"flash_bwd_seg": records[BERT_TRAIN[0][3]]}


# ----------------------------------------------- phases 7c and 7d, BERT


def random_bert_arrays(layers=None, seed=SEED, head="sequence_classification",
                       **overrides):
    """(config, parameters) of a two-class
    `BertForSequenceClassification` (or, with head="pretraining", a
    `BertForPretraining`) under the JAX names, drawn from a numpy seed:
    N(0, 0.02) embeddings, weights and biases (BERT's
    initializer_range), LayerNorm scales 1 + N(0, 0.02). `overrides`
    join the config (the dropout probabilities)."""
    import numpy as np
    from paddle_tpu_torch.models import bert
    cfg = dict(BERT, num_hidden_layers=layers or BERT["num_hidden_layers"],
               **overrides)
    body = bert.BertModel(**cfg, device="meta")
    model = bert.BertForPretraining(body) if head == "pretraining" \
        else bert.BertForSequenceClassification(body)
    rng = np.random.default_rng(seed)
    arrays = {}
    for n, p in model.named_parameters():
        a = rng.standard_normal(tuple(p.shape), dtype=np.float32) \
            * np.float32(0.02)
        if "norm" in n and n.endswith("weight"):
            a += np.float32(1)
        arrays[n] = a
    return cfg, arrays


def bert_batch(n, S, shortest, seed):
    """[n, S] padded ids (pad id 0 after each sequence, lengths uniform
    in shortest..S) and the lengths."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(shortest, S + 1, n)
    ids = rng.integers(1, BERT["vocab_size"], (n, S))
    ids[np.arange(S)[None] >= lens[:, None]] = 0
    return ids, lens


def bert_reference(model, ids, fa):
    """The classifier's forward in fp32 from plain tensor ops over the
    model's weights (widened to fp32), with the segmented kernel's plain
    version for attention: (sequence output, pooled output, logits)."""
    import torch
    import torch.nn.functional as F
    p = {n: t.detach().float() for n, t in model.named_parameters()}
    B, S = ids.shape
    H = BERT["num_attention_heads"]
    keep = (ids != 0).to(torch.int32)

    def lin(x, name):
        return x @ p[name + ".weight"] + p[name + ".bias"]

    def ln(x, name):
        return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                            p[name + ".bias"], 1e-5)
    e = "bert.embeddings."
    x = ln(p[e + "word_embeddings.weight"][ids]
           + p[e + "position_embeddings.weight"][:S]
           + p[e + "token_type_embeddings.weight"][0], e + "layer_norm")
    for i in range(len(model.bert.encoder.layers)):
        a = f"bert.encoder.layers.{i}."
        q, k, v = (lin(x, a + f"self_attn.{n}_proj").reshape(
            B, S, H, -1).transpose(1, 2) for n in "qkv")
        out, _ = fa.flash_fwd_reference(q * q.shape[-1] ** -0.5, k, v,
                                        False, keep)
        x = ln(x + lin(out.transpose(1, 2).reshape(B, S, -1),
                       a + "self_attn.out_proj"), a + "norm1")
        x = ln(x + lin(F.gelu(lin(x, a + "linear1")), a + "linear2"),
               a + "norm2")
    pooled = torch.tanh(lin(x[:, 0], "bert.pooler.dense"))
    return x, pooled, lin(pooled, "classifier")


def bert_forward(model, ids):
    """(sequence output, pooled output, logits) through the model's
    entry points."""
    seq, pooled = model.bert(ids)
    return seq, pooled, model(ids)


def serve_bert(fa, device, counters):
    """Phase 7c, with checks (a), (c) and (d): BERT-base bf16 in eval
    over the two padded batches. Every count is zeroed just before each
    batch's timed forwards and read just after: the segmented flash
    forward must have launched once a layer a forward and no other
    kernel. Returns the launches."""
    import torch
    from paddle_tpu_torch.convert import load_jax_bert
    L = BERT["num_hidden_layers"]
    t0 = time.perf_counter()
    cfg, arrays = random_bert_arrays()
    model = load_jax_bert(arrays, cfg, head="sequence_classification",
                          device=device, dtype=torch.bfloat16).eval()
    del arrays
    print(f"serve BERT: BERT-base built in {time.perf_counter() - t0:.1f} s"
          f" (vocab {BERT['vocab_size']}, hidden {BERT['hidden_size']}, {L}"
          f" layers, {BERT['num_attention_heads']} heads, bf16, eval, 2 "
          f"classes)", flush=True)
    total, first = 0, None
    for n, S, shortest in BERT_BATCHES:
        ids_np, lens = bert_batch(n, S, shortest, SEED + S)
        ids = torch.tensor(ids_np, device=device)
        first = first or (ids, lens)
        with torch.inference_mode():
            for _ in range(2):                             # warm-up
                model(ids)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            for mod, attr, _ in counters:
                setattr(mod, attr, 0)
            t0 = time.perf_counter()
            for _ in range(BERT_FORWARDS):
                logits = model(ids)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {name: getattr(mod, attr) for mod, attr, name in counters}
        hold_launches(f"serve BERT S={S}", launches,
                      {"flash_fwd_seg": BERT_FORWARDS * L})
        total += launches["flash_fwd_seg"]
        if not bool(torch.isfinite(logits.float()).all()):
            fail(f"serve BERT S={S}: non-finite logits")
        ms = wall * 1e3 / BERT_FORWARDS
        print(f"serve BERT: {n} sequences at S={S}, lengths {lens.min()}-"
              f"{lens.max()} ({lens.sum()} real tokens of {n * S}): "
              f"{ms:.3f} ms per batch on the host clock = "
              f"{n * 1e3 / ms:.1f} sequences/s, {lens.sum() * 1e3 / ms:.0f}"
              f" real tokens/s; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(device)} B; flash_fwd_seg "
              f"{launches['flash_fwd_seg'] // BERT_FORWARDS} launches per "
              f"forward, other kernels 0", flush=True)
        profile_bert(model, ids, S)
        # (a) and (d): against the fp32 forward of the same weights
        with torch.inference_mode():
            got = bert_forward(model, ids)
            want = bert_reference(model, ids, fa)
        real = torch.arange(S, device=device)[None] < torch.as_tensor(
            lens, device=device)[:, None]
        err = max(close_or_fail(f"serve BERT S={S} bf16 vs fp32 {name}", a,
                                e, BERT_TOL)
                  for name, a, e in zip(
                      ("seq_out real rows", "pooled", "logits"),
                      (got[0][real], got[1], got[2]),
                      (want[0][real], want[1], want[2])))
        if not all(bool(torch.isfinite(t.float()).all()) for t in got):
            fail(f"serve BERT S={S}: a non-finite output")
        print(f"serve BERT check (a) S={S}: bf16 card forward against an "
              f"fp32 plain forward of the same weights: logits, pooled and"
              f" real rows max_abs_err={err:.3g} (tol {BERT_TOL} (1 + "
              f"|fp32|)); (d) every output finite, padded rows too",
              flush=True)
        del got, want
    # (c) padding invariance: 8 sequences of the S=128 batch at S=512
    ids128, lens = first[0][:8], first[1][:8]
    ids512 = torch.zeros(8, 512, dtype=ids128.dtype, device=device)
    ids512[:, :128] = ids128
    with torch.inference_mode():
        a, b = model(ids128), model(ids512)
    err = close_or_fail("serve BERT check (c) logits at S=512 vs S=128", b,
                        a, PAD_TOL)
    print(f"serve BERT check (c): the same 8 sequences (lengths "
          f"{lens.min()}-{lens.max()}) batched at S=128 and at S=512 give "
          f"the same logits: max_abs_err={err:.3g} (tol {PAD_TOL} (1 + "
          f"|logit|))", flush=True)
    return {"flash_fwd_seg": total}


def profile_bert(model, ids, S):
    """One forward on the host clock, then one under torch.profiler for
    its device time, launches and top kernels. Informational: prints
    "not measured" when the profiler records no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(ids)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(ids)
            torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    if not dev:
        print(f"profile: BERT forward S={S} {host_ms:.3f} ms on the host "
              "clock; device time not measured (no device events)",
              flush=True)
        return
    device_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    k1c = [e for e in dev if "flash_fwd" in e.key or "seg_ranges" in e.key]
    k1c_ms = sum(e.self_device_time_total for e in k1c) / 1e3
    print(f"profile: BERT forward S={S}, K1c: {k1c_ms:.3f} ms of device "
          f"time, {k1c_ms / device_ms:.1%} of the forward's, in " + ", ".join(
              f"{e.key[:56]} {e.self_device_time_total / 1e3:.3f} ms "
              f"x{e.count}" for e in k1c), flush=True)
    print(f"profile: BERT forward S={S}: {host_ms:.3f} ms on the host "
          f"clock, {device_ms:.3f} ms of device time in "
          f"{sum(e.count for e in dev)} device launches, device busy "
          f"{device_ms / host_ms:.1%}; most device time: " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms "
              f"x{e.count}" for e in top), flush=True)


def check_bert_on_card(device):
    """Phase 7d (b): a 2-layer fp32 BERT at full width over 8 sequences
    at S = 128, two each unpadded, with trailing, left and interleaved
    padding, on the card (kernels) and on a CPU copy (plain versions):
    sequence output (every row), pooled output and logits within the
    fp32 train tolerance."""
    import numpy as np
    import torch
    from paddle_tpu_torch.convert import load_jax_bert
    cfg, arrays = random_bert_arrays(layers=2)
    rng = np.random.default_rng(SEED + 12)
    ids = rng.integers(1, BERT["vocab_size"], (8, 128))
    keep = np.concatenate([seg_ids(pat, 2, 128, rng) for pat in (
        "trailing", "trailing", "left", "interleaved")])
    ids[keep == 0] = 0
    out = {}
    for dev in (device, torch.device("cpu")):
        model = load_jax_bert(arrays, cfg, head="sequence_classification",
                              device=dev).eval()
        with torch.inference_mode():
            out[dev.type] = [t.cpu() for t in bert_forward(
                model, torch.tensor(ids, device=dev))]
        del model
    tol = TRAIN_TOL["float32"]
    err = max(close_or_fail(f"BERT fp32 card vs CPU {n}", a, e, tol)
              for n, a, e in zip(("seq_out", "pooled", "logits"),
                                 out["cuda"], out["cpu"]))
    print(f"BERT check (b): 2-layer fp32 BERT at full width, 8 sequences at"
          f" S=128 (trailing, left and interleaved padding), card (kernels)"
          f" against a CPU copy (plain versions): every row, pooled and "
          f"logits max_abs_err={err:.3g} (tol {tol} (1 + |CPU|))",
          flush=True)


# ----------------------------------------- phases 7e and 7f, train BERT


def bert_pretrainer(device, layers=None, dtype="bfloat16", **overrides):
    """(config, `hapi.Model`) of a `BertForPretraining` on `device` from
    random_bert_arrays, as bench_bert builds it: `amp.decorate(O2)` (for
    bf16), LAMB (BERT_LR, BERT_WD) and the pretraining criterion."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.convert import load_jax_bert
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models.bert import BertPretrainingCriterion
    from paddle_tpu_torch.optimizer import Lamb
    cfg, arrays = random_bert_arrays(layers, head="pretraining", **overrides)
    net = load_jax_bert(arrays, cfg, head="pretraining", device=device)
    del arrays
    if dtype == "bfloat16":
        amp.decorate(net, level="O2")
    model = Model(net, device=device).prepare(
        Lamb(BERT_LR, lamb_weight_decay=BERT_WD,
             parameters=net.parameters()),
        BertPretrainingCriterion(cfg["vocab_size"]))
    return cfg, model


def pretraining_batch(n, S, shortest, device, seed):
    """Ids ([n, S], pad id 0 after lengths uniform in shortest..S), MLM
    labels (15% of real tokens, a random id; -1 elsewhere), NSP labels,
    and the lengths."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    lens = rng.integers(shortest, S + 1, n)
    real = np.arange(S)[None] < lens[:, None]
    ids = np.where(real, rng.integers(1, BERT["vocab_size"], (n, S)), 0)
    mlm = np.where(real & (rng.random((n, S)) < 0.15),
                   rng.integers(0, BERT["vocab_size"], (n, S)), -1)
    nsp = rng.integers(0, 2, n)
    return [torch.tensor(a, device=device) for a in (ids, mlm, nsp)], lens


def train_bert(device, counters):
    """Phase 7e: BERT-base pretraining steps through `Model.train_batch`
    in each configuration of BERT_TRAIN, every count zeroed just before
    the timed steps and read after: (A) K1c forward and backward exactly
    once a layer a step and no other kernel, (B) no kernel; a finite loss
    that falls; then one profiled step of (A). Returns (A)'s launches."""
    import torch
    from paddle_tpu_torch import seed
    L, d, V = (BERT["num_hidden_layers"], BERT["hidden_size"],
               BERT["vocab_size"])
    launches_a = None
    for label, attn_p, n, S, shortest in BERT_TRAIN:
        t0 = time.perf_counter()
        _, model = bert_pretrainer(device, attention_probs_dropout_prob=attn_p,
                                   hidden_dropout_prob=0.1)
        (ids, mlm, nsp), lens = pretraining_batch(n, S, shortest, device,
                                                  SEED + 20 + S)
        built = time.perf_counter() - t0
        seed(SEED)
        losses = [float(model.train_batch([ids], [mlm, nsp])[0])
                  for _ in range(BERT_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        for mod, attr, _ in counters:
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        for _ in range(BERT_STEPS):
            losses.append(float(model.train_batch([ids], [mlm, nsp])[0]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: getattr(mod, attr) for mod, attr, name in counters}
        want = {"flash_fwd_seg": L * BERT_STEPS,
                "flash_bwd_seg": L * BERT_STEPS} if attn_p == 0.0 else {}
        hold_launches(f"train BERT ({label})", launches, want)
        if not all(x == x and abs(x) < float("inf") for x in losses):
            fail(f"train BERT ({label}): a non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            fail(f"train BERT ({label}): the loss did not fall {losses}")
        ms = wall * 1e3 / BERT_STEPS
        # bench_bert's flops a sequence (bench.py:256-258), over padded S
        n_params = 12 * L * d * d + V * d
        flops_seq = (6 * n_params + 12 * L * S * d) * S
        sps = n * 1e3 / ms
        print(f"train BERT ({label}): BERT-base, AMP O2, LAMB, attention "
              f"dropout {attn_p}, hidden dropout 0.1, {n} sequences at S={S}"
              f", lengths {lens.min()}-{lens.max()} ({lens.sum()} real "
              f"tokens of {n * S}), built in {built:.1f} s; {BERT_STEPS} "
              f"timed steps after {BERT_WARMUP} warm-up: {ms:.2f} ms/step "
              f"on the host clock, {sps:.1f} sequences/s, "
              f"{lens.sum() * 1e3 / ms:.0f} real tokens/s, "
              f"{sps * flops_seq / PEAK_FLOPS['bfloat16']:.1%} of the bf16 "
              f"peak ({flops_seq} flops a sequence, bench_bert's count); "
              f"max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(device)} B; launches a "
              f"step: flash_fwd_seg {launches['flash_fwd_seg'] // BERT_STEPS}"
              f", flash_bwd_seg {launches['flash_bwd_seg'] // BERT_STEPS}, "
              f"other kernels 0; loss first {losses[0]:.4f} last "
              f"{losses[-1]:.4f} (" + " ".join(f"{x:.4f}" for x in losses)
              + ")", flush=True)
        if attn_p == 0.0:
            launches_a = {k: launches[k] for k in want}
            profile_bert_train(model, ids, mlm, nsp)
        del model, ids, mlm, nsp
        torch.cuda.empty_cache()
    return launches_a


def profile_bert_train(model, ids, mlm, nsp):
    """One train step of `model` under torch.profiler: its host time
    against the device time of what it launched, the launches and the
    top device kernels. Informational: prints "not measured" when the
    profiler records no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.train_batch([ids], [mlm, nsp])
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    if not dev:
        print(f"profile: BERT train step {host_ms:.1f} ms on the host clock "
              "(profiled); device time not measured (no device events)",
              flush=True)
        return
    device_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    flash = {k: sum(e.self_device_time_total for e in dev if k in e.key)
             for k in ("flash_fwd", "seg_ranges", "flash_bwd", "flash_delta")}
    print(f"profile: BERT train step (A), {host_ms:.1f} ms on the host "
          f"clock (profiled), {device_ms:.2f} ms of device time in "
          f"{sum(e.count for e in dev)} device launches, device busy "
          f"{device_ms / host_ms:.1%}; K1c: " + ", ".join(
              f"{k}* {t / 1e3:.3f} ms" for k, t in flash.items())
          + "; most device time: " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms "
              f"x{e.count}" for e in top), flush=True)
    fwd = [e for e in dev if "flash_fwd" in e.key or "seg_ranges" in e.key]
    fwd_ms = sum(e.self_device_time_total for e in fwd) / 1e3
    print(f"profile: BERT train step (A), K1c's forward: {fwd_ms:.3f} ms of "
          f"device time, {fwd_ms / device_ms:.1%} of the step's, in " +
          ", ".join(f"{e.key[:56]} {e.self_device_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in fwd), flush=True)
    bwd = [e for e in dev if "flash_bwd" in e.key or "flash_delta" in e.key]
    bwd_ms = sum(e.self_device_time_total for e in bwd) / 1e3
    print(f"profile: BERT train step (A), K1c's backward: {bwd_ms:.3f} ms of "
          f"device time, {bwd_ms / device_ms:.1%} of the step's, in " +
          ", ".join(f"{e.key[:56]} {e.self_device_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in bwd), flush=True)


# the fp32 card-against-CPU train step: the same update on both, summed
# in another order; LAMB divides each gradient element by its own scale,
# so rounding in the smallest gradients reaches the step at up to ~lr of
# a parameter: 1e-5 relative and absolute. The key projections' biases
# get a zero gradient up to rounding (the softmax cancels a constant on
# every key), which LAMB scales to a step of norm lr * ||w|| in a
# direction rounding picks: held by that norm on both devices instead.
BERT_STEP_TOL = 1e-5


def check_bert_train_on_card(device):
    """Phase 7f: (a) one fp32 `Model.train_batch` of a 2-layer BERT at
    full width (dropout 0; 4 sequences at S = 128, trailing padding) on
    the card (K1c forward and backward) and on a CPU copy (plain
    versions): the loss and every parameter after the step agree; (b)
    two bf16 steps of config (A) from the same weights after the same
    `seed()`: every parameter bit-identical."""
    import torch
    from paddle_tpu_torch import seed
    rng_seed = SEED + 30
    got = {}
    for dev in (device, torch.device("cpu")):
        _, model = bert_pretrainer(dev, layers=2, dtype="float32",
                                   attention_probs_dropout_prob=0.0,
                                   hidden_dropout_prob=0.0)
        (ids, mlm, nsp), lens = pretraining_batch(4, 128, 32, dev, rng_seed)
        before = {n: p.detach().cpu().clone()
                  for n, p in model.network.named_parameters()}
        loss = float(model.train_batch([ids], [mlm, nsp])[0])
        got[dev.type] = (loss, before, {
            n: p.detach().cpu() for n, p in model.network.named_parameters()})
        del model
    (lc, _, card), (lh, b1, cpu) = got["cuda"], got["cpu"]
    if not abs(lc - lh) <= BERT_STEP_TOL * abs(lh):
        fail(f"BERT train check (a): loss card {lc} CPU {lh}")
    err, worst = 0.0, None
    for n in cpu:
        if n.endswith("self_attn.k_proj.bias"):
            for side in (card, cpu):
                step = float((side[n] - b1[n]).norm())
                want = BERT_LR * float(b1[n].norm())
                if abs(step - want) > 1e-4 * want:
                    fail(f"BERT train check (a) {n}: step norm {step}, "
                         f"expected lr * ||w|| = {want}")
            continue
        e = close_or_fail(f"BERT train check (a) {n}", card[n], cpu[n],
                          BERT_STEP_TOL)
        if e >= err:
            err, worst = e, n
    print(f"BERT train check (a): one fp32 Model.train_batch (LAMB) of a "
          f"2-layer BERT at full width, 4 sequences at S=128 (lengths "
          f"{lens.min()}-{lens.max()}), card (K1c forward and backward) "
          f"against a CPU copy (plain versions): loss {lc:.6f} vs {lh:.6f},"
          f" every parameter max_abs_err={err:.3g} ({worst}; tol "
          f"{BERT_STEP_TOL} (1 + |CPU|)); key biases: step norm lr * ||w|| "
          f"on both", flush=True)
    _, attn_p, n, S, shortest = BERT_TRAIN[0]
    runs = []
    for _ in range(2):
        _, model = bert_pretrainer(device, attention_probs_dropout_prob=attn_p,
                                   hidden_dropout_prob=0.1)
        (ids, mlm, nsp), _ = pretraining_batch(n, S, shortest, device,
                                               SEED + 20 + S)
        seed(SEED)
        model.train_batch([ids], [mlm, nsp])
        runs.append([p.detach().clone() for p in model.parameters()])
        del model
    same = sum(bool(torch.equal(a, b)) for a, b in zip(*runs))
    if same != len(runs[0]):
        fail(f"BERT train check (b): {len(runs[0]) - same} of "
             f"{len(runs[0])} parameters differ between two identical "
             "bf16 steps")
    print(f"BERT train check (b): two bf16 (A) steps from the same weights "
          f"after the same seed(): {same} of {len(runs[0])} parameters "
          f"bit-identical", flush=True)
    del runs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- main


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops import conv_wgrad as cw
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import grouped_matmul as gm
    from paddle_tpu_torch.ops import layer_norm as ln
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import qkv_proj as qp

    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind}, {count} device(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    # (name, module, counter attribute, TPU kernel replaced, source)
    csrc = "paddle_tpu_torch/ops/csrc/"
    pallas = "paddle_tpu/ops/pallas/"
    kernels = [
        ("paged_attention", pa, "launch_count",
         pallas + "paged_attention.py:101", csrc + "paged_attention.cu"),
        ("paged_verify", pa, "verify_launch_count",
         pallas + "paged_attention.py:276", csrc + "paged_attention.cu"),
        ("paged_int8", pa, "int8_launch_count",
         pallas + "paged_attention.py:110", csrc + "paged_attention.cu"),
        ("paged_fp8", pa, "fp8_launch_count",
         pallas + "paged_attention.py:110", csrc + "paged_attention.cu"),
        ("paged_verify_int8", pa, "verify_int8_launch_count",
         pallas + "paged_attention.py:110", csrc + "paged_attention.cu"),
        ("paged_verify_fp8", pa, "verify_fp8_launch_count",
         pallas + "paged_attention.py:110", csrc + "paged_attention.cu"),
        ("flash_fwd", fa, "fwd_launch_count",
         pallas + "flash_attention.py:99", csrc + "flash_attention.cu"),
        ("flash_bwd", fa, "bwd_launch_count",
         pallas + "flash_attention.py:99", csrc + "flash_attention.cu"),
        ("add_ln_fwd", ln, "fwd_launch_count",
         pallas + "layer_norm.py:34", csrc + "layer_norm.cu"),
        ("add_ln_bwd", ln, "bwd_launch_count",
         pallas + "layer_norm.py:49", csrc + "layer_norm.cu"),
        ("gmm_fp", gm, "fp_launch_count",
         pallas + "grouped_matmul.py:159", csrc + "grouped_matmul.cu"),
        ("gmm_int8", gm, "int8_launch_count",
         pallas + "grouped_matmul.py:181", csrc + "grouped_matmul.cu"),
        ("gmm_int4", gm, "int4_launch_count",
         pallas + "grouped_matmul.py:201", csrc + "grouped_matmul.cu"),
        ("qkv_proj", qp, "launch_count",
         pallas + "qkv_proj.py:31", csrc + "qkv_proj.cu"),
        ("flash_bshd", fa, "bshd_launch_count",
         pallas + "flash_attention.py:235", csrc + "flash_attention.cu"),
        ("wgrad_1x1", cw, "launch_count",
         pallas + "conv_wgrad.py:44", csrc + "conv_wgrad.cu"),
        ("flash_fwd_seg", fa, "seg_launch_count",
         pallas + "flash_attention.py:159", csrc + "flash_attention.cu"),
        ("flash_bwd_seg", fa, "seg_bwd_launch_count",
         pallas + "flash_attention.py:161", csrc + "flash_attention.cu")]
    # one per source
    build_fns = (pa.build, fa.build, ln.build, gm.build, qp.build, cw.build)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build_fns)) as ex:
        libs = list(ex.map(lambda b: b(), build_fns))
    print(f"build: {len(libs)} kernel sources in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    counters = [(m, attr, name) for name, m, attr, _r, _s in kernels]

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=device)
    checks = {"paged_attention": check_paged_attention(pa, device, flush)}
    checks.update(check_paged_variants(pa, device, flush))
    check_paged_decode(pa, device, flush)
    checks.update(check_gmm(gm, device, flush))
    checks.update(check_flash(fa, device, flush))
    checks.update(check_add_ln(ln, device, flush))
    checks.update(check_qkv_proj(qp, device, flush))
    checks.update(check_flash_bshd(fa, device, flush))
    checks.update(check_wgrad(cw, device, flush))
    checks.update(check_flash_seg(fa, device, flush))
    checks.update(check_flash_seg_bwd(fa, device, flush))
    del flush
    torch.cuda.empty_cache()

    eng, reqs, serve_launches = serve(device, counters)
    check_outputs(eng.model, reqs, device)
    profile_decode(eng, "GPT-350M", kernel=PAGED_KERNELS)
    dense_out = [list(r.output) for r in reqs]
    del eng, reqs
    torch.cuda.empty_cache()
    spec_launches, spec_out, model = serve_spec(device, counters)
    serve_launches.update(spec_launches)
    serve_multitick(model, device, counters, dense_out, spec_out)
    del model
    torch.cuda.empty_cache()
    check_spec_on_card(device)
    check_multitick_on_card(device)
    serve_launches.update(serve_moe(device, counters))
    check_moe_on_card(device)

    launches = train(device, counters)
    launches.update({n: serve_launches[n] for n in (
        "paged_attention", "paged_verify", "paged_int8", "paged_fp8",
        "paged_verify_int8", "paged_verify_fp8", "gmm_fp", "gmm_int8",
        "gmm_int4")})
    check_train_step(device)
    torch.cuda.empty_cache()
    launches.update(flash_bshd_phase(fa, device, counters))
    launches.update(wgrad_phase(cw, device, counters))
    launches.update(serve_bert(fa, device, counters))
    torch.cuda.empty_cache()
    check_bert_on_card(device)
    # K1c's forward runs on both BERT paths: its count is the sum of both
    for name, n in train_bert(device, counters).items():
        launches[name] = launches.get(name, 0) + n
    check_bert_train_on_card(device)

    line = {"kernels": [dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches[name],
        **{k: checks[name][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        library_ms=checks[name].get("library_ms"),
        sdpa_gathered_ms=checks[name].get("sdpa_gathered_ms"))
        for name, _m, _c, replaces, source in kernels]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": kind,
                                              "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
