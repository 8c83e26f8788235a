"""Chip smoke of the PyTorch/CUDA port (`paddle_tpu_torch`) on one
NVIDIA card.

    python3 chip_smoke.py          # from the repository root

Drives the port's paths end to end — serving a dense GPT-350M, serving
it speculatively over bf16, int8 and fp8 KV pools, serving it with
several decode ticks a dispatch and with penalties, with the radix
prefix cache and with block-sparse decode, with LoRA adapters and as a
weight-only int8 stack, serving the
8-expert MoE-350M with float, int8 and int4 experts, serving both
with tensor (and expert) parallelism over ranks on the one card, and
by a disaggregated fleet of prefill and decode replicas behind the
replica router, the train step
(with and without the fused QKV projection), MoE training and its
dp x ep mesh of ranks on the one card, the mp x pp mesh (tensor and
sequence parallelism, the micro-batch pipeline) and bucketed dp over
ranks on the one card, the paddle-layout
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
   decode entry `paged_attention()`; the block-sparse decode's region
   (`paged_sparse_case`: 8 slots at contexts 700-1000 over [8, 11]
   shortened tables with compacted positions from `select_blocks`),
   the ragged entry over bf16, int8 and fp8 pools and the verify entry
   (4 queries a slot) over bf16, two launches of each bit-identical,
   timed beside the selected blocks' bound, SDPA on a gathered copy of
   them and the same kernel over the full tables; the three
   grouped expert matmuls — float, int8 and int4 experts — at the MoE
   step's two expert products, each with its bytes/s and share of its
   bound; the float one under autograd at the MoE train step's ffn1
   shape [8, 5120, 1024] x [1024, 4096] (one forward launch a call, dx
   and dw against the plain version's autograd, quantized weights
   refusing a gradient); the int8 kernel at one group as the dense weight-only
   projections run it (`weight_only_matmul`: [256, 1024] x [1024, 3072 |
   1024 | 4096] and [256, 4096] x [4096, 1024], two launches of each
   bit-identical, beside `torch.matmul` on a pre-dequantized copy);
   flash attention forward/backward (with their TFLOP/s and share
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
   segment ranges keep; and at a tensor-parallel rank's shapes
   (`check_tp_shapes`): the paged kernel's ragged and verify entries at
   8 heads, K4 at one group at the shard widths and the grouped expert
   matmuls at [4, 80, 1024] x [1024, 2048] and [4, 80, 2048] x [2048,
   1024]; and at an mp rank's shapes (`check_mp_shapes`): bf16 flash
   attention forward and backward at [8, 8, 1024, 64] and add+LayerNorm
   at a sequence-parallel rank's [4096, 1024] rows, and fp32 at what
   phase 6d's mp x pp job gives them, a micro-batch of 4: [4, 8, 1024,
   64], [2048, 1024] and the fused QKV projection into the rank's 8
   heads, two launches of each bit-identical), with
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
   The on-card checks of the serving phases (5c, 5d, 5f, 5i, 5l, 5p,
   5t) time nothing and are bound by their host loops: they run after
   phase 5s in two processes at once, this one and a spawned child,
   before phase 5b;
5d. on-card spec check — fp32, 2 layers at full width: the draft_k=3
   float-pool engine on the card (kernels) gives the same greedy tokens
   and draft counts as on a CPU copy (plain versions) and as the card's
   draft_k=0 engine, unless the first differing token sat at an fp32
   top-2 logit gap under 1e-5; int8 and fp8 pools reported, not held;
5f. on-card multi-tick check — the same 2-layer fp32 model, draft_k=3
   with the penalties at 4 ticks: the card's greedy tokens equal a CPU
   copy's and the card's 1-tick engine's; seeded penalized sampling at
   4 ticks equals its 1-tick twin on the card;
5g. serve prefix — phase 5a's model served two waves (16 requests on a
   shared 256-token system prompt with suffixes of 16-256 tokens, 64 new
   tokens; then 4 finished conversations replayed with a new suffix and
   one exact full-prompt replay) by a cache-off engine and
   `prefix_caching=True` engines over bf16 and int8 pools: launches
   held (steps x 24), the bf16 cache's every token within the near-tie
   oracle, hits printed (sum > 0, whole blocks but the exact replay's,
   which re-feeds its last token into a copy on write), every block
   free after `evict_all`; prompt tokens fed, TTFT and tokens/s beside
   the cache-off engine's; the int8 pool reported, not held;
5h. serve sparse — the same model, 8 prompts of 700-992 tokens, 32 new
   tokens: a dense engine, `sparse_blocks=8, sparse_recent=2` (11 of up
   to 64 blocks) over bf16, int8 and fp8 pools, at full coverage
   (`sparse_blocks=64`, near-tie oracle), and with draft_k=3 at 1 and 4
   ticks (4 ticks equal to 1): the region's `paged_sparse` launches and
   the rest's full-table launches each steps (issued ticks) x 24, skip
   ratios and agreement with the dense engine printed;
5i. on-card prefix and sparse check — fp32, 2 layers at full width: a
   prefix-cache engine (two waves with a copy-on-write replay) and a
   block-sparse engine at real sparsity (3 of up to 15 blocks), at 1
   and 4 ticks, give the same greedy tokens, hits and selected blocks
   on the card and on a CPU copy (and the cache engine the card's
   cache-off tokens), unless the first difference sat at an fp32 top-2
   gap under 1e-5;
5j. serve LoRA — phase 5a's model with `max_adapters=3` (2 usable
   slots) and 4 random rank-16 tenants, the 16 requests split between
   the base model and the tenants: every request finishes, at least one
   eviction, pins and blocks back, paged attention steps x 24 and
   nothing else, the base-model requests within phase 5's near-tie
   oracle (their agreement with phase 4's tokens printed), each tenant
   against a solo engine (printed); the same mix at 4 ticks under sync
   debug equal to it; adapter loads, hits, evictions, bytes_per_slot,
   tokens/s, TTFT and a profiled decode step beside phase 4's;
5k. serve weight-only — the same weights as int8 projections
   (`weight_only=True`): the 16 requests, K4 at one group exactly steps
   x 96 and paged attention steps x 24, projection bytes (at least 1.9x
   under bf16), tokens/s, agreement with phase 4 and a profiled decode
   step beside phase 4's, two requests within the near-tie oracle of
   its own fp32 forward; and (after phase 5b) MoE-350M as
   `FusedMultiTransformerMoeWeightOnly` (int8 attention, int4 experts)
   on 8 requests: dense launches steps x 2L and int4 expert launches
   steps x 2L (L = MOE_LAYERS), counted apart;
5l. on-card LoRA and weight-only check — fp32, 2 layers at full width,
   at 1 and 4 ticks, card against a CPU copy: a tenant mix with churn
   (tokens and adapter counters), the base-model requests on an adapter
   engine against an engine without adapters, and the weight-only dense
   engine (int8 weights carried in through `convert.load_jax_gpt`);
   equal unless the first difference sat at an fp32 top-2 gap under
   1e-5 (the weight-only MoE engine is held in phase 5c);
5b. serve MoE — MoE-350M (bench_gpt_moe's widths: GPT-350M with every
   FFN 8 experts, top-2, capacity factor 1.25; depth cut to MOE_LAYERS
   = L = 4 (12 until PR 21); random weights from a numpy seed through
   `convert.load_jax_gpt(moe=...)`) served by three
   engines in turn, `moe_weight_dtype` None, "int8" and "int4", each
   taking the dense phase's 16 requests: every request finishes, paged
   attention launched once and the engine's grouped-matmul variant twice
   per layer per step (the other two never), and every valid token's
   two choices are counted or dropped; then a profiled decode window of
   each engine, with the grouped matmuls' share of its device time; and
   the float experts at 4 ticks a dispatch (sync debug on): the float
   1-tick engine's tokens, paged attention issued ticks x L and the
   float grouped matmul issued ticks x 2L launches, routed + dropped =
   2 x L x valid tokens over the ticks that counted; then phase 5k's
   weight-only MoE engine;
5c. on-card MoE check — fp32, 2 layers at full width, float and int8
   experts, and the weight-only stack (int8 attention, int4 experts) at
   1 and 4 ticks: 4 requests served on the card (kernels) and on a CPU copy
   (plain versions) give the same greedy tokens, unless the first
   expert choice that differs, at or before the first differing token,
   sat at a near-tie of the top-k gate boundary (reported as the cause);
5m. serve TP — every rank a process on the one card, joined over gloo
   (NCCL takes a card a rank): GPT-350M's widths at TP_LAYERS = 8
   layers (full depth until PR 21), bf16, by
   `TPServingEngine(tensor_parallel=2)` on 2 ranks, the 16 requests:
   each rank's paged launches exactly steps x 8 at its 8 heads,
   every rank's tokens equal, rank 0's within phase 5's near-tie
   oracle, a profiled decode window on each rank (host and device ms a
   step printed beside phase 4's 1-rank engine; the ranks share the
   card, so these are not TP speed); then MoE-350M's widths at
   MOE_TP_LAYERS layers with int8 experts at tp = 2 x ep = 2 on 4 ranks:
   paged launches steps x L, gmm_int8 steps x 2L, routed + dropped = 2 x
   L x valid tokens on every rank, every rank's tokens and routing
   counts equal, beside the 1-rank engine of the same model;
5n. on-card TP check — fp32, 2 layers at full width: TP engines (tp = 2
   with draft_k=3; the weight-only int8 stack at tp = 2, K4's dense
   route at the shard widths; MoE float experts at tp = 2 x ep = 2),
   launches held, each equal to the card's 1-rank engine and to a CPU
   copy unless the first differing token sat at an fp32 top-2 gap under
   1e-5; a failed rank fails the script;
5o. serve disagg — phase 5a's model (bf16, full depth) served by a
   disaggregated fleet: one `role="prefill"` and two `role="decode"`
   engines with phase 4's settings behind `ReplicaRouter(roles=...)`
   over `InProcessTransport` (each replica's `engine.step` in the event
   loop's executor, so the replicas step from several threads), the 16
   requests streamed at once: every request finishes, 16 handoffs,
   every block exported, sent and imported once, the payload exactly
   blocks x 1,572,864 B plus frame headers, the ragged paged kernel
   launched by each replica exactly its own steps x 24 (its step
   thread's tally) and nothing else, every replica drained, tokens
   within phase 5's near-tie oracle;
   tokens/s, TTFT and the inter-token gap beside phase 4's, steps a
   replica, the share of blocks streamed ahead of their ticket, the
   codec's, export's and import's seconds; then the same with one shed
   hop between the decode replicas mid-stream;
5p. on-card disaggregation check — fp32, 2 layers at full width, 4
   requests of 16 new tokens (prompts of 40-200 tokens over a 64-token
   budget): the fleet's greedy tokens equal the card's monolithic
   engine's and the same fleet's on the CPU, no near-tie used, over the
   float pool, int8 pools with draft_k=2 on the decode role and prefix
   caching on the prefill role, one shed hop, and a prefill replica
   whose step raises mid-prefill (its requests fail over to a second
   prefill replica); each replica's launches held in each;
5r. serve generate — `GPTForGeneration.generate()` on phase 5a's
   GPT-350M (bf16) over the first 8 serve prompts with their true
   seq_lens, 64 new tokens: greedy with use_scan True and False give
   the same tokens, each within phase 5's near-tie oracle; draft_k=3's
   every token is within that oracle too (in bf16 it may part from the
   scan at a near tie; in fp32 it is identical); seeded sampling twice
   gives the same tokens; no kernel
   launched (its dense-cache attention is plain torch, as JAX's is
   XLA); then the weight-only twin (K4's dense route exactly 64
   forwards x 96) and, after phase 5b, MoE-350M (K4's float experts
   exactly 64 forwards x 2 x MOE_LAYERS); ms a token, tokens/s, peak
   memory;
5s. serve fleet — `inference.create_fleet_controller` over 2 GPT-350M
   replicas (phase 5a's model, phase 4's settings with prefix caching),
   the v1 bundle exported into a temporary directory: a third replica
   booted from it (cold start to its first token printed, no nvcc
   run), `rolling_upgrade` to v2 weights while the 16 requests stream
   (none fails), an `SLOAutoscaler` on a tight TTFT target scaling up
   once (a boot from the bundle) and on a loose one down once (a retire
   spilling its prefix cache); the FLEET_* series equal the
   controller's own events;
5t. on-card fleet check — fp32, 2 layers at full width: the booted
   replica's tokens equal replica 0's and a fresh v1 engine's; every
   request streamed through the upgrade equals a fresh v1 or v2
   engine's; every replica equals the fresh v2 engine after it, and a
   swapped engine holds its tensors bit for bit;
6. train — GPT-350M at full width in `bench_gpt`'s exact config (bf16,
   bf16 grads, remat with remat_policy="save_splash_residuals", fused
   CE in 4 chunks) trained by the port's `HybridGPT` at batch 8 for
   warm-up and timed steps on one fixed batch (random weights from a
   numpy seed through `convert.load_jax_hybrid_gpt`): finite, falling
   loss, and every train kernel launched exactly as the policy predicts
   per step (the flash forward once a layer); then one profiled step
   (K1a's forward and backward device ms on lines of their own); then
   batch 8 again with remat_policy None (the flash forward twice a layer) and with
   qkv_kernel=True (the fused projection twice a layer), side by side,
   the last with one profiled step (the fused projection's device ms and
   its share of the step's device time);
6b. train MoE — MoE-350M in `bench_gpt_moe`'s exact TPU config
   (bench.py:1749-1754: 8 experts, top-2, capacity factor 1.25, full
   remat, fused CE in 4 chunks, bf16 grads, batch 16; random weights
   from a numpy seed through `convert.load_jax_hybrid_gpt`), 3 warm-up
   and 2 timed steps on one fixed batch, the last under torch.profiler
   (host and device ms, launches, top device kernels, K1a, K2 and the
   routing scan): a finite, falling loss, K1a and K2 exactly as full
   remat predicts per step, no other kernel, routed + dropped = 16 x
   1024 x 2 x 24 every step; ms a step and tokens/s (the unprofiled
   timed step), peak memory, the last step's balance loss and routing;
6d. train mesh — three jobs in phase 5n's 4 rank processes sharing the
   card over gloo, after their serving job (a failed rank fails the
   script), each fp32, full remat, the fused QKV projection, global
   batch 8, 2 steps: MoE-350M's experts at 1 layer, dp 2 x ep 2 with
   ZeRO-1 (capacity factor 4: nothing drops, as a rank's capacity comes
   from its own tokens); `dryrun_multichip(4)`'s mesh, mp 2 x pp 2,
   with sequence parallelism, 2 micro-batches and ZeRO-1, at GPT-350M's
   widths at 2 layers (one a stage); a dense dp 4 job at 1 layer with
   25 MiB gradient buckets. For each: every rank's losses equal, and
   equal a 1-rank card trainer's on the same weights and batch, routing
   too; each rank's parameters and first moments after step 1 within
   phase 7's bounds; each rank's K1a, K2 and K5 launches exactly what
   full remat predicts for its layers x micro-batches, no other kernel;
   the bucketed job's all-reduces a step `grad_bucket_count`; rank step
   ms and peak memory printed (host-staged, not DP / EP / TP / PP
   speed);
7. on-card train check — one fp32 step of the same widths at 2 layers
   on the card (kernels) and on a CPU copy (plain versions), remat off
   and with the residuals kept and the fused projection: loss and every
   parameter after the step must agree, and the card's step with the
   residuals kept must agree with its full-remat step; the same for a
   2-layer MoE step (remat off and the residual policy; routing
   exactly, balance and z within 1e-5), and two bf16 MoE steps from the
   same weights bit-identical;
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
8. the script's total time, and a JSON line listing every kernel with
   its launches (each > 0), error and times;
9. the last line, `{"ok": true, "device": {...}}`.

Any failed phase raises and exits non-zero; without a card the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import os
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
# experts, top-2, capacity factor 1.25), served at 4 of its 24 layers
# (the widths, and so every kernel's shapes, are whole) to keep the
# script inside its time limit
MOE = dict(num_expert=8, top_k=2, capacity_factor=1.25)
MOE_LAYERS = 4

# GPT-350M train step: bench.py's bench_gpt TPU config at batch 8 (its
# own batch, 32, was timed here until phase 6d needed the time)
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
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
# multi-LoRA serving (phase 5j): 2 usable adapter slots (slot 0 is the
# null adapter) for 4 rank-16 tenants, random A and B at this std, and
# the adapter of each of the 16 requests (None: the base model): the
# first 8 fill the engine's slots with two tenants, the other two
# tenants wait at the head of the queue until the first two's requests
# have all finished, then evict them
LORA_SLOTS, LORA_RANK, LORA_STD = 3, 16, 0.05
LORA_MIX = (None, "t0", "t1", "t0", None, "t1", "t0", "t1",
            None, "t2", "t3", "t2", None, "t3", "t2", "t3")
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


# the block-sparse decode: the B best-scoring blocks and a recency window
# of a slot's up to 64; its shortened tables hold Bt = 1 + recent + B
SPARSE_BLOCKS, SPARSE_RECENT = 8, 2
SPARSE_BT = 1 + SPARSE_RECENT + SPARSE_BLOCKS
# the pure-decode step's contexts at long context, and the sparse serve
# phase's prompt lengths and horizon
SPARSE_CTX = (1000, 958, 911, 874, 833, 790, 746, 700)
SPARSE_PROMPTS, SPARSE_NEW = (700, 992), 32


def paged_sparse_case(dtype, device, kind="float", K=1, seed=SEED):
    """The block-sparse decode region at full width: 8 slots at contexts
    700-1000 (`SPARSE_CTX`), K queries a slot ending at its newest
    position, every slot's pages drawn at random; the [8, 11] shortened
    tables and compacted positions come from the engine's
    `select_blocks` over summaries of the pools' own keys (B = 8, 2
    recent). Float pools in `dtype`, or "int8" / "fp8" pools quantized as
    the engine quantizes. Returns (the sparse call's [q, k, v, tables,
    slots, positions, k_scale, v_scale], the same queries over the full
    tables at their true positions): the ragged entry's at K = 1, the
    verify entry's at K > 1."""
    import torch
    from paddle_tpu_torch.serving.engine import quantize_kv, select_blocks
    g = torch.Generator().manual_seed(seed)
    H, Dh = HEADS, HIDDEN // HEADS
    MB = MAX_SEQ // BLOCK
    NB = SLOTS * MB + 1
    bt = torch.zeros(SLOTS, MB, dtype=torch.int32)
    perm = torch.randperm(NB - 1, generator=g) + 1
    for s, n in enumerate(SPARSE_CTX):
        nb = -(-n // BLOCK)
        bt[s, :nb] = perm[s * MB:s * MB + nb].int()
    pos = torch.tensor([[n - K + j for j in range(K)] for n in SPARSE_CTX],
                       dtype=torch.int32)
    q = torch.randn(SLOTS, K, H, Dh, generator=g)
    kf = torch.randn(NB, BLOCK, H, Dh, generator=g)
    vf = torch.randn(NB, BLOCK, H, Dh, generator=g)
    short, pos_c = select_blocks(q, pos, bt, kf.amin(1), kf.amax(1),
                                 SPARSE_BT, SPARSE_RECENT, BLOCK)
    if kind == "float":
        kp, vp, ks, vs = kf.to(dtype), vf.to(dtype), None, None
    else:
        kv_dtype = "int8" if kind == "int8" else "fp8_e4m3"
        (kp, ks), (vp, vs) = quantize_kv(kf, kv_dtype), quantize_kv(
            vf, kv_dtype)
    slots = torch.arange(SLOTS, dtype=torch.int32)
    q = q.to(dtype)
    if K == 1:
        q, pos, pos_c = q[:, 0], pos[:, 0], pos_c[:, 0].contiguous()
    out = []
    for table, p in ((short, pos_c), (bt, pos)):
        out.append([None if a is None else a.to(device)
                    for a in (q, kp, vp, table, slots, p, ks, vs)])
    return out


def check_paged_sparse(pa, device, flush):
    """Phase 3 for the block-sparse decode (`kernel_name="paged_sparse"`):
    the ragged entry over the shortened tables of `paged_sparse_case`
    over bf16, int8 and fp8 pools, and the verify entry (4 queries a
    slot) over bf16 pools, each in fp32 and bf16 queries against its
    plain version, two launches to the same bits; timed (bf16) beside
    its bound (the selected blocks' bytes), SDPA on a gathered copy of
    the selected blocks, and the same kernel over the full tables at the
    same contexts. Returns the bf16 records."""
    import torch
    variants = (("paged_sparse", 1, "float"), ("paged_sparse_int8", 1, "int8"),
                ("paged_sparse_fp8", 1, "fp8"),
                ("paged_sparse_verify", DRAFT_K + 1, "float"))
    records = {}
    for label, K, kind in variants:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            args, full = paged_sparse_case(dtype, device, kind, K)
            fn, plain = ((pa.ragged_paged_attention,
                          pa.ragged_gather_reference) if K == 1 else
                         (pa.verify_paged_attention,
                          pa.verify_gather_reference))
            entry = "sparse" if K == 1 else "sparse_verify"
            counter = pa._COUNTERS[(entry, None if kind == "float"
                                    else args[1].dtype)]
            tol = (TOL if kind == "float" else QTOL)[name]
            before = getattr(pa, counter)
            got = fn(*args, kernel_name="paged_sparse")
            torch.cuda.synchronize()
            if getattr(pa, counter) != before + 1:
                fail(f"{label} {name}: {counter} did not count the launch")
            err = close_or_fail(f"{label} {name}", got, plain(*args), tol)
            if not torch.equal(fn(*args, kernel_name="paged_sparse"), got):
                fail(f"{label} {name}: two runs gave different bits")
            if name != "bfloat16":
                continue
            ms = cuda_ms(lambda: fn(*args, kernel_name="paged_sparse"),
                         flush=flush)
            plain_ms = cuda_ms(lambda: plain(*args), iters=5, flush=flush)
            sdpa_ms = cuda_ms(sdpa_yardstick(
                args if K == 1 else as_ragged(args)), flush=flush)
            full_ms = cuda_ms(lambda: fn(*full), flush=flush)
            bound_ms, bound_by, _ = paged_bound(args)
            full_bound, _, _ = paged_bound(full)
            records[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by,
                                  sdpa_gathered_ms=sdpa_ms)
            shape = "x".join(str(d) for d in args[0].shape)
            print(f"kernel check: {label} {name} q [{shape}] over "
                  f"{str(args[1].dtype).split('.')[-1]} pools, shortened "
                  f"tables [{SLOTS}, {SPARSE_BT}] of contexts "
                  f"{min(SPARSE_CTX)}-{max(SPARSE_CTX)} (B={SPARSE_BLOCKS},"
                  f" {SPARSE_RECENT} recent) max_abs_err={err:.3g} (tol "
                  f"{tol} (1 + |plain|); two runs bit-identical) "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by}: the selected "
                  f"blocks) yardstick: SDPA on a pre-gathered"
                  f"{'' if kind == 'float' else ', dequantized'} copy of "
                  f"the selected blocks {sdpa_ms:.4f} ms; the full-table "
                  f"walk at the same contexts {full_ms:.4f} ms (bound "
                  f"{full_bound:.4f} ms)", flush=True)
    return records


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
    """Phase 4: returns (engine, requests, launches per kernel, the run's
    tokens/s and mean TTFT). `counters` lists every kernel's (module,
    attribute, name); all are zeroed just before the 16 requests and read
    just after."""
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
    return eng, reqs, launches, dict(tokens_s=generated / wall,
                                     ttft_ms=ttft * 1e3, wall=wall,
                                     steps=steps)


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


def profile_decode(eng, label, window=16, kernel=None, adapters=None):
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
    may be a tuple of such strings. `adapters`: the requests' adapter
    ids, in turn. Returns {host_ms, device_ms (None when not measured),
    launches}."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 2)
    horizon = (eng.draft_k + 1) * 2 * window + 4
    reqs = [eng.submit(rng.integers(0, VOCAB, 256).tolist(), horizon,
                       adapter_id=adapters[i % len(adapters)]
                       if adapters else None)
            for i in range(SLOTS)]
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
        return dict(host_ms=host_ms, device_ms=None, launches=None)
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
    return dict(host_ms=host_ms, device_ms=device_ms, launches=launches)


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


def check_weight_only_gmm(gm, device, flush):
    """Phase 3 for K4 at one group, the dense weight-only projections
    (`weight_only_matmul`, what `_mm` runs on a weight-only stack): x
    [256, d_in] bf16 (the step's token budget) against int8 weights with
    bf16 scales (the engine casts fp32 scales to the compute dtype) at
    qkv [1024, 3072], out [1024, 1024], ffn1 [1024, 4096] and ffn2
    [4096, 1024], each against its plain version (`torch.matmul` over
    the dequantized weight, in bf16), one launch counted a call, two
    launches bit-identical. Yardstick: `torch.matmul` on a pre-dequantized
    bf16 copy (the dequant left out of its time). Returns the record of
    gmm_int8_dense, the mean per call over the four products."""
    import torch
    from paddle_tpu_torch.incubate.nn.fused_transformer import \
        _quantize_stack
    D, F = HIDDEN, 4 * HIDDEN
    tol = GMM_TOL["bfloat16"]
    calls = []
    for prod, (d_in, d_out) in (("qkv", (D, 3 * D)), ("out", (D, D)),
                                ("ffn1", (D, F)), ("ffn2", (F, D))):
        g = torch.Generator(device=device).manual_seed(SEED)
        x = torch.randn(BUDGET, d_in, generator=g,
                        device=device).to(torch.bfloat16)
        q, s = _quantize_stack(torch.randn(1, d_in, d_out, generator=g,
                                           device=device) / d_in ** 0.5, 8)
        w, scale = q[0], s[0].to(torch.bfloat16)
        before = gm.dense_launch_count
        got = gm.weight_only_matmul(x, w, scale, qmax=127.0)
        torch.cuda.synchronize()
        if gm.dense_launch_count != before + 1:
            fail(f"gmm_int8_dense {prod}: {gm.dense_launch_count - before} "
                 "launches counted for one call")

        def plain():
            return torch.matmul(x, gm.dequantize(w, scale, d_in,
                                                 torch.bfloat16, 127.0))
        err = close_or_fail(f"gmm_int8_dense {prod}", got, plain(), tol)
        if not torch.equal(gm.weight_only_matmul(x, w, scale, qmax=127.0),
                           got):
            fail(f"gmm_int8_dense {prod}: two launches differ")
        ms = cuda_ms(lambda: gm.weight_only_matmul(x, w, scale,
                                                   qmax=127.0), flush=flush)
        plain_ms = cuda_ms(plain, iters=5, flush=flush)
        w_lib = gm.dequantize(w, scale, d_in, torch.bfloat16, 127.0)
        lib = cuda_ms(lambda: torch.matmul(x, w_lib), flush=flush)
        bound_ms, bound_by = gmm_bound(x[None], w[None], scale[None], d_out)
        calls.append((err, ms, plain_ms, lib, bound_ms, bound_by))
        flops = 2 * BUDGET * d_in * d_out
        print(f"kernel check: gmm_int8_dense {prod} [1, {BUDGET}, {d_in}] "
              f"x [1, {d_in}, {d_out}] int8 weights, bf16 scales "
              f"max_abs_err={err:.3g} (tol {tol} (1 + |plain|)), two "
              f"launches bit-identical, kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({bound_by}), the kernel at {bound_ms / ms:.1%} of it, "
              f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s; yardstick: "
              f"torch.matmul on a pre-dequantized copy {lib:.4f} ms",
              flush=True)
        del x, w, scale, got, w_lib
    n = len(calls)
    return {"gmm_int8_dense": dict(
        max_abs_err=max(c[0] for c in calls),
        ms=sum(c[1] for c in calls) / n,
        plain_ms=sum(c[2] for c in calls) / n,
        library_ms=sum(c[3] for c in calls) / n,
        bound_ms=sum(c[4] for c in calls) / n,
        bound_by=max(calls, key=lambda c: c[4])[5])}



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

    for kv_dtype in (None, "int8", "fp8_e4m3"):
        got, card_counts = serve(device, kv_dtype, DRAFT_K)
        want, cpu_counts = serve("cpu", kv_dtype, DRAFT_K)
        same, total, gap = first_gap(models["cpu"], prompts, got, want)
        line = (f"check spec: fp32, {layers} layers at full width, "
                f"{kv_dtype or 'float32'} pools, draft_k={DRAFT_K}: "
                f"{same}/{total} greedy tokens equal on the card and the "
                f"CPU; drafts proposed/accepted {card_counts} on the card, "
                f"{cpu_counts} on the CPU; first differing token's fp32 "
                f"top-2 gap {'none' if gap is None else f'{gap:.3g}'}")
        if kv_dtype is None:
            plain, _ = serve(device, None, 0)
            p_same, _, p_gap = first_gap(models["cpu"], prompts, got, plain)
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


def serve_counted(eng, prompts, counters, label, new=NEW_TOKENS,
                  adapters=None):
    """Serve the prompts to completion (`new` tokens each; under
    `adapters`, one adapter id a prompt) with every kernel counter zeroed
    just before and read just after. Fails unless every request finished
    with its full horizon and every KV block came back (and every adapter
    pin). Returns (outputs, launches, the run's numbers)."""
    import torch
    for mod, attr, _ in counters:
        setattr(mod, attr, 0)
    before = (eng.steps_run, eng.dispatches_run, eng.device_ticks_run,
              eng.device_ticks_issued, dict(eng.early_exit_counts),
              eng.tokens_fed)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, new, adapter_id=a) for p, a in
            zip(prompts, adapters or [None] * len(prompts))]
    try:
        eng.run()
    except RuntimeError as e:
        fail(f"{label}: {e}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {name: getattr(mod, attr) for mod, attr, name in counters}
    outputs = [list(r.output) for r in reqs]
    if any(r.state != "finished" or len(r.output) != new
           for r in reqs):
        fail(f"{label}: not every request finished with its full horizon")
    if eng.kv.blocks_in_use:
        fail(f"{label}: {eng.kv.blocks_in_use} KV blocks still held after "
             "every request finished")
    if eng.adapters is not None and eng.adapters.total_pins:
        fail(f"{label}: {eng.adapters.total_pins} adapter pins still held "
             "after every request finished")
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
        / len(reqs), reqs=reqs)
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


# ----------------------------------------------- phases 5g, 5h and 5i

# the prefix-cache workload: a shared system prompt of 16 blocks, then
# distinct suffixes of 16-256 tokens; the second wave's conversations
# take a new suffix of this many tokens
SYSTEM_PROMPT, REPLAY_SUFFIX = 256, 32


def prefix_waves():
    """(the first wave's 16 prompts, a function of their outputs giving
    the second wave): a shared 256-token system prompt plus a distinct
    suffix of 16-256 tokens each (the first's 64, so that its prompt
    fills 20 whole blocks); then 4 finished conversations (prompt +
    output) replayed with a new 32-token suffix, and the first prompt
    replayed exactly (its whole prompt cached: the last token is re-fed
    into a private copy of a shared block)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 21)
    system = rng.integers(0, VOCAB, SYSTEM_PROMPT).tolist()
    lens = rng.integers(16, 257, N_REQUESTS)
    lens[0] = 64
    first = [system + rng.integers(0, VOCAB, int(n)).tolist() for n in lens]

    def second(outputs):
        return [first[i] + outputs[i]
                + rng.integers(0, VOCAB, REPLAY_SUFFIX).tolist()
                for i in (1, 2, 3, 4)] + [list(first[0])]
    return first, second


def serve_waves(eng, counters, label, pool_launches):
    """Both waves of `prefix_waves` on `eng`, every kernel counter zeroed
    just before and read just after; holds every request's horizon and
    the launches (`pool_launches`: the pool's ragged variant, steps x
    24, nothing else). Returns (requests, the run's numbers)."""
    import torch
    first, second = prefix_waves()
    for mod, attr, _ in counters:
        setattr(mod, attr, 0)
    steps0, fed0 = eng.steps_run, eng.prefill_tokens_fed
    t0 = time.perf_counter()
    reqs = [eng.submit(p, NEW_TOKENS) for p in first]
    eng.run()
    reqs += [eng.submit(p, NEW_TOKENS)
             for p in second([list(r.output) for r in reqs])]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {name: getattr(mod, attr) for mod, attr, name in counters}
    steps = eng.steps_run - steps0
    if any(r.state != "finished" or len(r.output) != NEW_TOKENS
           for r in reqs):
        fail(f"{label}: not every request finished with its full horizon")
    for name, n in got.items():
        want = steps * LAYERS if name == pool_launches else 0
        if n != want:
            fail(f"{label}: {name} launched {n} times, expected {want} "
                 f"({steps} steps)")
    generated = sum(len(r.output) for r in reqs)
    return reqs, dict(
        steps=steps, wall=wall, generated=generated,
        prefill=eng.prefill_tokens_fed - fed0,
        ttft=sum(r.first_token_time - r.submit_time for r in reqs)
        / len(reqs))


def serve_prefix(model, device, counters):
    """Phase 5g: GPT-350M (phase 5a's model) served the two waves of
    `prefix_waves` by a cache-off engine and by `prefix_caching=True`
    engines over bf16 and int8 pools, launches held (the pool's ragged
    variant steps x 24 times). The bf16 cache's engine: every token
    within the near-tie oracle of the fp32 dense forward. Both cache
    engines: hits printed, their sum > 0, each a whole number of blocks
    but the exact replay's (its prompt less the re-fed token, through a
    copy on write); after `evict_all` every block back on the free list.
    Prompt tokens fed, TTFT and tokens/s beside the cache-off engine's;
    the int8 pool's tokens reported, not held."""
    import torch
    from paddle_tpu_torch.serving.engine import ServingEngine
    t_phase = time.perf_counter()
    base = dict(max_slots=SLOTS, block_size=BLOCK, max_seq_len=MAX_SEQ,
                token_budget=BUDGET, cache_dtype="bfloat16", device=device)
    off = None
    for label, kw, variant in (
            ("cache off", {}, "paged_attention"),
            ("cache on", dict(prefix_caching=True), "paged_attention"),
            ("cache on int8", dict(prefix_caching=True, kv_dtype="int8"),
             "paged_int8")):
        eng = ServingEngine(model, **base, **kw)
        eng.generate_batch([[1, 2, 3]], max_new_tokens=2)   # warm-up
        pc = eng.prefix_cache
        if pc is not None:
            pc.evict_all()
            pc.hit_tokens = pc.miss_tokens = pc.evictions = 0
        torch.cuda.synchronize()
        reqs, run = serve_waves(eng, counters, f"serve prefix {label}",
                                variant)
        outputs = [list(r.output) for r in reqs]
        off = off or outputs
        same = sum(a == b for o, w in zip(outputs, off)
                   for a, b in zip(o, w))
        line = (f"serve prefix {label}: {len(reqs)} requests (16 on a "
                f"{SYSTEM_PROMPT}-token system prompt, then 4 replayed "
                f"conversations and 1 exact replay), {run['steps']} steps, "
                f"{run['prefill']} prompt tokens fed, {run['generated']} "
                f"generated tokens in {run['wall']:.3f} s = "
                f"{run['generated'] / run['wall']:.1f} tokens/s, mean TTFT "
                f"{run['ttft'] * 1e3:.1f} ms, {variant} {run['steps']} x "
                f"{LAYERS} launches; tokens equal to the cache-off engine's "
                f"{same}/{run['generated']}")
        if pc is None:
            print(line, flush=True)
            del eng
            continue
        hits = [r.cache_hit_tokens for r in reqs]
        print(line + f"; hits {sum(hits)} tokens ({pc.hit_ratio():.1%} of "
              f"prompt tokens; per request {hits}), copies on write "
              f"{pc.cow_copies}, LRU evictions {pc.evictions} blocks, "
              f"{pc.cached_blocks} blocks cached", flush=True)
        replay = reqs[-1]
        odd = [h for r, h in zip(reqs[:-1], hits) if h % BLOCK]
        if sum(hits) <= 0 or odd:
            fail(f"serve prefix {label}: hits {hits}, not whole blocks: "
                 f"{odd}")
        if hits[-1] != len(replay.prompt) - 1 or pc.cow_copies < 1:
            fail(f"serve prefix {label}: the exact replay hit {hits[-1]} "
                 f"of {len(replay.prompt)} tokens with {pc.cow_copies} "
                 "copies on write")
        if kw.get("kv_dtype") is None:
            check_outputs(model, reqs, device, label="check prefix")
        freed = pc.evict_all()
        alloc = eng.kv.allocator
        if alloc.num_free != alloc.capacity or not alloc.invariant_ok:
            fail(f"serve prefix {label}: {alloc.num_free} of "
                 f"{alloc.capacity} blocks free after evict_all")
        print(f"serve prefix {label}: evict_all freed {freed} blocks, all "
              f"{alloc.capacity} blocks free", flush=True)
        del eng
        torch.cuda.empty_cache()
    print(f"serve prefix: phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def sparse_prompts():
    """The sparse serve phase's 8 prompts, 700-992 tokens (up to 62 of a
    slot's 64 blocks with their horizon)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 31)
    return [rng.integers(0, VOCAB, int(n)).tolist() for n in
            rng.integers(SPARSE_PROMPTS[0], SPARSE_PROMPTS[1] + 1, SLOTS)]


def serve_sparse(model, device, counters):
    """Phase 5h: GPT-350M (phase 5a's model) served 8 prompts of 700-992
    tokens, 32 new tokens each, by a dense engine and block-sparse
    engines (`sparse_blocks=8`, `sparse_recent=2`: Bt = 11 of up to 64
    blocks) over bf16, int8 and fp8 pools, with draft_k=3 at 1 and 4
    ticks (sync debug on), and at full coverage (`sparse_blocks=64`).
    Launches held exactly: a sparse step issues the region's call over
    the shortened tables (the `paged_sparse` variant of its entry and
    pool) and the rest's over the full tables, each steps (or issued
    ticks) x 24. The full-coverage engine passes the near-tie oracle;
    the 4-tick engine's tokens equal the 1-tick one's; skip ratios and
    the agreement with the dense engine are printed, not held. Returns
    the sparse variants' launches."""
    import torch
    from paddle_tpu_torch.serving.engine import ServingEngine
    t_phase = time.perf_counter()
    prompts = sparse_prompts()
    base = dict(max_slots=SLOTS, block_size=BLOCK, max_seq_len=MAX_SEQ,
                token_budget=BUDGET, cache_dtype="bfloat16", device=device)
    sparse = dict(sparse_blocks=SPARSE_BLOCKS, sparse_recent=SPARSE_RECENT)
    draft = dict(draft_k=DRAFT_K, draft_ngram=DRAFT_NGRAM,
                 draft_ring=DRAFT_RING)
    runs = (("dense", {}, ("paged_attention",)),
            ("sparse", sparse, ("paged_sparse", "paged_attention")),
            ("sparse full coverage", dict(sparse_blocks=MAX_SEQ // BLOCK),
             ("paged_sparse", "paged_attention")),
            ("sparse int8", dict(sparse, kv_dtype="int8"),
             ("paged_sparse_int8", "paged_int8")),
            ("sparse fp8", dict(sparse, kv_dtype="fp8_e4m3"),
             ("paged_sparse_fp8", "paged_fp8")),
            (f"sparse draft_k={DRAFT_K}", dict(sparse, **draft),
             ("paged_sparse_verify", "paged_attention")),
            (f"sparse draft_k={DRAFT_K} {TICKS} ticks",
             dict(sparse, **draft, ticks_per_dispatch=TICKS),
             ("paged_sparse_verify", "paged_attention")))
    outs, launches = {}, {}
    for label, kw, variants in runs:
        eng = ServingEngine(model, **base, **kw)
        eng.generate_batch([[1, 2, 3]], max_new_tokens=2)   # warm-up
        torch.cuda.synchronize()
        if eng._multitick:
            sync_guarded(eng)
        cand0, sel0 = eng.sparse_candidate_blocks, eng.sparse_selected_blocks
        outputs, got, run = serve_counted(eng, prompts, counters,
                                          f"serve sparse {label}",
                                          new=SPARSE_NEW)
        outs[label] = outputs
        n = run["issued"] if eng._multitick else run["steps"]
        want = {v: n * LAYERS for v in variants}
        for name, c in got.items():
            if c != want.get(name, 0):
                fail(f"serve sparse {label}: {name} launched {c} times, "
                     f"expected {want.get(name, 0)} ({n} "
                     f"{'ticks issued' if eng._multitick else 'steps'})")
        if variants[0].startswith("paged_sparse"):
            launches.setdefault(variants[0], got[variants[0]])
        cand = eng.sparse_candidate_blocks - cand0
        sel = eng.sparse_selected_blocks - sel0
        ref = ("sparse" if kw.get("kv_dtype") else
               f"sparse draft_k={DRAFT_K}" if "ticks_per_dispatch" in kw
               else "dense")
        same = sum(a == b for o, w in zip(outputs, outs[ref])
                   for a, b in zip(o, w))
        print(f"serve sparse {label}: {SLOTS} prompts of "
              f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
              f"{SPARSE_NEW} new each; table width "
              f"{eng.sparse_table_width or MAX_SEQ // BLOCK}, "
              f"{run['steps']} dispatches"
              + (f", {run['issued']} ticks issued, {run['ticks']} executed"
                 if eng._multitick else "")
              + f"; {run['generated']} generated tokens in {run['wall']:.3f}"
              f" s = {run['generated'] / run['wall']:.1f} tokens/s, mean "
              f"TTFT {run['ttft'] * 1e3:.1f} ms; decode blocks selected "
              f"{sel} of {cand} candidates, skip ratio "
              f"{1 - sel / cand if cand else 0.0:.3f}; tokens equal to the "
              f"{ref} engine's {same}/{run['generated']}; launches "
              + ", ".join(f"{v} {got[v]}" for v in variants), flush=True)
        if label == "sparse full coverage":
            check_outputs(model, run["reqs"], device,
                          label="check sparse full coverage")
        if "ticks_per_dispatch" in kw:
            if outputs != outs[ref]:
                fail(f"serve sparse {label}: tokens differ from the 1-tick "
                     "engine's")
            if run["ticks"] <= run["dispatches"]:
                fail(f"serve sparse {label}: the loop never ran more than "
                     "one tick a dispatch")
        del eng
        torch.cuda.empty_cache()
    print(f"serve sparse: phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def first_gap(model, prompts, got, want):
    """(tokens equal, total, the fp32 top-2 logit gap of `model` (plain
    dense forward, teacher-forced on `want`) at the first token where
    `got` and `want` differ, or None). `model` may also be a function of
    the request's index that returns its model."""
    import torch
    same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    total = sum(map(len, want))
    for n, (p, g, w) in enumerate(zip(prompts, got, want)):
        i = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if i is None:
            continue
        m = model if isinstance(model, torch.nn.Module) else model(n)
        ids = torch.tensor([p + w[:i]],
                           device=m.word_embeddings.weight.device)
        top = m(ids, dtype=torch.float32)[0, -1].topk(2)
        return same, total, float(top.values[0] - top.values[1])
    return same, total, None


def check_prefix_sparse_on_card(device):
    """Phase 5i: fp32, 2 layers at full width, 16-token blocks of a
    256-token slot, a 64-token budget: a `prefix_caching=True` engine
    (two waves: 4 prompts on a shared 64-token head, then 2 replayed
    conversations and an exact replay of a 96-token prompt, a copy on
    write) and a block-sparse engine (`sparse_blocks=1`,
    `sparse_recent=1`: 3 of up to 15 blocks) over 4 prompts of 150-230
    tokens, each at 1 and 4 ticks, on the card (kernels) and on a CPU
    copy (plain versions). Greedy tokens, prefix hits and selected
    blocks must be equal, unless the first differing token sat at an
    fp32 top-2 gap under 1e-5; the card's cache engine must also give
    the card's cache-off engine's tokens under the same rule (fp32
    pools keep `paged_attend_kernel`, a warp per (token, head), which
    no layout changes)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.serving.engine import ServingEngine
    t_phase = time.perf_counter()
    layers = 2
    arrays = random_gpt_arrays(SEED + 41, layers=layers)
    models = {str(d): load_jax_gpt(arrays, HEADS, device=d)
              for d in (device, "cpu")}
    rng = np.random.default_rng(SEED + 42)
    head = rng.integers(0, VOCAB, 64).tolist()
    first = [head + rng.integers(0, VOCAB, n).tolist()
             for n in (32, 45, 70, 9)]
    tail = [rng.integers(0, VOCAB, 8).tolist() for _ in range(2)]
    long = [rng.integers(0, VOCAB, int(n)).tolist()
            for n in (150, 230, 181, 199)]

    def serve(dev, ticks, waves, **kw):
        eng = ServingEngine(models[str(dev)], max_slots=4, block_size=BLOCK,
                            max_seq_len=256, token_budget=64,
                            cache_dtype="float32", ticks_per_dispatch=ticks,
                            device=dev, **kw)
        if eng._multitick and torch.device(dev).type == "cuda":
            sync_guarded(eng)
        if waves:
            out = eng.generate_batch(first, max_new_tokens=16)
            second = [first[i] + out[i] + t
                      for i, t in zip((1, 2), tail)] + [first[0]]
            reqs = [eng.submit(p, 16) for p in second]
            eng.run()
            prompts = first + second
            out += [list(r.output) for r in reqs]
            pc = eng.prefix_cache
            counts = (pc.hit_tokens, pc.cow_copies) if pc else None
        else:
            prompts = long
            out = eng.generate_batch(long, max_new_tokens=16)
            counts = (eng.sparse_candidate_blocks,
                      eng.sparse_selected_blocks)
        return prompts, out, counts

    def hold(line, gap, same_counts):
        if gap is not None and gap >= 1e-5:
            fail(line + " — tokens differ past a near-tie")
        if gap is None and not same_counts:
            fail(line + " — equal tokens but different counts")

    for label, kw in (("prefix", dict(prefix_caching=True)),
                      ("sparse", dict(sparse_blocks=1, sparse_recent=1))):
        waves = label == "prefix"
        for ticks in (1, TICKS):
            prompts, got, card = serve(device, ticks, waves, **kw)
            _, want, cpu = serve("cpu", ticks, waves, **kw)
            same, total, gap = first_gap(models["cpu"], prompts, got, want)
            line = (f"check {label}: fp32, {layers} layers at full width, "
                    f"{ticks} tick(s) a dispatch: {same}/{total} greedy "
                    f"tokens equal on the card and the CPU; "
                    f"{'hits, copies on write' if label == 'prefix' else 'candidate, selected blocks'}"
                    f" {card} on the card, {cpu} on the CPU; first "
                    f"differing token's fp32 top-2 gap "
                    f"{'none' if gap is None else f'{gap:.3g}'}")
            hold(line, gap, card == cpu)
            if label == "prefix":
                _, off, _ = serve(device, ticks, waves)
                o_same, _, o_gap = first_gap(models["cpu"], prompts, got, off)
                line += (f"; {o_same}/{total} equal to the card's cache-off "
                         f"engine (first gap "
                         f"{'none' if o_gap is None else f'{o_gap:.3g}'})")
                hold(line, o_gap, True)
            print(line, flush=True)
    print(f"check prefix/sparse: phase took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del models
    torch.cuda.empty_cache()


# ------------------------------------------------- phases 5j, 5k and 5l


def lora_adapters(decoder, seed):
    """The four tenants' random rank-LORA_RANK adapters (numpy draws from
    `seed`, `serving.adapters.make_random_adapter`)."""
    from paddle_tpu_torch.serving.adapters import make_random_adapter
    return {f"t{i}": make_random_adapter(decoder, LORA_RANK, seed=seed + i,
                                         scale=LORA_STD)
            for i in range(4)}


def projection_bytes(eng):
    """Device bytes of the decoder's four projection weights in `eng`
    (with their scales on a weight-only stack), as the step reads them."""
    names = {p + k for p in ("qkv", "out", "ffn1", "ffn2")
             for k in ("_w", "_s")}
    return sum(t.numel() * t.element_size() for pl in eng._layers
               for n, t in pl.items() if n in names)


def weight_only_copy(model, device, moe=None):
    """The weight-only twin of the float GPT `model` on `device`:
    `GPTForGeneration(weight_only=True, moe=moe)` given `model`'s tensors,
    its four projections quantized as the weight-only stacks quantize
    them (`_quantize_stack`: int8, fp32 scales; MoE experts at moe's
    `moe_quant_bits` by `_quantize_expert_stack`), every other tensor
    copied."""
    import torch
    from paddle_tpu_torch.incubate.nn.fused_transformer import (
        _quantize_expert_stack, _quantize_stack)
    from paddle_tpu_torch.models.gpt import GPTForGeneration
    dec = model.decoder
    wo = GPTForGeneration(
        vocab_size=model.vocab_size, hidden_size=model.hidden_size,
        num_layers=dec.num_layers, num_attention_heads=dec.num_heads,
        intermediate_size=dec.dim_feedforward,
        max_position_embeddings=model.max_position_embeddings,
        weight_only=True, moe=moe, compute_dtype=model.compute_dtype,
        device=device, dtype=model.word_embeddings.weight.dtype)
    ebits = (moe or {}).get("moe_quant_bits") or 8
    dst = wo.state_dict()
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.split(".")[-1] in ("qkv_w", "out_w", "ffn1_w", "ffn2_w"):
                q, sc = (_quantize_expert_stack(v.float(), ebits)
                         if v.ndim == 4 else _quantize_stack(v.float(), 8))
                dst[k].copy_(q)
                dst[k[:-2] + "_s"].copy_(sc)
            else:
                dst[k].copy_(v)
    return wo


def serve_lora(model, device, counters, dense_out, base, base_prof):
    """Phase 5j: GPT-350M (phase 5a's model, bf16) served with
    `max_adapters=3` (2 usable slots) and 4 random rank-16 tenants: the
    16 requests split between the base model and the tenants
    (`LORA_MIX`), so slots churn and admission blocks. Holds: every
    request finishes, at least one eviction, pins and blocks back after
    the drain, paged attention launched steps x 24 and nothing else, the
    base-model requests within phase 5's near-tie oracle; prints the base
    requests' agreement with phase 4's tokens and each tenant's with a
    solo engine. Then the same mix at 4 ticks a dispatch under sync
    debug (its tokens equal the 1-tick engine's) and a profiled decode
    step, each beside phase 4's."""
    import torch
    from paddle_tpu_torch.serving.engine import ServingEngine
    t_phase = time.perf_counter()
    ads = lora_adapters(model.decoder, SEED + 60)
    prompts = serve_prompts()
    mix = list(LORA_MIX)

    def build(slots=LORA_SLOTS, tenants=ads, **kw):
        eng = ServingEngine(model, max_slots=SLOTS, block_size=BLOCK,
                            max_seq_len=MAX_SEQ, token_budget=BUDGET,
                            cache_dtype="bfloat16", max_adapters=slots,
                            lora_rank=LORA_RANK, device=device, **kw)
        for t, w in tenants.items():
            eng.register_adapter(t, w)
        eng.generate_batch([[1, 2, 3]], max_new_tokens=2)   # warm-up
        torch.cuda.synchronize()
        return eng

    eng = build()
    label = "serve LoRA"
    outputs, got, run = serve_counted(eng, prompts, counters, label,
                                      adapters=mix)
    c = eng.adapters
    base_idx = [i for i, t in enumerate(mix) if t is None]
    base_same = sum(a == b for i in base_idx
                    for a, b in zip(outputs[i], dense_out[i]))
    print(f"{label}: max_adapters={LORA_SLOTS} ({LORA_SLOTS - 1} usable "
          f"slots), {len(ads)} tenants of rank {LORA_RANK} (alpha = rank), "
          f"bytes_per_slot {c.bytes_per_slot}; {run['steps']} steps, "
          f"{run['generated']} generated tokens in {run['wall']:.3f} s = "
          f"{run['generated'] / run['wall']:.1f} tokens/s (phase 4: "
          f"{base['tokens_s']:.1f}), mean TTFT {run['ttft'] * 1e3:.1f} ms "
          f"(phase 4: {base['ttft_ms']:.1f}); adapter loads "
          f"{c.cache_misses}, hits {c.cache_hits}, evictions "
          f"{c.evictions}, hit ratio {c.hit_ratio():.3f}, load_seconds "
          f"{c.load_seconds:.4f}; base-model requests' tokens equal to "
          f"phase 4's {base_same}/{len(base_idx) * NEW_TOKENS}; launches "
          + ", ".join(f"{n} {k}" for n, k in got.items() if k), flush=True)
    if c.evictions < 1:
        fail(f"{label}: {len(ads)} tenants on {LORA_SLOTS - 1} slots "
             "evicted nothing")
    want = {"paged_attention": run["steps"] * LAYERS}
    for name, n in got.items():
        if n != want.get(name, 0):
            fail(f"{label}: {name} launched {n} times, expected "
                 f"{want.get(name, 0)} ({run['steps']} steps)")
    check_outputs(model, [run["reqs"][i] for i in base_idx], device,
                  label="check LoRA base requests")
    for t in ads:
        idx = [i for i, x in enumerate(mix) if x == t]
        solo = build(slots=2, tenants={t: ads[t]})
        reqs = [solo.submit(prompts[i], NEW_TOKENS, adapter_id=t)
                for i in idx]
        solo.run()
        same = sum(a == b for i, r in zip(idx, reqs)
                   for a, b in zip(outputs[i], r.output))
        print(f"{label}: tenant {t}: {same}/{len(idx) * NEW_TOKENS} tokens "
              "equal to a solo engine's (one usable slot, the tenant's "
              "requests alone)", flush=True)
        del solo
    prof = profile_decode(eng, "GPT-350M LoRA", kernel=PAGED_KERNELS,
                          adapters=[None, "t0", "t1"])
    if prof["device_ms"] is not None and base_prof["device_ms"] is not None:
        print(f"{label}: a decode step {prof['launches']:.0f} launches "
              f"against phase 4's {base_prof['launches']:.0f}, "
              f"{prof['device_ms']:.3f} against {base_prof['device_ms']:.3f}"
              f" ms of device time, {prof['host_ms']:.3f} against "
              f"{base_prof['host_ms']:.3f} ms on the host clock", flush=True)
    del eng
    torch.cuda.empty_cache()
    eng = build(ticks_per_dispatch=TICKS)
    sync_guarded(eng)
    label = "serve LoRA 4 ticks"
    out4, got4, run4 = serve_counted(eng, prompts, counters, label,
                                     adapters=mix)
    same = sum(a == b for o, w in zip(out4, outputs) for a, b in zip(o, w))
    print(multitick_line("LoRA", eng, run4, "the 1-tick LoRA engine", same,
                         got4) + f"; adapter loads "
          f"{eng.adapters.cache_misses}, evictions {eng.adapters.evictions};"
          " every dispatch's ticks ran under set_sync_debug_mode('error')",
          flush=True)
    hold_multitick(label, eng, run4, out4, outputs, got4,
                   {"paged_attention": run4["issued"] * LAYERS})
    del eng
    torch.cuda.empty_cache()
    print(f"serve LoRA: phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def serve_weight_only(model, device, counters, dense_out, base, base_prof):
    """Phase 5k, dense: GPT-350M `weight_only=True` (phase 5a's weights,
    int8 projections with fp32 scales, bf16 compute) on the 16 requests:
    every request finishes, K4 at one group launched exactly steps x 96
    (4 projections x 24 layers) and paged attention steps x 24, nothing
    else; two served requests within the near-tie oracle of the
    weight-only model's own fp32 forward; projection bytes, tokens/s,
    agreement with phase 4's bf16 engine and a profiled decode step
    printed beside phase 4's. Returns K4's dense launches."""
    import torch
    from paddle_tpu_torch.serving.engine import ServingEngine
    t_phase = time.perf_counter()
    wo = weight_only_copy(model, device)
    kw = dict(max_slots=SLOTS, block_size=BLOCK, max_seq_len=MAX_SEQ,
              token_budget=BUDGET, cache_dtype="bfloat16", device=device)
    # the bf16 engine's projections: 2 bytes a weight
    float_bytes = sum(2 * getattr(model.decoder, n).numel()
                      for n in ("qkv_w", "out_w", "ffn1_w", "ffn2_w"))
    eng = ServingEngine(wo, **kw)
    eng.generate_batch([[1, 2, 3]], max_new_tokens=2)       # warm-up
    torch.cuda.synchronize()
    wo_bytes = projection_bytes(eng)
    label = "serve weight-only"
    outputs, got, run = serve_counted(eng, serve_prompts(), counters, label)
    same = sum(a == b for o, w in zip(outputs, dense_out)
               for a, b in zip(o, w))
    print(f"{label}: GPT-350M int8 projections (quant_bits 8, scales cast "
          f"to bf16): projection bytes {wo_bytes} against the bf16 "
          f"engine's {float_bytes} ({float_bytes / wo_bytes:.3f}x smaller);"
          f" {run['steps']} steps, {run['generated']} generated tokens in "
          f"{run['wall']:.3f} s = {run['generated'] / run['wall']:.1f} "
          f"tokens/s (phase 4: {base['tokens_s']:.1f}), mean TTFT "
          f"{run['ttft'] * 1e3:.1f} ms (phase 4: {base['ttft_ms']:.1f}); "
          f"tokens equal to phase 4's bf16 engine {same}/{run['generated']}"
          "; launches " + ", ".join(f"{n} {k}" for n, k in got.items() if k),
          flush=True)
    if float_bytes / wo_bytes < 1.9:
        fail(f"{label}: projections only {float_bytes / wo_bytes:.3f}x "
             "smaller than bf16")
    want = {"paged_attention": run["steps"] * LAYERS,
            "gmm_int8_dense": run["steps"] * 4 * LAYERS}
    for name, n in got.items():
        if n != want.get(name, 0):
            fail(f"{label}: {name} launched {n} times, expected "
                 f"{want.get(name, 0)} ({run['steps']} steps)")
    check_outputs(wo, run["reqs"][:2], device, label="check weight-only")
    prof = profile_decode(eng, "GPT-350M weight-only", kernel="gmm")
    if prof["device_ms"] is not None and base_prof["device_ms"] is not None:
        print(f"{label}: a decode step {prof['launches']:.0f} launches "
              f"against phase 4's {base_prof['launches']:.0f}, "
              f"{prof['device_ms']:.3f} against {base_prof['device_ms']:.3f}"
              f" ms of device time, {prof['host_ms']:.3f} against "
              f"{base_prof['host_ms']:.3f} ms on the host clock", flush=True)
    launches = {"gmm_int8_dense": got["gmm_int8_dense"]}
    del eng, wo
    torch.cuda.empty_cache()
    print(f"{label}: phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def serve_moe_weight_only(model, device, counters, prompts):
    """Phase 5k, MoE: `FusedMultiTransformerMoeWeightOnly` at MoE-350M
    widths (phase 5b's weights: int8 attention, packed int4 experts with
    fp16 scales) on 8 of the requests: every request finishes, the dense
    K4 launches (attention) steps x 2L and the int4 expert launches steps
    x 2L, counted apart, paged attention steps x L (L = MOE_LAYERS),
    nothing else."""
    import torch
    from paddle_tpu_torch.serving.engine import ServingEngine
    wo = weight_only_copy(model, device, moe=dict(MOE, moe_quant_bits=4))
    eng = ServingEngine(wo, max_slots=SLOTS, block_size=BLOCK,
                        max_seq_len=MAX_SEQ, token_budget=BUDGET,
                        cache_dtype="bfloat16", device=device)
    eng.generate_batch([[1, 2, 3]], max_new_tokens=2)       # warm-up
    torch.cuda.synchronize()
    label = "serve MoE weight-only"
    outputs, got, run = serve_counted(eng, prompts[:SLOTS], counters, label)
    d = wo.decoder
    nbytes = sum(getattr(d, n).numel() * getattr(d, n).element_size()
                 for n in ("qkv_w", "out_w", "ffn1_w", "ffn2_w", "qkv_s",
                           "out_s", "ffn1_s", "ffn2_s"))
    print(f"{label}: int8 attention, int4 experts (fp16 scales): "
          f"projection bytes {nbytes}; {run['steps']} steps, "
          f"{run['generated']} generated tokens in {run['wall']:.3f} s = "
          f"{run['generated'] / run['wall']:.1f} tokens/s, mean TTFT "
          f"{run['ttft'] * 1e3:.1f} ms; launches " + ", ".join(
              f"{n} {k}" for n, k in got.items() if k), flush=True)
    want = {"paged_attention": run["steps"] * MOE_LAYERS,
            "gmm_int8_dense": run["steps"] * 2 * MOE_LAYERS,
            "gmm_int4": run["steps"] * 2 * MOE_LAYERS}
    for name, n in got.items():
        if n != want.get(name, 0):
            fail(f"{label}: {name} launched {n} times, expected "
                 f"{want.get(name, 0)} ({run['steps']} steps)")
    del eng, wo
    torch.cuda.empty_cache()


def quantized_arrays(arrays, expert_bits=8):
    """`random_gpt_arrays` output as a JAX weight-only model's
    `_gen_tensors()` give it: the four projections int8 with fp32
    scales (`*_s`), MoE experts at `expert_bits` (8, or 4: packed with
    fp16 scales), for `convert.load_jax_gpt` to carry across."""
    import torch
    from paddle_tpu_torch.incubate.nn.fused_transformer import (
        _quantize_expert_stack, _quantize_stack)
    out = dict(arrays)
    for n in ("qkv_w", "out_w", "ffn1_w", "ffn2_w"):
        w = torch.from_numpy(arrays[n])
        q, sc = (_quantize_expert_stack(w, expert_bits) if w.ndim == 4
                 else _quantize_stack(w, 8))
        out[n], out[n[:-2] + "_s"] = q.numpy(), sc.numpy()
    return out


def merged_model(arrays, adapter, scaling):
    """A float CPU model whose projections hold W + A B (alpha / r): the
    plain dense forward of a tenant, for its near-tie gaps."""
    import numpy as np
    from paddle_tpu_torch.convert import load_jax_gpt
    out = dict(arrays)
    for name, (a, b) in adapter.items():
        w = f"{name}_w"
        out[w] = (arrays[w].astype(np.float64)
                  + np.matmul(a.astype(np.float64),
                              b.astype(np.float64) * scaling)
                  ).astype(np.float32)
    return load_jax_gpt(out, HEADS, device="cpu")


def check_lora_weight_only_on_card(device):
    """Phase 5l: fp32, 2 layers at full width, at 1 and 4 ticks, on the
    card (kernels) and on a CPU copy (plain versions): a tenant mix with
    churn (4 tenants and the base model on 2 usable slots, 4 engine
    slots), the base-model requests alone on the card beside an engine
    without adapters, and the weight-only dense engine (its int8
    weights and scales carried in through `convert.load_jax_gpt`).
    Greedy tokens (and adapter loads, hits, evictions) must be equal,
    unless the first differing token sat at an fp32 top-2 gap under
    1e-5 (a tenant's gap from its merged W + A B model). The weight-only
    MoE engine is held in phase 5c."""
    import numpy as np
    import torch
    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.serving.engine import ServingEngine
    t_phase = time.perf_counter()
    layers = 2
    arrays = random_gpt_arrays(SEED + 70, layers=layers)
    q_arrays = quantized_arrays(arrays)
    models = {str(d): load_jax_gpt(arrays, HEADS, device=d)
              for d in (device, "cpu")}
    wo_models = {str(d): load_jax_gpt(q_arrays, HEADS, device=d)
                 for d in (device, "cpu")}
    ads = lora_adapters(models["cpu"].decoder, SEED + 71)
    rng = np.random.default_rng(SEED + 72)
    prompts = [rng.integers(0, VOCAB, int(n)).tolist()
               for n in (9, 40, 23, 64, 17, 31, 50)]
    mix = ["t0", None, "t1", "t2", None, "t3", "t0"]
    merged = {}

    def model_of(i):
        t = mix[i]
        if t is None:
            return models["cpu"]
        if t not in merged:
            merged[t] = merged_model(arrays, ads[t], 1.0)
        return merged[t]

    def serve(m, dev, ticks, lora, ps, tenants=None):
        eng = ServingEngine(m, max_slots=4, block_size=BLOCK,
                            max_seq_len=256, token_budget=64,
                            cache_dtype="float32", ticks_per_dispatch=ticks,
                            max_adapters=LORA_SLOTS if lora else 0,
                            lora_rank=LORA_RANK, device=dev)
        if eng._multitick and torch.device(dev).type == "cuda":
            sync_guarded(eng)
        for t, w in (ads.items() if lora else ()):
            eng.register_adapter(t, w)
        reqs = [eng.submit(p, 16, adapter_id=a) for p, a in
                zip(ps, tenants or [None] * len(ps))]
        eng.run()
        c = eng.adapters
        if c is not None and c.total_pins:
            fail(f"check LoRA: {c.total_pins} pins held after the drain")
        return ([list(r.output) for r in reqs],
                None if c is None else (c.cache_misses, c.cache_hits,
                                        c.evictions))

    def hold(line, gap, same_counts):
        if gap is not None and gap >= 1e-5:
            fail(line + " — tokens differ past a near-tie")
        if gap is None and not same_counts:
            fail(line + " — equal tokens but different counts")
        print(line, flush=True)

    base_idx = [i for i, t in enumerate(mix) if t is None]
    base_ps = [prompts[i] for i in base_idx]
    for ticks in (1, TICKS):
        got, card = serve(models[str(device)], device, ticks, True, prompts,
                          mix)
        want, cpu = serve(models["cpu"], "cpu", ticks, True, prompts, mix)
        same, total, gap = first_gap(model_of, prompts, got, want)
        hold(f"check LoRA: fp32, {layers} layers at full width, {ticks} "
             f"tick(s) a dispatch, 4 tenants and the base model on "
             f"{LORA_SLOTS - 1} usable slots: {same}/{total} greedy tokens "
             f"equal on the card and the CPU; adapter loads, hits, "
             f"evictions {card} on the card, {cpu} on the CPU; first "
             f"differing token's fp32 top-2 gap "
             f"{'none' if gap is None else f'{gap:.3g}'}", gap, card == cpu)
        if card[2] < 1:
            fail("check LoRA: the tenant mix evicted nothing")
        alone, _ = serve(models[str(device)], device, ticks, True, base_ps)
        plain, _ = serve(models[str(device)], device, ticks, False, base_ps)
        same, total, gap = first_gap(models["cpu"], base_ps, alone, plain)
        hold(f"check LoRA: {ticks} tick(s), base-model requests on the "
             f"card's adapter engine: {same}/{total} tokens equal to the "
             f"card's engine without adapters; the mix's base-model "
             f"requests {sum(got[i] == a for i, a in zip(base_idx, alone))}"
             f"/{len(base_idx)} equal to them alone; first gap "
             f"{'none' if gap is None else f'{gap:.3g}'}", gap, True)
        got, _ = serve(wo_models[str(device)], device, ticks, False, prompts)
        want, _ = serve(wo_models["cpu"], "cpu", ticks, False, prompts)
        same, total, gap = first_gap(wo_models["cpu"], prompts, got, want)
        hold(f"check weight-only: fp32, {layers} layers at full width "
             f"(int8 weights and fp32 scales through convert), {ticks} "
             f"tick(s): {same}/{total} greedy tokens equal on the card (K4 "
             f"at one group) and the CPU (plain formula); first gap "
             f"{'none' if gap is None else f'{gap:.3g}'}", gap, True)
    print(f"check LoRA / weight-only: phase took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del models, wo_models, merged
    torch.cuda.empty_cache()



# ----------------------------------------------------- phases 5b and 5c


def serve_moe(device, counters):
    """Phase 5b: MoE-350M served by three engines (float, int8, int4
    experts), each zeroing every kernel counter just before its 16
    requests and reading them just after; then phase 5k's weight-only
    MoE engine over the same weights. Returns each grouped-matmul
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
    model = load_jax_gpt(random_gpt_arrays(SEED + 8, layers=MOE_LAYERS,
                                           experts=E), HEADS,
                         moe=MOE, compute_dtype="bfloat16", device=device,
                         dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    n_expert = model.decoder.ffn1_w.numel() + model.decoder.ffn2_w.numel()
    print(f"serve MoE: MoE-350M built in {time.perf_counter() - t0:.1f} s: "
          f"{n_params} resident parameters, {n_expert} of them experts "
          f"({E} experts, top-{k}, capacity factor "
          f"{MOE['capacity_factor']}; vocab {VOCAB}, hidden {HIDDEN}, "
          f"{MOE_LAYERS} layers, {HEADS} heads, bf16)", flush=True)
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
        wbytes = (expert_weight_bytes(E, D, F, wdt, MOE_LAYERS)
                  + expert_weight_bytes(E, F, D, wdt, MOE_LAYERS))
        print(f"serve MoE {wdt} experts: expert_weight_bytes {wbytes} "
              f"({n_params} resident parameters); built in {build_s:.1f} s;"
              f" {steps} steps, {generated} generated tokens in {wall:.3f} "
              f"s = {generated / wall:.1f} tokens/s, mean TTFT "
              f"{ttft * 1e3:.1f} ms, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(device)} B, preemptions "
              f"{eng.scheduler.preemption_count}; {fed} valid tokens fed, "
              f"expert utilization entropy "
              f"{moe_utilization_entropy(counts):.4f}, dropped {dropped:.0f}"
              f" of {k * MOE_LAYERS * fed} choices, last aux "
              f"{eng.moe_last_aux:.4f}; tokens equal to the float "
              f"engine's {same}/{generated}; launches " + ", ".join(
                  f"{n} {got[n]}" for n in ("paged_attention", "gmm_fp",
                                            "gmm_int8", "gmm_int4")),
              flush=True)
        if any(r.state != "finished" or len(r.output) != NEW_TOKENS
               for r in reqs):
            fail(f"serve MoE {wdt}: not every request finished with its "
                 "full horizon")
        want = {"paged_attention": steps * MOE_LAYERS,
                variant[fmt]: steps * 2 * MOE_LAYERS}
        for name, n in got.items():
            if n != want.get(name, 0):
                fail(f"serve MoE {wdt}: {name} launched {n} times, "
                     f"expected {want.get(name, 0)} ({steps} steps)")
        if not np.all(np.isfinite(counts)) or \
                counts.sum() + dropped != k * MOE_LAYERS * fed:
            fail(f"serve MoE {wdt}: {counts.sum()} routed + {dropped} "
                 f"dropped choices != {k} x {MOE_LAYERS} layers x {fed} "
                 "tokens")
        launches[variant[fmt]] = got[variant[fmt]]
        profile_decode(eng, f"MoE-350M {fmt or 'float'} experts",
                       kernel="gmm")
        del eng, reqs
        torch.cuda.empty_cache()
        if fmt is None:
            serve_moe_multitick(model, device, counters, prompts, float_out)
    serve_moe_weight_only(model, device, counters, prompts)
    serve_generate_moe(model, device, counters)
    del model
    torch.cuda.empty_cache()
    return launches


def serve_moe_multitick(model, device, counters, prompts, want_out):
    """Phase 5b's multi-tick engine: MoE-350M with float experts at 4
    ticks a dispatch, every dispatch's ticks under
    `set_sync_debug_mode("error")`: the float 1-tick engine's tokens,
    paged attention issued ticks x L and the float grouped matmul issued
    ticks x 2L launches (nothing else), and routed + dropped = 2 x L x
    valid tokens over the ticks that counted (L = MOE_LAYERS)."""
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
          f"{k * MOE_LAYERS * run['fed']} choices; every dispatch's ticks ran "
          "under set_sync_debug_mode('error')", flush=True)
    hold_multitick(label, eng, run, outputs, want_out, got,
                   {"paged_attention": run["issued"] * MOE_LAYERS,
                    "gmm_fp": run["issued"] * 2 * MOE_LAYERS})
    if not np.all(np.isfinite(counts)) or \
            counts.sum() + dropped != k * MOE_LAYERS * run["fed"]:
        fail(f"{label}: {counts.sum()} routed + {dropped} dropped choices "
             f"!= {k} x {MOE_LAYERS} layers x {run['fed']} tokens")
    del eng
    torch.cuda.empty_cache()


def check_moe_on_card(device):
    """Phase 5c: fp32, 2 layers at full width, float and int8 experts,
    and the weight-only stack (int8 attention, int4 experts, carried in
    through `convert.load_jax_gpt`) at 1 and 4 ticks: 4 requests of 16
    new tokens served on the card (kernels) and on a CPU copy (plain
    versions) must give the same greedy tokens. A near-tie
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

    wo_arrays = quantized_arrays(arrays, expert_bits=4)
    wo_moe = dict(MOE, moe_quant_bits=4)
    for fmt, ticks in ((None, 1), ("int8", 1), ("weight-only int4", 1),
                       ("weight-only int4", TICKS)):
        out, logs = {}, {}
        wo = fmt == "weight-only int4"
        for dev in (device, "cpu"):
            model = (load_jax_gpt(wo_arrays, HEADS, moe=wo_moe, device=dev)
                     if wo else load_jax_gpt(arrays, HEADS, moe=MOE,
                                             device=dev))
            eng = ServingEngine(model, max_slots=4, block_size=BLOCK,
                                max_seq_len=128, token_budget=BUDGET,
                                cache_dtype="float32",
                                moe_weight_dtype=None if wo else fmt,
                                ticks_per_dispatch=ticks, device=dev)
            logs[str(dev)] = []
            out[str(dev)] = serve(eng, logs[str(dev)])
            del eng, model
        (got, _), (want, want_at) = out[str(device)], out["cpu"]
        card_log, cpu_log = logs[str(device)], logs["cpu"]
        min_gap = min(float(g.min()) for _, _, g in cpu_log if g.numel())
        same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
        total = sum(map(len, want))
        line = (f"check MoE: fp32, {layers} layers at full width, "
                f"{fmt or 'float'} experts"
                + (" (int8 attention, carried in through convert)"
                   if wo else "") + f", {ticks} tick(s) a dispatch: "
                f"{same}/{total} greedy tokens "
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


def check_flash(fa, device, flush, shape=None, dtypes=None,
                label="kernel check"):
    """Phase 3 for flash attention at the train step's [8, 16, 1024, 64]
    (or `shape`): forward kernel (out, lse) against its plain version,
    backward through torch.autograd.grad (dq, dk, dv) against the plain
    backward, two launches of each bit-identical; returns the bf16
    {"flash_fwd": ..., "flash_bwd": ...}."""
    import torch
    import torch.nn.functional as F
    B, H, S, D = shape or (TRAIN_BATCH, HEADS, TRAIN_SEQ, HIDDEN // HEADS)
    scale = 1.0 / D ** 0.5
    records = {}
    for dtype in dtypes or (torch.float32, torch.bfloat16):
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
        again = fa._launch_fwd(qs, k, v, True)
        grads = fa._launch_bwd(qs, k, v, out, lse, dout, True)
        if not (all(torch.equal(a, b) for a, b in zip(again, (out, lse)))
                and all(torch.equal(a, b) for a, b in zip(
                    grads, fa._launch_bwd(qs, k, v, out, lse, dout,
                                          True)))):
            fail(f"flash {name} [{B}, {H}, {S}, {D}]: two launches differ")
        del again, grads
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
            print(f"{label}: {kname} {name} [{B}, {H}, {S}, {D}] causal"
                  f" max_abs_err={err:.3g} (tol {tol} (1 + |plain|); two "
                  f"launches bit-identical) "
                  f"kernel_ms={ms:.4f} plain_ms={plain:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by}), "
                  f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
                  f"{bound_ms / ms:.1%} of the bound; yardstick: "
                  f"scaled_dot_product_attention"
                  f"{' backward' if bwd else ''} {lib:.4f} ms", flush=True)
        del q, k, v, dout, qs, out, lse, args
    return records.get("bfloat16")


def check_add_ln(ln, device, flush, rows=None, dtypes=None,
                 label="kernel check"):
    """Phase 3 for add+LayerNorm at the train step's 8192 (or `rows`)
    rows x 1024:
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
    N, d = rows or TRAIN_BATCH * TRAIN_SEQ, HIDDEN
    records = {}
    for dtype in dtypes or (torch.float32, torch.bfloat16):
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
            print(f"{label}: {kname} {name} [{N}, {d}] "
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
    return records.get("bfloat16")


def check_qkv_proj(qp, device, flush, batch=None, heads=None, dtypes=None,
                   grads=True, label="kernel check"):
    """Phase 3 for the fused QKV projection (K5) at the train step's x
    [8, 1024, 1024] x w_qkv [1024, 3072] into 3 x [8, 16, 1024, 64] (or
    `batch` rows and an mp rank's `heads`: w_qkv [1024, 3 x heads x
    64]), fp32 and bf16 (or `dtypes`): the forward kernel against its
    plain version, and, unless not `grads`, the gradients through the
    autograd function (the kernel's forward, the plain-tensor backward:
    no kernel) against the plain version differentiated by autograd on
    fp32 copies and rounded once; returns the bf16 {"qkv_proj": ...}
    where bf16 ran."""
    import torch
    B, S, d = batch or TRAIN_BATCH, TRAIN_SEQ, HIDDEN
    H = heads or HEADS
    dh = HIDDEN // HEADS
    width = 3 * H * dh
    records = {}
    for dtype in dtypes or (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = TRAIN_TOL[name]
        g = torch.Generator(device=device).manual_seed(SEED)
        x = torch.randn(B, S, d, generator=g, device=device).to(dtype)
        w = (torch.randn(d, width, generator=g, device=device)
             * d ** -0.5).to(dtype)
        b = (torch.randn(width, generator=g, device=device)
             * 0.1).to(dtype)
        got = qp.qkv_proj(x, w, b, H)
        torch.cuda.synchronize()
        want = qp.qkv_proj_reference(x, w, b, H)
        err_f = max(close_or_fail(f"qkv_proj {name} {n}", a, e, tol)
                    for n, a, e in zip("qkv", got, want))
        del got, want
        err_b = None
        if grads:
            gq, gk, gv = (torch.randn(B, H, S, dh, generator=g,
                                      device=device).to(dtype)
                          for _ in range(3))
            args = [t.detach().requires_grad_() for t in (x, w, b)]
            got = torch.autograd.grad(qp.qkv_proj(*args, H), args,
                                      (gq, gk, gv))
            torch.cuda.synchronize()
            # the plain version differentiated on fp32 copies, each
            # gradient rounded once to the dtype: JAX's fp32 sums and
            # single cast (autograd on the bf16 operands would add the
            # three thirds' dx in bf16)
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
        nbytes = (x.numel() + w.numel() + b.numel() + B * S * width) \
            * x.element_size()
        t_bytes = nbytes / PEAK_BYTES
        t_flops = 2 * B * S * d * width / PEAK_FLOPS[name]
        bound_ms = max(t_bytes, t_flops) * 1e3
        bound_by = "bytes" if t_bytes >= t_flops else "operations"
        err = err_f if err_b is None else max(err_f, err_b)
        records[name] = {"qkv_proj": dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib)}
        print(f"{label}: qkv_proj {name} x [{B}, {S}, {d}] x w_qkv "
              f"[{d}, {width}] -> 3 x [{B}, {H}, {S}, {dh}] max_abs_err="
              f"{err_f:.3g} forward"
              + ("" if err_b is None else f", {err_b:.3g} dx/dw/db")
              + f" (tol {tol} (1 + |plain|)) kernel_ms={ms:.4f} "
              f"plain_ms={plain:.4f} bound_ms={bound_ms:.4f} ({bound_by}), "
              f"{2 * B * S * d * width / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
              f"{bound_ms / ms:.1%} of the bound; yardstick: torch.addmm"
              f" over [{B * S}, {d}] x [{d}, {width}] (no head layout) "
              f"{lib:.4f} ms", flush=True)
        del x, w, b, x2
    return records.get("bfloat16")


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


def random_hybrid_params(layers, seed=SEED, experts=0):
    """GPT-350M trainer parameters in the JAX `HybridGPT` layout (nested,
    blocks stacked on [L]), drawn from a numpy seed with the JAX
    trainer's init scales: N(0, 0.02), output projections N(0, 0.02 /
    sqrt(2L)), unit LayerNorm scales, zero biases. `experts` > 0 gives
    MoE-350M's blocks: a gate [L, d, E] and the FFN as E experts, whose
    1.6 G draws at 24 layers are filled by 8 threads from child seeds of
    the same numpy seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    L, D, FF, V = layers, HIDDEN, 4 * HIDDEN, VOCAB
    proj = 0.02 / (2 * L) ** 0.5

    def normal(shape, std=0.02):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    params = {"tok_emb": normal((V, D)), "pos_emb": normal((TRAIN_SEQ, D)),
              "ln_f_w": np.ones(D, np.float32), "ln_f_b": zeros(D),
              "head": normal((D, V)),
              "blocks": {"ln1_w": np.ones((L, D), np.float32),
                         "ln1_b": zeros(L, D),
                         "w_qkv": normal((L, D, 3 * D)),
                         "b_qkv": zeros(L, 3 * D),
                         "w_o": normal((L, D, D), proj), "b_o": zeros(L, D),
                         "ln2_w": np.ones((L, D), np.float32),
                         "ln2_b": zeros(L, D)}}
    if experts:
        params["blocks"].update(
            gate=normal((L, D, experts)),
            w_fc1=threaded_normal(rng, (L, experts, D, FF), 0.02),
            b_fc1=zeros(L, experts, FF),
            w_fc2=threaded_normal(rng, (L, experts, FF, D), proj),
            b_fc2=zeros(L, experts, D))
    else:
        params["blocks"].update(
            w_fc1=normal((L, D, FF)), b_fc1=zeros(L, FF),
            w_fc2=normal((L, FF, D), proj), b_fc2=zeros(L, D))
    return params


def threaded_normal(rng, shape, std, parts=8):
    """N(0, std) float32 of `shape`, filled in `parts` threads (numpy's
    generators release the GIL while they fill), each from a child seed
    drawn from `rng`."""
    import numpy as np
    out = np.empty(shape, np.float32)
    flat = out.reshape(-1)
    step = -(-flat.size // parts)
    seeds = rng.integers(0, 2 ** 63, parts)

    def fill(i):
        part = flat[i * step:(i + 1) * step]
        np.random.default_rng(int(seeds[i])).standard_normal(
            out=part, dtype=np.float32)
        part *= np.float32(std)
    with ThreadPoolExecutor(parts) as ex:
        list(ex.map(fill, range(parts)))
    return out


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
    exactly; bench_gpt's config then gets one profiled step. Returns the
    launches of the runs that carry each kernel (bench_gpt's, and the
    qkv_kernel run's for qkv_proj)."""
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
        del trainer
    print("train: side by side (ms/step, tokens/s, max_memory_allocated B): "
          + "; ".join(f"{label} batch {batch}: {ms:.1f}, {tps:.0f}, {peak}"
                      for label, batch, ms, tps, peak in table), flush=True)
    del params, opt
    return launches


def compare_steps(label, a, b):
    """Fails unless train step results a and b, each (loss, params,
    opt), agree as `check_train_step` says; prints how closely they
    do."""
    import torch
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

    print(f"check: one fp32 train step, {layers} layers at full width, "
          f"batch 1", flush=True)
    compare_steps("remat off: card vs CPU", step(device, remat=False),
            step("cpu", remat=False))
    kept = dict(remat=True, qkv_kernel=True)
    card = step(device, **kept)
    compare_steps("save_splash_residuals + qkv_kernel: card vs CPU", card,
            step("cpu", **kept))
    compare_steps("save_splash_residuals vs full remat, both qkv_kernel, card",
            card, step(device, remat=True, qkv_kernel=True,
                       remat_policy=None))


def profile_train(trainer, params, opt, tok, lab, step_num, label,
                  extra=()):
    """Where a train step's device time goes: one step under
    torch.profiler, its host time against the device time of the kernels
    it launched, and each of the port's kernel families' device ms and
    share of it, and of the kernels whose names hold one of `extra`
    (lower case). Informational: prints "not measured" when the profiler
    records no device events. Returns the step's (params, opt, loss)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = trainer.train_step(params, opt, tok, lab, step_num=step_num)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    if not dev:
        print(f"profile: train step [{label}] {host_ms:.1f} ms on the host "
              "clock (profiled); device time not measured (no device "
              "events)", flush=True)
        return out
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
    for word in extra:
        hits = [e for e in dev if word in e.key.lower()]
        t = sum(e.self_device_time_total for e in hits) / 1e3
        print(f"profile: train step [{label}] kernels named *{word}*: "
              f"{t:.3f} ms ({t / device_ms:.1%} of the step's device time)"
              f" in {sum(e.count for e in hits)} launches: " + "; ".join(
                  f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms "
                  f"x{e.count}" for e in hits[:4]), flush=True)
    return out


# ---------------------------------------------------- phases 6b, 7 (MoE)

# bench_gpt_moe's TPU config (bench.py:1749-1754): MoE-350M, 8 experts,
# top-2, capacity factor 1.25, full remat (its remat_policy is None)
MOE_TRAIN = dict(moe_num_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
                 remat_policy=None)
MOE_TRAIN_BATCH, MOE_TIMED_STEPS = 16, 2


def moe_stats_line(stats):
    return (f"balance {float(stats['balance']):.5f}, z "
            f"{float(stats['z']):.4f}, counts "
            f"{[int(c) for c in stats['counts'].tolist()]}, dropped "
            f"{int(stats['dropped'])}")


def train_moe(device, counters):
    """Phase 6b: MoE-350M (bench_gpt_moe's TPU config) trained for
    WARMUP_STEPS + MOE_TIMED_STEPS steps on one fixed batch of 16, the
    last timed step under torch.profiler (ms a step and tokens/s from the
    others); every count zeroed just before the first step and read after
    the last: K1a and K2 exactly as full remat predicts per step, no
    other kernel; every step's routed + dropped choices = 16 x 1024 x 2 x
    24; a finite, falling loss."""
    import numpy as np
    import torch
    from paddle_tpu_torch.convert import load_jax_hybrid_gpt
    from paddle_tpu_torch.parallel.hybrid_gpt import (HybridGPT,
                                                      init_opt_state)
    t0 = time.perf_counter()
    cfg = train_config(**MOE_TRAIN)
    params = load_jax_hybrid_gpt(
        random_hybrid_params(LAYERS, seed=SEED + 8,
                             experts=MOE_TRAIN["moe_num_experts"]),
        device=device)
    opt = init_opt_state(cfg, params)
    trainer = HybridGPT(cfg, device=device)
    n_params = sum(p.numel() for p in params["blocks"].values()) + sum(
        params[k].numel() for k in params if k != "blocks")
    print(f"train MoE: MoE-350M ({n_params} parameters, "
          f"{cfg.moe_experts} experts, top-{cfg.moe_top_k}, capacity "
          f"factor {cfg.moe_capacity_factor}) built in "
          f"{time.perf_counter() - t0:.1f} s; bench_gpt_moe's config: "
          f"bf16, bf16_grads, full remat, fused_ce, ce_seq_chunks=4, "
          f"zero_stage {cfg.zero_stage}, batch {MOE_TRAIN_BATCH}",
          flush=True)
    rng = np.random.default_rng(SEED + 9)
    tok = rng.integers(0, VOCAB, (MOE_TRAIN_BATCH, TRAIN_SEQ))
    lab = rng.integers(0, VOCAB, (MOE_TRAIN_BATCH, TRAIN_SEQ))
    routed = MOE_TRAIN_BATCH * TRAIN_SEQ * cfg.moe_top_k * LAYERS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod, attr, _ in counters:
        setattr(mod, attr, 0)
    losses, stats, step = [], [], 1
    for _ in range(WARMUP_STEPS):
        params, opt, loss = trainer.train_step(params, opt, tok, lab,
                                               step_num=step)
        losses.append(loss)
        stats.append(trainer.last_moe_stats)
        step += 1
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    clean = MOE_TIMED_STEPS - 1
    for _ in range(clean):
        params, opt, loss = trainer.train_step(params, opt, tok, lab,
                                               step_num=step)
        losses.append(loss)
        stats.append(trainer.last_moe_stats)
        step += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    params, opt, loss = profile_train(trainer, params, opt, tok, lab, step,
                                      "MoE-350M", extra=("scan",))
    losses.append(loss)
    stats.append(trainer.last_moe_stats)
    peak = torch.cuda.max_memory_allocated()
    got = {name: getattr(mod, attr) for mod, attr, name in counters}
    steps = WARMUP_STEPS + MOE_TIMED_STEPS
    want = {"flash_fwd": 2 * LAYERS, "flash_bwd": LAYERS,
            "add_ln_fwd": 2 * LAYERS, "add_ln_bwd": LAYERS}
    hold_launches("train MoE", got, {n: steps * k for n, k in want.items()})
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        fail(f"train MoE: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train MoE: the loss did not fall ({losses[0]} -> "
             f"{losses[-1]})")
    for i, st in enumerate(stats):
        n = float(st["counts"].sum()) + float(st["dropped"])
        if n != routed:
            fail(f"train MoE: step {i + 1} routed + dropped {n}, expected "
                 f"{routed}")
    tps = MOE_TRAIN_BATCH * TRAIN_SEQ * clean / wall
    print(f"train MoE: batch {MOE_TRAIN_BATCH}, {MOE_TIMED_STEPS} timed "
          f"steps after {WARMUP_STEPS} warm-up, the last profiled (above): "
          f"{wall * 1e3 / clean:.1f} ms/step, {tps:.0f} tokens/s,"
          f" max_memory_allocated {peak} B; losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; launches " + ", ".join(
              f"{n} {got[n]} ({got[n] // steps}/step)" for n in want)
          + f", other kernels 0; every step routed + dropped = {routed}; "
          f"last step: {moe_stats_line(stats[-1])}", flush=True)
    launches = {n: got[n] for n in want}
    del trainer, params, opt
    torch.cuda.empty_cache()
    return launches


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


# phase 6d: 4 rank processes of phase 5n's spawn, global batch 8, 2
# steps a job. "dp x ep": MoE-350M's experts (bench_gpt_moe) at 1 layer,
# dp 2 x ep 2 with ZeRO-1; a rank's capacity comes from its own tokens
# (as in JAX), so where choices drop, they drop unlike one rank's over
# the global batch: the job runs at capacity factor E / top_k = 4, where
# nothing drops, as JAX's own ep parity test does (tests/test_moe.py).
# "mp x pp": `dryrun_multichip(4)`'s mesh
# (__graft_entry__.py:43-44), mp 2 x pp 2, with sequence parallelism, 2
# micro-batches and ZeRO-1, at GPT-350M's widths at 2 layers (one a
# stage). "dp buckets": dense dp 4 at 1 layer with gradient buckets of
# PyTorch DDP's default 25 MiB. Each fp32, full remat, the fused QKV
# projection (K5; at the mp rank's 8 heads).
DP_EP = dict(dp=2, ep=2, zero_stage=1,
             moe_num_experts=MOE_TRAIN["moe_num_experts"],
             moe_top_k=MOE_TRAIN["moe_top_k"], moe_capacity_factor=4.0)
MESH = dict(pp=2, mp=2, sequence_parallel=True, micro_batches=2,
            zero_stage=1)
DP_BUCKETS = dict(dp=4, grad_bucket_bytes=25 * 2 ** 20, zero_stage=1)
#: (label, GPTConfig overrides, layers, seeds of the weights and of the
#: batches)
MESH_JOBS = (("dp x ep", DP_EP, 1, SEED + 10, SEED + 11),
             ("mp x pp", MESH, 2, SEED + 14, SEED + 114),
             ("dp buckets", DP_BUCKETS, 1, SEED + 15, SEED + 115))
MESH_BATCH, MESH_STEPS = 8, 2


def mesh_config(layers, **kw):
    """Phase 6d's config: GPT-350M's widths at `layers`, fp32, full
    remat, the fused QKV projection."""
    import torch
    return train_config(n_layers=layers, bf16_grads=False,
                        compute_dtype=torch.float32, remat_policy=None,
                        qkv_kernel=True, **kw)


def mesh_params(layers, seed, kw):
    return random_hybrid_params(layers, seed,
                                experts=kw.get("moe_num_experts", 0))


def mesh_batches(seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, VOCAB, (MESH_BATCH, TRAIN_SEQ)),
             rng.integers(0, VOCAB, (MESH_BATCH, TRAIN_SEQ)))
            for _ in range(MESH_STEPS)]


def mesh_launches(cfg, steps=MESH_STEPS):
    """K1a, K2 and K5 launches of one rank's steps under full remat: its
    stage's layers x micro-batches, the forwards twice."""
    n = steps * cfg.n_layers // cfg.pp * cfg.micro_batches
    return {"flash_fwd": 2 * n, "flash_bwd": n, "add_ln_fwd": 2 * n,
            "add_ln_bwd": n, "qkv_proj": 2 * n}


def mesh_train_job(rank, world):
    """Phase 6d on one rank: each of MESH_JOBS, MESH_STEPS steps on the
    global batch's rows of this rank, every kernel count zeroed just
    before the first step and read after the last; returns per job the
    losses, each step's wall ms and MoE stats, the parameters and Adam
    state after step 1 (on the host), the counts, the bucketed
    reduction's all-reduces a step, peak memory and the job's
    seconds."""
    import numpy as np
    import torch
    from paddle_tpu_torch.convert import shard_jax_hybrid_gpt
    from paddle_tpu_torch.parallel.hybrid_gpt import (HybridGPT,
                                                      init_opt_state)
    counters = [(m, attr, name) for name, m, attr, _r, _s in kernel_table()]
    out = {}
    for label, kw, layers, seed, batch_seed in MESH_JOBS:
        t_job = time.perf_counter()
        cfg = mesh_config(layers, **kw)
        trainer = HybridGPT(cfg, device="cuda:0")
        params = shard_jax_hybrid_gpt(mesh_params(layers, seed, kw),
                                      cfg=cfg, rank=rank, device="cuda:0")
        opt = init_opt_state(cfg, params, trainer.mesh)
        res = dict(losses=[], ms=[], stats=[])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for mod, attr, _ in counters:
            setattr(mod, attr, 0)
        for step, (tok, lab) in enumerate(mesh_batches(batch_seed), 1):
            t0 = time.perf_counter()
            params, opt, loss = trainer.train_step(
                params, opt, *trainer.shard_data(tok, lab), step_num=step)
            res["losses"].append(float(loss))
            res["ms"].append((time.perf_counter() - t0) * 1e3)
            if cfg.moe_experts:
                res["stats"].append(_to_cpu(trainer.last_moe_stats))
            if step == 1:
                res["params1"], res["opt1"] = _to_cpu(params), _to_cpu(opt)
        res["launches"] = {name: getattr(mod, attr)
                           for mod, attr, name in counters}
        res["peak"] = torch.cuda.max_memory_allocated()
        res["buckets"] = trainer.last_grad_buckets
        if not np.isfinite(res["losses"]).all():
            raise RuntimeError(f"rank {rank} [{label}]: non-finite loss "
                               f"{res['losses']}")
        res["seconds"] = time.perf_counter() - t_job
        out[label] = res
        del trainer, params, opt
        torch.cuda.empty_cache()
    return out


def train_mesh(device, ranks):
    """Phase 6d: `ranks`, the results of `mesh_train_job` on 4 rank
    processes sharing the card over gloo (run in phase 5n's spawn). For
    each job: every rank's losses equal rank 0's and a 1-rank card
    trainer's (its micro-batches kept) on the same weights and global
    batch within rtol 1e-4; each rank's parameters and Adam first
    moments after step 1 the 1-rank trainer's cut to the rank's shard
    (`shard_state`), within phase 7's bounds; each rank's K1a, K2 and K5
    launches exactly `mesh_launches`, no other kernel; the MoE job's
    routing counts and drops exactly the 1-rank trainer's at every step;
    the bucketed job's all-reduces a step `grad_bucket_count`. At full
    width an element whose gradient is near Adam's eps moves by a
    sizeable part of lr for summation-order noise, so the parameters
    are held to phase 7's bounds (`compare_steps`), not the CPU tests'
    5e-2 lr. The rank step ms is printed: the ranks share one card and
    their collectives go through the host, so it is not DP / EP / TP /
    PP speed."""
    import torch
    from paddle_tpu_torch.convert import load_jax_hybrid_gpt
    from paddle_tpu_torch.parallel.hybrid_gpt import (
        AXES, HybridGPT, grad_bucket_count, init_opt_state, shard_state)
    t_phase = time.perf_counter()
    for label, kw, layers, seed, batch_seed in MESH_JOBS:
        cfg = mesh_config(layers, **kw)
        cfg1 = mesh_config(layers, **{k: v for k, v in kw.items()
                                      if k not in AXES + (
                                          "sequence_parallel",
                                          "grad_bucket_bytes")})
        one = HybridGPT(cfg1, device=device)
        params = load_jax_hybrid_gpt(mesh_params(layers, seed, kw),
                                     device=device)
        opt = init_opt_state(cfg1, params)
        losses, ms, stats = [], [], []
        for step, (tok, lab) in enumerate(mesh_batches(batch_seed), 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, loss = one.train_step(params, opt, tok, lab,
                                               step_num=step)
            losses.append(float(loss))
            ms.append((time.perf_counter() - t0) * 1e3)
            if cfg.moe_experts:
                stats.append(_to_cpu(one.last_moe_stats))
            if step == 1:
                params1, opt1 = _to_cpu(params), _to_cpu(opt)
        jobs = [r[label] for r in ranks]
        want = mesh_launches(cfg)
        buckets = grad_bucket_count(params, cfg.grad_bucket_bytes) \
            if cfg.grad_bucket_bytes else None
        widths = (f"MoE-350M's widths ({cfg.moe_experts} experts, top-"
                  f"{cfg.moe_top_k}, capacity factor "
                  f"{cfg.moe_capacity_factor})" if cfg.moe_experts
                  else "GPT-350M's widths")
        print(f"train mesh [{label}]: {widths} at {layers} of "
              f"{LAYERS} layers, fp32, full remat, qkv_kernel, dp {cfg.dp} "
              f"x pp {cfg.pp} x mp {cfg.mp} x ep {cfg.ep}, sequence_parallel "
              f"{cfg.sequence_parallel}, micro_batches {cfg.micro_batches},"
              f" zero_stage {cfg.zero_stage}, grad_bucket_bytes "
              f"{cfg.grad_bucket_bytes}, {len(ranks)} rank processes on "
              f"the one card over gloo, global batch {MESH_BATCH}: rank "
              f"0's losses " + " ".join(f"{x:.6f}" for x in jobs[0]["losses"])
              + ", the 1-rank trainer's " + " ".join(f"{x:.6f}"
                                                     for x in losses)
              + "; rank step ms " + "; ".join(
                  f"rank {r}: " + " ".join(f"{x:.1f}" for x in j["ms"])
                  for r, j in enumerate(jobs))
              + " (host-staged collectives, ranks sharing one card: not "
              f"DP / EP / TP / PP speed), the 1-rank trainer's " + " ".join(
                  f"{x:.1f}" for x in ms)
              + "; max_memory_allocated a rank " + ", ".join(
                  str(j["peak"]) for j in jobs) + " B; launches a rank "
              + ", ".join(f"{n} {jobs[0]['launches'][n]}" for n in want)
              + (f"; {jobs[0]['buckets']} bucket all-reduces a step "
                 f"(grad_bucket_count {buckets})" if buckets else "")
              + f"; the ranks' jobs took {jobs[0]['seconds']:.1f} s"
              + (f"; last step: {moe_stats_line(jobs[0]['stats'][-1])}"
                 if cfg.moe_experts else ""), flush=True)
        for r, res in enumerate(jobs):
            if res["losses"] != jobs[0]["losses"]:
                fail(f"train mesh [{label}]: rank {r} losses "
                     f"{res['losses']} differ from rank 0's "
                     f"{jobs[0]['losses']}")
            if not all(abs(a - b) <= 1e-4 * abs(b)
                       for a, b in zip(res["losses"], losses)):
                fail(f"train mesh [{label}]: rank {r} losses "
                     f"{res['losses']} vs the 1-rank trainer's {losses} "
                     f"past rtol 1e-4")
            for i, (st, st1) in enumerate(zip(res["stats"], stats)):
                if not (torch.equal(st["counts"], st1["counts"])
                        and float(st["dropped"]) == float(st1["dropped"])):
                    fail(f"train mesh [{label}]: rank {r} step {i + 1} "
                         f"routing {moe_stats_line(st)} vs the 1-rank "
                         f"trainer's {moe_stats_line(st1)}")
            hold_counts(f"train mesh [{label}] rank {r}", res["launches"],
                        want)
            if res["buckets"] != buckets:
                fail(f"train mesh [{label}]: rank {r} issued "
                     f"{res['buckets']} bucket all-reduces a step, "
                     f"grad_bucket_count {buckets}")
            compare_steps(f"mesh [{label}] rank {r} vs 1 rank, after step 1",
                          (res["losses"][0], res["params1"], res["opt1"]),
                          (losses[0], *shard_state(cfg, params1, opt1, r)))
        del one, params, opt
        torch.cuda.empty_cache()
    print(f"train mesh: every rank's losses (and routing) equal the 1-rank "
          f"trainer's, launches as full remat predicts; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def check_moe_train_step(device):
    """Phase 7, MoE: one fp32 step of MoE-350M's widths at 2 layers,
    batch 1, on the card (kernels), remat off and with
    "save_splash_residuals", each against one CPU copy's step (plain
    versions, remat off): the loss, parameters and
    first moments as `check_train_step` holds them, the routing counts
    and drops exactly, balance and z within 1e-5 relative. Then one bf16
    step (bench_gpt_moe's config at 2 layers, batch 2) from the same
    weights twice: every parameter and moment bit-identical."""
    import numpy as np
    import torch
    from paddle_tpu_torch.convert import load_jax_hybrid_gpt
    from paddle_tpu_torch.parallel.hybrid_gpt import (HybridGPT,
                                                      init_opt_state)
    t_phase = time.perf_counter()
    layers = 2
    arrays = random_hybrid_params(layers, seed=SEED + 12,
                                  experts=MOE_TRAIN["moe_num_experts"])
    rng = np.random.default_rng(SEED + 13)
    tok = rng.integers(0, VOCAB, (2, TRAIN_SEQ))
    lab = rng.integers(0, VOCAB, (2, TRAIN_SEQ))

    def step(dev, steps=1, batch=1, **kw):
        cfg = train_config(n_layers=layers, **{**MOE_TRAIN, **kw})
        trainer = HybridGPT(cfg, device=dev)
        params = load_jax_hybrid_gpt(arrays, device=dev)
        opt = init_opt_state(cfg, params)
        for i in range(1, steps + 1):
            params, opt, loss = trainer.train_step(
                params, opt, tok[:batch], lab[:batch], step_num=i)
        return float(loss), params, opt, trainer.last_moe_stats

    fp32 = dict(bf16_grads=False, compute_dtype=torch.float32)
    # one CPU step (remat off): in fp32 the policies change no value
    cpu = step("cpu", remat=False, **fp32)
    for policy in (None, "save_splash_residuals"):
        card = step(device, remat=policy is not None, remat_policy=policy,
                    **fp32)
        label = f"MoE, remat {'off' if policy is None else policy}"
        compare_steps(f"{label}: card vs CPU", card[:3], cpu[:3])
        sg, sc = card[3], cpu[3]
        if not (torch.equal(sg["counts"].cpu(), sc["counts"])
                and float(sg["dropped"]) == float(sc["dropped"])):
            fail(f"train check [{label}]: routing {moe_stats_line(sg)} vs "
                 f"the CPU's {moe_stats_line(sc)}")
        for k in ("balance", "z"):
            if not abs(float(sg[k]) - float(sc[k])) <= 1e-5 * abs(
                    float(sc[k])):
                fail(f"train check [{label}]: {k} {float(sg[k])} vs "
                     f"{float(sc[k])}")
        print(f"check [{label}]: routing equal ({moe_stats_line(sg)}); "
              f"balance and z within 1e-5", flush=True)
    a, b = (step(device, batch=2) for _ in range(2))
    same = n = 0

    def walk(x, y):
        nonlocal same, n
        for k in x:
            if isinstance(x[k], dict):
                walk(x[k], y[k])
                continue
            n += 1
            same += int(torch.equal(x[k], y[k]))
    walk(a[1], b[1])
    walk(a[2], b[2])
    if same != n or a[0] != b[0]:
        fail(f"train check [MoE bf16]: two identical steps: "
             f"{same} of {n} tensors bit-identical, losses {a[0]} vs "
             f"{b[0]}")
    print(f"check [MoE bf16, bench_gpt_moe's config at {layers} layers]: "
          f"two steps bit-identical in all {n} parameters and "
          f"moments (loss {a[0]:.6f}); phase took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def check_gmm_backward(gm, device, flush):
    """Phase 3 for K4 under autograd at the MoE train step's ffn1 shape,
    [8, 5120, 1024] x [8, 1024, 4096] bf16 (C = ceil(1.25 x 16384 x 2 /
    8)): the forward is the kernel (one launch a call), dx and dw are the
    grouped contractions (JAX's `_gmm_core_bwd`) as bf16 `bmm`s, each
    within GMM_TOL of the plain version's autograd; int8 and int4
    weights raise on a gradient."""
    import torch
    from paddle_tpu_torch.parallel.moe_utils import expert_capacity
    E, D, F = MOE["num_expert"], HIDDEN, 4 * HIDDEN
    C = expert_capacity(MOE_TRAIN_BATCH * TRAIN_SEQ, E, MOE["top_k"],
                        MOE["capacity_factor"])
    tol = GMM_TOL["bfloat16"]
    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(E, C, D, generator=g, device=device).bfloat16()
    w = (torch.randn(E, D, F, generator=g, device=device)
         / D ** 0.5).bfloat16()
    dout = torch.randn(E, C, F, generator=g, device=device).bfloat16()
    before = gm.fp_launch_count
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = gm.grouped_expert_matmul(xa, wa)
    dx, dw = torch.autograd.grad(out, (xa, wa), dout)
    torch.cuda.synchronize()
    launches = gm.fp_launch_count - before
    if launches != 1:
        fail(f"gmm_fp under autograd: {launches} K4 launches, expected 1")
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    ref = gm.grouped_matmul_reference(xr, wr)
    rdx, rdw = torch.autograd.grad(ref, (xr, wr), dout)
    errs = [close_or_fail(f"gmm_fp under autograd: {name}", got.detach(),
                          want.detach(), tol)
            for name, got, want in (("out", out, ref), ("dx", dx, rdx),
                                    ("dw", dw, rdw))]

    def fwd_bwd(x, w, fn):
        def run():
            xa, wa = x.detach().requires_grad_(), w.detach().requires_grad_()
            torch.autograd.grad(fn(xa, wa), (xa, wa), dout)
        return run
    ms = cuda_ms(fwd_bwd(x, w, gm.grouped_expert_matmul), iters=5,
                 flush=flush)
    plain = cuda_ms(fwd_bwd(x, w, gm.grouped_matmul_reference), iters=5,
                    flush=flush)
    q, scale = gm.quantize_int4_experts(w.float())
    x8 = x.clone().requires_grad_()
    for wq, sq in ((torch.randint(-127, 128, w.shape, dtype=torch.int8,
                                  device=device),
                    torch.ones(E, F, device=device)), (q, scale)):
        try:
            gm.grouped_expert_matmul(x8, wq, sq)
        except RuntimeError as e:
            if "gradient" not in str(e):
                raise
        else:
            fail("gmm under autograd: quantized weights took a gradient")
    print(f"kernel check: gmm_fp under autograd [{E}, {C}, {D}] x [{D}, "
          f"{F}] bf16: one K4 forward launch a call; out / dx / dw "
          f"max_abs_err {errs[0]:.3g} / {errs[1]:.3g} / {errs[2]:.3g} (tol "
          f"{tol} (1 + |plain|)); forward + backward {ms:.3f} ms, plain "
          f"version's {plain:.3f} ms; int8 and int4 weights refuse a "
          f"gradient", flush=True)
    del x, w, dout, out, dx, dw, ref, rdx, rdw, xa, wa, xr, wr


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


# ------------------------------------------- phases 3 (TP), 5m and 5n

# tensor-parallel serving: every rank a process on the one card over gloo
# (NCCL takes one card a rank), so the ranks' kernels interleave on it and
# their times are not TP speed. TP x EP MoE at a cut depth: four ranks
# share the card and its host.
TP, MOE_TP, MOE_EP, MOE_TP_LAYERS = 2, 2, 2, 4
# the dense TP job's depth (GPT-350M's widths), cut for the time limit
TP_LAYERS = 8


def check_tp_shapes(pa, gm, device, flush):
    """Phase 3 at a TP rank's shapes (GPT-350M at tp = 2, MoE-350M at
    tp = 2 x ep = 2): the paged kernel's ragged and verify entries over
    8 heads (the rank's half of `paged_case` / `verify_case`: bf16 pools
    and int8 pools); K4 at one group at the rank's dense weight-only
    products [256, 1024] x [1024, 1536 | 2048] and [256, 512 | 2048] x
    [512 | 2048, 1024] (int8, bf16 scales); the grouped expert matmuls
    at the rank's [4, 80, 1024] x [1024, 2048] and [4, 80, 2048] x
    [2048, 1024], float / int8 / int4 under bf16 and float under fp32.
    Each against its plain version, two launches bit-identical, timed
    beside the plain version, its bound (`paged_bound`, `gmm_bound`)
    and the library call
    of the full-width check (SDPA on a pre-gathered copy of the rank's
    heads for the paged entries, `torch.matmul` / `torch.bmm` on a
    pre-dequantized copy for K4)."""
    import torch
    from paddle_tpu_torch.incubate.nn.fused_transformer import \
        _quantize_stack
    h = HEADS // TP

    def rank_half(args):
        """The rank's heads of q and the pools (and the scale pools)."""
        q, kp, vp = (a[..., :h, :].contiguous() for a in args[:3])
        return [q, kp, vp] + list(args[3:6]) + [
            None if a is None else a[..., :h].contiguous()
            for a in args[6:]]

    cases = [("ragged bf16", pa.ragged_paged_attention,
              pa.ragged_gather_reference,
              rank_half(paged_case(torch.bfloat16, device)), TOL)]
    for kind in ("float", "int8"):
        cases.append((f"verify {kind} pools", pa.verify_paged_attention,
                      pa.verify_gather_reference,
                      rank_half(verify_case(torch.bfloat16, device, kind)),
                      TOL if kind == "float" else QTOL))
    for label, fn, plain, args, tol in cases:
        if args[0].shape[-2] != h or args[1].shape[-2] != h:
            fail(f"check TP shapes {label}: not cut to {h} heads")
        valid = args[4] >= 0
        got = fn(*args)
        torch.cuda.synchronize()
        err = close_or_fail(f"paged {label} at {h} heads", got[valid],
                            plain(*args)[valid], tol["bfloat16"])
        if not torch.equal(fn(*args), got):
            fail(f"paged {label} at {h} heads: two runs differ")
        ms = cuda_ms(lambda: fn(*args), flush=flush)
        plain_ms = cuda_ms(lambda: plain(*args), iters=5, flush=flush)
        sdpa_ms = cuda_ms(sdpa_yardstick(
            as_ragged(args) if args[5].dim() == 2 else args), flush=flush)
        bound_ms, bound_by, _ = paged_bound(args)
        print(f"kernel check TP: paged {label} q "
              f"{list(args[0].shape)} pools {list(args[1].shape)} "
              f"max_abs_err={err:.3g} (tol {tol['bfloat16']} (1 + |plain|);"
              f" two runs bit-identical) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({bound_by}), the kernel at {bound_ms / ms:.1%} of it; "
              f"yardstick: SDPA on a pre-gathered copy {sdpa_ms:.4f} ms",
              flush=True)
    D, F = HIDDEN, 4 * HIDDEN
    g = torch.Generator(device=device).manual_seed(SEED)
    for d_in, d_out in ((D, 3 * D // TP), (D // TP, D), (D, F // TP),
                        (F // TP, D)):
        x = torch.randn(BUDGET, d_in, generator=g,
                        device=device).to(torch.bfloat16)
        q, s = _quantize_stack(torch.randn(1, d_in, d_out, generator=g,
                                           device=device) / d_in ** 0.5, 8)
        w, scale = q[0], s[0].to(torch.bfloat16)
        got = gm.weight_only_matmul(x, w, scale, qmax=127.0)
        torch.cuda.synchronize()
        err = close_or_fail(
            f"gmm_int8_dense [{d_in}, {d_out}]", got, torch.matmul(
                x, gm.dequantize(w, scale, d_in, torch.bfloat16, 127.0)),
            GMM_TOL["bfloat16"])
        if not torch.equal(gm.weight_only_matmul(x, w, scale, qmax=127.0),
                           got):
            fail(f"gmm_int8_dense [{d_in}, {d_out}]: two launches differ")
        ms = cuda_ms(lambda: gm.weight_only_matmul(x, w, scale, qmax=127.0),
                     flush=flush)
        plain_ms = cuda_ms(lambda: torch.matmul(x, gm.dequantize(
            w, scale, d_in, torch.bfloat16, 127.0)), iters=5, flush=flush)
        w_lib = gm.dequantize(w, scale, d_in, torch.bfloat16, 127.0)
        lib = cuda_ms(lambda: torch.matmul(x, w_lib), flush=flush)
        bound_ms, bound_by = gmm_bound(x[None], w[None], scale[None], d_out)
        print(f"kernel check TP: gmm_int8_dense [{BUDGET}, {d_in}] x "
              f"[{d_in}, {d_out}] max_abs_err={err:.3g} (tol "
              f"{GMM_TOL['bfloat16']} (1 + |plain|); two launches "
              f"bit-identical) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.4f} "
              f"({bound_by}), the kernel at {bound_ms / ms:.1%} of it; "
              f"yardstick: torch.matmul on a pre-dequantized copy "
              f"{lib:.4f} ms", flush=True)
    E = MOE["num_expert"] // MOE_EP
    for variant, xdt in (("fp", torch.bfloat16), ("int8", torch.bfloat16),
                         ("int4", torch.bfloat16), ("fp", torch.float32)):
        dname = str(xdt).split(".")[-1]
        for d_in, d_out in ((D, F // MOE_TP), (F // MOE_TP, D)):
            x, w, scale = gmm_case(gm, variant, xdt, d_in, d_out, device)
            x, w = x[:E].contiguous(), w[:E].contiguous()
            scale = None if scale is None else scale[:E].contiguous()
            got = gm.grouped_expert_matmul(x, w, scale)
            torch.cuda.synchronize()
            err = close_or_fail(
                f"gmm_{variant} {dname} [{E}, {x.shape[1]}, {d_in}]", got,
                gm.grouped_matmul_reference(x, w, scale), GMM_TOL[dname])
            if not torch.equal(gm.grouped_expert_matmul(x, w, scale), got):
                fail(f"gmm_{variant} {dname} at TP shapes: two launches "
                     "differ")
            ms = cuda_ms(lambda: gm.grouped_expert_matmul(x, w, scale),
                         flush=flush)
            plain_ms = cuda_ms(lambda: gm.grouped_matmul_reference(
                x, w, scale), iters=5, flush=flush)
            w_lib = gm.dequantize(w, scale, d_in, xdt)
            lib = cuda_ms(lambda: torch.bmm(x, w_lib), flush=flush)
            bound_ms, bound_by = gmm_bound(x, w, scale, d_out)
            print(f"kernel check TP: gmm_{variant} {dname} "
                  f"{list(x.shape)} x [{E}, {d_in}, {d_out}] "
                  f"{str(w.dtype).split('.')[-1]} weights max_abs_err="
                  f"{err:.3g} (tol {GMM_TOL[dname]} (1 + |plain|); two "
                  f"launches bit-identical) kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by}), the kernel at "
                  f"{bound_ms / ms:.1%} of it; yardstick: torch.bmm"
                  f"{'' if scale is None else ' on a pre-dequantized copy'}"
                  f" {lib:.4f} ms", flush=True)


def check_mp_shapes(fa, ln, qp, device, flush):
    """Phase 3 at an mp rank's shapes of the train step (phase 6d's
    GPT-350M at mp = 2 with sequence parallelism), each kernel against
    its plain version, two launches bit-identical, timed beside its
    bound, its plain version and its library call (`check_flash`,
    `check_add_ln`, `check_qkv_proj`): bf16 at a rank's batch of 8, K1a
    forward and backward over the rank's 8 of 16 heads [8, 8, 1024, 64]
    and K2 over its S / 2 rows [4096, 1024]; fp32 at what phase 6d's mp
    x pp job gives the kernels, a micro-batch of 4 rows: K1a [4, 8, 1024,
    64], K2 [2048, 1024], and K5's forward x [4, 1024, 1024] into the
    rank's 8 heads. K5's backward is two plain fp32 products, no kernel:
    held against autograd's at 4096 rows it differs by the rounding of
    fp32 sums in another order, which reaches the fp32 tolerance."""
    import torch
    mp, heads = MESH["mp"], HEADS // MESH["mp"]
    micro = MESH_BATCH // MESH["micro_batches"]
    for dtype, rows in ((torch.bfloat16, TRAIN_BATCH),
                        (torch.float32, micro)):
        check_flash(fa, device, flush, dtypes=(dtype,),
                    shape=(rows, heads, TRAIN_SEQ, HIDDEN // HEADS),
                    label="kernel check mp")
        check_add_ln(ln, device, flush, dtypes=(dtype,),
                     rows=rows * TRAIN_SEQ // mp, label="kernel check mp")
    check_qkv_proj(qp, device, flush, batch=micro, heads=heads,
                   dtypes=(torch.float32,), grads=False,
                   label="kernel check mp")


def whole_lines():
    """Make this child process's standard output write each line whole:
    it shares one pipe with the parent and its siblings."""
    import io
    sys.stdout = io.TextIOWrapper(
        io.BufferedWriter(io.FileIO(sys.stdout.fileno(), "w",
                                    closefd=False), 1 << 16),
        line_buffering=True)


def tp_rank_main(rank, world, out_dir, job):
    """One rank of a TP phase: joins the gloo group of `world` processes
    on cuda:0 and saves `job(rank, world)`'s result. Its standard output
    writes each line whole (the ranks share one pipe)."""
    import datetime
    import os

    import torch
    import torch.distributed as dist
    whole_lines()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out_dir, "rendezvous"),
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=600))
    try:
        torch.save(job(rank, world), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def tp_run(world, job):
    """Run `job` in `world` spawned rank processes (`tp_rank_main`); a
    failed rank fails the phase (the others are stopped). Returns each
    rank's result."""
    import os
    import shutil

    import torch
    import torch.multiprocessing as mp
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke_tp", job.__name__)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    mp.start_processes(tp_rank_main, args=(world, out_dir, job),
                       nprocs=world, join=True, start_method="spawn")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def hold_counts(label, got, want):
    for name, n in got.items():
        if n != want.get(name, 0):
            fail(f"{label}: {name} launched {n} times, expected "
                 f"{want.get(name, 0)}")


def tp_dense_job(rank, world):
    """Phase 5m's dense half on one rank: GPT-350M's widths at TP_LAYERS,
    bf16,
    `TPServingEngine(tensor_parallel=2)` on phase 4's 16 requests
    (paged launches exactly steps x 24, rank 0's tokens within the
    near-tie oracle), a profiled decode window; then phase 5n's dense
    checks."""
    import torch
    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.serving.distributed import TPServingEngine
    device = torch.device("cuda:0")
    counters = [(m, attr, name) for name, m, attr, _r, _s in kernel_table()]
    t0 = time.perf_counter()
    model = load_jax_gpt(random_gpt_arrays(layers=TP_LAYERS), HEADS,
                         compute_dtype="bfloat16", device=device)
    eng = TPServingEngine(model, tensor_parallel=TP, device=device,
                          max_slots=SLOTS, block_size=BLOCK,
                          max_seq_len=MAX_SEQ, token_budget=BUDGET,
                          cache_dtype="bfloat16")
    eng.generate_batch([[1, 2, 3]], max_new_tokens=2)      # warm-up
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    label = f"serve TP rank {rank}/{world}"
    torch.cuda.reset_peak_memory_stats(device)
    outputs, got, run = serve_counted(eng, serve_prompts(), counters, label)
    hold_counts(label, got, {"paged_attention": run["steps"] * TP_LAYERS})
    print(f"{label}: GPT-350M's widths at {TP_LAYERS} layers, bf16, "
          f"{eng.kv.num_heads} of {HEADS} heads, "
          f"kv_bytes_per_token {eng.kv.kv_bytes_per_token}, built in "
          f"{build_s:.1f} s; {run['steps']} steps, {run['generated']} "
          f"generated tokens in {run['wall']:.3f} s = "
          f"{run['generated'] / run['wall']:.1f} tokens/s, "
          f"{run['wall'] / run['steps'] * 1e3:.2f} ms a step on the host "
          f"clock, mean TTFT {run['ttft'] * 1e3:.1f} ms, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated(device)}"
          f" B; paged_attention {got['paged_attention']} launches = steps "
          f"x {TP_LAYERS}", flush=True)
    if rank == 0:
        check_outputs(model, run["reqs"], device, label="check TP")
    prof = profile_decode(eng, f"GPT-350M TP={TP} rank {rank}", window=8,
                          kernel=PAGED_KERNELS)
    res = dict(outputs=outputs, steps=run["steps"], wall=run["wall"],
               generated=run["generated"], prof=prof)
    del eng, model, run
    torch.cuda.empty_cache()
    res["check"] = tp_check_dense(rank, device, counters)
    return res


def tp_check(rank, label, arrays, kw, make, want_launches, moe=None,
             counters=()):
    """Phase 5n, one engine: fp32 at 2 layers on the card under TP (every
    rank), and (rank 0) the card's 1-rank engine and a CPU copy (plain
    versions) of the same config: equal greedy tokens unless the first
    difference sat at an fp32 top-2 logit gap under 1e-5 (of the plain
    forward, teacher-forced). `want_launches(steps)`: the TP engine's
    launches, held exactly."""
    import numpy as np
    import torch
    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.serving.engine import ServingEngine
    rng = np.random.default_rng(SEED + 12)
    prompts = [rng.integers(0, VOCAB, int(n)).tolist()
               for n in (17, 40, 64, 9)]
    prompts[3] = prompts[3] * 5
    base = dict(max_slots=4, block_size=BLOCK, max_seq_len=128,
                token_budget=BUDGET, cache_dtype="float32", **kw)
    card = load_jax_gpt(arrays, HEADS, moe=moe, device="cuda:0")
    eng = make(card, base)
    for mod, attr, _ in counters:
        setattr(mod, attr, 0)
    steps0 = eng.steps_run
    got = eng.generate_batch(prompts, max_new_tokens=16)
    torch.cuda.synchronize()
    launches = {name: getattr(mod, attr) for mod, attr, name in counters}
    hold_counts(f"check TP {label} rank {rank}", launches,
                want_launches(eng.steps_run - steps0))
    del eng
    if rank:
        return got
    one = ServingEngine(card, device="cuda:0", **base).generate_batch(
        prompts, max_new_tokens=16)
    cpu_model = load_jax_gpt(arrays, HEADS, moe=moe, device="cpu")
    cpu = ServingEngine(cpu_model, device="cpu", **base).generate_batch(
        prompts, max_new_tokens=16)
    same1, total, gap1 = first_gap(cpu_model, prompts, got, one)
    same2, _, gap2 = first_gap(cpu_model, prompts, got, cpu)
    line = (f"check TP: {label}, fp32, 2 layers at full width: "
            f"{same1}/{total} greedy tokens equal to the card's 1-rank "
            f"engine (first gap {'none' if gap1 is None else f'{gap1:.3g}'}"
            f"), {same2}/{total} to a CPU copy (first gap "
            f"{'none' if gap2 is None else f'{gap2:.3g}'}); launches "
            + ", ".join(f"{n} {c}" for n, c in launches.items() if c))
    for g in (gap1, gap2):
        if g is not None and g >= 1e-5:
            fail(line + " — tokens differ past a near-tie")
    print(line, flush=True)
    del card, cpu_model
    torch.cuda.empty_cache()
    return got


def tp_check_dense(rank, device, counters):
    """Phase 5n's dense engines: draft_k=3 and the weight-only int8 stack
    (K4's dense route at the rank's widths, 4 launches a layer a step)
    at tp = 2."""
    from paddle_tpu_torch.serving.distributed import TPServingEngine
    arrays = random_gpt_arrays(SEED + 11, layers=2)

    def tp(model, base):
        return TPServingEngine(model, tensor_parallel=TP, device=device,
                               **base)
    return dict(
        spec=tp_check(rank, f"tp = {TP}, draft_k={DRAFT_K}", arrays,
                      dict(draft_k=DRAFT_K), tp,
                      lambda n: {"paged_verify": 2 * n,
                                 "paged_attention": 2 * n},
                      counters=counters),
        weight_only=tp_check(rank, f"tp = {TP}, weight-only int8",
                             quantized_arrays(arrays), {}, tp,
                             lambda n: {"paged_attention": 2 * n,
                                        "gmm_int8_dense": 8 * n},
                             counters=counters))


def tp_moe_job(rank, world):
    """Phase 5m's MoE half on one rank of tp = 2 x ep = 2: MoE-350M's
    widths at MOE_TP_LAYERS layers, bf16, int8 experts, on the 16
    requests (paged launches steps x L, gmm_int8 steps x 2 L, nothing
    else; routed + dropped = 2 x L x valid tokens), rank 0 also the
    1-rank engine of the same model; then phase 5n's MoE check."""
    import numpy as np
    import torch
    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.serving.distributed import TPServingEngine
    from paddle_tpu_torch.serving.engine import ServingEngine
    device = torch.device("cuda:0")
    counters = [(m, attr, name) for name, m, attr, _r, _s in kernel_table()]
    E, k, L = MOE["num_expert"], MOE["top_k"], MOE_TP_LAYERS
    model = load_jax_gpt(random_gpt_arrays(SEED + 8, layers=L, experts=E),
                         HEADS, moe=MOE, compute_dtype="bfloat16",
                         device=device, dtype=torch.bfloat16)
    kw = dict(max_slots=SLOTS, block_size=BLOCK, max_seq_len=MAX_SEQ,
              token_budget=BUDGET, cache_dtype="bfloat16",
              moe_weight_dtype="int8", device=device)
    eng = TPServingEngine(model, tensor_parallel=MOE_TP,
                          expert_parallel=MOE_EP, **kw)
    eng.generate_batch([[1, 2, 3]], max_new_tokens=2)      # warm-up
    counts0, dropped0 = eng.moe_expert_counts.copy(), eng.moe_dropped_total
    label = (f"serve TP MoE rank {rank}/{world} (mp rank {eng.mp_rank}, "
             f"ep rank {eng.ep_rank})")
    outputs, got, run = serve_counted(eng, serve_prompts(), counters, label)
    counts = eng.moe_expert_counts - counts0
    dropped = eng.moe_dropped_total - dropped0
    hold_counts(label, got, {"paged_attention": run["steps"] * L,
                             "gmm_int8": run["steps"] * 2 * L})
    if not np.all(np.isfinite(counts)) or \
            counts.sum() + dropped != k * L * run["fed"]:
        fail(f"{label}: {counts.sum()} routed + {dropped} dropped choices "
             f"!= {k} x {L} layers x {run['fed']} tokens")
    print(f"{label}: MoE-350M widths at {L} layers, int8 experts, "
          f"{E // MOE_EP} of {E} experts and {eng.kv.num_heads} of {HEADS} "
          f"heads on this rank; {run['steps']} steps, {run['generated']} "
          f"generated tokens in {run['wall']:.3f} s, "
          f"{run['wall'] / run['steps'] * 1e3:.2f} ms a step on the host "
          f"clock; {run['fed']} valid tokens fed, routed {counts.sum():.0f}"
          f" + dropped {dropped:.0f} = {k} x {L} x {run['fed']}; launches "
          f"paged_attention {got['paged_attention']}, gmm_int8 "
          f"{got['gmm_int8']}", flush=True)
    prof = profile_decode(eng, f"MoE-350M ({L} layers) int8 experts "
                          f"TP={MOE_TP} x EP={MOE_EP} rank {rank}",
                          window=4, kernel="gmm")
    res = dict(outputs=outputs, counts=counts.tolist(), dropped=dropped,
               steps=run["steps"], wall=run["wall"], prof=prof)
    del eng
    if rank == 0:
        one = ServingEngine(model, **kw)
        one.generate_batch([[1, 2, 3]], max_new_tokens=2)
        one_out, _, one_run = serve_counted(one, serve_prompts(), counters,
                                            "serve TP MoE 1-rank")
        res["one"] = dict(outputs=one_out, steps=one_run["steps"],
                          wall=one_run["wall"])
        del one
    del model
    torch.cuda.empty_cache()

    def tp(m, base):
        return TPServingEngine(m, tensor_parallel=MOE_TP,
                               expert_parallel=MOE_EP, device=device, **base)
    res["check"] = tp_check(
        rank, f"MoE float experts, tp = {MOE_TP} x ep = {MOE_EP}",
        random_gpt_arrays(SEED + 9, layers=2, experts=E), {}, tp,
        lambda n: {"paged_attention": 2 * n, "gmm_fp": 4 * n}, moe=MOE,
        counters=counters)
    return res


def serve_tp(base, base_prof):
    """Phases 5m and 5n: the dense job on 2 ranks, then the MoE job on 4,
    each rank a process on cuda:0 over gloo. Every rank's tokens must
    equal rank 0's; host and device ms a step printed beside phase 4's
    1-rank engine (the ranks share one card: not TP speed)."""
    t0 = time.perf_counter()
    dense = tp_run(TP, tp_dense_job)
    for r, res in enumerate(dense[1:], 1):
        if res["outputs"] != dense[0]["outputs"] or \
                res["check"] != dense[0]["check"]:
            fail(f"serve TP: rank {r}'s tokens differ from rank 0's")

    def ms(p, key):
        return "not measured" if p[key] is None else f"{p[key]:.3f}"
    print(f"serve TP: tp = {TP} on one card over gloo, {TP_LAYERS} layers, "
          f"every rank's tokens equal; "
          + "; ".join(f"rank {r}: {res['generated'] / res['wall']:.1f} "
                      f"tokens/s, decode step {ms(res['prof'], 'host_ms')}"
                      f" ms host, {ms(res['prof'], 'device_ms')} ms device"
                      for r, res in enumerate(dense))
          + f"; 1-rank engine (phase 4, {LAYERS} layers): "
          f"{base['tokens_s']:.1f} tokens/s, "
          f"decode step {ms(base_prof, 'host_ms')} ms host, "
          f"{ms(base_prof, 'device_ms')} ms device; in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    moe = tp_run(MOE_TP * MOE_EP, tp_moe_and_train_job)
    for r, res in enumerate(moe[1:], 1):
        if (res["outputs"], res["counts"], res["check"]) != \
                (moe[0]["outputs"], moe[0]["counts"], moe[0]["check"]):
            fail(f"serve TP MoE: rank {r}'s tokens or routing counts "
                 "differ from rank 0's")
    one = moe[0]["one"]
    same = sum(a == b for o, w in zip(moe[0]["outputs"], one["outputs"])
               for a, b in zip(o, w))
    print(f"serve TP MoE: tp = {MOE_TP} x ep = {MOE_EP}, {MOE_TP_LAYERS} "
          f"layers, every rank's tokens and routing counts equal; "
          f"{same}/{sum(map(len, one['outputs']))} tokens equal to the "
          f"1-rank engine's (bf16, reported); "
          + "; ".join(f"rank {r}: {res['wall'] / res['steps'] * 1e3:.2f} ms"
                      f" a step host, decode step "
                      f"{ms(res['prof'], 'device_ms')} ms device"
                      for r, res in enumerate(moe))
          + f"; 1-rank engine {one['wall'] / one['steps'] * 1e3:.2f} ms a "
          f"step host; in {time.perf_counter() - t0:.1f} s, phase 6d's "
          f"rank steps included", flush=True)
    return [res["mesh"] for res in moe]


def tp_moe_and_train_job(rank, world):
    """Phase 5n's MoE job, then phase 6d's train jobs (`mesh_train_job`),
    in one spawn of the 4 ranks: a rank process's start and its first
    launches take longer than any job's own steps."""
    res = tp_moe_job(rank, world)
    res["mesh"] = mesh_train_job(rank, world)
    return res


# ------------------------------------------------- phases 5o and 5p

#: the disaggregated fleet: one prefill replica and two decode replicas
DISAGG_ROLES = ("prefill", "decode", "decode")
#: the payload of one bf16 GPT-350M block: L x BS x H x Dh x 2 B x (k, v)
BLOCK_BYTES = LAYERS * BLOCK * HEADS * (HIDDEN // HEADS) * 2 * 2


def timed_transport():
    """The router's default transport, `InProcessTransport` (every
    block through the codec), timing its calls: `seconds` in the
    codec, `frames` sent and `ahead` (the blocks streamed ahead of their
    ticket). Every call comes from the event loop's thread."""
    from paddle_tpu_torch.serving.distributed import InProcessTransport

    class Timed(InProcessTransport):
        def __init__(self):
            super().__init__()
            self.seconds, self.frames, self.ahead = 0.0, 0, 0
            self._in_ticket = False

        def send_chunk(self, src, dst, key, meta, chunk):
            t0 = time.perf_counter()
            super().send_chunk(src, dst, key, meta, chunk)
            self.frames += 1
            if not self._in_ticket:
                self.seconds += time.perf_counter() - t0
                self.ahead += chunk.count

        def send_ticket(self, src, dst, key, ticket):
            t0 = time.perf_counter()
            self._in_ticket = True
            try:
                super().send_ticket(src, dst, key, ticket)
            finally:
                self._in_ticket = False
            self.frames += 1
            self.seconds += time.perf_counter() - t0

    return Timed()


def disagg_fleet(model, device, roles=DISAGG_ROLES, per_role=None, **kw):
    """(router, engines): one `ServingEngine` a role on `device` behind a
    `ReplicaRouter` over `timed_transport()`; `kw` for every engine and
    `per_role` {role: kw} on top. Each engine's block export and import
    is timed into its `moved` dict, and the paged-attention launches
    its steps make are tallied into its `launches` {kernel name: n}
    from the stepping thread's own counts, so each replica's launches
    are known while the others launch from their threads."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving.distributed import ReplicaRouter
    from paddle_tpu_torch.serving.engine import ServingEngine
    from paddle_tpu_torch.serving.frontend import ServingFrontend
    names = {attr: name for name, m, attr, _r, _s in kernel_table()
             if m is pa}
    engines = []
    for i, role in enumerate(roles):
        eng = ServingEngine(model, role=role, name=f"{role}{i}",
                            device=device,
                            **dict(kw, **(per_role or {}).get(role, {})))
        eng.launches = dict.fromkeys(names.values(), 0)

        def counted(*a, _step=eng.step, _tally=eng.launches, **k):
            before = pa.thread_counts()
            try:
                return _step(*a, **k)
            finally:
                for attr, n in pa.thread_counts().items():
                    _tally[names[attr]] += n - before.get(attr, 0)
        eng.step = counted
        eng.moved = {"export": 0.0, "import": 0.0}
        for what in ("export", "import"):
            fn = getattr(eng.kv, f"{what}_blocks")

            def timed(*a, _fn=fn, _what=what, _m=eng.moved):
                t0 = time.perf_counter()
                try:
                    return _fn(*a)
                finally:
                    _m[_what] += time.perf_counter() - t0
            setattr(eng.kv, f"{what}_blocks", timed)
        engines.append(eng)
    router = ReplicaRouter([ServingFrontend(e, max_pending=64)
                            for e in engines], roles=list(roles),
                           transport=timed_transport())
    return router, engines


async def fleet_stream(router, prompts, new, during=None):
    """Every prompt through `router.stream` at once; `during(router)` runs
    beside the streams (a shed, a crash). Returns (outputs, each
    request's token arrival times, the start time)."""
    import asyncio
    t0 = time.perf_counter()
    times = [[] for _ in prompts]

    async def one(i, p):
        out = []
        async for tok in router.stream(p, new):
            times[i].append(time.perf_counter())
            out.append(tok)
        return out
    tasks = [asyncio.ensure_future(one(i, p)) for i, p in enumerate(prompts)]
    if during is not None:
        await during(router)
    return list(await asyncio.gather(*tasks)), times, t0


def live_decode(engines, idxs, min_tokens):
    """The first of replicas `idxs` holding a decode with at least
    `min_tokens` tokens out, or None."""
    for i in idxs:
        if any(r is not None and r.state == "decode"
               and len(r.output) >= min_tokens
               for r in engines[i].scheduler.slots):
            return i
    return None


def shed_hop(engines, idxs, min_tokens=8):
    """A `during` for `fleet_stream`: one `router.shed(i, 1)` on a decode
    replica of `idxs` once one holds a live decode (60 s at most)."""
    import asyncio

    async def during(router):
        for _ in range(60_000):
            i = live_decode(engines, idxs, min_tokens)
            if i is not None and router.shed(i, 1):
                return
            await asyncio.sleep(0.001)
        fail("no decode replica held a live decode to shed")
    return during


class _Counts:
    """A snapshot of the fleet's counters, so a run reads its own
    deltas."""

    def __init__(self, router, engines):
        st = router.stats()
        self.migrations = dict(st["migrations"])
        self.transport = dict(st["transport"])
        t = router.transport
        self.timed = (t.seconds, t.frames, t.ahead)
        self.engines = [(e.steps_run, e.kv.blocks_exported,
                         e.kv.blocks_imported, dict(e.moved),
                         dict(e.launches)) for e in engines]


def fleet_deltas(router, engines, before):
    """The counters a run moved: migrations, transport, timed codec,
    and each engine's steps, blocks exported, blocks imported, its
    export / import seconds and its paged-attention launches."""
    now = _Counts(router, engines)
    return dict(
        migrations={k: v - before.migrations.get(k, 0)
                    for k, v in now.migrations.items()},
        transport={k: v - before.transport[k]
                   for k, v in now.transport.items()},
        seconds=now.timed[0] - before.timed[0],
        frames=now.timed[1] - before.timed[1],
        ahead=now.timed[2] - before.timed[2],
        steps=[a[0] - b[0] for a, b in zip(now.engines, before.engines)],
        exported=[a[1] - b[1] for a, b in zip(now.engines, before.engines)],
        imported=[a[2] - b[2] for a, b in zip(now.engines, before.engines)],
        moved={w: sum(a[3][w] - b[3][w] for a, b in zip(
            now.engines, before.engines)) for w in ("export", "import")},
        launches=[{k: n - b[4][k] for k, n in a[4].items() if n - b[4][k]}
                  for a, b in zip(now.engines, before.engines)])


def hold_fleet(label, engines, d, outputs, new, per_replica, got,
               handoffs, sheds, payload=None, dropped=False):
    """The checks of a fleet run: every request finished with its full
    horizon, the handoffs and sheds counted, every block exported once,
    sent once and imported once (`dropped`: a failover dropped transfers
    in flight, so fewer are imported; with `payload`, the transport's
    bytes exactly blocks x payload plus frame headers), each replica's
    launches exactly its `per_replica` {kernel name: n} (those made by
    its steps), the run's counts (`got`) exactly their sum, and every
    replica of `engines` drained with its allocator whole."""
    if any(len(o) != new for o in outputs):
        fail(f"{label}: not every request finished with its full horizon")
    if d["migrations"] != {"handoff": handoffs, "shed": sheds}:
        fail(f"{label}: migrations {d['migrations']}, expected "
             f"{handoffs} handoffs and {sheds} sheds")
    sent = d["transport"]["blocks_sent"]
    imported = sum(d["imported"])
    if sent != sum(d["exported"]) or (imported > sent if dropped
                                      else imported != sent):
        fail(f"{label}: blocks sent {sent}, exported {d['exported']}, "
             f"imported {d['imported']}")
    if payload is not None:
        headers = d["transport"]["bytes_sent"] - sent * payload
        if not 0 < headers < 4096 * d["frames"]:
            fail(f"{label}: {d['transport']['bytes_sent']} bytes sent for "
                 f"{sent} blocks of {payload} B in {d['frames']} frames")
    for i, (want, mine) in enumerate(zip(per_replica, d["launches"])):
        if mine != {k: n for k, n in want.items() if n}:
            fail(f"{label}: replica {i}'s steps launched {mine}, expected "
                 f"{want}")
    hold_counts(label, got, {k: sum(w.get(k, 0) for w in per_replica)
                             for k in got})
    for e in engines:
        if e.prefix_cache is not None:
            e.prefix_cache.evict_all()
        if e.kv.blocks_in_use or not e.kv.allocator.invariant_ok:
            fail(f"{label}: replica {e.name} holds {e.kv.blocks_in_use} "
                 "blocks after the drain (or its allocator is broken)")


def serve_disagg(model, device, counters, dense_out, base):
    """Phase 5o: GPT-350M (phase 5a's model, bf16, full depth) served by
    a disaggregated fleet — one `role="prefill"` replica and two
    `role="decode"` replicas with phase 4's engine settings behind a
    `ReplicaRouter` over `InProcessTransport` — on the 16 requests, all
    streamed at once. Holds: every request finishes with its full
    horizon, 16 handoffs, every block exported once, sent once and
    imported once, the payload exactly blocks x 1,572,864 B (the rest
    frame headers), the ragged paged kernel launched by each replica
    exactly its own steps x 24 and nothing else, every replica drained,
    the tokens within phase 5's near-tie oracle. All 16 requests start
    together, when both decode replicas are equally idle, so the router
    (the JAX package's placement rule: least queued, then lowest index)
    hands every one to the first decode replica; the second decodes
    only in the second run, the same with one `router.shed(i, 1)` hop
    on a decode replica mid-stream. Prints
    tokens/s and TTFT beside phase 4's, the mean inter-token gap, steps
    a replica, the share of blocks streamed ahead of their ticket, the
    codec's, export's and import's seconds."""
    import asyncio
    from types import SimpleNamespace

    import torch
    t_phase = time.perf_counter()
    prompts = serve_prompts()
    router, engines = disagg_fleet(
        model, device, max_slots=SLOTS, block_size=BLOCK,
        max_seq_len=MAX_SEQ, token_budget=BUDGET, cache_dtype="bfloat16")
    runs = {}

    async def drive():
        async with router:
            # warm-up: a few requests, so that every replica has run
            await asyncio.gather(*[router.submit([1, 2, 3, i], 2)
                                   for i in range(4)])
            torch.cuda.synchronize()
            for label, during in (("serve disagg", None),
                                  ("serve disagg shed", shed_hop(
                                      engines, (1, 2)))):
                before = _Counts(router, engines)
                for mod, attr, _ in counters:
                    setattr(mod, attr, 0)
                outs, times, t0 = await fleet_stream(router, prompts,
                                                     NEW_TOKENS, during)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = {name: getattr(mod, attr)
                       for mod, attr, name in counters}
                runs[label] = (outs, times, t0, wall, got,
                               fleet_deltas(router, engines, before))
    asyncio.run(drive())
    for label, (outs, times, t0, wall, got, d) in runs.items():
        shed = 1 if label.endswith("shed") else 0
        hold_fleet(label, engines, d, outs, NEW_TOKENS,
                   [{"paged_attention": n * LAYERS} for n in d["steps"]],
                   got, handoffs=len(prompts), sheds=shed,
                   payload=BLOCK_BYTES)
        generated = sum(map(len, outs))
        ttft = sum(t[0] - t0 for t in times) / len(times)
        gaps = [b - a for t in times for a, b in zip(t, t[1:])]
        same = sum(a == b for o, w in zip(outs, dense_out)
                   for a, b in zip(o, w))
        sent = d["transport"]["blocks_sent"]
        print(f"{label}: roles {list(DISAGG_ROLES)}, phase 4's engine "
              f"settings, InProcessTransport; {len(prompts)} "
              f"requests, {generated} generated tokens in {wall:.3f} s = "
              f"{generated / wall:.1f} tokens/s (phase 4: "
              f"{base['tokens_s']:.1f}), mean TTFT {ttft * 1e3:.1f} ms "
              f"(phase 4: {base['ttft_ms']:.1f}), mean inter-token gap "
              f"{sum(gaps) / len(gaps) * 1e3:.2f} ms; steps per replica "
              f"{d['steps']}; migrations {d['migrations']}; blocks sent "
              f"{sent} (exported {d['exported']}, imported "
              f"{d['imported']}), {d['transport']['bytes_sent']} B = "
              f"{sent} x {BLOCK_BYTES} B + "
              f"{d['transport']['bytes_sent'] - sent * BLOCK_BYTES} B of "
              f"headers in {d['frames']} frames; {d['ahead']}/{sent} = "
              f"{d['ahead'] / sent:.1%} streamed ahead of the tickets; "
              f"codec {d['seconds']:.3f} s, export {d['moved']['export']:.3f}"
              f" s, import {d['moved']['import']:.3f} s (wall, host clock);"
              f" paged_attention launches {got['paged_attention']}, each "
              f"replica's = its steps x {LAYERS} ("
              + ", ".join(str(x.get("paged_attention", 0))
                          for x in d["launches"])
              + f"); {same}/{generated} tokens equal to phase 4's",
              flush=True)
        check_outputs(model, [SimpleNamespace(req_id=i, prompt=p, output=o)
                              for i, (p, o) in enumerate(zip(prompts, outs))],
                      device, label=f"check {label[6:]}")
    del router, engines
    torch.cuda.empty_cache()
    print(f"serve disagg: phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def check_disagg_on_card(device, counters):
    """Phase 5p: fp32, 2 layers at full width, 4 requests of 16 new
    tokens (prompts of 40-200 tokens over a 64-token budget, so blocks
    stream ahead), the same geometry on every engine. The fleet's greedy
    tokens must equal the card's monolithic engine's and those of the
    same fleet on the CPU (plain versions), with no near-tie used, in
    four cases: (1) the float pool, 1 prefill + 2 decode replicas;
    (2) int8 pools with draft_k=2 on the decode role and
    prefix_caching=True on the prefill role; (3) one shed hop between
    the decode replicas; (4) two prefill replicas and one decode
    replica, the first prefill replica's step raising mid-prefill (its
    requests restart on the other). Launches held in each, replica by
    replica: the ragged variant its steps x 2, the verify variant its
    steps x 2 on a decode replica with draft_k, nothing else. Cases 1,
    3 and 4 share one monolithic reference (the same engine settings).
    Prints each case's wall seconds."""
    import asyncio

    import numpy as np
    import torch
    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.serving.engine import ServingEngine
    t_phase = time.perf_counter()
    layers = 2
    arrays = random_gpt_arrays(SEED + 71, layers=layers)
    models = {str(d): load_jax_gpt(arrays, HEADS, device=d)
              for d in (device, "cpu")}
    rng = np.random.default_rng(SEED + 72)
    prompts = [rng.integers(0, VOCAB, int(n)).tolist()
               for n in (40, 200, 97, 151)]
    geo = dict(max_slots=4, block_size=BLOCK, max_seq_len=256,
               token_budget=64, cache_dtype="float32")
    int8 = dict(kv_dtype="int8")
    cases = (
        ("float", DISAGG_ROLES, {}, {}, None),
        ("int8 + draft_k=2 + prefix", DISAGG_ROLES, int8,
         {"decode": dict(draft_k=2), "prefill": dict(prefix_caching=True)},
         None),
        ("shed hop", DISAGG_ROLES, {}, {}, "shed"),
        ("prefill failover", ("prefill", "prefill", "decode"), {}, {},
         "crash"))

    def serve_fleet(dev, roles, kw, per_role, event):
        router, engines = disagg_fleet(models[str(dev)], dev, roles=roles,
                                       per_role=per_role, **geo, **kw)
        during = None
        if event == "shed":
            during = shed_hop(engines, (1, 2), min_tokens=4)
        elif event == "crash":
            real, calls = engines[0].step, [0]

            def flaky():
                calls[0] += 1
                if calls[0] > 1:
                    raise RuntimeError("injected prefill crash")
                return real()
            engines[0].step = flaky

        async def drive():
            async with router:
                before = _Counts(router, engines)
                for mod, attr, _ in counters:
                    setattr(mod, attr, 0)
                outs, _, _ = await fleet_stream(router, prompts, 16, during)
                if torch.device(dev).type == "cuda":
                    torch.cuda.synchronize()
                got = {name: getattr(mod, attr)
                       for mod, attr, name in counters}
                return outs, got, fleet_deltas(router, engines, before)
        outs, got, d = asyncio.run(drive())
        return outs, got, d, router, engines

    monos = {}                      # the card's monolithic tokens by kw
    for label, roles, kw, per_role, event in cases:
        t_case = time.perf_counter()
        mono_kw = dict(kw, **({"draft_k": 2, "prefix_caching": True}
                              if per_role else {}))
        key = tuple(sorted(mono_kw.items()))
        if key not in monos:
            mono = ServingEngine(models[str(device)], device=device, **geo,
                                 **mono_kw)
            monos[key] = mono.generate_batch(prompts, 16)
            del mono
        want = monos[key]
        t_fleet = time.perf_counter()
        got_out, got, d, router, engines = serve_fleet(
            device, roles, kw, per_role, event)
        t_cpu = time.perf_counter()
        cpu_out, _, _, _, _ = serve_fleet("cpu", roles, kw, per_role, event)
        t_end = time.perf_counter()
        ragged = ("paged_int8" if kw.get("kv_dtype") == "int8"
                  else "paged_attention")
        per_replica = [{ragged: n * layers} for n in d["steps"]]
        if per_role:
            for want_i, n, e in zip(per_replica, d["steps"], engines):
                if e.draft_k:
                    want_i["paged_verify_int8"] = n * layers
        alive = [e for e in engines if not (event == "crash"
                                            and e is engines[0])]
        hold_fleet(f"check disagg {label}", alive, d, got_out, 16,
                   per_replica, got, handoffs=len(prompts),
                   sheds=1 if event == "shed" else 0,
                   dropped=event == "crash")
        same, total, gap = first_gap(models["cpu"], prompts, got_out, want)
        c_same, _, c_gap = first_gap(models["cpu"], prompts, got_out,
                                     cpu_out)
        line = (f"check disagg: fp32, {layers} layers at full width, "
                f"{label}, roles {list(roles)}: {same}/{total} greedy "
                f"tokens equal to the card's monolithic engine, "
                f"{c_same}/{total} to the same fleet on the CPU (first "
                f"differing token's fp32 top-2 gap "
                f"{'none' if gap is None else f'{gap:.3g}'} / "
                f"{'none' if c_gap is None else f'{c_gap:.3g}'}, no near-"
                f"tie used); steps per replica {d['steps']}, migrations "
                f"{d['migrations']}, failovers {router.failovers}, blocks "
                f"sent {d['transport']['blocks_sent']} ({d['ahead']} "
                f"streamed ahead); launches "
                + ", ".join(f"{n} {k}" for n, k in got.items() if k)
                + f", each replica's its steps x {layers}; wall "
                f"{t_fleet - t_case:.1f} s monolithic, "
                f"{t_cpu - t_fleet:.1f} s card fleet, "
                f"{t_end - t_cpu:.1f} s CPU fleet")
        print(line, flush=True)
        if gap is not None or c_gap is not None:
            fail(line + " — the fleet's tokens differ")
        if event == "crash" and not router.failovers:
            fail(line + " — the injected crash caused no failover")
        del router, engines
    del models
    torch.cuda.empty_cache()
    print(f"check disagg: phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# ------------------------------------------------- phases 5r, 5s and 5t


GEN_ROWS = 8        # serve generate's batch: the first 8 serve prompts


def gen_batch():
    """The first GEN_ROWS serve prompts right-padded into one [8, S]
    batch, with their true lengths."""
    import numpy as np
    prompts = serve_prompts()[:GEN_ROWS]
    ids = np.zeros((GEN_ROWS, max(map(len, prompts))), np.int64)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    return prompts, ids, np.array([len(p) for p in prompts], np.int32)


def gen_run(model, ids, lens, counters, label, **kw):
    """One timed `generate()` of NEW_TOKENS on the batch, every kernel
    counter zeroed just before and read just after. Returns (tokens
    [B, M] as lists, gen_lens, the launches, ms a step)."""
    import torch
    device = model.word_embeddings.weight.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for mod, attr, _ in counters:
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    toks, glens = model.generate(ids, max_new_tokens=NEW_TOKENS,
                                 seq_lens=lens, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: getattr(mod, attr) for mod, attr, name in counters}
    toks = toks.cpu()
    if toks.shape != (len(ids), NEW_TOKENS) or toks.dtype != torch.int32 \
            or not ((toks >= 0) & (toks < VOCAB)).all():
        fail(f"{label}: generate() gave {tuple(toks.shape)} {toks.dtype} "
             "ids outside the vocabulary or the shape")
    ms = wall * 1e3 / NEW_TOKENS
    print(f"{label}: {len(ids)} rows x {NEW_TOKENS} new tokens in "
          f"{wall:.3f} s = {ms:.2f} ms a token (a step of every row), "
          f"{len(ids) * NEW_TOKENS / wall:.1f} tokens/s, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated(device)}"
          f" B; launches " + ", ".join(f"{n} {v}" for n, v in
                                       launches.items() if v), flush=True)
    return toks.tolist(), glens.cpu().tolist(), launches, ms


def hold_gen_launches(label, launches, want):
    """Every kernel's launches in a generate() run equal `want` (0 where
    it names none)."""
    for name, n in launches.items():
        if n != want.get(name, 0):
            fail(f"{label}: {name} launched {n} times, expected "
                 f"{want.get(name, 0)}")


def gen_oracle(model, prompts, toks, device, label, rows=None):
    """Phase 5's near-tie oracle over generate()'s rows."""
    from types import SimpleNamespace
    reqs = [SimpleNamespace(req_id=i, prompt=list(prompts[i]),
                            output=list(toks[i]))
            for i in (range(len(prompts)) if rows is None else rows)]
    check_outputs(model, reqs, device, label)


def serve_generate(model, device, counters):
    """Phase 5r: `GPTForGeneration.generate()` on GPT-350M (phase 5a's
    model, bf16) over the first 8 serve prompts with their true
    seq_lens, 64 new tokens: greedy with use_scan True and False (the
    same tokens, within the near-tie oracle), draft_k=3 (every token
    within the oracle; in bf16 it may part from the scan at a near
    tie), seeded sampling twice (the same tokens); no kernel launched
    (the dense-cache attention is plain torch, as JAX's is XLA). Then
    the weight-only twin: K4's dense route exactly 64 forwards x 4 x 24.

    The oracle (`check_outputs`, through `GPTForGeneration.forward`)
    runs the same dense attention (`_layer_body`, `_sdp`) as
    generate()'s prefill, so on the card it does not hold that
    attention independently; the CPU tests hold it against the JAX
    package's."""
    t_phase = time.perf_counter()
    prompts, ids, lens = gen_batch()
    # warm-up at the runs' shapes (the first S = 512 prefill and decode
    # steps allocate)
    model.generate(ids, max_new_tokens=2, seq_lens=lens)
    runs = {}
    for label, kw in (("greedy scan", {}), ("greedy loop",
                                             dict(use_scan=False)),
                      ("draft_k=3", dict(draft_k=3)),
                      ("sampling", dict(decode_strategy="sampling",
                                        top_k=50, top_p=0.9, seed=11)),
                      ("sampling again", dict(decode_strategy="sampling",
                                              top_k=50, top_p=0.9,
                                              seed=11))):
        toks, glens, launches, ms = gen_run(
            model, ids, lens, counters, f"serve generate {label}", **kw)
        hold_gen_launches(f"serve generate {label}", launches, {})
        if glens != [NEW_TOKENS] * len(ids):
            fail(f"serve generate {label}: gen_lens {glens}")
        runs[label] = toks
    if runs["greedy loop"] != runs["greedy scan"]:
        fail("serve generate: the greedy loop differs from the scan")
    if runs["sampling again"] != runs["sampling"]:
        fail("serve generate: two seeded sampling runs differ")
    # a verify pass scores 4 positions in one [32, D] product where a
    # decode step multiplies [8, D]: bf16 rounds the two differently, so
    # the speculative run may leave the scan at a near tie (each run's
    # every token is held by the near-tie oracle below)
    same, total, gap = first_gap(model, prompts, runs["draft_k=3"],
                                 runs["greedy scan"])
    print(f"serve generate: greedy scan = loop; draft_k=3 equal to the "
          f"scan {same}/{total} (fp32 top-2 gap at the first difference "
          f"{gap}), {len(model.last_accept_counts)} verify steps for "
          f"{NEW_TOKENS - 1} tokens a row; seeded sampling repeats "
          "itself", flush=True)
    gen_oracle(model, prompts, runs["greedy scan"], device,
               "check generate")
    if same != total:
        gen_oracle(model, prompts, runs["draft_k=3"], device,
                   "check generate draft_k=3")
    wo = weight_only_copy(model, device)
    wo.generate(ids, max_new_tokens=2, seq_lens=lens)
    toks, _, launches, _ = gen_run(wo, ids, lens, counters,
                                   "serve generate weight-only")
    hold_gen_launches("serve generate weight-only", launches,
                      {"gmm_int8_dense": NEW_TOKENS * 4 * LAYERS})
    gen_oracle(wo, prompts, toks, device, "check generate weight-only",
               rows=(0, 1))
    del wo
    print(f"serve generate: phase took {time.perf_counter() - t_phase:.1f} "
          "s", flush=True)


def serve_generate_moe(model, device, counters):
    """Phase 5r, MoE: greedy generate() on MoE-350M at MOE_LAYERS (phase
    5b's model): K4's float experts exactly 64 forwards x 2 x layers."""
    prompts, ids, lens = gen_batch()
    model.generate(ids, max_new_tokens=2, seq_lens=lens)
    _, _, launches, _ = gen_run(model, ids, lens, counters,
                                "serve generate MoE")
    hold_gen_launches("serve generate MoE", launches,
                      {"gmm_fp": NEW_TOKENS * 2 * MOE_LAYERS})


def ordered(model, arrays):
    """`arrays` ({name: array}, random_gpt_arrays') in the model's
    `_gen_tensors()` order: a checkpoint for `swap_weights`."""
    return [arrays[n] for n in model.gen_names()]


async def fleet_requests(router, prompts, new):
    import asyncio
    return await asyncio.gather(*[router.submit(list(p), max_new_tokens=new)
                                  for p in prompts])


async def only_on(router, idx, prompts, new):
    """`prompts` served by replica `idx` alone (every other live replica
    quiesced for the call)."""
    others = [i for i in range(len(router.frontends))
              if i != idx and i not in router._quiesced]
    for i in others:
        router.quiesce(i)
    try:
        return await fleet_requests(router, prompts, new)
    finally:
        for i in others:
            router.unquiesce(i)


def serve_fleet(model, device, counters):
    """Phase 5s: the fleet plane at full width. `create_fleet_controller`
    over 2 GPT-350M replicas (phase 5a's model, phase 4's engine
    settings with prefix caching) exports the v1 bundle into a temporary
    directory; `boot_replica` boots a third from it (a probe prompt;
    cold start printed; no nvcc run); `rolling_upgrade` flips the fleet
    to v2 weights (another numpy seed) while the 16 requests stream
    (none may fail); an `SLOAutoscaler` on a tight TTFT target records
    one scale-up (a boot from the bundle), then on a loose one a
    scale-down (a retire with a prefix spill). The registry's FLEET_*
    series equal the controller's own events."""
    import asyncio
    import tempfile

    import torch
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.profiler import metrics as pm
    from paddle_tpu_torch.serving import metrics as sm
    from paddle_tpu_torch.serving.fleet import (AutoscalerPolicy,
                                                SLOAutoscaler)
    from paddle_tpu_torch.serving.slo import SLOMonitor
    t_phase = time.perf_counter()
    prompts = serve_prompts()
    w2 = ordered(model, random_gpt_arrays(SEED + 90))
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_")
    pm.REGISTRY.reset()
    pm.enable()
    try:
        cfg = inference.Config().enable_continuous_batching(
            max_slots=SLOTS, block_size=BLOCK, max_seq_len=MAX_SEQ,
            token_budget=BUDGET, cache_dtype="bfloat16",
            prefix_caching=True, num_replicas=2)
        t0 = time.perf_counter()
        router, ctl = inference.create_fleet_controller(
            cfg, model, bundle_root=tmp.name, version="v1",
            spill_dir=os.path.join(tmp.name, "spill"), device=device)
        print(f"serve fleet: 2 replicas built and the v1 bundle exported "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)

        async def run():
            async with router:
                await fleet_requests(router, [[1, 2, 3]] * 2, 2)
                runs = _build.nvcc_runs
                cold0 = sm.FLEET_COLD_START.sum
                idx = await ctl.boot_replica(probe_prompt=prompts[0],
                                             probe_tokens=1)
                if _build.nvcc_runs != runs:
                    fail(f"serve fleet: the boot ran "
                         f"{_build.nvcc_runs - runs} nvcc builds")
                print(f"serve fleet: replica {idx} booted from the bundle "
                      f"in {sm.FLEET_COLD_START.sum - cold0:.2f} s to its "
                      "first token "
                      f"(cold), 0 nvcc runs", flush=True)
                t0 = time.perf_counter()
                tasks = [asyncio.ensure_future(router.submit(
                    list(p), max_new_tokens=NEW_TOKENS)) for p in prompts]
                await asyncio.sleep(0.05)
                flipped = await ctl.rolling_upgrade(w2, "v2")
                outs = await asyncio.gather(*tasks)
                upgrade_s = time.perf_counter() - t0
                if any(len(o) != NEW_TOKENS for o in outs):
                    fail("serve fleet: a request streamed through the "
                         "upgrade came back short")
                versions = router.stats()["versions"]
                print(f"serve fleet: rolling upgrade flipped {flipped} to "
                      f"v2 while {len(prompts)} requests streamed "
                      f"({sum(map(len, outs))} tokens, none failed) in "
                      f"{upgrade_s:.2f} s; versions {versions}", flush=True)
                if versions != ["v2"] * 3 or sorted(flipped) != [0, 1, 2]:
                    fail(f"serve fleet: versions {versions} after the "
                         "upgrade")
                tight = SLOMonitor({"default": {"ttft_p95": 1e-4}})
                scaler = SLOAutoscaler(ctl, tight, policy=AutoscalerPolicy(
                    min_replicas=3, max_replicas=4, sustain_s=0.0,
                    recovery_s=0.0, cooldown_s=0.0))
                for p in prompts[:4]:
                    t0 = time.perf_counter()
                    async for _ in router.stream(list(p), 1):
                        ttft = time.perf_counter() - t0
                    tight.on_ttft("default", ttft, tight.clock())
                    if await scaler.step():
                        break
                up = scaler.decisions[-1] if scaler.decisions else None
                if not up or up["direction"] != "up":
                    fail("serve fleet: no scale-up on a burning TTFT")
                await only_on(router, up["replica"], prompts[:2], 4)
                scaler.monitor = SLOMonitor({"default": {"ttft_p95": 1e3}})
                scaler.monitor.on_ttft("default", 0.01,
                                       scaler.monitor.clock())
                down = await scaler.step()
                if not down or down["direction"] != "down" \
                        or down["replica"] != up["replica"]:
                    fail(f"serve fleet: no scale-down retiring the "
                         f"autoscaler's replica: {down}")
                spills = os.listdir(os.path.join(tmp.name, "spill"))
                print(f"serve fleet: autoscaler scaled up to replica "
                      f"{up['replica']} (burn {up['burn']:.0f}) and down "
                      f"again; the retire spilled {spills}; active "
                      f"{ctl.active_replicas()}", flush=True)
                return flipped, scaler.decisions
        flipped, decisions = asyncio.run(run())
        boots = {k[0]: v.value for k, v in sm.FLEET_BOOTS.samples()}
        scale = {k: v.value for k, v in sm.FLEET_SCALE_EVENTS.samples()}
        want_scale = {(d["direction"], d["reason"]): 1.0
                      for d in decisions}
        if boots != {"cold": float(len(ctl.booted))} \
                or sm.FLEET_UPGRADES.value != len(flipped) \
                or scale != want_scale:
            fail(f"serve fleet: FLEET_* {boots} / "
                 f"{sm.FLEET_UPGRADES.value} / {scale} against the "
                 f"controller's {len(ctl.booted)} boots, {len(flipped)} "
                 f"upgrades, {want_scale}")
        print(f"serve fleet: FLEET_BOOTS {boots}, FLEET_UPGRADES "
              f"{sm.FLEET_UPGRADES.value:.0f}, FLEET_SCALE_EVENTS {scale}, "
              f"FLEET_COLD_START count {sm.FLEET_COLD_START.count}: the "
              "controller's own events", flush=True)
    finally:
        pm.disable()
        pm.REGISTRY.reset()
        tmp.cleanup()
    del router, ctl
    torch.cuda.empty_cache()
    print(f"serve fleet: phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def check_fleet_on_card(device):
    """Phase 5t: the fleet's identity checks on an fp32 2-layer model at
    full width (v1 and v2 from two numpy seeds), 4 prompts of 16 new
    tokens, prefix caching on: the booted replica's tokens equal replica
    0's (and a fresh v1 engine's); each request streamed through the
    rolling upgrade equals a fresh v1 or a fresh v2 engine's, never a
    mix; after it every replica's tokens equal the fresh v2 engine's,
    and a swapped engine holds the fresh v2 engine's tensors bit for
    bit."""
    import asyncio
    import tempfile

    import numpy as np
    import torch
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.serving.engine import ServingEngine
    t_phase = time.perf_counter()
    a1 = random_gpt_arrays(SEED + 91, layers=2)
    m1 = load_jax_gpt(a1, HEADS, device=device)
    m2 = load_jax_gpt(random_gpt_arrays(SEED + 92, layers=2), HEADS,
                      device=device)
    rng = np.random.default_rng(SEED + 93)
    prompts = [rng.integers(0, VOCAB, int(n)).tolist()
               for n in (40, 200, 97, 151)]
    new = 16
    geo = dict(max_slots=4, block_size=BLOCK, max_seq_len=256,
               token_budget=64, cache_dtype="float32", prefix_caching=True)
    ref = {v: ServingEngine(m, device=device, **geo).generate_batch(
        prompts, new) for v, m in (("v1", m1), ("v2", m2))}
    fresh2 = ServingEngine(m2, device=device, **geo)
    w2 = ordered(m1, random_gpt_arrays(SEED + 92, layers=2))
    cfg = inference.Config().enable_continuous_batching(num_replicas=2,
                                                        **geo)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        router, ctl = inference.create_fleet_controller(
            cfg, m1, bundle_root=tmp, device=device)

        async def run():
            async with router:
                base = await only_on(router, 0, prompts, new)
                idx = await ctl.boot_replica()
                booted = await only_on(router, idx, prompts, new)
                tasks = [asyncio.ensure_future(router.submit(
                    list(p), max_new_tokens=new)) for p in prompts]
                await asyncio.sleep(0.01)
                await ctl.rolling_upgrade(w2, "v2")
                streamed = await asyncio.gather(*tasks)
                after = [await only_on(router, i, prompts, new)
                         for i in ctl.active_replicas()]
                return base, booted, streamed, after, idx
        base, booted, streamed, after, idx = asyncio.run(run())
    if base != ref["v1"] or booted != base:
        fail("check fleet: the booted replica's tokens differ from "
             "replica 0's or a fresh v1 engine's")
    versions = ["v1" if s == r1 else "v2" if s == r2 else "mix"
                for s, r1, r2 in zip(streamed, ref["v1"], ref["v2"])]
    if "mix" in versions:
        fail(f"check fleet: a request streamed through the upgrade mixed "
             f"versions: {versions}")
    if any(a != ref["v2"] for a in after):
        fail("check fleet: a replica's tokens after the upgrade differ "
             "from a fresh v2 engine's")
    swapped = router.frontends[idx].engine._weight_slots()
    for key, t in fresh2._weight_slots().items():
        if not torch.equal(swapped[key], t):
            fail(f"check fleet: swapped tensor {key} differs from a fresh "
                 "v2 engine's")
    print(f"check fleet: booted replica {idx} = replica 0 = fresh v1; "
          f"streamed requests ran on {versions}; {len(after)} replicas = "
          f"fresh v2 after the upgrade; swapped tensors = fresh v2's bit "
          f"for bit; phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# ------------------------------------------------------------ phase 5q


def load_trace_smoke():
    """tools/torch_trace_smoke.py (the fleet-trace contract) as a
    module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tools", "torch_trace_smoke.py")
    spec = importlib.util.spec_from_file_location("torch_trace_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def hold_traced_engine(label, eng, run, prefill_fed, smoke):
    """The registry, tracer and flight recorder of one traced engine run
    against the engine's own counts: the step and token counters, the
    finished requests, TTFT count, every contract metric exported, one
    closed monotone trace a request, and the span-derived TTFT,
    inter-token and queue-wait values in the histograms' buckets count
    for count (sums to the summation order's rounding)."""
    from paddle_tpu_torch.profiler import metrics as pm
    from paddle_tpu_torch.serving import metrics as sm
    from paddle_tpu_torch.serving import tracing
    n = len(run["reqs"])
    text = pm.REGISTRY.to_prometheus()
    missing = [m for m in sm.CONTRACT_METRICS if m not in text]
    want = {"steps": run["steps"], "prefill tokens": prefill_fed,
            "decode tokens": run["fed"] - prefill_fed,
            "finished": n, "TTFT count": n, "flight steps": run["steps"]}
    got = {"steps": sm.SERVING_STEPS.value,
           "prefill tokens": sm.SERVING_TOKENS.labels("prefill").value,
           "decode tokens": sm.SERVING_TOKENS.labels("decode").value,
           "finished": sm.SERVING_REQUESTS.labels("finished").value,
           "TTFT count": sm.SERVING_TTFT_SECONDS.count,
           "flight steps": eng.flight.steps}
    traces = [tracing.TRACER.get(r.trace_id) for r in run["reqs"]]
    bad = [t.trace_id for t in traces
           if t is None or t.outcome != "finished" or not t.monotone()]
    failures = []
    derived = [t.derive() for t in traces if t is not None]
    smoke.hold_histogram(failures, "TTFT", sm.SERVING_TTFT_SECONDS,
                          [d["ttft"] for d in derived])
    smoke.hold_histogram(failures, "inter-token",
                          sm.SERVING_INTER_TOKEN_SECONDS,
                          [g for d in derived for g in d["inter_token"]])
    smoke.hold_histogram(failures, "queue wait",
                          sm.SERVING_TRACE_QUEUE_WAIT,
                          [d["queue_wait"] for d in derived])
    if missing or got != want or bad or tracing.TRACER.active() \
            or len(tracing.TRACER.traces()) != n or failures:
        fail(f"{label}: registry {got} against the engine's {want}; "
             f"missing metrics {missing}; traces not closed or not "
             f"monotone {bad}; open {len(tracing.TRACER.active())}; "
             f"{failures}")
    return sum(d["ttft"] for d in derived) / n


def serve_observed(model, device, counters, dense_out, base):
    """Phase 5q: the observability plane on the card.
    (a) GPT-350M (phase 5a's model) at phase 4's settings on the 16
    requests with metrics, tracing and an SLOMonitor on: tokens equal
    to phase 4's, the paged kernel launched steps x 24 (nothing else),
    the registry's counters against the engine's, one closed monotone
    trace a request, the spans against the histograms, every contract
    metric exported; tokens/s and host ms a step beside phase 4's,
    holding the run's wall time at most 2 x phase 4's + 0.05 s.
    (b) 4 requests at 4 ticks a dispatch with recording on, every
    dispatch's ticks under set_sync_debug_mode("error"): tokens equal to
    a 1-tick engine's on the same requests.
    (c) tools/torch_trace_smoke.py's fleet contract on phase 5p's fp32
    2-layer model at full width.
    Then the port's Profiler over 8 decode steps of (a)'s engine: its
    summary() printed, its chrome export read back."""
    import json
    import tempfile

    import numpy as np
    import torch
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.serving import slo, tracing
    from paddle_tpu_torch.serving.engine import ServingEngine
    t_phase = time.perf_counter()
    smoke = load_trace_smoke()
    prompts = serve_prompts()
    geo = dict(max_slots=SLOTS, block_size=BLOCK, max_seq_len=MAX_SEQ,
               token_budget=BUDGET, cache_dtype="bfloat16", device=device)

    # (a) the traced engine
    tracing.recording(False)
    eng = ServingEngine(model, name="observed", **geo)
    eng.generate_batch([[1, 2, 3]], max_new_tokens=2)     # warm-up
    torch.cuda.synchronize()
    tracing.recording(True)
    monitor = slo.SLOMonitor().attach()
    prefill0 = eng.prefill_tokens_fed
    outputs, got, run = serve_counted(eng, prompts, counters,
                                      "serve observed", new=NEW_TOKENS)
    same = sum(a == b for o, w in zip(outputs, dense_out)
               for a, b in zip(o, w))
    if outputs != dense_out:
        fail("serve observed: tokens differ from phase 4's with recording "
             "on")
    want = {"paged_attention": run["steps"] * LAYERS}
    if {k: n for k, n in got.items() if n} != want:
        fail(f"serve observed: launches {got}, expected {want}")
    ttft = hold_traced_engine("serve observed", eng, run,
                              eng.prefill_tokens_fed - prefill0, smoke)
    report = monitor.evaluate()
    monitor.detach()
    # the same engine again with recording off: a second reading of the
    # pair in turns (phase 4 off, on, off)
    tracing.recording(False)
    off_out, _, off = serve_counted(eng, prompts, counters,
                                    "serve observed off", new=NEW_TOKENS)
    if off_out != dense_out:
        fail("serve observed: tokens differ from phase 4's with recording "
             "off")
    tracing.recording(True, reset=False)

    def ms(r):
        return r["wall"] / r["steps"] * 1e3
    line = (f"serve observed: GPT-350M at phase 4's settings, metrics, "
            f"tracing and an SLOMonitor on: {run['steps']} steps, "
            f"{run['generated']} tokens in {run['wall']:.3f} s = "
            f"{run['generated'] / run['wall']:.1f} tokens/s (recording "
            f"off: phase 4 {base['tokens_s']:.1f}, this engine after it "
            f"{off['generated'] / off['wall']:.1f}), {ms(run):.2f} ms a "
            f"step on the host clock (off: {ms(base):.2f}, "
            f"{ms(off):.2f}); tokens equal to phase 4's "
            f"{same}/{run['generated']}; paged_attention "
            f"launches {got['paged_attention']} = steps x {LAYERS}; "
            f"{len(tracing.TRACER.traces())} traces closed, span-derived "
            f"mean TTFT {ttft * 1e3:.1f} ms; SLO "
            + ", ".join(f"{t} ttft_p95 {r['ttft_p95']['value'] * 1e3:.1f} ms"
                        f" burn {r['ttft_p95']['burn_rate']:.2f}"
                        for t, r in report.items() if "ttft_p95" in r))
    print(line, flush=True)
    if run["wall"] > 2 * base["wall"] + 0.05:
        fail(line + " — recording more than doubled the run's time")

    # the Profiler over 8 decode steps of the traced engine
    rng = np.random.default_rng(SEED + 91)
    reqs = [eng.submit(rng.integers(0, VOCAB, 128).tolist(), 32)
            for _ in range(SLOTS)]
    while any(r.state != "decode" for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        prof = profiler.Profiler(
            on_trace_ready=profiler.export_chrome_tracing(tmp, "observed"))
        with prof:
            for _ in range(8):
                with profiler.RecordEvent("decode_step"):
                    eng.step()
            torch.cuda.synchronize()
        with open(prof.exported_path) as f:
            events = json.load(f)["traceEvents"]
    for r in reqs:
        eng.cancel(r)
    text = prof.summary(top_k=8)
    tracks = {str(e.get("tid")) for e in events}
    flight_slices = [e for e in events if e.get("tid") == "engine:observed"
                     and e.get("ph") == "X"]
    trace_events = [e for e in events
                    if str(e.get("tid", "")).startswith("trace:")]
    spans = [e for e in events if e.get("name") == "decode_step"
             and e.get("ph") == "X"]
    if len(spans) != 8 or not flight_slices or not trace_events \
            or "Metrics Summary" not in text \
            or "request traces" not in text:
        fail(f"profiler: {len(spans)} host spans, {len(flight_slices)} "
             f"flight slices, {len(trace_events)} trace events in the "
             f"chrome export ({len(tracks)} tracks); summary sections "
             "missing")
    device_line = ("device kernels read" if profiler.statistic.NO_DEVICE_KERNELS
                   not in text else "no device kernels read")
    print(f"profiler: 8 decode steps of the traced engine; chrome export "
          f"{len(events)} events on {len(tracks)} tracks ({len(spans)} "
          f"host spans, {len(flight_slices)} flight slices, "
          f"{len(trace_events)} trace events); summary: {device_line}",
          flush=True)
    tracing.recording(False)
    del eng
    torch.cuda.empty_cache()

    # (b) traced multi-tick dispatches under sync debug
    few = prompts[:4]
    one = ServingEngine(model, **geo)
    want_out = one.generate_batch(few, NEW_TOKENS)
    del one
    eng = ServingEngine(model, ticks_per_dispatch=TICKS, **geo)
    eng.generate_batch([[1, 2, 3]], max_new_tokens=2)     # warm-up
    torch.cuda.synchronize()
    sync_guarded(eng)
    tracing.recording(True)
    outputs, got, run = serve_counted(eng, few, counters,
                                      "serve observed multitick",
                                      new=NEW_TOKENS)
    tracing.recording(False)
    if outputs != want_out:
        fail("serve observed multitick: tokens differ from the 1-tick "
             "engine's")
    if eng.flight.steps != run["dispatches"] or run["ticks"] <= \
            run["dispatches"]:
        fail(f"serve observed multitick: {eng.flight.steps} flight "
             f"records for {run['dispatches']} dispatches of "
             f"{run['ticks']} ticks")
    print(f"serve observed multitick: {len(few)} requests at {TICKS} "
          f"ticks a dispatch, recording on, every dispatch's ticks under "
          f"set_sync_debug_mode('error'): tokens equal to the 1-tick "
          f"engine's; {run['dispatches']} dispatches of {run['ticks']} "
          f"ticks, {run['issued']} issued; paged_attention launches "
          f"{got['paged_attention']} = issued x {LAYERS}: "
          f"{got['paged_attention'] == run['issued'] * LAYERS}", flush=True)
    if got["paged_attention"] != run["issued"] * LAYERS:
        fail("serve observed multitick: launches differ from issued ticks "
             f"x {LAYERS}")
    del eng
    torch.cuda.empty_cache()

    # (c) the fleet-trace contract on a 2-layer fp32 fleet at full width
    small = load_jax_gpt(random_gpt_arrays(SEED + 71, layers=2), HEADS,
                         device=device)
    try:
        stats, failures = smoke.run_smoke(
            small, device, geo=dict(max_slots=4, block_size=BLOCK,
                                    max_seq_len=256, token_budget=64,
                                    cache_dtype="float32"),
            vocab=VOCAB, tail=(20, 120), max_new=32)
    finally:
        tracing.recording(False)
    line = (f"serve observed fleet: 1 prefill + 2 decode replicas, fp32, 2 "
            f"layers at full width, int8 pools: {stats['traces']} stitched "
            f"traces / {stats['events']} events, span-derived mean TTFT "
            f"{stats['span_ttft_mean_ms']:.1f} ms, {stats['handoffs']} "
            f"handoffs + {stats['sheds']} shed, {stats['transport_bytes']} "
            f"transport bytes, mean handoff latency "
            f"{stats['handoff_ms_mean']:.2f} ms, {stats['breaches']} SLO "
            "breach")
    print(line, flush=True)
    if failures:
        fail(line + f" — {failures}")
    tracing.TRACER.reset()
    del small, stats
    torch.cuda.empty_cache()
    print(f"serve observed: phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def kernel_table():
    """Every kernel variant of the port: (name, module, counter
    attribute, TPU kernel replaced, source)."""
    from paddle_tpu_torch.ops import conv_wgrad as cw
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import grouped_matmul as gm
    from paddle_tpu_torch.ops import layer_norm as ln
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import qkv_proj as qp
    csrc = "paddle_tpu_torch/ops/csrc/"
    pallas = "paddle_tpu/ops/pallas/"
    return [
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
         pallas + "flash_attention.py:161", csrc + "flash_attention.cu"),
        ("paged_sparse", pa, "sparse_launch_count",
         pallas + "paged_attention.py:196", csrc + "paged_attention.cu"),
        ("paged_sparse_int8", pa, "sparse_int8_launch_count",
         pallas + "paged_attention.py:196", csrc + "paged_attention.cu"),
        ("paged_sparse_fp8", pa, "sparse_fp8_launch_count",
         pallas + "paged_attention.py:196", csrc + "paged_attention.cu"),
        ("paged_sparse_verify", pa, "sparse_verify_launch_count",
         pallas + "paged_attention.py:196", csrc + "paged_attention.cu"),
        ("gmm_int8_dense", gm, "dense_launch_count",
         pallas + "grouped_matmul.py:181", csrc + "grouped_matmul.cu")]


# the on-card checks of the serving phases: each holds tokens against a
# CPU copy's, none takes a time, and each is bound by its host loop, so
# they run in two processes at once, this one and a spawned child,
# CHECK_THREADS CPU threads each (the card's host has 8 cores); the
# child's share took about as long as the rest on an H100's host
SERVING_CHECKS = {
    "5c": lambda device, counters: check_moe_on_card(device),
    "5d": lambda device, counters: check_spec_on_card(device),
    "5f": lambda device, counters: check_multitick_on_card(device),
    "5i": lambda device, counters: check_prefix_sparse_on_card(device),
    "5l": lambda device, counters: check_lora_weight_only_on_card(device),
    "5p": check_disagg_on_card,
    "5t": lambda device, counters: check_fleet_on_card(device)}
CHILD_CHECKS, CHECK_THREADS = ("5c", "5i"), 4


def check_child(_index, names):
    """The spawned half of `serving_checks`: the checks `names` on
    cuda:0."""
    import torch
    whole_lines()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(CHECK_THREADS)
    counters = [(m, attr, name) for name, m, attr, _r, _s in kernel_table()]
    for name in names:
        SERVING_CHECKS[name](torch.device("cuda:0"), counters)


def serving_checks(device, counters):
    """Phases 5c, 5d, 5f, 5i, 5l, 5p and 5t: CHILD_CHECKS in a spawned
    child process and the others here, at once. A failed check on
    either side fails the script; the child is stopped if this side
    fails first."""
    import torch
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException
    t0 = time.perf_counter()
    ctx = mp.start_processes(check_child, args=(CHILD_CHECKS,), nprocs=1,
                             join=False, start_method="spawn")
    threads = torch.get_num_threads()
    torch.set_num_threads(CHECK_THREADS)
    try:
        for name, check in SERVING_CHECKS.items():
            if name not in CHILD_CHECKS:
                check(device, counters)
        here = time.perf_counter() - t0
        try:
            while not ctx.join():
                pass
        except ProcessException as e:
            fail(f"serving checks: the child running {CHILD_CHECKS} "
                 f"failed ({e})")
    finally:
        torch.set_num_threads(threads)
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
    print(f"serving checks: {', '.join(CHILD_CHECKS)} in a child process "
          f"beside the others here: this side's took {here:.1f} s, both "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def main():
    import torch
    t_start = time.perf_counter()
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

    kernels = kernel_table()
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
    checks.update(check_paged_sparse(pa, device, flush))
    checks.update(check_gmm(gm, device, flush))
    check_gmm_backward(gm, device, flush)
    checks.update(check_weight_only_gmm(gm, device, flush))
    check_tp_shapes(pa, gm, device, flush)
    check_mp_shapes(fa, ln, qp, device, flush)
    checks.update(check_flash(fa, device, flush))
    checks.update(check_add_ln(ln, device, flush))
    checks.update(check_qkv_proj(qp, device, flush))
    checks.update(check_flash_bshd(fa, device, flush))
    checks.update(check_wgrad(cw, device, flush))
    checks.update(check_flash_seg(fa, device, flush))
    checks.update(check_flash_seg_bwd(fa, device, flush))
    del flush
    torch.cuda.empty_cache()

    def mark(label):
        print(f"chip_smoke: {label} done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
    mark("build and kernel checks")
    eng, reqs, serve_launches, base = serve(device, counters)
    check_outputs(eng.model, reqs, device)
    base_prof = profile_decode(eng, "GPT-350M", kernel=PAGED_KERNELS)
    dense_out = [list(r.output) for r in reqs]
    del eng, reqs
    torch.cuda.empty_cache()
    mark("phases 4, 5")
    spec_launches, spec_out, model = serve_spec(device, counters)
    serve_launches.update(spec_launches)
    mark("phase 5a")
    serve_multitick(model, device, counters, dense_out, spec_out)
    mark("phase 5e")
    serve_prefix(model, device, counters)
    serve_launches.update(serve_sparse(model, device, counters))
    mark("phases 5g, 5h")
    serve_lora(model, device, counters, dense_out, base, base_prof)
    serve_launches.update(serve_weight_only(model, device, counters,
                                            dense_out, base, base_prof))
    mark("phases 5j, 5k")
    serve_disagg(model, device, counters, dense_out, base)
    mark("phase 5o")
    serve_observed(model, device, counters, dense_out, base)
    mark("phase 5q")
    serve_generate(model, device, counters)
    serve_fleet(model, device, counters)
    del model
    torch.cuda.empty_cache()
    mark("phases 5r, 5s")
    serving_checks(device, counters)
    mark("phases 5c, 5d, 5f, 5i, 5l, 5p, 5t")
    serve_launches.update(serve_moe(device, counters))
    mark("phase 5b")
    mesh_ranks = serve_tp(base, base_prof)
    mark("phases 5m, 5n")

    launches = train(device, counters)
    launches.update({n: serve_launches[n] for n in (
        "paged_attention", "paged_verify", "paged_int8", "paged_fp8",
        "paged_verify_int8", "paged_verify_fp8", "gmm_fp", "gmm_int8",
        "gmm_int4", "paged_sparse", "paged_sparse_int8", "paged_sparse_fp8",
        "paged_sparse_verify", "gmm_int8_dense")})
    mark("phase 6")
    train_moe(device, counters)
    mark("phase 6b")
    train_mesh(device, mesh_ranks)
    mark("phase 6d")
    check_train_step(device)
    check_moe_train_step(device)
    torch.cuda.empty_cache()
    mark("phase 7")
    launches.update(flash_bshd_phase(fa, device, counters))
    launches.update(wgrad_phase(cw, device, counters))
    launches.update(serve_bert(fa, device, counters))
    torch.cuda.empty_cache()
    check_bert_on_card(device)
    # K1c's forward runs on both BERT paths: its count is the sum of both
    for name, n in train_bert(device, counters).items():
        launches[name] = launches.get(name, 0) + n
    check_bert_train_on_card(device)

    idle = [name for name, *_ in kernels if not launches[name]]
    if idle:
        fail(f"kernels never launched on their main path: {idle}")
    line = {"kernels": [dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches[name],
        **{k: checks[name][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        library_ms=checks[name].get("library_ms"),
        sdpa_gathered_ms=checks[name].get("sdpa_gathered_ms"))
        for name, _m, _c, replaces, source in kernels]}
    print(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": kind,
                                              "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
