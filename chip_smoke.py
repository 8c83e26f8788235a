"""Chip smoke of the PyTorch/CUDA port (`paddle_tpu_torch`) on one
NVIDIA card.

    python3 chip_smoke.py          # from the repository root

Drives the port's serving path end to end and holds every CUDA kernel
on it against its plain PyTorch version. Phases, one line each:

1. device — the card's name, count, and `nvidia-smi` name/power limit;
2. build — every kernel source compiled with nvcc (one process per
   source, all started together);
3. kernel check — each kernel against its plain version at the serving
   shapes, with times (CUDA events, L2 flushed between launches) and
   the card's bound for the same work;
4. serve — a full-width GPT-350M (random weights from a numpy seed,
   carried in through `convert.load_jax_gpt`) served by the port's
   `ServingEngine`: 16 requests to completion; every kernel of the path
   must have launched, paged attention once per layer per step;
5. on-card correctness — two served requests re-scored by the plain
   dense causal forward in fp32, teacher-forced on the engine's output;
   then a short profiled window of decode steps (host vs device time);
6. a JSON line listing every kernel with its launches, error and times;
7. the last line, `{"ok": true, "device": {...}}`.

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


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, iters=20, warmup=3, flush=None):
    """Mean device ms of `fn` over `iters` launches timed by CUDA
    events, with `flush` (a large buffer) rewritten before each launch
    so every launch finds L2 cold, as it does inside the 24-layer
    step."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
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


def paged_bound(args):
    """(bound_ms, bound_by, per_token_bound_ms) for one paged-attention
    call: the bytes it must move — each needed K/V row read once (a
    slot's rows up to the furthest position any of its tokens sees), q,
    tables, slots and positions read once, the output written once —
    over device bandwidth, against 4*Dh flops per attended (token, key)
    over the operand type's peak. The third number counts K/V bytes
    once per attended (token, key): what a kernel moves that re-walks a
    slot's pages for every token, as this one does."""
    q, kp, _vp, bt, slots, pos = args
    T, H, Dh = q.shape
    S, MB = bt.shape
    last = pos.clamp(max=MB * BLOCK - 1).long()
    keys = int((last + 1).sum())
    furthest = {}
    for s, p in zip(slots.clamp(min=0).tolist(), last.tolist()):
        furthest[s] = max(furthest.get(s, -1), p)
    rows = sum(p + 1 for p in furthest.values())
    kv_row = 2 * H * Dh * kp.element_size()          # one K and one V row
    other = (2 * q.numel() * q.element_size() + bt.numel() * 4
             + 2 * T * 4)
    flops = 4 * keys * H * Dh
    t_flops = flops / PEAK_FLOPS[str(kp.dtype).split(".")[-1]]
    t_bytes = (rows * kv_row + other) / PEAK_BYTES
    t_token = (keys * kv_row + other) / PEAK_BYTES
    by = "bytes" if t_bytes >= t_flops else "operations"
    return (max(t_bytes, t_flops) * 1e3, by,
            max(t_token, t_flops) * 1e3)


def sdpa_yardstick(args):
    """A closure timing `scaled_dot_product_attention` over a
    pre-gathered contiguous copy of every slot's context with a
    position mask: a yardstick only — no single PyTorch call computes
    the paged function, and the gather is left out of the time."""
    import torch
    import torch.nn.functional as F
    q, kp, vp, bt, slots, pos = args
    T, H, Dh = q.shape
    S, MB = bt.shape
    safe = slots.clamp(min=0).long()
    lens = torch.zeros(S, dtype=torch.long, device=q.device)
    lens.scatter_reduce_(0, safe, pos.long() + 1, "amax")
    ks, vs, offsets, off = [], [], [], 0
    for s in range(S):
        n = int(lens[s])
        blocks = bt[s, :-(-n // BLOCK)].long()
        ks.append(kp[blocks].reshape(-1, H, Dh)[:n])
        vs.append(vp[blocks].reshape(-1, H, Dh)[:n])
        offsets.append(off)
        off += n
    k = torch.cat(ks).transpose(0, 1)[None]          # [1, H, N, Dh]
    v = torch.cat(vs).transpose(0, 1)[None]
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
              f"(tol {TOL[name]} (1 + |plain|)) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({bound_by}; {token_bound_ms:.4f} counting K/V once per "
              f"attended token and key) yardstick: SDPA on a "
              f"pre-gathered copy {sdpa_ms:.4f} ms", flush=True)
    return records["bfloat16"]


# ------------------------------------------------------------- phase 4


def random_gpt_arrays(seed=SEED):
    """GPT-350M parameters in the JAX model's `_gen_tensors()` layout,
    drawn from a numpy seed as the JAX stack initialises: N(0, 0.02)
    embeddings, N(0, 1/fan_in) weights, unit LayerNorm scales, zero
    biases."""
    import numpy as np
    rng = np.random.default_rng(seed)
    L, D, F = LAYERS, HIDDEN, 4 * HIDDEN

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    return {
        "word_embeddings": normal((VOCAB, D), 0.02),
        "position_embeddings": normal((MAXPOS, D), 0.02),
        "ln_s": np.ones((L, D), np.float32),
        "ln_b": np.zeros((L, D), np.float32),
        "qkv_w": normal((L, D, 3 * D), D ** -0.5),
        "qkv_b": np.zeros((L, 3 * D), np.float32),
        "out_w": normal((L, D, D), D ** -0.5),
        "out_b": np.zeros((L, D), np.float32),
        "ffn_ln_s": np.ones((L, D), np.float32),
        "ffn_ln_b": np.zeros((L, D), np.float32),
        "ffn1_w": normal((L, D, F), D ** -0.5),
        "ffn1_b": np.zeros((L, F), np.float32),
        "ffn2_w": normal((L, F, D), F ** -0.5),
        "ffn2_b": np.zeros((L, D), np.float32),
        "ln_f.weight": np.ones((D,), np.float32),
        "ln_f.bias": np.zeros((D,), np.float32),
        "lm_head.weight": normal((D, VOCAB), D ** -0.5),
    }


def serve(device, counters):
    """Phase 4: returns (engine, requests, launches per kernel)."""
    import numpy as np
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
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, VOCAB, int(n)).tolist() for n in
               rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                            N_REQUESTS)]
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
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} never launched on the serving path")
    if launches["paged_attention"] != steps * LAYERS:
        fail(f"paged_attention launched {launches['paged_attention']} "
             f"times, expected steps x layers = {steps * LAYERS}")
    return eng, reqs, launches


def check_outputs(model, reqs, device):
    """Phase 5: teacher-force two served requests through the plain
    dense causal forward in fp32. Each emitted token must be the fp32
    argmax or within the near-tie margin of it: twice the largest
    |bf16 - fp32| logit difference of the same dense forward on the
    same rows (a bf16 computation can swap two tokens whose fp32 logits
    differ by up to twice its error)."""
    import torch
    exact = total = 0
    worst = 0.0
    for req in reqs[:2]:
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
            fail(f"request {req.req_id}: an emitted token's fp32 logit "
                 f"is {float(gap.max()):.4f} below the argmax, past the "
                 f"margin {margin:.4f}")
        print(f"check: request {req.req_id} ({len(req.prompt)} prompt "
              f"tokens): {int((gap == 0).sum())}/{len(req.output)} tokens "
              f"are the fp32 argmax, largest gap {float(gap.max()):.4f} "
              f"within margin {margin:.4f}", flush=True)
    print(f"check: agreement {exact}/{total} exact fp32 argmax, worst "
          f"near-tie gap {worst:.4f}", flush=True)


def profile_decode(eng, window=16):
    """Where a decode step's time goes: 8 requests with 256-token
    prompts are prefilled, then `window` pure-decode steps are timed on
    the host clock and the next `window` run under torch.profiler for
    their device time. Device busy share = device time / host time of
    the same kind of step (the profiler's own host overhead is kept out
    of the host time). Informational: prints "not measured" when the
    profiler records no device events."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 2)
    reqs = [eng.submit(rng.integers(0, VOCAB, 256).tolist(),
                       2 * window + 4) for _ in range(SLOTS)]
    while any(r.state != "decode" for r in reqs):
        eng.step()
    torch.cuda.synchronize()
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
    for r in reqs:
        eng.scheduler.cancel(r)
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    if not dev:
        print(f"profile: decode step {host_ms:.3f} ms on the host clock; "
              "device time not measured (no device events)", flush=True)
        return
    device_ms = sum(e.self_device_time_total for e in dev) / 1e3 / window
    launches = sum(e.count for e in dev) / window
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    print(f"profile: decode step, 8 slots at contexts 256-{256 + 3 * window}"
          f": {host_ms:.3f} ms per step on the host clock, {device_ms:.3f} "
          f"ms of device time in {launches:.0f} device launches, device "
          f"busy {device_ms / host_ms:.1%}; most device time: " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3 / window:.3f}"
              f" ms x{e.count // window}" for e in top), flush=True)


# ---------------------------------------------------------------- main


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops import paged_attention as pa

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

    # (name, builder, module, counter attribute, TPU kernel replaced)
    kernels = [("paged_attention", pa.build, pa, "launch_count",
                "paddle_tpu/ops/pallas/paged_attention.py:101",
                "paddle_tpu_torch/ops/csrc/paged_attention.cu")]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as ex:
        libs = list(ex.map(lambda k: k[1](), kernels))
    print(f"build: {len(libs)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=device)
    checks = {"paged_attention": check_paged_attention(pa, device, flush)}
    del flush

    eng, reqs, launches = serve(
        device, [(k[2], k[3], k[0]) for k in kernels])
    check_outputs(eng.model, reqs, device)
    profile_decode(eng)

    line = {"kernels": [dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches[name], library_ms=None, **checks[name])
        for name, _b, _m, _c, replaces, source in kernels]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": kind,
                                              "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
