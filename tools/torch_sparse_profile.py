"""Where a block-sparse decode step's time goes, against the dense
step, on one card.

    python tools/torch_sparse_profile.py [--rounds 2]

Builds `chip_smoke.py`'s GPT-350M (bf16, random weights from its numpy
seed) and, for each engine in turns (dense; dense with
`track_summaries=True`; `sparse_blocks=8, sparse_recent=2`, as
`chip_smoke.py`'s `serve sparse` runs it; then the same in reverse
order, `--rounds` times), prefills 8 requests of 800-token prompts
(max_slots=8, block_size=16, max_seq_len=1024, token_budget=256),
times 10 pure-decode steps on the host clock, and runs 5 more under
`torch.profiler` (CPU and CUDA): host ms a step, device ms and device
launches a step, and for the sparse engine the 12 host ops with the
most self time. Every line carries the card's name and power limit.
Needs a card; imports torch and the port only (and `chip_smoke.py` for
the model).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ENGINES = (("dense", {}),
           ("dense + summaries", dict(track_summaries=True)),
           ("sparse B=8", dict(sparse_blocks=8, sparse_recent=2)))


def profile_engine(model, label, kw, prompts, smi, top):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving.engine import ServingEngine
    eng = ServingEngine(model, max_slots=8, block_size=16, max_seq_len=1024,
                        token_budget=256, cache_dtype="bfloat16",
                        device="cuda", **kw)
    reqs = [eng.submit(p, 40) for p in prompts]
    while any(r.state != "decode" for r in reqs):
        eng.step()
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        eng.step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            eng.step()
        torch.cuda.synchronize()
    for r in reqs:
        eng.scheduler.cancel(r)
    ka = prof.key_averages()
    dev = [e for e in ka if e.device_type == DeviceType.CUDA]
    line = (f"{label}: a decode step at contexts 800-840, "
            f"{host_ms:.3f} ms on the host clock")
    if dev:
        device_ms = sum(e.self_device_time_total for e in dev) / 5e3
        line += (f", {device_ms:.3f} ms of device time in "
                 f"{sum(e.count for e in dev) / 5:.0f} device launches")
    else:
        line += ", device time not measured (no device events)"
    print(f"{line}; {smi}", flush=True)
    if top:
        host = sorted((e for e in ka if e.device_type != DeviceType.CUDA),
                      key=lambda e: -e.self_cpu_time_total)[:12]
        for e in host:
            print(f"  {label} host op {e.key[:48]}: "
                  f"{e.self_cpu_time_total / 5e3:.3f} ms a step in "
                  f"{e.count / 5:.0f} calls", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_sparse_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch.convert import load_jax_gpt
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    model = load_jax_gpt(cs.random_gpt_arrays(), cs.HEADS,
                         compute_dtype="bfloat16", device="cuda")
    rng = np.random.default_rng(cs.SEED + 51)
    prompts = [rng.integers(0, cs.VOCAB, 800).tolist() for _ in range(8)]
    for r in range(args.rounds):
        order = ENGINES if r % 2 == 0 else ENGINES[::-1]
        for label, kw in order:
            profile_engine(model, label, kw, prompts, smi,
                           top=r == 0 and "sparse" in label)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
