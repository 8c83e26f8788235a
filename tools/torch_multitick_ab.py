"""Where the host time of the serving engine's multi-tick dispatch goes,
against the 1-tick engine, on one card.

    python tools/torch_multitick_ab.py [--rounds 2]

Builds `chip_smoke.py`'s GPT-350M (bf16, random weights from its numpy
seed) and serves `chip_smoke.py`'s 16 requests (64 new tokens,
max_slots=8, block_size=16, max_seq_len=1024, token_budget=256) with
engines in turns: `ticks_per_dispatch` 1, 4, 4 with every dispatch's
ticks under `torch.cuda.set_sync_debug_mode("error")`, and "auto" (then
the same in reverse order, `--rounds` times). Each run prints tokens/s
and ms per dispatch, per executed tick and per issued tick on the host
clock, and splits the host time of a dispatch into its parts, each
summed over the run with `time.perf_counter`:

* plan — `Scheduler.plan`;
* enqueue — the ticks' launches (`_run_ticks`; at one tick the mixed
  step's call);
* readback — the one copy to the host, which waits for the card
  (`_to_host`);
* rest — everything else of the dispatch: packing, preallocation,
  uploads, the token replay.

Then 8 requests with 256-token prompts are prefilled and one 4-tick
dispatch and one 1-tick step run under `torch.profiler` (CPU and CUDA):
host ms, device ms, launches, and the 12 ops with the most host time.
Every line carries the card's name and power limit. Needs a card;
imports torch and the port only (and `chip_smoke.py` for the model and
the prompts).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


class Timers:
    """perf_counter sums of an engine's dispatch parts."""

    def __init__(self, eng, engine_mod):
        self.t = dict(plan=0.0, enqueue=0.0, readback=0.0)
        plan, to_host = eng.scheduler.plan, engine_mod._to_host
        timed = "_run_ticks" if eng._multitick else "_mixed_step"
        inner = getattr(eng, timed)

        def clock(name, fn):
            def run(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    self.t[name] += time.perf_counter() - t0
            return run
        eng.scheduler.plan = clock("plan", plan)
        setattr(eng, timed, clock("enqueue", inner))
        self._restore = lambda: setattr(engine_mod, "_to_host", to_host)
        engine_mod._to_host = clock("readback", to_host)

    def close(self):
        self._restore()


def serve_once(model, prompts, label, smi, **kw):
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.serving import engine as engine_mod
    from paddle_tpu_torch.serving.engine import ServingEngine
    guarded = kw.pop("guarded", False)
    eng = ServingEngine(model, max_slots=cs.SLOTS, block_size=cs.BLOCK,
                        max_seq_len=cs.MAX_SEQ, token_budget=cs.BUDGET,
                        cache_dtype="bfloat16", device="cuda", **kw)
    eng.generate_batch([[1, 2, 3]], max_new_tokens=2)       # warm-up
    torch.cuda.synchronize()
    if guarded:
        cs.sync_guarded(eng)
    timers = Timers(eng, engine_mod)
    steps0, ticks0, issued0 = (eng.steps_run, eng.device_ticks_run,
                               eng.device_ticks_issued)
    t0 = time.perf_counter()
    out = eng.generate_batch(prompts, max_new_tokens=cs.NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timers.close()
    disp = eng.steps_run - steps0
    ticks = eng.device_ticks_run - ticks0 if eng._multitick else disp
    issued = eng.device_ticks_issued - issued0 if eng._multitick else disp
    gen = sum(map(len, out))
    t = timers.t
    rest = wall - sum(t.values())
    print(f"{label}: {gen} tokens in {wall:.3f} s = {gen / wall:.1f} "
          f"tokens/s; {disp} dispatches, {ticks} ticks executed, {issued} "
          f"issued; ms per dispatch {wall * 1e3 / disp:.2f}, per executed "
          f"tick {wall * 1e3 / ticks:.2f}, per issued tick "
          f"{wall * 1e3 / issued:.2f}; per dispatch: plan "
          f"{t['plan'] * 1e3 / disp:.2f}, enqueue "
          f"{t['enqueue'] * 1e3 / disp:.2f} ({t['enqueue'] * 1e3 / issued:.2f}"
          f" a tick), readback {t['readback'] * 1e3 / disp:.2f}, rest "
          f"{rest * 1e3 / disp:.2f} ms [{smi}]", flush=True)
    return out


def profile_dispatch(model, ticks, smi):
    """One pure-decode dispatch of `ticks` ticks under torch.profiler
    after 8 256-token prompts are prefilled."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from paddle_tpu_torch.serving.engine import ServingEngine
    eng = ServingEngine(model, max_slots=cs.SLOTS, block_size=cs.BLOCK,
                        max_seq_len=cs.MAX_SEQ, token_budget=cs.BUDGET,
                        cache_dtype="bfloat16", device="cuda",
                        ticks_per_dispatch=ticks)
    rng = np.random.default_rng(cs.SEED + 2)
    reqs = [eng.submit(rng.integers(0, cs.VOCAB, 256).tolist(), 40)
            for _ in range(cs.SLOTS)]
    while any(r.state in ("queued", "prefill") for r in reqs):
        eng.step()
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    ev = prof.key_averages()
    dev = [e for e in ev if e.device_type == DeviceType.CUDA]
    cpu = sorted((e for e in ev if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_cpu_time_total)
    device_ms = sum(e.self_device_time_total for e in dev) / 1e3
    print(f"profile {ticks}-tick dispatch: {host * 1e3:.3f} ms on the host "
          f"clock (profiled), {device_ms:.3f} ms of device time in "
          f"{sum(e.count for e in dev)} device launches, "
          f"{sum(e.count for e in ev if e.device_type == DeviceType.CPU and e.key.startswith('aten::'))}"
          " aten calls; most host time: " + "; ".join(
              f"{e.key} {e.self_cpu_time_total / 1e3:.3f} ms x{e.count}"
              for e in cpu[:12]) + f" [{smi}]", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_multitick_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.ops import paged_attention as pa
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    pa.build()
    model = load_jax_gpt(cs.random_gpt_arrays(), cs.HEADS,
                         compute_dtype="bfloat16", device="cuda")
    prompts = cs.serve_prompts()
    arms = [("1 tick", {}), ("4 ticks", dict(ticks_per_dispatch=4)),
            ("4 ticks, sync debug on", dict(ticks_per_dispatch=4,
                                            guarded=True)),
            ("auto", dict(ticks_per_dispatch="auto"))]
    ref = None
    for _ in range(args.rounds):
        for label, kw in arms + arms[::-1]:
            out = serve_once(model, prompts, label, smi, **kw)
            ref = ref or out
            if out != ref:
                print(f"{label}: tokens differ from the first run's",
                      file=sys.stderr)
                return 1
    profile_dispatch(model, 4, smi)
    profile_dispatch(model, 1, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
