"""What recording (metrics and tracing) costs the serving engine's host
loop, on one card.

    python tools/torch_observe_ab.py [--rounds 2] [--ticks 4 --draft-k 3]
    python tools/torch_observe_ab.py --off [--ticks 4 --draft-k 3]

Builds `chip_smoke.py`'s GPT-350M (bf16, random weights from its numpy
seed) and one engine at phase 4's settings (max_slots=8, block_size=16,
max_seq_len=1024, token_budget=256; `--ticks` ticks a dispatch and
`--draft-k` drafts, 1 and 0 by default), and serves `chip_smoke.py`'s
16 requests (64 new tokens) on it in turns: recording off, on, on, off
(`--rounds` times). "On" is `profiler.metrics` and `serving.tracing`
enabled with an `SLOMonitor` attached, the registry and tracer reset
before the run. With `--off` every turn runs with recording off and the
tool imports no observability module, so it also runs on a checkout
that has none (a before/after of the engine itself). Each run prints
tokens/s, host ms a step (wall over steps, the card synchronized at
the end) and a device tick (wall over the ticks that ran), the Python
garbage collector's passes by generation and the seconds they took
(timed by `gc.callbacks`), and with recording on the trace events and
flight records the run left. Every line carries the card's name and
power limit. Needs a card; imports torch and the port only (and
`chip_smoke.py` for the model and the prompts).
"""
from __future__ import annotations

import argparse
import gc
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


class GCTimer:
    """Passes and seconds of the garbage collector while installed."""

    def __init__(self):
        self.passes = [0, 0, 0]
        self.seconds = 0.0
        self._t0 = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self.passes[info["generation"]] += 1
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *a):
        gc.callbacks.remove(self)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--ticks", type=int, default=1)
    ap.add_argument("--draft-k", type=int, default=0)
    ap.add_argument("--off", action="store_true",
                    help="recording off in every turn")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving.engine import ServingEngine
    if not args.off:
        from paddle_tpu_torch.serving import slo, tracing

    if not torch.cuda.is_available():
        raise SystemExit("torch_observe_ab: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda:0")
    pa.build()
    model = load_jax_gpt(cs.random_gpt_arrays(), cs.HEADS,
                         compute_dtype="bfloat16", device=device)
    eng = ServingEngine(model, max_slots=cs.SLOTS, block_size=cs.BLOCK,
                        max_seq_len=cs.MAX_SEQ, token_budget=cs.BUDGET,
                        cache_dtype="bfloat16", device=device,
                        ticks_per_dispatch=args.ticks, draft_k=args.draft_k)
    eng.generate_batch([[1, 2, 3]], max_new_tokens=2)     # warm-up
    prompts = cs.serve_prompts()
    shape = f"ticks {args.ticks} draft_k {args.draft_k}"
    want = None
    for r in range(args.rounds):
        for on in (False, True, True, False):
            on = on and not args.off
            if not args.off:
                tracing.recording(on)
            monitor = slo.SLOMonitor().attach() if on else None
            flight0 = eng.flight.steps if on else 0
            ticks0 = eng.device_ticks_run
            torch.cuda.synchronize()
            with GCTimer() as gct:
                t0 = time.perf_counter()
                reqs = [eng.submit(p, cs.NEW_TOKENS) for p in prompts]
                steps = eng.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            if monitor is not None:
                monitor.evaluate()
                monitor.detach()
            # a 1-tick engine runs one tick a step
            ticks = eng.device_ticks_run - ticks0 or steps
            out = [list(q.output) for q in reqs]
            want = want or out
            if out != want:
                raise SystemExit("torch_observe_ab: tokens changed with "
                                 "recording " + ("on" if on else "off"))
            line = (f"observe ab [{card}] {shape} round {r} recording "
                    f"{'on ' if on else 'off'}: {steps} steps, {ticks} "
                    f"ticks, {sum(map(len, out)) / wall:.1f} tokens/s, "
                    f"{wall / steps * 1e3:.3f} ms a step, "
                    f"{wall / ticks * 1e3:.3f} ms a tick on the host "
                    f"clock; gc passes {gct.passes} in "
                    f"{gct.seconds * 1e3:.1f} ms "
                    f"({gct.seconds / steps * 1e3:.3f} ms a step)")
            if on:
                tracing.recording(False)
                events = sum(len(t.events) for t in tracing.TRACER.traces())
                line += (f"; {events} trace events, "
                         f"{eng.flight.steps - flight0} flight records")
            print(line, flush=True)
    if not args.off:
        tracing.TRACER.reset()
    return 0


if __name__ == "__main__":
    sys.exit(main())
