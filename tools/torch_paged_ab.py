"""Parent-against-change check of the port's paged-attention kernels on
one card: the walk over verify groups (K3b, K3c verify) and over the
ragged entry's groups (K3a, K3c ragged).

    python tools/torch_paged_ab.py --parent OTHER/paged_attention.cu [--sweep] [--probe]

Builds `paddle_tpu_torch/ops/csrc/paged_attention.cu` of this tree and
another copy of it (for example the parent commit's, unpacked with
`git archive`; a copy without `paddle_tpu_torch_paged_verify` runs its
verify groups, one without `paddle_tpu_torch_paged_ragged` its ragged
calls, through `paddle_tpu_torch_paged_attention`) with
`nvcc -Xptxas -v`, and prints:

* registers, stack and spills of every walk kernel of each copy
  (ptxas lines that report spills printed on their own);
* both copies at `chip_smoke.py`'s shapes with bf16 queries: the verify
  entry (`verify_case`: 8 groups of 4 queries, H = 16, Dh = 64, BS =
  16, contexts up to 1024) over bf16, int8 and fp8 pools, the ragged
  entry at `paged_case` (256 tokens: decodes, prefill chunks, padding)
  over the same three, and at `paged_decode_case` (8 decodes, 248
  padding tokens) over bf16 and int8 pools and, over bf16 pools, at
  the profiled decode step's contexts (257-292), timed in turns (other, this,
  this, other, other, this) with CUDA events and L2 flushed, as
  `chip_smoke.py` times kernels, each side held against the plain
  version first (TOL / QTOL (1 + |plain|)) and a walk's two launches to
  the same bits; beside them the bound and the SDPA yardstick.

With `--sweep` it also runs this tree's verify walk with other ranges a
walk (one, which leaves a block a group, half, twice and four times the
plan's), its ragged walk with other least tiles an item (wmin 1, 4, 8)
and other targets (half and twice the SMs), and builds copies with other
ring depths (at
most 2, 3, 4 or 6 tiles, both walks), each timed at the cells it applies
to and held
against the plain version. With `--probe` it builds copies whose
consumers only release the tiles they are given (loads only), that stop
before the grid sync and the combine (no combine), that walk no item
(the verify walk's combine alone, over stale states) and that stop after
the ragged plan (the plan alone), each timed at its cells.

Needs a card and nvcc; imports torch and the port only.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from torch_flash_ab import compile_v, substitute, usage  # noqa: E402

SRC = ROOT / "paddle_tpu_torch/ops/csrc/paged_attention.cu"
_CODES = {"float32": 0, "bfloat16": 1, "float16": 2, "int8": 3,
          "float8_e4m3fn": 4}


def load(path, text):
    """The library at `path`; `text`, its source, says which entries it
    has (the verify walk's; the ragged walk's)."""
    lib = ctypes.CDLL(str(path))
    lib.paddle_tpu_torch_paged_attention.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    lib.paddle_tpu_torch_paged_attention.restype = ctypes.c_int
    lib.walk = "paddle_tpu_torch_paged_verify" in text
    if lib.walk:
        lib.paddle_tpu_torch_paged_verify.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int] * 9 + [ctypes.c_float] + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        lib.paddle_tpu_torch_paged_verify.restype = ctypes.c_int
    lib.ragged = "paddle_tpu_torch_paged_ragged" in text
    if lib.ragged:
        lib.paddle_tpu_torch_paged_ragged.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.paddle_tpu_torch_paged_ragged.restype = ctypes.c_int
    return lib


def cells(dev):
    """(label, entry, args) of chip_smoke.py's bf16 cells: the verify
    entry over float, int8 and fp8 pools, the ragged entry at
    `paged_case` over the same three, and at `paged_decode_case` over
    float and int8 pools."""
    import torch
    import chip_smoke
    out = [(f"verify {kind}", "verify",
            chip_smoke.verify_case(torch.bfloat16, dev, kind))
           for kind in ("float", "int8", "fp8")]
    q, kp, vp, bt, slots, pos = chip_smoke.paged_case(torch.bfloat16, dev)
    out.append(("ragged float", "ragged", [q, kp, vp, bt, slots, pos, None,
                                           None]))
    for kind in ("int8", "fp8"):
        kq, vq, ks, vs = chip_smoke.quantized_pools(
            kp.shape[0], torch.bfloat16, kind,
            torch.Generator().manual_seed(chip_smoke.SEED + 12))
        out.append((f"ragged {kind}", "ragged",
                    [q, kq.to(dev), vq.to(dev), bt, slots, pos, ks.to(dev),
                     vs.to(dev)]))
    for kind in ("float", "int8"):
        out.append((f"decode {kind}", "ragged",
                    chip_smoke.paged_decode_case(torch.bfloat16, dev, kind)))
    # the profiled decode step's contexts (256-token prompts, 0-36 tokens
    # generated)
    out.append(("decode short float", "ragged", chip_smoke.paged_decode_case(
        torch.bfloat16, dev, ctx=(292, 287, 282, 277, 272, 267, 262, 257))))
    return out


def runner(lib, entry, args, label, ranges_of=None, check=True, plan=None):
    """A closure launching the library once on the cell (its walk where
    it has one and the pair takes it), held against the plain version
    (and, for a walk, a second launch) once. `plan` (the ragged walk):
    dict of wmin and target (a function of the SM count), the wrapper's
    choice where missing."""
    import torch
    import chip_smoke
    from paddle_tpu_torch.ops import paged_attention as pa
    q, kp, vp, bt, slots, pos, ks, vs = args
    if entry == "ragged":
        q4, pos2 = q[:, None], pos.reshape(-1, 1)
    else:
        q4, pos2 = q, pos
    N, G, H, Dh = q4.shape
    NB, BS = kp.shape[:2]
    S, MB = bt.shape
    out = torch.empty_like(q4)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    scales = (None if ks is None else ks.data_ptr(),
              None if vs is None else vs.data_ptr())
    common = (q4.data_ptr(), kp.data_ptr(), vp.data_ptr(), *scales,
              bt.data_ptr(), slots.data_ptr(), pos2.data_ptr(),
              out.data_ptr())
    codes = (_CODES[str(q.dtype).split(".")[-1]],
             _CODES[str(kp.dtype).split(".")[-1]])
    pair = pa.walk_pair(q.dtype, kp.dtype)
    walk = pair and (lib.ragged if G == 1 else lib.walk)
    if walk and G == 1:
        plan = plan or {}
        target = plan.get("target", lambda n: n)(sms)
        hb = pa.heads_a_block(Dh)
        state = torch.empty(2 * target * pa.RAGGED_ROWS * hb * (Dh + 2),
                            device=q.device)
        call = (lib.paddle_tpu_torch_paged_ragged, common + (
            state.data_ptr(), N, H, Dh, BS, S, MB, *codes, 1.0 / Dh ** 0.5,
            plan.get("wmin", pa.RAGGED_MIN_TILES), target, 2 * target, sms,
            stream))
    elif walk:
        hb, hblk, r, _items, _grid = pa.verify_plan(N, H, Dh, sms)
        r = ranges_of(r) if ranges_of else r
        items = N * hblk * r
        state = torch.empty(items * G * hb * (Dh + 2), device=q.device)
        call = (lib.paddle_tpu_torch_paged_verify, common + (
            state.data_ptr(), N, G, H, Dh, BS, S, MB, *codes,
            1.0 / Dh ** 0.5, r, min(items, sms), stream))
    else:
        call = (lib.paddle_tpu_torch_paged_attention, common + (
            N, G, H, Dh, BS, S, MB, *codes, 1.0 / Dh ** 0.5, stream))

    def run():
        err = call[0](*call[1])
        if err:
            raise SystemExit(f"{label} launch failed: CUDA error {err}")
        return out
    first = run().clone()
    torch.cuda.synchronize()
    run.err = float("nan")
    if check:
        plain = (pa.verify_gather_reference if entry == "verify"
                 else pa.ragged_gather_reference)
        want = plain(*args)
        got = first if entry == "verify" else first[:, 0]
        valid = slots >= 0
        tol = (chip_smoke.TOL if ks is None else chip_smoke.QTOL)["bfloat16"]
        run.err = chip_smoke.close_or_fail(label, got[valid], want[valid],
                                           tol)
        if walk and not torch.equal(run(), first):
            raise SystemExit(f"{label}: two launches gave different bits")
    return run


def in_turns(runs, flush):
    import chip_smoke
    times = {"other": [], "this": []}
    for side in ("other", "this", "this", "other", "other", "this"):
        times[side].append(chip_smoke.cuda_ms(runs[side], flush=flush))
    return times, {s: sum(t) / len(t) for s, t in times.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the other copy of paged_attention.cu")
    ap.add_argument("--sweep", action="store_true",
                    help="also time other plans and ring depths")
    ap.add_argument("--probe", action="store_true",
                    help="also time copies with loads only, without the "
                         "combine, or the plan only")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_paged_ab: no CUDA device")
    import chip_smoke
    build = ROOT / "build" / "paged_ab"
    build.mkdir(parents=True, exist_ok=True)
    srcs = {"other": Path(args.parent), "this": SRC}
    with ThreadPoolExecutor(2) as ex:
        reports = dict(zip(srcs, ex.map(
            lambda side: compile_v(srcs[side], build / f"lib_{side}.so"),
            srcs)))
    for side, text in reports.items():
        for line in text.splitlines():
            if "spill" in line and not re.search(
                    r"0 bytes spill stores, 0 bytes spill loads", line):
                print(f"ptxas ({side}): {line.strip()}", flush=True)
        for name, use in sorted(usage(text).items()):
            if "verify_walk" in name:
                print(f"{side}: {name}: [{use}]", flush=True)
    libs = {side: load(build / f"lib_{side}.so", srcs[side].read_text())
            for side in srcs}
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    for label, entry, cargs in cells(dev):
        runs = {side: runner(libs[side], entry, cargs, f"{side} {label}")
                for side in ("other", "this")}
        times, mean = in_turns(runs, flush)
        bound, by, _ = chip_smoke.paged_bound(cargs)
        sdpa = chip_smoke.cuda_ms(chip_smoke.sdpa_yardstick(
            chip_smoke.as_ragged(cargs) if entry == "verify" else cargs),
            flush=flush)
        print(f"{label} bf16 q [{'x'.join(map(str, cargs[0].shape))}] ms on "
              f"{card}: other {[round(t, 4) for t in times['other']]} (mean "
              f"{mean['other']:.4f}, max abs err {runs['other'].err:.3g}), "
              f"this {[round(t, 4) for t in times['this']]} (mean "
              f"{mean['this']:.4f}, max abs err {runs['this'].err:.3g}): "
              f"{mean['this'] / mean['other'] - 1:+.2%}; bound {bound:.4f} "
              f"({by}); yardstick SDPA on a pre-gathered copy {sdpa:.4f}",
              flush=True)
    if args.sweep:
        sweep(build, flush, card)
    if args.probe:
        probe(build, flush, card)
    return 0


# the ring depths of the verify walk and of the ragged walk
STAGES = ("constexpr int kMaxStages = {};",
          "constexpr int kRaggedStages = {};")


def copies(build, texts, prefix):
    """{name: library} of the sources `texts`, built in parallel."""
    def make(name):
        path = build / (prefix + re.sub(r"\W", "_", name) + ".cu")
        path.write_text(texts[name])
        compile_v(path, path.with_suffix(".so"))
        return load(path.with_suffix(".so"), texts[name])
    with ThreadPoolExecutor(len(texts)) as ex:
        return dict(zip(texts, ex.map(make, texts)))


def time_cells(runs, flush, card, what):
    """Each (name, library, entries, keyword arguments of `runner`)
    timed at the cells of the entries it names ("verify", "ragged")."""
    import torch
    import chip_smoke
    for label, entry, cargs in cells(torch.device("cuda")):
        out = []
        for name, lib, entries, kw in runs:
            if entry not in entries:
                continue
            run = runner(lib, entry, cargs, f"{what} {name} {label}", **kw)
            out.append(f"{name} {chip_smoke.cuda_ms(run, flush=flush):.4f}")
        if out:
            print(f"{what} {label} bf16 ms on {card}: " + "; ".join(out),
                  flush=True)


BOTH = ("verify", "ragged")


def sweep(build, flush, card):
    """This tree's walks at other plans, and copies with other ring
    depths, each held against the plain version: the verify walk at
    other ranges a walk; the ragged walk at other least tiles an item
    (wmin) and other targets (half and twice the SMs)."""
    src = SRC.read_text()
    now = [int(re.search(c.replace("{}", r"(\d+)"), src).group(1))
           for c in STAGES]
    texts = {"this tree": src}
    for n in (2, 3, 4, 6):
        texts[f"at most {n} tiles in the ring"] = substitute(
            src, [(c.format(m), c.format(n)) for c, m in zip(STAGES, now)],
            "stages")
    built = copies(build, texts, "sweep_paged_")
    runs = [(n, lib, BOTH, {}) for n, lib in built.items()]
    this = built["this tree"]
    for f, name in ((1 / 16, "one range a walk"), (0.5, "half the ranges"),
                    (2, "twice the ranges"), (4, "four times the ranges")):
        runs.append((name, this, ("verify",),
                     {"ranges_of": lambda r, f=f: max(1, int(r * f))}))
    for w in (1, 4, 8):
        runs.append((f"wmin {w}", this, ("ragged",), {"plan": {"wmin": w}}))
    for f, name in ((0.5, "half"), (2, "twice")):
        runs.append((f"target {name} the SMs", this, ("ragged",), {
            "plan": {"target": lambda sms, f=f: int(sms * f)}}))
    time_cells(runs, flush, card, "sweep")


# The probe's cuts, as (pattern, replacement, count) of this tree's source.
_LOADS_ONLY = (
    ("        // s[nt][2 rh + e]: row g + 8 rh, key 8 nt + 2 tq + e\n",
     "#if 0\n", 1),
    ("        __syncwarp();\n        mbar_arrive(&empty[stage]);\n",
     "#endif\n        mbar_arrive(&empty[stage]);\n", 1))
_NO_COMBINE = (
    ("  cooperative_groups::this_grid().sync();  // every item's state is "
     "stored\n", "  return;\n", 1),)
_NO_ITEMS = (("for (int item = blockIdx.x; item < items; item += gridDim.x)",
              "for (int item = blockIdx.x; item < 0; item += gridDim.x)", 2),)
_PLAN_ONLY = (
    ("  const int items = kRagged ? pl.items() : N * hblk * wa.R;\n",
     "  if (kRagged) return;\n"
     "  const int items = kRagged ? pl.items() : N * hblk * wa.R;\n", 1),)


def cut(src, subs, what):
    for old, new, n in subs:
        if src.count(old) != n:
            raise SystemExit(f"torch_paged_ab --probe: the source changed "
                             f"({what}: {old.strip()[:60]!r})")
        src = src.replace(old, new)
    return src


def probe(build, flush, card):
    """The walks beside copies with loads only, without the combine, with
    the combine only (the verify walk's, over stale states) and with the
    ragged plan only."""
    src = SRC.read_text()
    texts = {"full": src, "loads only": cut(src, _LOADS_ONLY, "loads only"),
             "no combine": cut(src, _NO_COMBINE, "no combine"),
             "combine only": cut(src, _NO_ITEMS, "combine only"),
             "plan only": cut(src, _PLAN_ONLY, "plan only")}
    built = copies(build, texts, "probe_paged_")
    entries = {"combine only": ("verify",), "plan only": ("ragged",)}
    time_cells([(n, lib, entries.get(n, BOTH), {"check": n == "full"})
                for n, lib in built.items()], flush, card, "probe")


if __name__ == "__main__":
    sys.exit(main())
