"""Parent-against-change check of the port's split-K 1x1 weight gradient
(K6) on one card.

    python tools/torch_wgrad_ab.py --parent OTHER/conv_wgrad.cu [--sweep] [--probe]

Builds `paddle_tpu_torch/ops/csrc/conv_wgrad.cu` of this tree and
another copy of it (for example the parent commit's, unpacked with
`git archive`; a copy whose C entry takes `chunk` is called as such)
with `nvcc -Xptxas -v`, and prints:

* registers, stack and spills of every kernel of each copy (ptxas
  lines that report spills printed on their own);
* both copies at ResNet-50's [401408, 256] x [401408, 64] (chunk 4096,
  chip_smoke.py's shape) and [25088, 1024] x [25088, 256] (chunk 3136)
  in bf16, and at [8192, 72] x [8192, 40] (chunk 1024) in fp32, timed
  in turns (other, this, this, other, other, this) with CUDA events and
  L2 flushed, as `chip_smoke.py` times kernels, each side held against
  the plain version first (WGRAD_TOL x sum |x dy|) and its two launches
  to the same bits; beside them the bound and `torch.mm(x.t(), dy)`.

With `--sweep` it also builds copies of this tree's source with other
ring depths (32 rows a stage in 6 or 4 stages) and other rows a stage
(64 rows in 5 / 4 stages at the two tile widths; 128 rows in 2), and
runs this tree's kernel with other splits of N (half and twice the
plan's, the blocks then walking two items each), each timed at the bf16
shapes and held against the plain version. With `--probe` it builds copies whose
consumers run no wgmma (loads only), that stop before the grid sync
and the ordered sum (no finish), and that walk no item (the finish
alone, over stale partials), each timed at both bf16 shapes, and, as
what one PyTorch read of the same bytes reaches, `torch.sum` over x and
over dy.

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

SRC = ROOT / "paddle_tpu_torch/ops/csrc/conv_wgrad.cu"
# (N, Ci, Co, chunk, dtype name)
SHAPES = ((401408, 256, 64, 4096, "bfloat16"),
          (25088, 1024, 256, 3136, "bfloat16"),
          (8192, 72, 40, 1024, "float32"))
_CODES = {"float32": 0, "bfloat16": 1, "float16": 2}


def load(path, text):
    """The library at `path`; `text`, its source, says whether its entry
    takes `chunk` (the parent's) or this tree's plan."""
    lib = ctypes.CDLL(str(path))
    fn = lib.paddle_tpu_torch_wgrad_1x1
    lib.chunked = re.search(r"int Ci, int Co, int chunk,", text) is not None
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [
        ctypes.c_int] * (4 if lib.chunked else 6) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def case(N, Ci, Co, dtype, dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(N + Ci)
    x = torch.randn(N, Ci, generator=g, device=dev).to(dtype)
    dy = torch.randn(N, Co, generator=g, device=dev).to(dtype)
    return x, dy


def runner(lib, x, dy, chunk, label, plan=None, check=True):
    """A closure launching the library once on (x, dy) into its own dW,
    held against the plain version and a second launch once."""
    import torch
    import chip_smoke
    from paddle_tpu_torch.ops import conv_wgrad as cw
    N, Ci = x.shape
    Co = dy.shape[1]
    dw = torch.empty(Ci, Co, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    code = _CODES[str(x.dtype).split(".")[-1]]
    if lib.chunked:
        part = torch.empty(N // chunk, Ci, Co, device=x.device)
        args = (x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
                N, Ci, Co, chunk, code, stream)
    else:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        bn, splits, grid = plan or cw.plan(N, Ci, Co, x.dtype, sms)
        part = torch.empty(max(splits, 1), Ci, Co, device=x.device)
        args = (x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
                N, Ci, Co, code, bn, splits, grid, stream)

    def run():
        err = lib.paddle_tpu_torch_wgrad_1x1(*args)
        if err:
            raise SystemExit(f"{label} launch failed: CUDA error {err}")
        return dw
    first = run().clone()
    torch.cuda.synchronize()
    if check:
        want = cw.wgrad_1x1_reference(x, dy, chunk=chunk)
        mass = x.float().abs().t() @ dy.float().abs()
        if not bool(((first - want).abs() <= chip_smoke.WGRAD_TOL * mass)
                    .all()):
            raise SystemExit(f"{label}: past WGRAD_TOL x sum |x dy| (max "
                             f"abs err {float((first - want).abs().max())})")
        if not torch.equal(run(), first):
            raise SystemExit(f"{label}: two launches gave different bits")
    run.err = float((first - cw.wgrad_1x1_reference(x, dy, chunk=chunk))
                    .abs().max()) if check else float("nan")
    return run


def bound_ms(x, dy):
    import chip_smoke
    name = str(x.dtype).split(".")[-1]
    N, Ci = x.shape
    Co = dy.shape[1]
    t_bytes = ((x.numel() + dy.numel()) * x.element_size()
               + Ci * Co * 4) / chip_smoke.PEAK_BYTES
    return max(t_bytes, 2 * N * Ci * Co / chip_smoke.PEAK_FLOPS[name]) * 1e3


def in_turns(runs, flush):
    import chip_smoke
    times = {"other": [], "this": []}
    for side in ("other", "this", "this", "other", "other", "this"):
        times[side].append(chip_smoke.cuda_ms(runs[side], flush=flush))
    return times, {s: sum(t) / len(t) for s, t in times.items()}


def report_ptxas(reports):
    for side, text in reports.items():
        for line in text.splitlines():
            if "spill" in line and not re.search(
                    r"0 bytes spill stores, 0 bytes spill loads", line):
                print(f"ptxas ({side}): {line.strip()}", flush=True)
        for name, use in sorted(usage(text).items()):
            print(f"{side}: {name}: [{use}]", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the other copy of conv_wgrad.cu")
    ap.add_argument("--sweep", action="store_true",
                    help="also time copies with other rings and splits")
    ap.add_argument("--probe", action="store_true",
                    help="also time copies without the wgmma or the finish")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_wgrad_ab: no CUDA device")
    import chip_smoke
    build = ROOT / "build" / "wgrad_ab"
    build.mkdir(parents=True, exist_ok=True)
    srcs = {"other": Path(args.parent), "this": SRC}
    with ThreadPoolExecutor(2) as ex:
        reports = dict(zip(srcs, ex.map(
            lambda side: compile_v(srcs[side], build / f"lib_{side}.so"),
            srcs)))
    report_ptxas(reports)
    libs = {side: load(build / f"lib_{side}.so", srcs[side].read_text())
            for side in srcs}
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    for N, Ci, Co, chunk, name in SHAPES:
        x, dy = case(N, Ci, Co, getattr(torch, name), dev)
        runs = {side: runner(libs[side], x, dy, chunk, f"{side} K6 {name}")
                for side in ("other", "this")}
        times, mean = in_turns(runs, flush)
        xt = x.t()
        lib_ms = chip_smoke.cuda_ms(lambda: torch.mm(xt, dy), flush=flush)
        nbytes = (x.numel() + dy.numel()) * x.element_size()
        print(f"K6 {name} x [{N}, {Ci}] dy [{N}, {Co}] ms on {card}: other "
              f"{[round(t, 4) for t in times['other']]} (mean "
              f"{mean['other']:.4f}, max abs err {runs['other'].err:.3g}), "
              f"this {[round(t, 4) for t in times['this']]} (mean "
              f"{mean['this']:.4f}, max abs err {runs['this'].err:.3g}): "
              f"{mean['this'] / mean['other'] - 1:+.2%}; this at "
              f"{nbytes / (mean['this'] * 1e-3) / 1e12:.2f} TB/s, bound "
              f"{bound_ms(x, dy):.4f}; yardstick torch.mm(x.t(), dy) "
              f"{lib_ms:.4f}", flush=True)
        del x, dy, xt, runs
    if args.sweep:
        sweep(build, flush, card)
    if args.probe:
        probe(build, flush, card)
    return 0


STAGES = "static constexpr int kStages = BN == 64 ? {} : {};"
ROWS = "constexpr int kRows = {};"


def copies(build, texts, prefix):
    """{name: library} of the sources `texts`, built in parallel."""
    def make(name):
        path = build / (prefix + re.sub(r"\W", "_", name) + ".cu")
        path.write_text(texts[name])
        compile_v(path, path.with_suffix(".so"))
        return load(path.with_suffix(".so"), texts[name])
    with ThreadPoolExecutor(len(texts)) as ex:
        return dict(zip(texts, ex.map(make, texts)))


def time_cells(cells, flush, card, what):
    """Each (name, library, plan, checked, shape index or None) timed at
    the bf16 shapes it names (None: both)."""
    import torch
    import chip_smoke
    for k, (N, Ci, Co, chunk, name) in enumerate(SHAPES[:2]):
        x, dy = case(N, Ci, Co, getattr(torch, name), torch.device("cuda"))
        out = []
        for label, lib, plan, check, only in cells:
            if only is not None and only != k:
                continue
            run = runner(lib, x, dy, chunk, f"{what} {label}", plan, check)
            out.append(f"{label} {chip_smoke.cuda_ms(run, flush=flush):.4f}")
        print(f"{what} K6 {name} x [{N}, {Ci}] dy [{N}, {Co}] ms on {card}: "
              + "; ".join(out), flush=True)
        del x, dy


def sweep(build, flush, card):
    """Copies with other ring depths and rows a stage, and this tree's
    kernel at other splits, each held against the plain version."""
    import torch
    from paddle_tpu_torch.ops import conv_wgrad as cw
    src = SRC.read_text()
    now = tuple(int(v) for v in re.search(
        STAGES.replace("{}", r"(\d+)").replace("?", r"\?"), src).groups())
    rows = int(re.search(ROWS.replace("{}", r"(\d+)"), src).group(1))
    texts = {}
    for r, st in ((rows, now), (32, (6, 6)), (32, (4, 4)), (64, (5, 4)),
                  (128, (2, 2))):
        name = f"{r} rows a stage, {st[0]}/{st[1]} stages" + (
            " (this tree)" if (r, st) == (rows, now) else "")
        texts[name] = src if (r, st) == (rows, now) else substitute(
            src, [(STAGES.format(*now), STAGES.format(*st)),
                  (ROWS.format(rows), ROWS.format(r))], "stages")
    built = copies(build, texts, "sweep_wgrad_")
    cells = [(n, lib, None, True, None) for n, lib in built.items()]
    this = built[next(n for n in built if "this tree" in n)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k, (N, Ci, Co, _chunk, name) in enumerate(SHAPES[:2]):
        bn, splits, grid = cw.plan(N, Ci, Co, getattr(torch, name), sms)
        for f, label in ((0.5, "half"), (2, "twice")):
            s = max(1, int(splits * f))
            cells.append((f"{label} the splits ({s})", this,
                          (bn, s, min(grid, s * (grid // splits))), True, k))
    time_cells(cells, flush, card, "sweep")


# The probe's cuts, as (pattern, replacement, count) of this tree's source.
_NO_WGMMA = (
    ("        wgmma_fence();\n#pragma unroll\n"
     "        for (int st = 0; st < kRows / 16; ++st) {", "#if 0\n"
     "        for (int st = 0; st < kRows / 16; ++st) {", 1),
    ("        wgmma_commit();\n        wgmma_wait<1>();  // the stage before"
     " this one is read: free it\n",
     "#endif\n", 1))
_NO_FINISH = (("  if (splits == 1) return;\n", "  return;\n", 1),)
_NO_ITEMS = (("for (int i = blockIdx.x; i < items; i += gridDim.x) {",
              "for (int i = blockIdx.x; i < 0; i += gridDim.x) {", 2),)


def cut(src, subs, what):
    for old, new, n in subs:
        if src.count(old) != n:
            raise SystemExit(f"torch_wgrad_ab --probe: the source changed "
                             f"({what}: {old.strip()[:60]!r})")
        src = src.replace(old, new)
    return src


def probe(build, flush, card):
    """The kernel beside copies with loads only, without the finish, and
    with the finish only."""
    src = SRC.read_text()
    texts = {"full": src, "loads only": cut(src, _NO_WGMMA, "loads only"),
             "no finish": cut(src, _NO_FINISH, "no finish"),
             "finish only": cut(src, _NO_ITEMS, "finish only")}
    built = copies(build, texts, "probe_wgrad_")
    time_cells([(n, lib, None, n == "full", None)
                for n, lib in built.items()], flush, card, "probe")
    read_yardstick(flush, card)


def read_yardstick(flush, card):
    """What one PyTorch read of the same bytes reaches: torch.sum over x
    and over dy, timed as the kernels are (no kernel of the port)."""
    import torch
    import chip_smoke
    for N, Ci, Co, _chunk, name in SHAPES[:2]:
        x, dy = case(N, Ci, Co, getattr(torch, name), torch.device("cuda"))
        ms = chip_smoke.cuda_ms(lambda: (x.sum(), dy.sum()), flush=flush)
        nbytes = (x.numel() + dy.numel()) * x.element_size()
        print(f"read yardstick: torch.sum(x), torch.sum(dy) at [{N}, {Ci}] "
              f"/ [{N}, {Co}] {name} on {card}: {ms:.4f} ms, "
              f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s", flush=True)
        del x, dy


if __name__ == "__main__":
    sys.exit(main())
