"""Parent-against-change check of the port's add+LayerNorm kernels (K2)
on one card.

    python tools/torch_ln_ab.py --parent OTHER/layer_norm.cu [--sweep] [--probe]

Builds `paddle_tpu_torch/ops/csrc/layer_norm.cu` of this tree and
another copy of it (for example the parent commit's, unpacked with
`git archive`) with `nvcc -Xptxas -v`, and prints:

* registers, stack and spills of every kernel of each copy (ptxas
  lines that report spills printed on their own);
* the forward and the backward at the train step's [8192, 1024] in bf16
  and fp32, timed in turns (other, this, this, other, other, this) with
  CUDA events and L2 flushed, as `chip_smoke.py` times kernels, each
  side held against the plain version first. The backward is timed as
  the train step runs it, dw and db included: a copy whose backward
  leaves them out (the parent's) gets the plain version's torch sums
  after its kernel, as its wrapper ran them. Beside them: GB/s of each
  side (the forward moves x, r, out and z, the backward z, g, g_z and
  dz), the bound, and the yardsticks `F.layer_norm` over the pre-added
  z (2 tensors moved) and its backward with w and b requiring grad (dx,
  dw and db in one call; 3 tensors);

With `--sweep` it also builds copies of this tree's source with 4, 8
or 16 warps a block, compiled for 1 to 4 blocks an SM, and rings of 1
to 4 staged rows (forward and backward apart) and times them at the
bf16 shape. With `--probe` it builds copies without the stores of out,
z and dz (each made conditional on a value that never occurs), with
the loads only (no stores, no row reductions), without the rows staged
ahead (a ring of one row: each copied when its turn comes), and a
backward without its dw and db sums (registers freed), and one with only the
tail that adds the blocks' dw and db partials; each timed at the bf16
shape.

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

SHAPE = (8192, 1024)  # the train step's rows x d
_CODES = {"float32": 0, "bfloat16": 1, "float16": 2}


def load(path, text):
    """The library at `path`; `text`, its source, says whether its
    backward sums dw and db (this tree's does)."""
    lib = ctypes.CDLL(str(path))
    lib.paddle_tpu_torch_add_ln_fwd.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    lib.sums = "paddle_tpu_torch_add_ln_bwd_blocks" in text
    if lib.sums:
        lib.paddle_tpu_torch_add_ln_bwd_blocks.argtypes = [
            ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
        lib.paddle_tpu_torch_add_ln_bwd.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
    else:
        lib.paddle_tpu_torch_add_ln_bwd.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
    for fn in ("paddle_tpu_torch_add_ln_fwd", "paddle_tpu_torch_add_ln_bwd"):
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def case(dtype, dev):
    """x, r, w, b, g, g_z at SHAPE, and the plain forward's (out, z, mu,
    rstd)."""
    import torch
    from paddle_tpu_torch.ops import layer_norm as ln
    g = torch.Generator(device=dev).manual_seed(0)
    x, r, gout, gz = (torch.randn(*SHAPE, generator=g, device=dev,
                                  dtype=dtype) for _ in range(4))
    w = torch.rand(SHAPE[1], generator=g, device=dev)
    b = torch.randn(SHAPE[1], generator=g, device=dev)
    return (x, r, w, b, gout, gz), ln.add_ln_fwd_reference(x, r, w, b, 1e-5)


def fwd_run(lib, args, want, label, check=True):
    """A launch of the library's forward, held against `want` once."""
    import torch
    import chip_smoke
    x, r, w, b, _g, _gz = args
    out, z = torch.empty_like(x), torch.empty_like(x)
    mu = torch.empty(x.shape[0], device=x.device)
    rs = torch.empty_like(mu)

    def run():
        err = lib.paddle_tpu_torch_add_ln_fwd(
            x.data_ptr(), r.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), z.data_ptr(), mu.data_ptr(), rs.data_ptr(),
            x.shape[0], x.shape[1], _CODES[str(x.dtype).split(".")[-1]],
            1e-5, torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{label} launch failed: CUDA error {err}")
    run()
    torch.cuda.synchronize()
    if check:
        tol = chip_smoke.TRAIN_TOL[str(x.dtype).split(".")[-1]]
        for n, a, e in zip(("out", "z", "mu", "rstd"), (out, z, mu, rs), want):
            chip_smoke.close_or_fail(f"{label} {n}", a, e, tol)
    return run


def bwd_run(lib, args, want, label, check=True):
    """The library's backward as the train step runs it (dz, dw, db; a
    library without dw and db gets its wrapper's torch sums), held
    against the plain backward once."""
    import torch
    import chip_smoke
    from paddle_tpu_torch.ops import layer_norm as ln
    _x, _r, w, _b, g2, gz2 = args
    _out, z2, mu, rs = want
    rows, d = z2.shape
    code = _CODES[str(z2.dtype).split(".")[-1]]
    dz = torch.empty_like(z2)
    res = {}
    if lib.sums:
        blocks = lib.paddle_tpu_torch_add_ln_bwd_blocks(
            z2.data_ptr(), g2.data_ptr(), gz2.data_ptr(), dz.data_ptr(), rows,
            d, code)
        if blocks <= 0:
            raise SystemExit(f"{label}: no grid (CUDA error {-blocks})")
        part = torch.empty(blocks, 2, d, device=z2.device)
        dw, db = (torch.empty(d, device=z2.device) for _ in range(2))

        def run():
            blocks = lib.paddle_tpu_torch_add_ln_bwd_blocks(
                z2.data_ptr(), g2.data_ptr(), gz2.data_ptr(), dz.data_ptr(),
                rows, d, code)
            err = lib.paddle_tpu_torch_add_ln_bwd(
                z2.data_ptr(), w.data_ptr(), mu.data_ptr(), rs.data_ptr(),
                g2.data_ptr(), gz2.data_ptr(), dz.data_ptr(), part.data_ptr(),
                dw.data_ptr(), db.data_ptr(), blocks, rows, d, code,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"{label} launch failed: CUDA error {err}")
            res["dw"], res["db"] = dw, db
    else:
        def run():
            err = lib.paddle_tpu_torch_add_ln_bwd(
                z2.data_ptr(), w.data_ptr(), mu.data_ptr(), rs.data_ptr(),
                g2.data_ptr(), gz2.data_ptr(), dz.data_ptr(), rows, d, code,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"{label} launch failed: CUDA error {err}")
            # the parent wrapper's per-feature sums
            zhat = (z2.float() - mu[:, None]) * rs[:, None]
            gf = g2.float()
            res["dw"], res["db"] = (gf * zhat).sum(0), gf.sum(0)
    run()
    torch.cuda.synchronize()
    if check:
        ref_dz, ref_dw, ref_db = ln.add_ln_bwd_reference(z2, w, mu, rs, g2,
                                                         gz2)
        tol = chip_smoke.TRAIN_TOL[str(z2.dtype).split(".")[-1]]
        chip_smoke.close_or_fail(f"{label} dz", dz, ref_dz, tol)
        zhat = (z2.float() - mu[:, None]) * rs[:, None]
        for n, got, ref, terms in (("dw", res["dw"], ref_dw, g2.float() * zhat),
                                   ("db", res["db"], ref_db, g2.float())):
            bound = 1e-6 * terms.abs().sum(0)
            if not bool(((got - ref).abs() <= bound).all()):
                raise SystemExit(f"{label} {n}: past 1e-6 of the column's "
                                 f"sum of |terms|")
    return run


def yardsticks(args, want, flush):
    """{"forward" / "backward": SDPA-style one-call yardstick ms}:
    F.layer_norm over the pre-added z, and its backward with w and b
    requiring grad (dx, dw, db)."""
    import torch
    import torch.nn.functional as F
    import chip_smoke
    _x, _r, w, b, g2, _gz = args
    z = want[1]
    d = z.shape[1]
    wd, bd = w.to(z.dtype), b.to(z.dtype)
    fwd = chip_smoke.cuda_ms(lambda: F.layer_norm(z, (d,), wd, bd, 1e-5),
                             flush=flush)
    leaves = [t.detach().requires_grad_() for t in (z, wd, bd)]
    lo = F.layer_norm(leaves[0], (d,), leaves[1], leaves[2], 1e-5)
    bwd = chip_smoke.cuda_ms(lambda: torch.autograd.grad(
        lo, leaves, g2, retain_graph=True), flush=flush)
    return {"forward": fwd, "backward": bwd}


def in_turns(runs, flush):
    import chip_smoke
    times = {"other": [], "this": []}
    for side in ("other", "this", "this", "other", "other", "this"):
        times[side].append(chip_smoke.cuda_ms(runs[side], flush=flush))
    return times, {s: sum(t) / len(t) for s, t in times.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the other copy of layer_norm.cu")
    ap.add_argument("--sweep", action="store_true",
                    help="also time copies with other warps a block")
    ap.add_argument("--probe", action="store_true",
                    help="also time copies without stores, reductions, "
                         "loads ahead or the dw/db sums")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_ln_ab: no CUDA device")
    import chip_smoke
    build = ROOT / "build" / "ln_ab"
    build.mkdir(parents=True, exist_ok=True)
    srcs = {"other": Path(args.parent),
            "this": ROOT / "paddle_tpu_torch/ops/csrc/layer_norm.cu"}
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
            print(f"{side}: {name}: [{use}]", flush=True)
    libs = {side: load(build / f"lib_{side}.so", srcs[side].read_text())
            for side in srcs}
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        ops, want = case(dtype, dev)
        yard = yardsticks(ops, want, flush)
        nbytes = 4 * ops[0].numel() * ops[0].element_size()
        lib_bytes = {"forward": 2 * nbytes // 4, "backward": 3 * nbytes // 4}
        bound, _ = chip_smoke.add_ln_bound(ops[0])
        for part, make in (("forward", fwd_run), ("backward", bwd_run)):
            runs = {side: make(libs[side], ops, want,
                               f"{side} K2 {part} {name}")
                    for side in ("other", "this")}
            times, mean = in_turns(runs, flush)
            print(f"K2 {part} {name} {list(SHAPE)} ms on {card}: other "
                  f"{[round(t, 4) for t in times['other']]} (mean "
                  f"{mean['other']:.4f}), this "
                  f"{[round(t, 4) for t in times['this']]} (mean "
                  f"{mean['this']:.4f}): {mean['this'] / mean['other'] - 1:+.2%}"
                  f"{' (dw, db included)' if part == 'backward' else ''}; "
                  f"this at {nbytes / (mean['this'] * 1e-3) / 1e9:.0f} GB/s "
                  f"(4 tensors), {bound / mean['this']:.1%} of the bound "
                  f"{bound:.4f}; yardstick F.layer_norm"
                  f"{' backward (dx, dw, db)' if part == 'backward' else ''}"
                  f" {yard[part]:.4f} ms at "
                  f"{lib_bytes[part] / (yard[part] * 1e-3) / 1e9:.0f} GB/s "
                  f"({2 if part == 'forward' else 3} tensors)", flush=True)
        del ops, want
    if args.sweep:
        sweep(build, flush, card)
    if args.probe:
        probe(build, flush, card)
    return 0


# the warps a block of each kernel, and the blocks an SM it is compiled
# for, as the source spells them
WARPS = "constexpr int kFwdWarps = {}, kBwdWarps = {};"
MIN_BLOCKS = "constexpr int kFwdMinBlocks = {}, kBwdMinBlocks = {};"


def ring_now(src):
    return tuple(int(x) for x in re.search(
        RING.replace("{}", r"(\d+)"), src).groups())


def copies(build, texts, prefix):
    """{name: library} of the sources `texts`, built in parallel."""
    def make(name):
        path = build / (prefix + re.sub(r"\W", "_", name) + ".cu")
        path.write_text(texts[name])
        report = compile_v(path, path.with_suffix(".so"))
        return load(path.with_suffix(".so"), texts[name]), report
    with ThreadPoolExecutor(len(texts)) as ex:
        return dict(zip(texts, ex.map(make, texts)))


def time_copies(built, flush, card, what, right):
    """Each copy of `built` timed at the bf16 shape, those named in
    `right` (whose outputs are still right) held against the plain
    version first."""
    import torch
    import chip_smoke
    ops, want = case(torch.bfloat16, torch.device("cuda"))
    for part, make in (("forward", fwd_run), ("backward", bwd_run)):
        cells = []
        for name, (lib, _report) in built.items():
            run = make(lib, ops, want, f"{what} {name} {part}",
                       check=name in right)
            cells.append(f"{name} {chip_smoke.cuda_ms(run, flush=flush):.4f}")
        print(f"{what} K2 {part} bfloat16 {list(SHAPE)} ms on {card}: "
              + "; ".join(cells), flush=True)


def sweep(build, flush, card):
    """Copies with other warps a block or blocks an SM, each held
    against the plain version."""
    src = (ROOT / "paddle_tpu_torch/ops/csrc/layer_norm.cu").read_text()
    now = tuple(int(x) for x in re.search(
        WARPS.replace("{}", r"(\d+)"), src).groups()) + tuple(
        int(x) for x in re.search(
            MIN_BLOCKS.replace("{}", r"(\d+)"), src).groups())
    now += ring_now(src)
    texts = {}
    for var in ((8, 8, 2, 1, 3, 3), (8, 8, 2, 1, 2, 2), (8, 8, 2, 1, 4, 4),
                (4, 4, 4, 2, 3, 2), (16, 16, 1, 1, 2, 1), (8, 8, 2, 2, 3, 2)):
        name = (f"{var[0]}/{var[1]} warps, {var[2]}/{var[3]} blocks an SM, "
                f"rings of {var[4]}/{var[5]} rows"
                + (" (this tree)" if var == now else ""))
        texts[name] = src if var == now else substitute(
            src, [(WARPS.format(*now[:2]), WARPS.format(*var[:2])),
                  (MIN_BLOCKS.format(*now[2:4]), MIN_BLOCKS.format(*var[2:4])),
                  (RING.format(*now[4:]), RING.format(*var[4:]))],
            "warps")
    built = copies(build, texts, "sweep_ln_")
    for name, (_lib, report) in built.items():
        spills = [ln.strip() for ln in report.splitlines() if "spill" in ln
                  and not re.search(r"0 bytes spill stores, 0 bytes spill "
                                    r"loads", ln)]
        print(f"sweep K2 {name}: {len(spills)} kernels spill", flush=True)
    time_copies(built, flush, card, "sweep", set(built))


# The probe's cuts, as (pattern, replacement) pairs of this tree's
# source; each pattern must occur as often as said.
_NO_STORES = (
    ("*reinterpret_cast<Vec<T, V>*>(out + base + e) = ov;",
     "if (to_float(ov.v[0]) == -1234.5f)\n"
     "          *reinterpret_cast<Vec<T, V>*>(out + base + e) = ov;", 1),
    ("store_cs<T, V>(z + base + e, zv);",
     "if (to_float(zv.v[0]) == -1234.5f)\n"
     "          store_cs<T, V>(z + base + e, zv);", 1),
    ("*reinterpret_cast<Vec<T, V>*>(dz + base + e) = dv;",
     "if (to_float(dv.v[0]) == -1234.5f)\n"
     "          *reinterpret_cast<Vec<T, V>*>(dz + base + e) = dv;", 1))
_NO_REDUCTIONS = (
    ("  s.x = warp_sum(s.x);\n  s.y = warp_sum(s.y);\n"
     "  if constexpr (W > 1) {",
     "  if constexpr (false) {", 1),)
# no loads ahead: a ring of one row (each row copied when its turn comes)
RING = "constexpr int kFwdRing = {}, kBwdRing = {};"
_NO_SUMS = (
    ("          dwa[i][j] += gf * zh;\n          dba[i][j] += gf;\n", "", 1),)
_TAIL_ONLY = (
    ("  kern<<<grid, kBwdWarps * 32, smem, stream>>>(\n"
     "      static_cast<const T*>(z), w, mu, rs, static_cast<const T*>(g),\n"
     "      static_cast<const T*>(gz), static_cast<T*>(dz), part, rows, d);\n",
     "", 1),)


def cut(src, subs, what):
    for old, new, n in subs:
        if src.count(old) != n:
            raise SystemExit(f"torch_ln_ab --probe: the source changed "
                             f"({what}: {old.strip()[:60]!r})")
        src = src.replace(old, new)
    return src


def probe(build, flush, card):
    """The kernels beside copies without stores, with loads only,
    without loads ahead, without the dw/db sums, and the dw/db tail
    alone."""
    src = (ROOT / "paddle_tpu_torch/ops/csrc/layer_norm.cu").read_text()
    no_stores = cut(src, _NO_STORES, "no stores")
    texts = {"full": src, "no stores": no_stores,
             "loads only": cut(no_stores, _NO_REDUCTIONS, "loads only"),
             "no loads ahead": substitute(src, [(RING.format(*ring_now(src)),
                                                 RING.format(1, 1))],
                                          "ring"),
             "no dw/db sums": cut(src, _NO_SUMS, "no dw/db sums"),
             "dw/db tail only": cut(src, _TAIL_ONLY, "dw/db tail only")}
    time_copies(copies(build, texts, "probe_ln_"), flush, card, "probe",
                {"full", "no loads ahead"})


if __name__ == "__main__":
    sys.exit(main())
