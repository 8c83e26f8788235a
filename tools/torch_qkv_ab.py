"""Parent-against-change check of the port's fused QKV projection (K5) on
one card.

    python tools/torch_qkv_ab.py --parent OTHER/qkv_proj.cu [--sweep]

Builds `paddle_tpu_torch/ops/csrc/qkv_proj.cu` of this tree and another
copy of it (for example the parent commit's, unpacked with `git
archive`) with `nvcc -Xptxas -v`, and prints:

* registers, stack, spills and shared memory of every kernel of each
  copy, side by side where both have it;
* K5 at the train step's x [8, 1024, 1024] x w_qkv [1024, 3072] into
  3 x [8, 16, 1024, 64], bf16, fp16 and fp32, timed in turns (other,
  this, this, other, other, this) with CUDA events and L2 flushed, as
  `chip_smoke.py` times kernels, beside `torch.addmm` over the same
  product (no head layout), the bound and the achieved TFLOP/s; each
  side's output is held against the plain version first.

With `--sweep` it also builds copies of this tree's source with other
block tiles (256 or 128 columns) and ring depths (2 to 4 stages), and
times each bf16 at the same shape with one block a tile and persistent
(a block on each SM, as `plan` takes it). With `--probe` it builds copies
of this tree's wgmma kernel whose consumers skip the wgmma, or the
epilogue's stores to device memory, or both (their outputs are wrong;
they keep every load, barrier and the staging), and times them beside
the full kernel under `plan`'s grid: what is left without either is the
loads' and barriers' time.

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

from torch_flash_ab import compile_v, usage  # noqa: E402

SRC = ROOT / "paddle_tpu_torch/ops/csrc/qkv_proj.cu"
B, S, D, H = 8, 1024, 1024, 16
# the sweep's knobs, as the source spells them in the wgmma kernel's
# namespace
KNOBS = {"kBN": r"constexpr int kBN = (\d+);",
         "kStages": r"constexpr int kStages = (\d+);"}
# the sweep's configurations (those shared memory allows)
SWEEP = [dict(kBN=bn, kStages=st)
         for bn, st in ((256, 4), (256, 3), (256, 2), (128, 4), (128, 3))]


def load(path):
    """The library at `path` and a caller for its K5 entry: the wgmma
    entry for 16-bit operands where the library has it, else the one
    entry (whose dtype argument a library without it takes)."""
    from paddle_tpu_torch.ops import qkv_proj as qp
    lib = ctypes.CDLL(str(path))
    new = hasattr(lib, "paddle_tpu_torch_qkv_proj_wgmma")
    sigs = dict(qp._SIGNATURES) if new else {
        "paddle_tpu_torch_qkv_proj": [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]}
    for fn, argtypes in sigs.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib, new


def caller(lib, new, x, w, b, qkv, grid=None):
    import torch
    from paddle_tpu_torch.ops import qkv_proj as qp
    ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(),
            *(t.data_ptr() for t in qkv))
    code = qp._DTYPE_CODES[x.dtype]
    if grid is None:
        grid = qp.plan(B, S, H, qp._sms(x.device))["grid"]

    def run():
        st = torch.cuda.current_stream().cuda_stream
        if not new:
            err = lib.paddle_tpu_torch_qkv_proj(*ptrs, B, S, D, H, code, st)
        elif code == 0:
            err = lib.paddle_tpu_torch_qkv_proj(*ptrs, B, S, D, H, st)
        else:
            err = lib.paddle_tpu_torch_qkv_proj_wgmma(*ptrs, B, S, D, H, code,
                                                      grid, st)
        if err:
            raise SystemExit(f"K5 launch failed: CUDA error {err}")
    return run


def operands(dtype, dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, S, D, generator=g, device=dev).to(dtype)
    w = (torch.randn(D, 3 * D, generator=g, device=dev) * D ** -0.5).to(dtype)
    b = (torch.randn(3 * D, generator=g, device=dev) * 0.1).to(dtype)
    return x, w, b


def bound_ms(dtype):
    import chip_smoke
    name = str(dtype).split(".")[-1]
    flops = 2 * B * S * D * 3 * D
    nbytes = (B * S * D * 4 + D * 3 * D + 3 * D) * (
        4 if name == "float32" else 2)
    return max(flops / chip_smoke.PEAK_FLOPS[name],
               nbytes / chip_smoke.PEAK_BYTES) * 1e3, flops


def check(run, qkv, want, label, tol):
    import torch
    import chip_smoke
    run()
    torch.cuda.synchronize()
    for n, a, e in zip("qkv", qkv, want):
        chip_smoke.close_or_fail(f"{label} {n}", a, e, tol)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the other copy of qkv_proj.cu")
    ap.add_argument("--sweep", action="store_true",
                    help="also time other tiles and ring depths")
    ap.add_argument("--probe", action="store_true",
                    help="also time copies without the wgmma or stores")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_qkv_ab: no CUDA device")
    import chip_smoke
    from paddle_tpu_torch.ops import qkv_proj as qp
    build = ROOT / "build" / "qkv_ab"
    build.mkdir(parents=True, exist_ok=True)
    libs, reports = {}, {}
    for side, src in (("other", Path(args.parent)), ("this", SRC)):
        reports[side] = usage(compile_v(src, build / f"lib_{side}.so"))
        libs[side] = load(build / f"lib_{side}.so")
    for name in sorted(set(reports["other"]) | set(reports["this"])):
        o, t = reports["other"].get(name), reports["this"].get(name)
        tag = ("same" if o == t else "DIFFERS") if o and t else (
            "only in the other copy" if o else "only in this tree")
        print(f"{tag}: {name}: other [{o}]; this [{t}]", flush=True)

    dev = torch.device("cuda")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    card = torch.cuda.get_device_name(0)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        name = str(dtype).split(".")[-1]
        x, w, b = operands(dtype, dev)
        want = qp.qkv_proj_reference(x, w, b, H)
        runs = {}
        for side in ("other", "this"):
            qkv = [torch.empty(B, H, S, 64, dtype=dtype, device=dev)
                   for _ in range(3)]
            runs[side] = caller(*libs[side], x, w, b, qkv)
            check(runs[side], qkv, want, f"{side} K5 {name}",
                  chip_smoke.TRAIN_TOL["float32" if name == "float32"
                                       else "bfloat16"])
        times = {"other": [], "this": []}
        for side in ("other", "this", "this", "other", "other", "this"):
            times[side].append(chip_smoke.cuda_ms(runs[side], flush=flush))
        lib_ms = chip_smoke.cuda_ms(
            lambda: torch.addmm(b, x.view(-1, D), w), flush=flush)
        bound, flops = bound_ms(dtype)
        mean = {s: sum(t) / len(t) for s, t in times.items()}
        print(f"K5 {name} x [{B}, {S}, {D}] x [{D}, {3 * D}] ms on {card}: "
              f"other {[round(t, 4) for t in times['other']]} (mean "
              f"{mean['other']:.4f}), this "
              f"{[round(t, 4) for t in times['this']]} (mean "
              f"{mean['this']:.4f}): {mean['this'] / mean['other'] - 1:+.2%};"
              f" torch.addmm {lib_ms:.4f}; bound {bound:.4f}, this at "
              f"{flops / (mean['this'] * 1e-3) / 1e12:.1f} TFLOP/s, "
              f"{bound / mean['this']:.1%} of the bound", flush=True)
        del x, w, b, want
    if args.sweep:
        sweep(build, flush, card)
    if args.probe:
        probe(build, flush, card)
    return 0


# The probe's cuts of the wgmma kernel, as text of this tree's source.
_WGMMA = ("          wgmma_ss<T, kBN, 1>(acc, desc_k(xs + 32 * s),\n"
          "                              desc_mn(ws + 2048 * s, kBoxBytes), "
          "1);\n")
_STORE = ("tma_store_3d(third == 0 ? &qmap : third == 1 ? &kmap : &vmap,\n"
          "                           buf, 0, mb % S, mb / S * H + head);")


def probe(build, flush, card):
    """The wgmma kernel beside copies without its wgmma, its stores, or
    both."""
    import torch
    import chip_smoke
    from paddle_tpu_torch.ops import qkv_proj as qp
    src = SRC.read_text()
    if _WGMMA not in src or _STORE not in src:
        raise SystemExit("torch_qkv_ab --probe: the kernel's text changed")
    no_wgmma = src.replace(_WGMMA, "          ;\n")
    cuts = {"full": src, "no wgmma": no_wgmma,
            "no stores": src.replace(_STORE, ";"),
            "neither": no_wgmma.replace(_STORE, ";")}

    def make(cut):
        path = build / f"probe_{cut.replace(' ', '_')}.cu"
        path.write_text(cuts[cut])
        compile_v(path, path.with_suffix(".so"))
        return load(path.with_suffix(".so"))
    with ThreadPoolExecutor(len(cuts)) as ex:
        libs = dict(zip(cuts, ex.map(make, cuts)))
    dev = torch.device("cuda")
    x, w, b = operands(torch.bfloat16, dev)
    qkv = [torch.empty(B, H, S, 64, dtype=x.dtype, device=dev)
           for _ in range(3)]
    cells = []
    for cut, lib in libs.items():
        run = caller(*lib, x, w, b, qkv)
        cells.append(f"{cut} {chip_smoke.cuda_ms(run, flush=flush):.4f} "
                     f"(L2 warm {chip_smoke.cuda_ms(run):.4f})")
    print(f"probe K5 bf16 x [{B}, {S}, {D}] x [{D}, {3 * D}] ms on {card}, "
          f"grid {qp.plan(B, S, H, qp._sms(dev))['grid']}: "
          + "; ".join(cells), flush=True)


def sweep(build, flush, card):
    """This tree's wgmma kernel at other tiles and depths."""
    import torch
    import chip_smoke
    from paddle_tpu_torch.ops import qkv_proj as qp
    head, sep, src = SRC.read_text().partition("namespace wg {")
    now = {k: int(re.search(p, src).group(1)) for k, p in KNOBS.items()}
    variants = SWEEP

    def make(var):
        text = src
        for k, v in var.items():
            text = re.sub(KNOBS[k], KNOBS[k].replace(r"(\d+)", str(v))
                          .replace("\\", ""), text)
        path = build / ("sweep_" + "_".join(f"{k}{v}" for k, v in
                                            var.items()) + ".cu")
        path.write_text(head + sep + text)
        compile_v(path, path.with_suffix(".so"))
        return load(path.with_suffix(".so"))
    with ThreadPoolExecutor(4) as ex:
        libs = list(ex.map(make, variants))
    dev = torch.device("cuda")
    x, w, b = operands(torch.bfloat16, dev)
    want = qp.qkv_proj_reference(x, w, b, H)
    qkv = [torch.empty(B, H, S, 64, dtype=x.dtype, device=dev)
           for _ in range(3)]
    bound, flops = bound_ms(x.dtype)
    sms = qp._sms(dev)
    for var, lib in zip(variants, libs):
        tiles = -(-B * S // 128) * -(-3 * D // var["kBN"])
        cells = []
        for label, grid in (("a block a tile", tiles),
                            ("persistent", min(tiles, sms))):
            run = caller(*lib, x, w, b, qkv, grid=grid)
            check(run, qkv, want, f"sweep {var} {label}", 2e-2)
            ms = chip_smoke.cuda_ms(run, flush=flush)
            cells.append(f"{label} {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                         f"TFLOP/s, {bound / ms:.1%} of the bound)")
        mark = " (this tree; plan: persistent)" if var == now else ""
        print(f"sweep K5 bf16 {var}{mark} on {card}: " + "; ".join(cells),
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
