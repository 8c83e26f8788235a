"""Parent-against-change check of the port's grouped expert matmul (K4)
on one card.

    python tools/torch_gmm_ab.py --parent OTHER/grouped_matmul.cu

Builds `paddle_tpu_torch/ops/csrc/grouped_matmul.cu` of this tree and
another copy of it (for example the parent commit's, unpacked with
`git archive`) with `nvcc -Xptxas -v`, and prints:

* registers, stack, spills and shared memory of every kernel the other
  copy has, beside the same kernel of this tree, and whether they are
  equal; kernels that only one copy has are listed as such;
* K4 at the MoE decode step's two products, ffn1 [8, 80, 1024] x
  [1024, 4096] and ffn2 [8, 80, 4096] x [4096, 1024], for float weights
  (bf16, fp16 and fp32) and int8 and int4 weights (bf16 and fp32
  activations), timed in turns (other, this, this, other, other, this)
  with CUDA events and L2 flushed, as `chip_smoke.py` times kernels,
  beside `torch.bmm` on a pre-dequantized copy, the byte bound, the
  achieved bytes/s and TFLOP/s; each side's output is held against the
  plain version first. Each side takes its own routing: this tree's
  `plan`, and for the other copy its wgmma entry for int8 and int4 under
  16-bit activations (where it has one) and its mma entry for the rest,
  as the port before float weights reached the wgmma kernel routed them.

With `--sweep` it also times this tree's wgmma kernel at both products
with D split in 1, 2, 3 and 4 parts (int8, int4 and float weights,
bf16 activations), L2 flushed and warm, beside the split `plan` takes,
and copies of it whose float-weight ring holds 2 to 6 stages (5 and 6
leave one block an SM). With `--probe` it builds copies of this tree's
source whose consumers skip the dequant (the raw words are the
fragments), the wgmma, or both (their outputs are wrong; they keep
every load, barrier and store), and times them beside the full kernel
at the planned split: what is left when both are gone is the data
movement's time; for float weights, where nothing is dequantized, the
copy without the wgmma is the loads and the epilogue alone.

With `--moe-step` it serves MoE-350M (`chip_smoke.py`'s phase 5b model)
with float, int8 and int4 experts, once through the other copy's
kernels and once through this tree's, and profiles a decode window of
each (`chip_smoke.profile_decode`): the step's device time and the
grouped matmuls' share of it.

Needs a card and nvcc; imports torch and the port only.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from torch_flash_ab import compile_v, usage  # noqa: E402


def load(path):
    from paddle_tpu_torch.ops import grouped_matmul as gm
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in gm._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def caller(lib, x, w, scale, out, plan):
    """A launch of the library's K4 entry for (x, w, scale) into `out`:
    the q16 entry where the library has it and the plan takes it, else
    the mma entry."""
    import torch
    from paddle_tpu_torch.ops import grouped_matmul as gm
    E, C, D = x.shape
    F = w.shape[2]
    fmt = 0 if scale is None else (1 if w.shape[1] == D else 2)
    qmax = 127.0 if fmt == 1 else 7.0
    args = (x.data_ptr(), w.data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(),
            E, C, D, F, gm._DTYPE_CODES[x.dtype], fmt,
            0 if scale is None else gm._DTYPE_CODES[scale.dtype], qmax)
    how = plan(E, C, D, F, fmt, x.dtype)
    q16 = how is not None and hasattr(
        lib, "paddle_tpu_torch_grouped_matmul_q16")

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        if q16:
            err = lib.paddle_tpu_torch_grouped_matmul_q16(
                *args, how["split"], gm._vec_ok(x, D), gm._vec_ok(w, F),
                stream)
        else:
            err = lib.paddle_tpu_torch_grouped_matmul(
                *args, gm._vec_ok(x, D), gm._vec_ok(w, F), stream)
        if err:
            raise SystemExit(f"K4 launch failed: CUDA error {err}")
    return run


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the other copy of grouped_matmul.cu")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every split of the quantized kernel")
    ap.add_argument("--probe", action="store_true",
                    help="also time copies without dequant and/or wgmma")
    ap.add_argument("--moe-step", action="store_true",
                    help="also profile the int8 / int4 MoE decode step on "
                         "each copy")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_gmm_ab: no CUDA device")
    import chip_smoke
    from paddle_tpu_torch.ops import grouped_matmul as gm
    build = ROOT / "build" / "gmm_ab"
    build.mkdir(parents=True, exist_ok=True)
    libs, reports = {}, {}
    for side, src in (("other", Path(args.parent)),
                      ("this", ROOT / "paddle_tpu_torch/ops/csrc/"
                               "grouped_matmul.cu")):
        reports[side] = usage(compile_v(src, build / f"lib_{side}.so"))
        libs[side] = load(build / f"lib_{side}.so")
    same = True
    for name, use in sorted(reports["other"].items()):
        mine = reports["this"].get(name)
        if mine is None:
            print(f"only in the other copy: {name}: [{use}]", flush=True)
            continue
        ok = mine == use
        same &= ok
        print(f"{'same' if ok else 'DIFFERS'}: {name}: other [{use}]; this "
              f"[{mine}]", flush=True)
    for name in sorted(set(reports["this"]) - set(reports["other"])):
        print(f"only in this tree: {name}: [{reports['this'][name]}]",
              flush=True)
    print(f"registers and spills of the kernels both copies have: "
          f"{'unchanged' if same else 'CHANGED'}", flush=True)

    def this_plan(E, C, D, F, fmt, xdt):
        p = gm.plan(E, C, D, F, fmt, xdt, gm._sms(torch.device("cuda")))
        return p if p["kernel"] == "q16" else None

    def other_plan(E, C, D, F, fmt, xdt):
        return this_plan(E, C, D, F, fmt, xdt) if fmt else None

    plans = {"other": other_plan, "this": this_plan}
    dev = torch.device("cuda")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    name = torch.cuda.get_device_name(0)
    D, F = chip_smoke.HIDDEN, 4 * chip_smoke.HIDDEN
    for variant, xdt in (("fp", torch.bfloat16), ("fp", torch.float16),
                         ("fp", torch.float32), ("int8", torch.float32),
                         ("int4", torch.float32), ("int8", torch.bfloat16),
                         ("int4", torch.bfloat16)):
        dname = str(xdt).split(".")[-1]
        for prod, (d_in, d_out) in (("ffn1", (D, F)), ("ffn2", (F, D))):
            x, w, scale = chip_smoke.gmm_case(gm, variant, xdt, d_in, d_out,
                                              dev)
            want = gm.grouped_matmul_reference(x, w, scale)
            tol = chip_smoke.GMM_TOL.get(dname,
                                         chip_smoke.GMM_TOL["bfloat16"])
            runs = {}
            for side in ("other", "this"):
                out = torch.empty_like(want)
                runs[side] = caller(libs[side], x, w, scale, out,
                                    plans[side])
                runs[side]()
                torch.cuda.synchronize()
                chip_smoke.close_or_fail(f"{side} gmm_{variant} {dname} "
                                         f"{prod}", out, want, tol)
            times = {"other": [], "this": []}
            for side in ("other", "this", "this", "other", "other", "this"):
                times[side].append(chip_smoke.cuda_ms(runs[side],
                                                      flush=flush))
            w_lib = gm.dequantize(w, scale, d_in, xdt)
            lib_ms = chip_smoke.cuda_ms(lambda: torch.bmm(x, w_lib),
                                        flush=flush)
            bound_ms, bound_by = chip_smoke.gmm_bound(x, w, scale, d_out)
            nbytes = bound_ms * 1e-3 * chip_smoke.PEAK_BYTES \
                if bound_by == "bytes" else None
            mean = {s: sum(t) / len(t) for s, t in times.items()}
            flops = 2 * x.shape[0] * x.shape[1] * d_in * d_out
            rate = (f"; this at {flops / (mean['this'] * 1e-3) / 1e12:.1f}"
                    f" TFLOP/s") + ("" if nbytes is None else (
                        f", moves {nbytes / (mean['this'] * 1e-3) / 1e12:.3f}"
                        f" TB/s"))
            print(f"K4 {variant} {dname} {prod} [{x.shape[0]}, "
                  f"{x.shape[1]}, {d_in}] x [{d_in}, {d_out}] ms on {name}:"
                  f" other {[round(t, 4) for t in times['other']]} (mean "
                  f"{mean['other']:.4f}), this "
                  f"{[round(t, 4) for t in times['this']]} (mean "
                  f"{mean['this']:.4f}): "
                  f"{mean['this'] / mean['other'] - 1:+.2%};"
                  f" torch.bmm{'' if scale is None else ' (pre-dequantized)'}"
                  f" {lib_ms:.4f}; bound {bound_ms:.4f} ({bound_by}), this "
                  f"at {bound_ms / mean['this']:.1%} of it{rate}",
                  flush=True)
            del x, w, scale, want, w_lib
    if args.sweep:
        sweep(libs["this"], flush, name)
        sweep_stages(build, flush, name)
    if args.probe:
        probe(build, flush, name)
    if args.moe_step:
        del flush
        moe_step(libs)
    return 0 if same else 1


def moe_step(libs):
    """The float, int8 and int4 MoE decode steps through each copy's
    kernels."""
    import torch
    import chip_smoke
    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import grouped_matmul as gm
    from paddle_tpu_torch.serving.engine import ServingEngine
    dev = torch.device("cuda")
    model = load_jax_gpt(chip_smoke.random_gpt_arrays(
        chip_smoke.SEED + 8, experts=chip_smoke.MOE["num_expert"]),
        chip_smoke.HEADS, moe=chip_smoke.MOE, compute_dtype="bfloat16",
        device=dev, dtype=torch.bfloat16)
    plan = gm.plan

    def other_plan(E, C, D, F, fmt, xdt, sms=gm.H100_SMS):
        if fmt and hasattr(libs["other"],
                           "paddle_tpu_torch_grouped_matmul_q16"):
            return plan(E, C, D, F, fmt, xdt, sms)
        return {"kernel": "mma", "split": 1}
    try:
        for side in ("other", "this"):
            _build._loaded["grouped_matmul"] = libs[side]
            gm.plan = plan if side == "this" else other_plan
            for fmt in (None, "int8", "int4"):
                eng = ServingEngine(
                    model, max_slots=chip_smoke.SLOTS,
                    block_size=chip_smoke.BLOCK,
                    max_seq_len=chip_smoke.MAX_SEQ,
                    token_budget=chip_smoke.BUDGET, cache_dtype="bfloat16",
                    moe_weight_dtype=fmt, device=dev)
                eng.generate_batch([[1, 2, 3]], max_new_tokens=2)
                chip_smoke.profile_decode(
                    eng, f"{side} copy's K4, MoE-350M {fmt or 'float'} "
                    "experts", kernel="gmm")
                del eng
                torch.cuda.empty_cache()
    finally:
        gm.plan = plan
        _build._loaded.pop("grouped_matmul", None)


# The probe's cuts of the consumer loops, as text of this tree's source:
# the quantized formats' dequant and wgmma, and the float weights' wgmma.
_DEQUANT = "dequant_frags<T, FMT>(a, words, s2);"
_RAW = ("for (int u = 0; u < 4; ++u) { a[0][u] = words[u]; "
        "a[1][u] = words[3 - u]; }")
_WGMMA = ("Wgmma<T>::run(acc[0], a[0], desc);\n"
          "        Wgmma<T>::run(acc[1], a[1], desc);")
_KEEP = ("acc[0][0] += __uint_as_float(a[0][0] ^ a[0][1] ^ a[0][2] ^ "
         "a[0][3]); acc[1][0] += __uint_as_float(a[1][0] ^ a[1][1] ^ "
         "a[1][2] ^ a[1][3]);")
_FP_WGMMA = ("wgmma_ss<T, kN, 0, 1>(acc[0], desc_mn(ws + st * 2048, kBox), "
             "b, 1);\n"
             "        wgmma_ss<T, kN, 0, 1>(acc[1], desc_mn(ws + kBox + st * "
             "2048, kBox),\n"
             "                              b, 1);")
_FP_KEEP = "acc[0][st] += (float)(b & 1);"


def probe(build, flush, name):
    """The quantized kernel beside copies of it without the dequant,
    without the wgmma, and without both."""
    import torch
    import chip_smoke
    from paddle_tpu_torch.ops import grouped_matmul as gm
    src = (ROOT / "paddle_tpu_torch/ops/csrc/grouped_matmul.cu").read_text()
    if _DEQUANT not in src or _WGMMA not in src or _FP_WGMMA not in src:
        raise SystemExit("torch_gmm_ab --probe: the consumer loop changed")
    cuts = {"full": src,
            "no dequant": src.replace(_DEQUANT, _RAW),
            "no wgmma": src.replace(_WGMMA, _KEEP).replace(_FP_WGMMA,
                                                           _FP_KEEP),
            "neither": src.replace(_DEQUANT, _RAW).replace(_WGMMA, _KEEP)}
    libs = {}
    for cut, text in cuts.items():
        path = build / f"probe_{cut.replace(' ', '_')}.cu"
        path.write_text(text)
        compile_v(path, path.with_suffix(".so"))
        libs[cut] = load(path.with_suffix(".so"))
    dev = torch.device("cuda")
    D, F = chip_smoke.HIDDEN, 4 * chip_smoke.HIDDEN
    for variant in ("fp", "int8", "int4"):
        for prod, (d_in, d_out) in (("ffn1", (D, F)), ("ffn2", (F, D))):
            x, w, scale = chip_smoke.gmm_case(gm, variant, torch.bfloat16,
                                              d_in, d_out, dev)
            fmt = {"fp": 0, "int8": 1, "int4": 2}[variant]
            how = gm.plan(*x.shape, d_out, fmt, x.dtype, gm._sms(dev))
            out = torch.empty(x.shape[0], x.shape[1], d_out, dtype=x.dtype,
                              device=dev)
            cells = []
            for cut, lib in libs.items():
                if fmt == 0 and cut in ("no dequant", "neither"):
                    continue  # nothing to dequantize
                run = caller(lib, x, w, scale, out, lambda *a: how)
                cold = chip_smoke.cuda_ms(run, flush=flush)
                cells.append(f"{cut} {cold:.4f} (L2 warm "
                             f"{chip_smoke.cuda_ms(run):.4f})")
            print(f"probe K4 {variant} bfloat16 {prod} split {how['split']} "
                  f"ms on {name}: " + "; ".join(cells), flush=True)
            del x, w, scale, out


def sweep(lib, flush, name):
    """This tree's wgmma kernel at each split of D."""
    import torch
    import chip_smoke
    from paddle_tpu_torch.ops import grouped_matmul as gm
    dev = torch.device("cuda")
    D, F = chip_smoke.HIDDEN, 4 * chip_smoke.HIDDEN
    for variant in ("fp", "int8", "int4"):
        for prod, (d_in, d_out) in (("ffn1", (D, F)), ("ffn2", (F, D))):
            x, w, scale = chip_smoke.gmm_case(gm, variant, torch.bfloat16,
                                              d_in, d_out, dev)
            want = gm.grouped_matmul_reference(x, w, scale)
            fmt = {"fp": 0, "int8": 1, "int4": 2}[variant]
            planned = gm.plan(*x.shape, d_out, fmt, x.dtype,
                              gm._sms(dev))["split"]
            cells = []
            for split in (1, 2, 3, 4):
                out = torch.empty_like(want)
                run = caller(lib, x, w, scale, out,
                             lambda *a: {"split": split})
                run()
                torch.cuda.synchronize()
                chip_smoke.close_or_fail(f"sweep gmm_{variant} {prod} split "
                                         f"{split}", out, want,
                                         chip_smoke.GMM_TOL["bfloat16"])
                cold = chip_smoke.cuda_ms(run, flush=flush)
                warm = chip_smoke.cuda_ms(run)
                mark = " (plan)" if split == planned else ""
                cells.append(f"split {split}{mark} {cold:.4f} (L2 warm "
                             f"{warm:.4f})")
            print(f"sweep K4 {variant} bfloat16 {prod} ms on {name}: "
                  + "; ".join(cells), flush=True)
            del x, w, scale, want



# the float-weight ring's depth, as the source spells it
_FP_STAGES = "static constexpr int kStages = FMT == 0 ? {} : FMT == 1 ? 5 : 3;"


def sweep_stages(build, flush, name):
    """Copies of this tree's source whose float-weight ring holds 2 to 6
    stages, at both products under bf16 activations and the planned
    split."""
    import re
    import torch
    import chip_smoke
    from concurrent.futures import ThreadPoolExecutor
    from paddle_tpu_torch.ops import grouped_matmul as gm
    src = (ROOT / "paddle_tpu_torch/ops/csrc/grouped_matmul.cu").read_text()
    now = re.search(re.escape(_FP_STAGES.split("{}")[0]) + r"(\d+)", src)
    if now is None:
        raise SystemExit("torch_gmm_ab --sweep: the ring's depth moved")
    now = int(now.group(1))

    def make(n):
        path = build / f"stages_{n}.cu"
        path.write_text(src.replace(_FP_STAGES.format(now),
                                    _FP_STAGES.format(n)))
        compile_v(path, path.with_suffix(".so"))
        return load(path.with_suffix(".so"))
    depths = (2, 3, 4, 5, 6)
    with ThreadPoolExecutor(len(depths)) as ex:
        libs = dict(zip(depths, ex.map(make, depths)))
    dev = torch.device("cuda")
    D, F = chip_smoke.HIDDEN, 4 * chip_smoke.HIDDEN
    for prod, (d_in, d_out) in (("ffn1", (D, F)), ("ffn2", (F, D))):
        x, w, _ = chip_smoke.gmm_case(gm, "fp", torch.bfloat16, d_in, d_out,
                                      dev)
        want = gm.grouped_matmul_reference(x, w)
        how = gm.plan(*x.shape, d_out, 0, x.dtype, gm._sms(dev))
        cells = []
        for n, lib in libs.items():
            out = torch.empty_like(want)
            run = caller(lib, x, w, None, out, lambda *a: how)
            run()
            torch.cuda.synchronize()
            chip_smoke.close_or_fail(f"stages {n} gmm_fp {prod}", out, want,
                                     chip_smoke.GMM_TOL["bfloat16"])
            mark = " (this tree)" if n == now else ""
            cells.append(f"{n} stages{mark} "
                         f"{chip_smoke.cuda_ms(run, flush=flush):.4f}")
        print(f"sweep K4 fp bfloat16 {prod} split {how['split']} ms on "
              f"{name}: " + "; ".join(cells), flush=True)
        del x, w, want


if __name__ == "__main__":
    sys.exit(main())
