"""Parent-against-change check of the port's flash kernels on one card.

    python tools/torch_flash_ab.py --parent OTHER/flash_attention.cu

Builds `paddle_tpu_torch/ops/csrc/flash_attention.cu` of this tree and
another copy of it (for example the parent commit's, unpacked with
`git archive`) with `nvcc -Xptxas -v`, and prints:

* registers, stack, spills and shared memory of every kernel the other
  copy has, beside the same kernel of this tree (a template argument
  this tree adds must be false there, and one it drops (`DROPPED`) must
  have been false in the other copy: the instantiation that the other
  copy compiled), and whether they are equal; kernels only one copy has
  are listed as such;
* K1a's forward and backward at the train step's [8, 16, 1024, 64] bf16
  causal, and the paddle-layout forward K1b at [8, 1024, 16, 128] bf16
  causal and full and [8, 1024, 8, 256] causal, timed in turns (other,
  this, this, other, other, this) with CUDA events and L2 flushed, as
  `chip_smoke.py` times kernels; K1b beside SDPA on transposed copies,
  its bound and achieved TFLOP/s, each side held against the plain
  version first;
* K1c's backward at BERT pretraining's [16, 12, 512, 64] and BERT's
  [64, 12, 128, 64] bf16 (full, trailing padding at the train phase's
  lengths), timed the same way beside SDPA's backward with the segment
  mask, its bound, its TFLOP/s over the pairs the ids make visible and
  the share of 64-row tile pairs its segment ranges keep; each side
  held against the plain backward first (the other copy called through
  its own entry: the parent's takes no ranges scratch).

With `--sweep` it also builds copies of this tree's source whose K1b
kernel takes other key tiles and ring depths at D = 128 (64 or 128
keys, 2 to 4 stages, as shared memory allows) and other L2 budgets for
its head groups (4 MB to all heads at once), and times each at the two
D = 128 shapes. With `--probe` it builds copies whose K1b consumers skip
the softmax, the S = Q K^T products, the P V products, both products,
or all but the loads (their outputs are wrong; they keep every load and
store), and one without the warpgroups' turns, and times them beside
the full kernel at its three shapes; and copies of K1c's 16-bit
backward without the segment-range skip (every tile pair visited, all
masked), without its products and softmax (loads only), without its dQ
items, without its dK/dV items, and with its pre-pass alone, timed at
both BERT shapes.

Needs a card and nvcc; imports torch and the port only.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def compile_v(src, out):
    """Build `src` into `out` with -Xptxas -v; returns ptxas's report."""
    from paddle_tpu_torch.ops import _build
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    res = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                          str(out), str(src)], capture_output=True,
                         text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{res.stderr}")
    return res.stderr


def usage(report):
    """{demangled kernel name (no parameter list): usage string}."""
    from torch.utils.cpp_extension import CUDA_HOME
    found, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and ("stack frame" in line or "Used" in line):
            found.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    filt = os.path.join(CUDA_HOME, "bin", "cu++filt")
    names = list(found)
    demangled = subprocess.run([filt, *names], capture_output=True,
                               text=True, check=True).stdout.splitlines()
    return {short(d): "; ".join(found[n]) for n, d in zip(names, demangled)}


def short(demangled):
    """`void (anonymous namespace)::kern<float, 64, false>(...)` ->
    `kern<float, 64, false>`."""
    d = demangled.replace("(anonymous namespace)::", "").replace(
        "<unnamed>::", "")
    d = d[d.index(" ") + 1:] if d.startswith("void ") else d
    depth = 0
    for i, c in enumerate(d):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0:
            return d[:i]
    return d


def split_name(name):
    base, _, args = name.partition("<")
    return base, [a.strip() for a in args.rstrip(">").split(",") if a]


FALSE = ("false", "(bool)0", "0")
# Template arguments this tree dropped: kernel -> index in the other
# copy's list. The other copy's instantiations with it false are this
# tree's without it; those with it true are gone. (kSeg: K1c's 16-bit
# backward left these kernels for bwd16::flash_bwd_wgmma_kernel.)
DROPPED = {"flash_bwd_dkdv_mma_kernel": 2, "flash_bwd_dq_mma_kernel": 2}


def match(name, mine):
    """This tree's kernel for the other copy's `name`: the same base and
    leading template arguments, any further ones false (arguments this
    tree added), less a DROPPED argument that was false."""
    base, args = split_name(name)
    if base in DROPPED and len(args) > DROPPED[base]:
        i = DROPPED[base]
        if args[i] not in FALSE:
            return None
        args = args[:i] + args[i + 1:]
    for n in mine:
        b, a = split_name(n)
        if b == base and a[:len(args)] == args and all(
                x in FALSE for x in a[len(args):]):
            return n
    return None


def load(path, text=None):
    """The library at `path`; `text`, its source, says whether its
    segmented backward takes the ranges scratch (this tree's does)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    lib = ctypes.CDLL(str(path))
    for fn in ("paddle_tpu_torch_flash_fwd", "paddle_tpu_torch_flash_bwd",
               "paddle_tpu_torch_flash_fwd_bshd",
               "paddle_tpu_torch_flash_bwd_seg"):
        getattr(lib, fn).argtypes = fa._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.seg_ranges = text is None or _RANGES in text
    if not lib.seg_ranges:
        lib.paddle_tpu_torch_flash_bwd_seg.argtypes = \
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return lib


# the segmented backward's C entry with the ranges scratch
_RANGES = "const void* seg,\n    void* ranges, void* dq"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the other copy of flash_attention.cu")
    ap.add_argument("--sweep", action="store_true",
                    help="also time K1b at other key tiles and depths")
    ap.add_argument("--probe", action="store_true",
                    help="also time K1b copies without softmax or products")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_ab: no CUDA device")
    import chip_smoke
    from paddle_tpu_torch.ops import flash_attention as fa
    build = ROOT / "build" / "flash_ab"
    build.mkdir(parents=True, exist_ok=True)
    srcs = {"other": Path(args.parent),
            "this": ROOT / "paddle_tpu_torch/ops/csrc/flash_attention.cu"}
    with ThreadPoolExecutor(2) as ex:
        texts = ex.map(lambda side: compile_v(srcs[side],
                                              build / f"lib_{side}.so"),
                       srcs)
        reports = {side: usage(t) for side, t in zip(srcs, texts)}
    libs = {side: load(build / f"lib_{side}.so", srcs[side].read_text())
            for side in srcs}
    same = True
    for name, use in sorted(reports["other"].items()):
        mine = match(name, reports["this"])
        if mine is None:
            print(f"only in the other copy: {name}: [{use}]", flush=True)
            continue
        ok = reports["this"][mine] == use
        same &= ok
        print(f"{'same' if ok else 'DIFFERS'}: {name}: other [{use}]; this "
              f"{mine!r} [{reports['this'].get(mine)}]", flush=True)
    extra = sorted(set(reports["this"]) - {
        match(n, reports["this"]) for n in reports["other"]})
    for name in extra:
        print(f"only in this tree: {name}: [{reports['this'][name]}]",
              flush=True)
    print(f"registers and spills of the kernels both copies have: "
          f"{'unchanged' if same else 'CHANGED'}", flush=True)

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    B, H, S, D = 8, 16, 1024, 64
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(B, H, S, D, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    q = (q * D ** -0.5).to(torch.bfloat16)
    out, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
    lse, delta = (torch.empty(B, H, S, device=dev) for _ in range(2))

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fwd(lib):
        return lambda: lib.paddle_tpu_torch_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B * H, S, D, 1, 1, stream())

    def bwd(lib):
        return lambda: lib.paddle_tpu_torch_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B * H, S, D, 1, 1, stream())
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    for kname, make in (("K1a forward", fwd), ("K1a backward", bwd)):
        times = {"other": [], "this": []}
        for side in ("other", "this", "this", "other", "other", "this"):
            times[side].append(chip_smoke.cuda_ms(make(libs[side]),
                                                  flush=flush))
        mean = {s: sum(t) / len(t) for s, t in times.items()}
        print(f"{kname} bf16 [{B}, {H}, {S}, {D}] causal ms: other "
              f"{times['other']} (mean {mean['other']:.4f}), this "
              f"{times['this']} (mean {mean['this']:.4f}): "
              f"{mean['this'] / mean['other'] - 1:+.2%}", flush=True)
    del q, k, v, do, out, dq, dk, dv, lse, delta
    for H, D, causal in BSHD_SHAPES:
        q, k, v = bshd_operands(H, D, dev)
        want = fa.flash_fwd_bshd_reference(q, k, v, D ** -0.5, causal)
        runs = {side: bshd_run(libs[side], q, k, v, causal, want,
                               f"{side} K1b")
                for side in ("other", "this")}
        times = {"other": [], "this": []}
        for side in ("other", "this", "this", "other", "other", "this"):
            times[side].append(chip_smoke.cuda_ms(runs[side], flush=flush))
        mean = {s: sum(t) / len(t) for s, t in times.items()}
        sdpa, bound, flops = bshd_yardsticks(q, k, v, causal, flush)
        print(f"K1b bf16 [8, 1024, {H}, {D}] {'causal' if causal else 'full'}"
              f" ms on {card}: other {[round(t, 4) for t in times['other']]}"
              f" (mean {mean['other']:.4f}), this "
              f"{[round(t, 4) for t in times['this']]} (mean "
              f"{mean['this']:.4f}): {mean['this'] / mean['other'] - 1:+.2%};"
              f" SDPA on transposed copies {sdpa:.4f}; bound {bound:.4f}, "
              f"this at {flops / (mean['this'] * 1e-3) / 1e12:.1f} TFLOP/s, "
              f"{bound / mean['this']:.1%} of the bound", flush=True)
        del q, k, v, want
    for B, S, shortest in SEG_SHAPES:
        case = seg_case(B, S, shortest, dev)
        runs = {side: seg_bwd_run(libs[side], case, f"{side} K1c backward")
                for side in ("other", "this")}
        times = {"other": [], "this": []}
        for side in ("other", "this", "this", "other", "other", "this"):
            times[side].append(chip_smoke.cuda_ms(runs[side], flush=flush))
        mean = {s: sum(t) / len(t) for s, t in times.items()}
        sdpa, bound, flops, kept = seg_yardsticks(case, flush)
        print(f"K1c backward bf16 [{B}, 12, {S}, 64] lengths {shortest}-{S}"
              f" ms on {card}: other {[round(t, 4) for t in times['other']]}"
              f" (mean {mean['other']:.4f}), this "
              f"{[round(t, 4) for t in times['this']]} (mean "
              f"{mean['this']:.4f}): {mean['this'] / mean['other'] - 1:+.2%};"
              f" SDPA backward with the segment mask {sdpa:.4f}; bound "
              f"{bound:.4f}, this at {flops / (mean['this'] * 1e-3) / 1e12:.1f}"
              f" TFLOP/s over visible pairs, {bound / mean['this']:.1%} of "
              f"the bound; tile pairs kept {kept:.1%}", flush=True)
        del case, runs
    if args.sweep:
        sweep(build, flush, card)
    if args.probe:
        probe(build, flush, card)
        probe_seg_bwd(build, flush, card)
    return 0 if same else 1


# K1c's backward shapes: (sequences, S, shortest length), 12 heads of 64
SEG_SHAPES = ((16, 512, 64), (64, 128, 16))


def seg_case(B, S, shortest, dev):
    """(q, k, v, out, lse, dout, seg) of K1c's backward at chip_smoke's
    operands, trailing padding at lengths shortest..S."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    rng = np.random.default_rng(S)
    lens = rng.integers(shortest, S + 1, B)
    seg = torch.tensor((np.arange(S)[None] < lens[:, None]).astype(np.int32),
                       device=dev)
    g = torch.Generator(device=dev).manual_seed(S)
    q, k, v, dout = (torch.randn(B, 12, S, 64, generator=g, device=dev,
                                 dtype=torch.bfloat16) for _ in range(4))
    q = (q * 64 ** -0.5).to(torch.bfloat16)
    out, lse = fa.flash_fwd_reference(q, k, v, False, seg)
    return q, k, v, out, lse, dout, seg


def seg_bwd_run(lib, case, label):
    """A launch of the library's segmented backward on `case`, held
    against the plain backward once."""
    import torch
    import chip_smoke
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, out, lse, dout, seg = case
    B, H, S, D = q.shape
    grads = [torch.empty_like(q) for _ in range(3)]
    delta = torch.empty_like(lse)
    ranges = torch.empty(B, -(-S // 64), 2, dtype=torch.int32,
                         device=q.device)
    ptrs = [t.data_ptr() for t in (q, k, v, out, dout, lse, delta, seg)]
    if lib.seg_ranges:
        ptrs.append(ranges.data_ptr())

    def run():
        err = lib.paddle_tpu_torch_flash_bwd_seg(
            *ptrs, *(g.data_ptr() for g in grads), B, H, S, D, 1, 0,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{label} launch failed: CUDA error {err}")
    run()
    torch.cuda.synchronize()
    want = fa.flash_bwd_reference(q, k, v, out, lse, dout, False, seg)
    for n, a, e in zip(("dq", "dk", "dv"), grads, want):
        chip_smoke.close_or_fail(f"{label} {n} [{B}, {H}, {S}, {D}]", a, e,
                                 chip_smoke.TRAIN_TOL["bfloat16"])
    return run


def seg_yardsticks(case, flush):
    """(SDPA backward ms with the segment mask, bound ms, flops over the
    visible pairs, share of 64-row tile pairs kept) of K1c's backward."""
    import torch
    import torch.nn.functional as F
    import chip_smoke
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, out, lse, dout, seg = case
    B, H, S, D = q.shape
    same = seg[:, None, :, None] == seg[:, None, None, :]
    sq = [t.detach().requires_grad_() for t in (q, k, v)]
    so = F.scaled_dot_product_attention(*sq, attn_mask=same, scale=1.0)
    sdpa = chip_smoke.cuda_ms(lambda: torch.autograd.grad(
        so, sq, dout, retain_graph=True), flush=flush)
    bound, _ = chip_smoke.seg_bound(q, seg, backward=True)
    flops = 10 * D * H * int((seg[:, :, None] == seg[:, None, :]).sum())
    kept = fa.segment_tile_pairs(seg, False).float().mean().item()
    return sdpa, bound, flops, kept


# The probe's cuts of K1c's 16-bit backward, as patterns of this tree's
# source: each must occur once.
_SEG_CUTS = {
    "no skip": (r"visit = visit && a\.x <= c\.y && c\.x <= a\.y;",
                "mask = true;"),
    "loads only": (r"if \(w0 >= 0 && \(fl & 1\)\) \{",
                   "if (w0 >= 0 && (fl & 1) && S < 0) {"),
    "no dQ pass": (r"const int first = 0, last = \(int\)\(2 \* per\);",
                   "const int first = 0, last = (int)per;"),
    "no dK/dV pass": (r"const int first = 0, last = \(int\)\(2 \* per\);",
                      "const int first = (int)per, last = (int)(2 * per);"),
    "pre-pass only": (r"\n  auto kern = flash_bwd_wgmma_kernel<T, D, kSeg>;",
                      "\n  return cudaSuccess;"
                      "\n  auto kern = flash_bwd_wgmma_kernel<T, D, kSeg>;"),
}


def probe_seg_bwd(build, flush, card):
    """K1c's 16-bit backward beside copies without its skip, its
    products, one of its passes, or all but its pre-pass."""
    import torch
    import chip_smoke
    src = (ROOT / "paddle_tpu_torch/ops/csrc/flash_attention.cu").read_text()
    cuts = {"full": src}
    for cut, (pat, rep) in _SEG_CUTS.items():
        if len(re.findall(pat, src)) != 1:
            raise SystemExit(f"torch_flash_ab --probe: K1c's backward "
                             f"changed ({cut})")
        cuts[cut] = re.sub(pat, rep, src)

    def make(cut):
        name = cut.replace(" ", "_").replace("/", "")
        path = build / f"probe_seg_{name}.cu"
        path.write_text(cuts[cut])
        compile_v(path, path.with_suffix(".so"))
        return load(path.with_suffix(".so"))
    with ThreadPoolExecutor(len(cuts)) as ex:
        libs = dict(zip(cuts, ex.map(make, cuts)))
    dev = torch.device("cuda")
    for B, S, shortest in SEG_SHAPES:
        case = seg_case(B, S, shortest, dev)
        q, k, v, out, lse, dout, seg = case
        grads = [torch.empty_like(q) for _ in range(3)]
        delta = torch.empty_like(lse)
        ranges = torch.empty(B, -(-S // 64), 2, dtype=torch.int32,
                             device=dev)
        cells = []
        for cut, lib in libs.items():
            def run(lib=lib):
                lib.paddle_tpu_torch_flash_bwd_seg(
                    *(t.data_ptr() for t in (q, k, v, out, dout, lse, delta,
                                             seg, ranges)),
                    *(g.data_ptr() for g in grads), B, 12, S, 64, 1, 0,
                    torch.cuda.current_stream().cuda_stream)
            cells.append(f"{cut} {chip_smoke.cuda_ms(run, flush=flush):.4f}")
        print(f"probe K1c backward bf16 [{B}, 12, {S}, 64] ms on {card}: "
              + "; ".join(cells), flush=True)
        del case, grads


# The probe's cuts of K1b's consumer loop, as patterns of this tree's
# source: every call of each.
_SOFTMAX = r"softmax_tile<kBN, (true|false)>\(s, m, l, lim, alpha\);"
_S_GEMM = r"\n\s*s_gemm<T, D>\([^;]*\);"
_PV_GEMM = r"\n\s*pv_gemm<T, D>\([^;]*\);"
_TURNS = r"named_(sync|arrive)\((turn|next|4), 256\);"
_COUNTS = {_SOFTMAX: 4, _S_GEMM: 2, _PV_GEMM: 2}


def probe(build, flush, card):
    """K1b beside copies without its softmax, S products, P V products,
    or both products."""
    import torch
    import chip_smoke
    src = (ROOT / "paddle_tpu_torch/ops/csrc/flash_attention.cu").read_text()
    for pat, n in _COUNTS.items():
        if len(re.findall(pat, src)) != n:
            raise SystemExit("torch_flash_ab --probe: K1b's text changed")
    no_s = re.sub(_S_GEMM, "", src)
    no_products = re.sub(_PV_GEMM, "", no_s)
    no_softmax = "alpha[0] = alpha[1] = 1.f;"
    cuts = {"full": src,
            "no softmax": re.sub(_SOFTMAX, no_softmax, src),
            "no S": no_s, "no P V": re.sub(_PV_GEMM, "", src),
            "no products": no_products,
            "loads only": re.sub(_SOFTMAX, no_softmax, no_products),
            "no turns": re.sub(_TURNS, ";", src)}

    def make(cut):
        path = build / f"probe_{cut.replace(' ', '_')}.cu"
        path.write_text(cuts[cut])
        compile_v(path, path.with_suffix(".so"))
        return load(path.with_suffix(".so"))
    with ThreadPoolExecutor(len(cuts)) as ex:
        libs = dict(zip(cuts, ex.map(make, cuts)))
    dev = torch.device("cuda")
    for H, D, causal in BSHD_SHAPES:
        q, k, v = bshd_operands(H, D, dev)
        out = torch.empty_like(q)
        cells = []
        for cut, lib in libs.items():
            def run(lib=lib):
                lib.paddle_tpu_torch_flash_fwd_bshd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    8, 1024, H, D, 1, int(causal), D ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
            cells.append(f"{cut} {chip_smoke.cuda_ms(run, flush=flush):.4f}")
        print(f"probe K1b bf16 [8, 1024, {H}, {D}] "
              f"{'causal' if causal else 'full'} ms on {card}: "
              + "; ".join(cells), flush=True)
        del q, k, v, out


# K1b's shapes: (heads, head_dim, causal) at B = 8, S = 1024, bf16
BSHD_SHAPES = ((16, 128, True), (16, 128, False), (8, 256, True))
# the sweep's knobs, as the source spells them in K1b's Cfg
BSHD_KNOBS = ("static constexpr int kBN = D == 128 ? {} : 64;",
              "static constexpr int kStages = D == 128 ? {} : 2;",
              "constexpr long long kL2Budget = {}LL << 20;")


def bshd_operands(H, D, dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(D)
    return [torch.randn(8, 1024, H, D, generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(3)]


def bshd_run(lib, q, k, v, causal, want, label):
    """A launch of the library's paddle-layout forward, held against the
    plain version `want` once."""
    import torch
    import chip_smoke
    B, S, H, D = q.shape
    out = torch.empty_like(q)

    def run():
        err = lib.paddle_tpu_torch_flash_fwd_bshd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, D, 1, int(causal), D ** -0.5,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{label} launch failed: CUDA error {err}")
    run()
    torch.cuda.synchronize()
    chip_smoke.close_or_fail(f"{label} [{B}, {S}, {H}, {D}]", out, want,
                             chip_smoke.TRAIN_TOL["bfloat16"])
    return run


def bshd_yardsticks(q, k, v, causal, flush):
    """(SDPA ms on transposed copies, bound ms, flops) of K1b's call."""
    import torch.nn.functional as F
    import chip_smoke
    D = q.shape[-1]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = chip_smoke.cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, scale=D ** -0.5), flush=flush)
    bound, _ = chip_smoke.flash_bound(qt, False, causal, lse=False)
    return sdpa, bound, chip_smoke.flash_flops(qt, causal)


def sweep(build, flush, card):
    """This tree's K1b kernel at other key tiles and depths, D = 128."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    import chip_smoke
    src = (ROOT / "paddle_tpu_torch/ops/csrc/flash_attention.cu").read_text()
    now = tuple(int(re.search(re.escape(k.split("{}")[0]) + r"(\d+)",
                              src).group(1)) for k in BSHD_KNOBS)
    variants = [(128, 3, 16), (128, 2, 16), (64, 4, 16), (64, 3, 16),
                (128, 3, 4), (128, 3, 4096)]

    def make(var):
        text = src
        for knob, val in zip(BSHD_KNOBS, var):
            text = text.replace(knob.format(now[BSHD_KNOBS.index(knob)]),
                                knob.format(val))
        path = build / "sweep_bn{}_st{}_l2{}.cu".format(*var)
        path.write_text(text)
        compile_v(path, path.with_suffix(".so"))
        return load(path.with_suffix(".so"))
    with ThreadPoolExecutor(len(variants)) as ex:
        libs = list(ex.map(make, variants))
    dev = torch.device("cuda")
    for H, D, causal in BSHD_SHAPES[:2]:
        q, k, v = bshd_operands(H, D, dev)
        want = fa.flash_fwd_bshd_reference(q, k, v, D ** -0.5, causal)
        cells = []
        for var, lib in zip(variants, libs):
            run = bshd_run(lib, q, k, v, causal, want, f"sweep {var}")
            mark = " (this tree)" if var == now else ""
            cells.append(f"{var[0]} keys x {var[1]} stages, heads grouped "
                         f"by {var[2]} MB{mark} "
                         f"{chip_smoke.cuda_ms(run, flush=flush):.4f}")
        print(f"sweep K1b bf16 [8, 1024, {H}, {D}] "
              f"{'causal' if causal else 'full'} ms on {card}: "
              + "; ".join(cells), flush=True)
        del q, k, v, want


if __name__ == "__main__":
    sys.exit(main())
