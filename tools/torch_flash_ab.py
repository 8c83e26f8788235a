"""Parent-against-change check of the port's flash kernels on one card.

    python tools/torch_flash_ab.py --parent OTHER/flash_attention.cu

Builds `paddle_tpu_torch/ops/csrc/flash_attention.cu` of this tree and
another copy of it (for example the parent commit's, unpacked with
`git archive`) with `nvcc -Xptxas -v`, and prints:

* registers, stack, spills and shared memory of every kernel the other
  copy has, beside the same kernel of this tree (a template argument
  this tree adds must be false there, and one it drops (`DROPPED`) must
  have been false in the other copy: the instantiation that the other
  copy compiled), and whether they are equal (the parameter space,
  cmem[0], is printed but not compared: a kernel parameter this tree
  adds grows it); kernels only one copy has are listed as such;
* K1a's forward and backward at the train step's [8, 16, 1024, 64] bf16
  causal, and the paddle-layout forward K1b at [8, 1024, 16, 128] bf16
  causal and full and [8, 1024, 8, 256] causal, timed in turns (other,
  this, this, other, other, this) with CUDA events and L2 flushed, as
  `chip_smoke.py` times kernels, beside SDPA (K1a: on the same
  operands, the backward through autograd; K1b: on transposed copies),
  their bounds and achieved TFLOP/s, each side held against the plain
  version first;
* K1c's backward at BERT pretraining's [16, 12, 512, 64] and BERT's
  [64, 12, 128, 64] bf16 (full, trailing padding at the train phase's
  lengths), timed the same way beside SDPA's backward with the segment
  mask, its bound, its TFLOP/s over the pairs the ids make visible and
  the share of 64-row tile pairs its segment ranges keep; each side
  held against the plain backward first (the other copy called through
  its own entry: the parent's takes no ranges scratch);
* K1c's forward at the same two shapes and ids, timed the same way
  beside SDPA with the segment mask, its bound, its TFLOP/s over the
  visible pairs and the share of (64-row query, 128-row key) tile pairs
  it computes; each side held against the plain forward first (the
  other copy through its own entry: a forward without the ranges
  scratch is called without it).

With `--sweep` it also builds copies of this tree's source whose K1b
kernel takes other key tiles and ring depths at D = 128 (64 or 128
keys, 2 to 4 stages, as shared memory allows) and other L2 budgets for
its head groups (4 MB to all heads at once), and times each at the two
D = 128 shapes; copies whose K1a forward at D = 64 takes other key
tiles (64, 128), ring depths (2 to 6), consumer warpgroups (2, 3), a
block an item instead of persistent blocks, other L2 budgets for its
head groups, or K1b's warpgroup turns; and copies whose K1a backward
orders its items in head groups of other L2 budgets (8 MB to all
heads) or in K1c's order (a head's items adjacent), each timed at
K1a's shape and held against the plain version; and copies whose K1c
forward takes 64-key tiles, or a block an item instead of persistent
blocks, timed at both BERT shapes. With `--probe` it
builds copies whose K1b and K1a forward consumers (one kernel) skip the
softmax, the S = Q K^T products, the P V products, both products, or
all but the loads (their outputs are wrong; they keep every load and
store), and one without K1b's warpgroup turns, and times them beside
the full kernel at K1b's three shapes and K1a's; copies of the 16-bit
backward without the segment-range skip (every tile pair visited, all
masked), without its products and softmax (loads only), without its dQ
items, without its dK/dV items, and with its pre-pass alone, timed at
both BERT shapes (K1c) and, loads only and pre-pass only, at K1a's;
copies of K1c's 16-bit forward without the tile skip (every tile
loaded and masked), with its loads only (every tile released unread)
and with its pre-pass only, at both BERT shapes; and copies of the
backward that stamp each block's start and end (%globaltimer), in this
tree's item order and in K1c's, which give K1a's item tail: the
kernel's span, the last block's end past the median block's, and the
blocks' mean idle share of the span.

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
# tree's without it; those with it true are gone. (None today: the
# mma.sync backward kernels that dropped kSeg are gone with K1a's
# backward now on bwd16::flash_bwd_wgmma_kernel.)
DROPPED = {}


def same_usage(a, b):
    """Whether two usage strings agree, the parameter space aside."""
    def strip(u):
        return re.sub(r", \d+ bytes cmem\[0\]", "", u or "")
    return strip(a) == strip(b)


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
               "paddle_tpu_torch_flash_bwd_seg",
               "paddle_tpu_torch_flash_fwd_seg"):
        getattr(lib, fn).argtypes = fa._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.seg_ranges = text is None or _RANGES in text
    if not lib.seg_ranges:
        lib.paddle_tpu_torch_flash_bwd_seg.argtypes = \
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.fwd_ranges = text is None or bool(re.search(_FWD_RANGES, text))
    if not lib.fwd_ranges:
        lib.paddle_tpu_torch_flash_fwd_seg.argtypes = \
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return lib


# the segmented backward's C entry with the ranges scratch, and the
# segmented forward's
_RANGES = "const void* seg,\n    void* ranges, void* dq"
_FWD_RANGES = r"paddle_tpu_torch_flash_fwd_seg\([^)]*void\* ranges"


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
        texts = dict(zip(srcs, ex.map(
            lambda side: compile_v(srcs[side], build / f"lib_{side}.so"),
            srcs)))
    reports = {side: usage(t) for side, t in texts.items()}
    for side, text in texts.items():  # serialized wgmma, spills
        for line in text.splitlines():
            if re.search(r"C75\d\d|spill", line) and not re.search(
                    r"0 bytes spill stores, 0 bytes spill loads", line):
                print(f"ptxas ({side}): {line.strip()}", flush=True)
    libs = {side: load(build / f"lib_{side}.so", srcs[side].read_text())
            for side in srcs}
    same = True
    for name, use in sorted(reports["other"].items()):
        mine = match(name, reports["this"])
        if mine is None:
            print(f"only in the other copy: {name}: [{use}]", flush=True)
            continue
        ok = same_usage(reports["this"][mine], use)
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
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    case = k1a_case(dev)
    yard = k1a_yardsticks(case, flush)
    for part, make in (("forward", k1a_fwd_run), ("backward", k1a_bwd_run)):
        runs = {side: make(libs[side], case, f"{side} K1a {part}")
                for side in ("other", "this")}
        times = {"other": [], "this": []}
        for side in ("other", "this", "this", "other", "other", "this"):
            times[side].append(chip_smoke.cuda_ms(runs[side], flush=flush))
        mean = {s: sum(t) / len(t) for s, t in times.items()}
        sdpa, bound, flops = yard[part]
        print(f"K1a {part} bf16 {list(case[0].shape)} causal ms on {card}: "
              f"other {[round(t, 4) for t in times['other']]} (mean "
              f"{mean['other']:.4f}), this "
              f"{[round(t, 4) for t in times['this']]} (mean "
              f"{mean['this']:.4f}): {mean['this'] / mean['other'] - 1:+.2%}"
              f"; SDPA{' backward' if part == 'backward' else ''} "
              f"{sdpa:.4f}; bound {bound:.4f}, this at "
              f"{flops / (mean['this'] * 1e-3) / 1e12:.1f} TFLOP/s, "
              f"{bound / mean['this']:.1%} of the bound", flush=True)
    del case
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
        runs = {side: seg_fwd_run(libs[side], case, f"{side} K1c forward")
                for side in ("other", "this")}
        times = {"other": [], "this": []}
        for side in ("other", "this", "this", "other", "other", "this"):
            times[side].append(chip_smoke.cuda_ms(runs[side], flush=flush))
        mean = {s: sum(t) / len(t) for s, t in times.items()}
        sdpa, bound, flops, kept = seg_fwd_yardsticks(case, flush)
        print(f"K1c forward bf16 [{B}, 12, {S}, 64] lengths {shortest}-{S}"
              f" ms on {card}: other {[round(t, 4) for t in times['other']]}"
              f" (mean {mean['other']:.4f}), this "
              f"{[round(t, 4) for t in times['this']]} (mean "
              f"{mean['this']:.4f}): {mean['this'] / mean['other'] - 1:+.2%};"
              f" SDPA with the segment mask {sdpa:.4f}; bound {bound:.4f}, "
              f"this at {flops / (mean['this'] * 1e-3) / 1e12:.1f} TFLOP/s "
              f"over visible pairs, {bound / mean['this']:.1%} of the bound;"
              f" (64 x 128) tile pairs computed {kept:.1%}", flush=True)
        del case, runs
    if args.sweep:
        sweep(build, flush, card)
        sweep_k1a(build, flush, card)
        sweep_seg_fwd(build, flush, card)
    if args.probe:
        probe(build, flush, card)
        probe_seg_bwd(build, flush, card)
        probe_seg_fwd(build, flush, card)
        probe_tail(build, card)
    return 0 if same else 1


def k1a_case(dev, B=8, H=16, S=1024, D=64):
    """(q, k, v, dout, out, lse) of K1a at the train step's shape, bf16,
    q scaled as `splash_mha` hands it to the kernels; (out, lse) from the
    plain forward."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v, dout = (torch.randn(B, H, S, D, generator=g, device=dev,
                                 dtype=torch.bfloat16) for _ in range(4))
    q = (q * D ** -0.5).to(torch.bfloat16)
    out, lse = fa.flash_fwd_reference(q, k, v, True)
    return q, k, v, dout, out, lse


def k1a_fwd_run(lib, case, label):
    """A launch of the library's K1a forward on `case`, held against the
    plain (out, lse) once."""
    import torch
    import chip_smoke
    q, k, v, _dout, want_out, want_lse = case
    B, H, S, D = q.shape
    out, lse = torch.empty_like(q), torch.empty_like(want_lse)

    def run():
        err = lib.paddle_tpu_torch_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B * H, S, D, 1, 1,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{label} launch failed: CUDA error {err}")
    run()
    torch.cuda.synchronize()
    chip_smoke.close_or_fail(f"{label} out", out, want_out,
                             chip_smoke.TRAIN_TOL["bfloat16"])
    chip_smoke.close_or_fail(f"{label} lse", lse, want_lse,
                             chip_smoke.TOL["float32"])
    return run


def k1a_bwd_run(lib, case, label):
    """A launch of the library's K1a backward on `case`, held against
    the plain backward once."""
    import torch
    import chip_smoke
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, dout, out, lse = case
    B, H, S, D = q.shape
    grads = [torch.empty_like(q) for _ in range(3)]
    delta = torch.empty_like(lse)

    def run():
        err = lib.paddle_tpu_torch_flash_bwd(
            *(t.data_ptr() for t in (q, k, v, out, dout, lse, delta)),
            *(g.data_ptr() for g in grads), B * H, S, D, 1, 1,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{label} launch failed: CUDA error {err}")
    run()
    torch.cuda.synchronize()
    want = fa.flash_bwd_reference(q, k, v, out, lse, dout, True)
    for n, a, e in zip(("dq", "dk", "dv"), grads, want):
        chip_smoke.close_or_fail(f"{label} {n}", a, e,
                                 chip_smoke.TRAIN_TOL["bfloat16"])
    return run


def k1a_yardsticks(case, flush):
    """{"forward" / "backward": (SDPA ms on the same operands at scale 1,
    the backward through autograd; bound ms; flops)} of K1a's call."""
    import torch
    import torch.nn.functional as F
    import chip_smoke
    q, k, v, dout, _out, _lse = case
    fwd = chip_smoke.cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=1.0), flush=flush)
    sq = [t.detach().requires_grad_() for t in (q, k, v)]
    so = F.scaled_dot_product_attention(*sq, is_causal=True, scale=1.0)
    bwd = chip_smoke.cuda_ms(lambda: torch.autograd.grad(
        so, sq, dout, retain_graph=True), flush=flush)
    return {part: (ms, chip_smoke.flash_bound(q, part == "backward")[0],
                   chip_smoke.flash_flops(q, True, part == "backward"))
            for part, ms in (("forward", fwd), ("backward", bwd))}


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


def seg_fwd_run(lib, case, label):
    """A launch of the library's segmented forward on `case`, held
    against the plain forward once."""
    import torch
    import chip_smoke
    q, k, v, want_out, want_lse, _dout, seg = case
    B, H, S, D = q.shape
    out, lse = torch.empty_like(q), torch.empty_like(want_lse)
    ranges = torch.empty(B, -(-S // 64), 2, dtype=torch.int32,
                         device=q.device)
    ptrs = [t.data_ptr() for t in (q, k, v, seg)]
    if lib.fwd_ranges:
        ptrs.append(ranges.data_ptr())

    def run():
        err = lib.paddle_tpu_torch_flash_fwd_seg(
            *ptrs, out.data_ptr(), lse.data_ptr(), B, H, S, D, 1, 0,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{label} launch failed: CUDA error {err}")
    run()
    torch.cuda.synchronize()
    chip_smoke.close_or_fail(f"{label} out [{B}, {H}, {S}, {D}]", out,
                             want_out, chip_smoke.TRAIN_TOL["bfloat16"])
    chip_smoke.close_or_fail(f"{label} lse [{B}, {H}, {S}, {D}]", lse,
                             want_lse, chip_smoke.TOL["float32"])
    return run


def seg_fwd_yardsticks(case, flush):
    """(SDPA ms with the segment mask, bound ms, flops over the visible
    pairs, share of (64-row query, 128-row key) tile pairs computed) of
    K1c's forward."""
    import torch.nn.functional as F
    import chip_smoke
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, _out, _lse, _dout, seg = case
    B, H, S, D = q.shape
    same = seg[:, None, :, None] == seg[:, None, None, :]
    sdpa = chip_smoke.cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=same, scale=1.0), flush=flush)
    bound, _ = chip_smoke.seg_bound(q, seg)
    flops = 4 * D * H * int((seg[:, :, None] == seg[:, None, :]).sum())
    kept = fa.segment_tile_pairs(seg, False, fa.SEG_TILE,
                                 fa.SEG_FWD_KEY_TILE).float().mean().item()
    return sdpa, bound, flops, kept


# K1c's forward: the key tile and the blocks, as the source spells them
SEG_FWD_KNOBS = ("constexpr int kBNSeg = {};",
                 "constexpr bool kSegPersist = {};")
# the probe's cuts of K1c's 16-bit forward, as patterns of this tree's
# source: each must occur once
_SEG_FWD_CUTS = {
    "no skip": ((r"a\.x <= c\.y && c\.x <= a\.y;\n  const bool mask =",
                 "true;\n  const bool mask = true ||"),),
    "loads only": ((r"const int fl = \(hdr >> \(2 \* wg\)\) & 3;",
                    "const int fl = 0 & hdr;"),),
    "pre-pass only": ((r"\n  const long long dims\[4\] = \{D, H, S, B\};",
                       "\n  if (kSeg) return cudaSuccess;"
                       "\n  const long long dims[4] = {D, H, S, B};"),),
}


def seg_fwd_copies(build, texts, prefix):
    """{name: library} of the sources `texts` ({name: text}), built in
    parallel under build/ with `prefix`."""
    def make(name):
        path = build / (prefix + re.sub(r"\W", "_", name) + ".cu")
        path.write_text(texts[name])
        compile_v(path, path.with_suffix(".so"))
        return load(path.with_suffix(".so"))
    with ThreadPoolExecutor(len(texts)) as ex:
        return dict(zip(texts, ex.map(make, texts)))


def sweep_seg_fwd(build, flush, card):
    """K1c's forward with 64- and 128-key tiles, persistent blocks or a
    block an item, at both BERT shapes against the plain forward."""
    import torch
    import chip_smoke
    src = (ROOT / "paddle_tpu_torch/ops/csrc/flash_attention.cu").read_text()
    now = (re.search(SEG_FWD_KNOBS[0].replace("{}", r"(\d+)"), src).group(1),
           re.search(SEG_FWD_KNOBS[1].replace("{}", r"(\w+)"), src).group(1))
    variants = [("128", "true"), ("64", "true"), ("128", "false"),
                ("64", "false")]
    texts = {f"{bn} keys, {'persistent' if p == 'true' else 'a block an item'}"
             + (" (this tree)" if (bn, p) == now else ""):
             substitute(src, [(k.format(n), k.format(v)) for k, n, v in zip(
                 SEG_FWD_KNOBS, now, (bn, p))], "K1c forward knobs")
             if (bn, p) != now else src for bn, p in variants}
    libs = seg_fwd_copies(build, texts, "sweep_seg_fwd_")
    for B, S, shortest in SEG_SHAPES:
        case = seg_case(B, S, shortest, torch.device("cuda"))
        cells = []
        for name, lib in libs.items():
            run = seg_fwd_run(lib, case, f"sweep K1c forward {name}")
            cells.append(f"{name} {chip_smoke.cuda_ms(run, flush=flush):.4f}")
        print(f"sweep K1c forward bf16 [{B}, 12, {S}, 64] lengths "
              f"{shortest}-{S} ms on {card}: " + "; ".join(cells), flush=True)
        del case


def probe_seg_fwd(build, flush, card):
    """K1c's 16-bit forward beside copies without its tile skip, with
    its loads only, or with its pre-pass only."""
    import torch
    import chip_smoke
    src = (ROOT / "paddle_tpu_torch/ops/csrc/flash_attention.cu").read_text()
    texts = {"full": src}
    for cut, subs in _SEG_FWD_CUTS.items():
        text = src
        for pat, rep in subs:
            if len(re.findall(pat, text)) != 1:
                raise SystemExit(f"torch_flash_ab --probe: K1c's forward "
                                 f"changed ({cut})")
            text = re.sub(pat, rep, text)
        texts[cut] = text
    libs = seg_fwd_copies(build, texts, "probe_seg_fwd_")
    for B, S, shortest in SEG_SHAPES:
        q, k, v, _out, lse, _dout, seg = seg_case(B, S, shortest,
                                                  torch.device("cuda"))
        out = torch.empty_like(q)
        ranges = torch.empty(B, -(-S // 64), 2, dtype=torch.int32,
                             device=q.device)
        cells = []
        for cut, lib in libs.items():
            def run(lib=lib):
                lib.paddle_tpu_torch_flash_fwd_seg(
                    *(t.data_ptr() for t in (q, k, v, seg, ranges, out, lse)),
                    B, 12, S, 64, 1, 0,
                    torch.cuda.current_stream().cuda_stream)
            cells.append(f"{cut} {chip_smoke.cuda_ms(run, flush=flush):.4f}")
        print(f"probe K1c forward bf16 [{B}, 12, {S}, 64] lengths "
              f"{shortest}-{S} ms on {card}: " + "; ".join(cells), flush=True)
        del q, k, v, out, lse, seg


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
    "no dQ pass": (r"const int first = 0, last = kSeg \? units :",
                   "const int first = 0, last = kSeg ? (int)per :"),
    "no dK/dV pass": (r"const int first = 0, last = kSeg \? units :",
                      "const int first = kSeg ? (int)per : 0, "
                      "last = kSeg ? units :"),
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
    # K1a (no segments): the cuts that apply to it
    q, k, v, dout, out, lse = k1a_case(dev)
    B, H, S, D = q.shape
    grads = [torch.empty_like(q) for _ in range(3)]
    delta = torch.empty_like(lse)
    cells = []
    for cut in ("full", "loads only", "pre-pass only"):
        def run(lib=libs[cut]):
            lib.paddle_tpu_torch_flash_bwd(
                *(t.data_ptr() for t in (q, k, v, out, dout, lse, delta)),
                *(g.data_ptr() for g in grads), B * H, S, D, 1, 1,
                torch.cuda.current_stream().cuda_stream)
        cells.append(f"{cut} {chip_smoke.cuda_ms(run, flush=flush):.4f}")
    print(f"probe K1a backward bf16 [{B}, {H}, {S}, {D}] causal ms on "
          f"{card}: " + "; ".join(cells), flush=True)


# Block start and end stamps in the 16-bit backward, for probe_tail: a
# device array, its reader, and where the stamps go (each pattern once).
_STAMP_DECL = (
    "\nnamespace bwd16 {\n",
    "\n__device__ unsigned long long g_probe_t[2 * 4096];\n"
    "__device__ __forceinline__ unsigned long long probe_clock() {\n"
    "  unsigned long long t;\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
    "  return t;\n}\n\nnamespace bwd16 {\n")
_STAMP_START = (
    "  const int qd = lane & 3;\n  const int rr =",
    "  const int qd = lane & 3;\n"
    "  if (threadIdx.x == 0) g_probe_t[2 * blockIdx.x] = probe_clock();\n"
    "  const int rr =")
_STAMP_END = (
    "    if (!it.dq) store_rows<T, D>(dv + roff * D, acc1, fr, S, qd);\n"
    "  }\n}\n",
    "    if (!it.dq) store_rows<T, D>(dv + roff * D, acc1, fr, S, qd);\n"
    "  }\n"
    "  if (threadIdx.x == 0) g_probe_t[2 * blockIdx.x + 1] = probe_clock();"
    "\n}\n")
_STAMP_READ = (
    '\nextern "C" int paddle_probe_times(void* host, int n) {\n'
    "  return (int)cudaMemcpyFromSymbol(host, g_probe_t,\n"
    "                                   (size_t)n * 16);\n}\n")


def substitute(src, subs, what):
    """`src` with each (old, new) of `subs` replaced; each old must occur
    exactly once."""
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"torch_flash_ab: the source changed ({what}: "
                             f"{old.strip()[:60]!r})")
        src = src.replace(old, new)
    return src


def probe_tail(build, card):
    """K1a's backward item tail: each block's start and end stamped, in
    this tree's item order and in K1c's; the kernel's span, the last
    block's end past the median block's, and the blocks' mean idle share
    of the span (their ends to the last end)."""
    import statistics
    import torch
    src = (ROOT / "paddle_tpu_torch/ops/csrc/flash_attention.cu").read_text()
    stamps = (_STAMP_DECL, _STAMP_START, _STAMP_END)
    orders = {"this order": substitute(src, stamps, "stamps") + _STAMP_READ,
              "K1c's order": substitute(src, stamps + K1C_ORDER,
                                        "stamps") + _STAMP_READ}

    def make(order):
        path = build / f"tail_{order.split()[0].replace(chr(39), '')}.cu"
        path.write_text(orders[order])
        compile_v(path, path.with_suffix(".so"))
        lib = load(path.with_suffix(".so"))
        lib.paddle_probe_times.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.paddle_probe_times.restype = ctypes.c_int
        return lib
    with ThreadPoolExecutor(len(orders)) as ex:
        libs = dict(zip(orders, ex.map(make, orders)))
    dev = torch.device("cuda")
    q, k, v, dout, out, lse = k1a_case(dev)
    B, H, S, D = q.shape
    grads = [torch.empty_like(q) for _ in range(3)]
    delta = torch.empty_like(lse)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    items = 2 * B * H * -(-S // 128)
    grid = min(items // 2, sms)  # both orders at this shape
    cells = []
    for order, lib in libs.items():
        spans = []
        for _ in range(5):
            lib.paddle_tpu_torch_flash_bwd(
                *(t.data_ptr() for t in (q, k, v, out, dout, lse, delta)),
                *(g.data_ptr() for g in grads), B * H, S, D, 1, 1,
                torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            t = (ctypes.c_ulonglong * (2 * grid))()
            if lib.paddle_probe_times(ctypes.addressof(t), grid):
                raise SystemExit("torch_flash_ab: reading the stamps failed")
            start, end = list(t[0::2]), list(t[1::2])
            span = max(end) - min(start)
            tail = max(end) - statistics.median(end)
            idle = sum(max(end) - e for e in end) / (grid * span)
            spans.append((span / 1e6, tail / span, idle))
        span, tail, idle = (statistics.median(x) for x in zip(*spans))
        cells.append(f"{order}: span {span:.4f} ms, last end past the "
                     f"median {tail:.1%} of it, mean idle {idle:.1%}")
    print(f"probe K1a backward item tail bf16 [{B}, {H}, {S}, {D}] causal, "
          f"{items} items on {grid} blocks, median of 5 launches (L2 warm) "
          f"on {card}: " + "; ".join(cells), flush=True)


# The probe's cuts of K1b's consumer loop, as patterns of this tree's
# source: every call of each.
_SOFTMAX = r"softmax_tile<kBN, (true|false)>\(s, m, l, lim, alpha\);"
_S_GEMM = r"\n\s*s_gemm<T, C>\([^;]*\);"
_PV_GEMM = r"\n\s*pv_gemm<T, C>\([^;]*\);"
_TURNS = r"named_(sync|arrive)\((turn|next|4), 256\);"
# (K1c's segmented walk has 2 S and 3 P V products of its own)
_COUNTS = {_SOFTMAX: 4, _S_GEMM: 4, _PV_GEMM: 5}


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
    q, k, v, _dout, out, lse = k1a_case(dev)
    B, H, S, D = q.shape
    cells = []
    for cut, lib in libs.items():
        def run(lib=lib):
            lib.paddle_tpu_torch_flash_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), B * H, S, D, 1, 1,
                torch.cuda.current_stream().cuda_stream)
        cells.append(f"{cut} {chip_smoke.cuda_ms(run, flush=flush):.4f}")
    print(f"probe K1a forward bf16 [{B}, {H}, {S}, {D}] causal ms on {card}: "
          + "; ".join(cells), flush=True)


# K1b's shapes: (heads, head_dim, causal) at B = 8, S = 1024, bf16
BSHD_SHAPES = ((16, 128, True), (16, 128, False), (8, 256, True))
# the sweep's knobs, as the source spells them in K1b's Cfg
BSHD_KNOBS = (
    "kSeg ? kBNSeg : D == 64 ? kBN64 : D == 128 ? {} : 64;",
    "kSeg ? (D == 128 ? 2 : 4) : D == 64 ? kStages64 : D == 128 ? {} : 2;",
    "constexpr long long kL2Budget = {}LL << 20;")
# K1a's forward at D = 64 (keys a tile, ring depth, consumer warpgroups)
# and its backward's item order (the L2 budget of its head groups), as
# the source spells them
K1A_FWD_KNOB = "constexpr int kBN64 = {}, kStages64 = {}, kWG64 = {};"
K1A_FWD_PERSIST = "constexpr bool kLsePersist = {};"
K1A_FWD_L2 = BSHD_KNOBS[2]  # shared with K1b
# K1a with K1b's warpgroup turns
K1A_TURNS = ("constexpr bool kTurns = !kLse;", "constexpr bool kTurns = true;")
K1A_BWD_KNOB = "constexpr long long kItemL2Budget = {}LL << 20;"
# the backward's items in K1c's order (a head's items adjacent; its
# items one range, not units taken in turn)
K1C_ORDER = (("  if constexpr (kSeg) {\n    it.dq = item >= per;",
              "  if constexpr (true) {\n    it.dq = item >= per;"),
             ("const int units = kSeg ? (int)(2 * per) : (int)per;",
              "const int units = (int)(2 * per);"),
             ("last = kSeg ? units : 2 * units + grid;", "last = units;"))


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


def sweep_k1a(build, flush, card):
    """K1a's forward at other key tiles, ring depths and consumer
    warpgroups (D = 64), and its backward in other item orders, each at
    the train step's shape against the plain version."""
    import torch
    import chip_smoke
    src = (ROOT / "paddle_tpu_torch/ops/csrc/flash_attention.cu").read_text()
    fwd_now = tuple(int(x) for x in re.search(
        K1A_FWD_KNOB.replace("{}", r"(\d+)"), src).groups()) + (
        re.search(K1A_FWD_PERSIST.replace("{}", r"(\w+)"), src).group(1),
        int(re.search(K1A_FWD_L2.replace("{}", r"(\d+)"), src).group(1)),
        False)
    bwd_now = int(re.search(K1A_BWD_KNOB.replace("{}", r"(\d+)"),
                            src).group(1))
    # (keys a tile, stages, consumer warpgroups, persistent, L2 budget of
    # the head groups in MB, warpgroup turns)
    fwd_vars = [(128, 4, 2, "true", 16, False), (128, 2, 2, "true", 16, False),
                (128, 3, 2, "true", 16, False), (128, 6, 2, "true", 16, False),
                (64, 4, 2, "true", 16, False), (128, 4, 2, "true", 64, False),
                (128, 4, 2, "false", 16, False), (128, 4, 2, "true", 16, True),
                (128, 4, 3, "true", 16, False), (64, 4, 3, "true", 16, False)]
    bwd_vars = [8, 16, 32, 64, 4096, "K1c's order"]
    texts = {}
    for var in fwd_vars:
        knobs = [(knob.format(*now_v), knob.format(*var_v)) for knob, now_v,
                 var_v in ((K1A_FWD_KNOB, fwd_now[:3], var[:3]),
                           (K1A_FWD_PERSIST, fwd_now[3:4], var[3:4]),
                           (K1A_FWD_L2, fwd_now[4:5], var[4:5]))]
        knobs += [K1A_TURNS] if var[5] else []
        texts[("fwd", var)] = substitute(src, knobs, "K1a forward knobs") \
            if var != fwd_now else src
    for var in bwd_vars:
        texts[("bwd", var)] = substitute(src, K1C_ORDER if isinstance(
            var, str) else [(K1A_BWD_KNOB.format(bwd_now),
                             K1A_BWD_KNOB.format(var))],
            "K1a backward order") if var != bwd_now else src

    def make(key):
        name = "_".join(str(x) for x in ((key[0],) + (
            key[1] if isinstance(key[1], tuple) else (key[1],))))
        path = build / ("sweep_k1a_" + re.sub(r"\W", "", name) + ".cu")
        path.write_text(texts[key])
        text = compile_v(path, path.with_suffix(".so"))
        serial = [ln.strip() for ln in text.splitlines()
                  if re.search(r"C75\d\d", ln)]
        return load(path.with_suffix(".so")), usage(text), serial
    with ThreadPoolExecutor(len(texts)) as ex:
        built = dict(zip(texts, ex.map(make, texts)))
    libs = {key: lib for key, (lib, _, _) in built.items()}
    case = k1a_case(torch.device("cuda"))
    shape = list(case[0].shape)
    cells = []
    kern = ("bshd::flash_fwd_bshd_wgmma_kernel<__nv_bfloat16, (int)64, "
            "(bool)1, (bool)0>")
    for var in fwd_vars:
        use = built[("fwd", var)][1].get(kern, "")
        print(f"sweep K1a forward {var}: ptxas [{use}]"
              + "".join(f"; {w}" for w in built[("fwd", var)][2]),
              flush=True)
        # the consumers' setmaxnreg share assumes the launch bound's
        # registers: a copy given fewer, or one that spills, is not run
        want = 65536 // (128 * (var[2] + 1)) // 8 * 8
        if f"Used {want} registers" not in use or not re.search(
                r"0 bytes spill stores, 0 bytes spill loads", use):
            cells.append(f"{var}: not run (ptxas [{use}])")
            continue
        run = k1a_fwd_run(libs[("fwd", var)], case, f"sweep K1a forward {var}")
        mark = " (this tree)" if var == fwd_now else ""
        grid = "persistent" if var[3] == "true" else "a block an item"
        cells.append(f"{var[0]} keys x {var[1]} stages x {var[2]} consumer "
                     f"warpgroups, {grid}, head groups of {var[4]} MB"
                     f"{', turns' if var[5] else ''}{mark} "
                     f"{chip_smoke.cuda_ms(run, flush=flush):.4f}")
    print(f"sweep K1a forward bf16 {shape} causal ms on {card}: "
          + "; ".join(cells), flush=True)
    cells = []
    for var in bwd_vars:
        run = k1a_bwd_run(libs[("bwd", var)], case,
                          f"sweep K1a backward {var}")
        label = var if isinstance(var, str) else (
            f"head groups of {var} MB" if var < 4096 else "all heads")
        mark = " (this tree)" if var == bwd_now else ""
        cells.append(f"{label}{mark} "
                     f"{chip_smoke.cuda_ms(run, flush=flush):.4f}")
    print(f"sweep K1a backward bf16 {shape} causal ms on {card}: "
          + "; ".join(cells), flush=True)


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
