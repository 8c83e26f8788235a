"""Parent-against-change check of the port's flash kernels on one card.

    python tools/torch_flash_ab.py --parent OTHER/flash_attention.cu

Builds `paddle_tpu_torch/ops/csrc/flash_attention.cu` of this tree and
another copy of it (for example the parent commit's, unpacked with
`git archive`) with `nvcc -Xptxas -v`, and prints:

* registers, stack, spills and shared memory of every kernel the other
  copy has, beside the same kernel of this tree (a template argument
  this tree adds must be false there: the instantiation that the other
  copy compiled), and whether they are equal;
* K1a's forward and backward at the train step's [8, 16, 1024, 64] bf16
  causal, timed in turns (other, this, this, other, other, this) with
  CUDA events and L2 flushed, as `chip_smoke.py` times kernels.

Needs a card and nvcc; imports torch and the port only.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
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


def match(name, mine):
    """This tree's kernel for the other copy's `name`: the same base and
    leading template arguments, any further ones false."""
    base, args = split_name(name)
    for n in mine:
        b, a = split_name(n)
        if b == base and a[:len(args)] == args and all(
                x in ("false", "(bool)0", "0") for x in a[len(args):]):
            return n
    return None


def load(path):
    from paddle_tpu_torch.ops import flash_attention as fa
    lib = ctypes.CDLL(str(path))
    for fn in ("paddle_tpu_torch_flash_fwd", "paddle_tpu_torch_flash_bwd"):
        getattr(lib, fn).argtypes = fa._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the other copy of flash_attention.cu")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_ab: no CUDA device")
    import chip_smoke
    build = ROOT / "build" / "flash_ab"
    build.mkdir(parents=True, exist_ok=True)
    libs = {}
    reports = {}
    for side, src in (("other", Path(args.parent)),
                      ("this", ROOT / "paddle_tpu_torch/ops/csrc/"
                               "flash_attention.cu")):
        reports[side] = usage(compile_v(src, build / f"lib_{side}.so"))
        libs[side] = load(build / f"lib_{side}.so")
    same = True
    for name, use in sorted(reports["other"].items()):
        mine = match(name, reports["this"])
        ok = mine is not None and reports["this"][mine] == use
        same &= ok
        print(f"{'same' if ok else 'DIFFERS'}: {name}: other [{use}]; this "
              f"{mine!r} [{reports['this'].get(mine)}]", flush=True)
    extra = sorted(set(reports["this"]) - {
        match(n, reports["this"]) for n in reports["other"]})
    for name in extra:
        print(f"new: {name}: [{reports['this'][name]}]", flush=True)
    print(f"registers and spills of every kernel of the other copy: "
          f"{'unchanged' if same else 'CHANGED'}", flush=True)

    dev = torch.device("cuda")
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
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
