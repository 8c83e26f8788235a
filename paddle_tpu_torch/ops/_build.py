"""Build and load the port's CUDA kernels: nvcc -> shared library ->
ctypes.

Each kernel is one source under `csrc/` with a plain C interface (and
the `csrc/*.cuh` headers it includes). It is compiled at first use into
`build/paddle_tpu_torch/lib<name>_<tag>.so` at the repository root; the
tag hashes the source and every header it includes (`source_tag`), so
an edited kernel or header is never served from a stale build, and the
library is written under a temporary name and renamed into place, so a
concurrent build sees all of it or none. A missing toolkit or a failed
compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC))

_loaded = {}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_tag(src: Path) -> str:
    """12 hex digits of a hash over `src` and, in order of first
    inclusion, every header it includes with `#include "..."` (directly
    or through another header), found beside the including file or in
    `csrc/`."""
    h = hashlib.sha1()
    seen, todo = set(), [Path(src)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text)
        for inc in _INCLUDE.findall(text.decode(errors="replace")):
            near = path.parent / inc
            todo.append(near if near.exists() else CSRC / inc)
    return h.hexdigest()[:12]


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless this source, with the headers it
    includes, has been built already; returns the library's path."""
    src = CSRC / f"{name}.cu"
    tag = source_tag(src)
    lib = BUILD_DIR / f"lib{name}_{tag}.so"
    if lib.exists():
        return lib
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError(f"{name}: no CUDA toolkit (nvcc) found to build "
                           "the kernel; set CUDA_HOME")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS,
           "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, lib)
    return lib


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, loaded once per process,
    with `signatures` ({C function: argtypes}) set on it; every function
    returns a cudaError_t as an int."""
    if name not in _loaded:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]
