"""Build and load the port's CUDA kernels: nvcc -> shared library ->
ctypes.

Each kernel is one source under `csrc/` with a plain C interface (and
the `csrc/*.cuh` headers it includes). It is compiled at first use into
`build/paddle_tpu_torch/lib<name>_<tag>.so` at the repository root; the
tag hashes the source and every header it includes (`source_tag`), so
an edited kernel or header is never served from a stale build, and the
library is written under a temporary name (the process's and thread's
ids in it) and renamed into place, so a concurrent build sees all of it
or none. Within one process a kernel is built and loaded once whichever
threads reach it first (a fleet of serving replicas steps its engines
from several threads): `build` and `load` hold a lock per kernel name,
so different kernels still build in parallel. A missing toolkit or a
failed compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC))

#: nvcc compiles this process has run (a replica booted in a process
#: that has built every kernel adds none)
nvcc_runs = 0
_loaded = {}
_locks = {}                         # kernel name -> its build/load lock
_locks_guard = threading.Lock()
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


def _lock(name):
    with _locks_guard:
        return _locks.setdefault(name, threading.RLock())


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless this source, with the headers it
    includes, has been built already; returns the library's path."""
    with _lock(name):
        return _build(name)


def _build(name):
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
    tmp = lib.with_name(
        f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS,
           "-o", str(tmp), str(src)]
    global nvcc_runs
    with _locks_guard:
        nvcc_runs += 1
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
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock(name):
        if name not in _loaded:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
    return _loaded[name]
