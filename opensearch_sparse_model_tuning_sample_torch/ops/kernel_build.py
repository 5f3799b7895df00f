"""Build the port's CUDA kernels into plain shared libraries and load them.

Each source under `csrc/` has a plain C interface and compiles with one
`nvcc` call for Hopper (`sm_90a`) into `build/torch_kernels/` at the repo
root, named by the hash of its source and flags, so a changed source rebuilds
and an unchanged one loads at once. Nothing builds at import: a kernel's
wrapper asks for its library at its first launch, and `build()` compiles
several at once (one `nvcc` process per source, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = {"maxpool_head": _PKG / "csrc" / "maxpool_head.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_BUILD_TIMEOUT_S = 600

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named library that is not built yet, all in parallel.
    Returns {name: {"seconds": wall time, "log": nvcc output}} for the ones
    compiled now (the log holds ptxas's register and shared-memory report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names or SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter(),
        )
    done = {}
    try:
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            os.replace(tmp, out)
            done[name] = {"seconds": time.perf_counter() - t0, "log": log}
    finally:
        for proc, _, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return done


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib
