"""Build the port's CUDA kernels with nvcc into shared libraries.

Each source under ``csrc/`` compiles to its own shared library with a plain
C interface (loaded with ctypes by the kernel's wrapper), into ``_build/``
next to this file. A library's file name carries a hash of its source and
flags, so an edited source never loads a stale build. Missing libraries are
compiled in parallel, one ``nvcc`` per source, all started together.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = {"stlt_scan": "stlt_scan.cu", "relevance_flash": "relevance_flash.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_kernels(echo: bool = False) -> dict:
    """Compile every kernel library that is not built yet; returns
    {name: library path}. ``echo`` prints nvcc's output (with ``-Xptxas -v``
    that is each kernel's registers and shared memory). Raises with the
    compiler's output if any build fails, or if ptxas reports that it had to
    serialize a kernel's wgmma instructions (warning C7512), a silent 2x
    slowdown of a warp-specialized kernel."""
    BUILD_DIR.mkdir(exist_ok=True)
    paths, procs = {}, {}
    for name, source in SOURCES.items():
        lib = paths[name] = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    errors = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        if "C7512" in out:
            errors.append(f"{name}: ptxas serialized the wgmma instructions (C7512); "
                          f"the kernel relies on their running asynchronously\n{out}")
            continue
        os.replace(tmp, lib)
        if echo:
            print(f"[build {name}]\n{out.strip()}")
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return paths
