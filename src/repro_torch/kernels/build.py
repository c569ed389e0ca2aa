"""Build the port's CUDA kernels with `nvcc` into shared libraries with a
plain C interface, and load them with `ctypes`.

Each `csrc/<name>.cu` compiles for sm_90a into `_build/<name>-<hash>.so`
beside this file (the directory is git-ignored), at the first call that
needs it; the hash of the source, the shared headers `csrc/*.cuh` and the
flags names the library, so an edited source or header rebuilds and an
unchanged one loads at once. The library is written
under a temporary name and renamed into place, so processes that build the
same source together never load a half-written file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {cand} and on PATH); "
                           "the CUDA kernels build only where the CUDA "
                           "toolkit is installed")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def compile_library(name: str) -> tuple[Path, float]:
    """Compile `csrc/<name>.cu` unless its library is already built.
    Returns (library path, seconds spent compiling; 0.0 when cached)."""
    lib = library_path(name)
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if need be."""
    lib = _loaded.get(name)
    if lib is None:
        path, _ = compile_library(name)
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
