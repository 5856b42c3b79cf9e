"""Build and load the port's CUDA kernels.

All sources under ``kernels/csrc/`` are compiled by ONE ``nvcc`` call into
one shared library with a plain C interface, loaded with ``ctypes``:

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
       -Xcompiler -fPIC -o <build>/librepro_torch_<hash>.so csrc/*.cu

The library is built at first use, into ``build/repro_torch/`` at the root
of the checkout (``$REPRO_TORCH_BUILD_DIR`` overrides it). Its file name
carries a hash of the sources and flags, so a stale build is never loaded.
A failed build raises; nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

__all__ = ["SOURCES", "NVCC_FLAGS", "DTYPE_CODES", "build_dir", "library_path",
           "load", "check"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "rmsnorm.cu", _CSRC / "flash_attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# the `dtype` argument of every C entry point
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_VP, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argtypes; each returns cudaGetLastError() as an int
_SIGNATURES = {
    "repro_rmsnorm": (_VP, _VP, _VP, _INT, _INT, _F32, _INT, _VP),
    "repro_flash_attention": (_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
                              _INT, _INT, _INT, _F32, _INT, _VP),
}

_lib: Optional[ctypes.CDLL] = None


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"librepro_torch_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of repro_torch cannot be built")


def _compile(out: Path, verbose: bool) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *map(str, SOURCES)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n"
                               f"{r.stdout}{r.stderr}")
        if verbose and (r.stdout or r.stderr):
            print(r.stdout + r.stderr, flush=True)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library, built on first use (raises if the build fails)."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        _compile(path, verbose)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
