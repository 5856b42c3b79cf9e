"""Build and load the port's CUDA kernels.

Each source under ``kernels/csrc/`` is compiled by its own ``nvcc``, all of
them started together, and one more ``nvcc`` links the objects into one
shared library with a plain C interface, loaded with ``ctypes``:

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
       -Xcompiler -fPIC -c -o <tmp>/<name>.o csrc/<name>.cu     (per source)
  nvcc -shared -o <build>/librepro_torch_<hash>.so <tmp>/*.o

The library is built at first use, into ``build/repro_torch/`` at the root
of the checkout (``$REPRO_TORCH_BUILD_DIR`` overrides it). Its file name
carries a hash of the flags and of every file under ``csrc/`` (the sources
and the headers they include), so a stale build is never loaded.
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

__all__ = ["SOURCES", "NVCC_FLAGS", "DTYPE_CODES", "csrc_files", "build_dir",
           "library_path", "load", "check"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "rmsnorm.cu", _CSRC / "rmsnorm_bwd.cu", _CSRC / "flash_attention.cu",
           _CSRC / "flash_attention_wgmma.cu", _CSRC / "flash_attention_bwd.cu",
           _CSRC / "ssm_scan.cu", _CSRC / "selective_scan.cu", _CSRC / "list_schedule.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# the `dtype` argument of every C entry point
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_VP, _INT, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_INTP = ctypes.POINTER(ctypes.c_int)
# C entry point -> argtypes; each returns cudaGetLastError() as an int
_SIGNATURES = {
    "repro_rmsnorm": (_VP, _VP, _VP, _INT, _INT, _F32, _INT, _VP),
    "repro_rmsnorm_variant": (_VP, _VP, _VP, _INT, _INT, _F32, _INT, _INT, _VP),
    "repro_rmsnorm_plan": (_INT, _INT, _INT, _INT, _INT, _INTP),
    "repro_rmsnorm_attrs": (_INT, _INT, _INT, _INT, _INTP, _INTP, _INTP),
    "repro_rmsnorm_bwd": (_VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _F32, _INT, _VP),
    "repro_rmsnorm_bwd_plan": (_INT, _INT, _INT, _INT, _INT, _INTP),
    "repro_rmsnorm_bwd_attrs": (_INT, _INT, _INT, _INTP, _INTP, _INTP),
    "repro_flash_attention": (_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
                              _INT, _INT, _INT, _INT, _INT, _INT, _F32, _INT, _VP),
    "repro_flash_attention_attrs": (_INT, _INT, _INT, _INTP, _INTP, _INTP, _INTP),
    "repro_flash_attention_wgmma": (_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT,
                                    _INT, _INT, _INT, _INT, _INT, _F32, _VP),
    "repro_flash_attention_wgmma_attrs": (_INT, _INT, _INT, _INTP, _INTP, _INTP),
    "repro_flash_attention_bwd": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                  _VP, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                                  _INT, _INT, _INT, _F32, _INT, _VP),
    "repro_flash_attention_bwd_slots": (_INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT),
    "repro_flash_attention_bwd_attrs": (_INT, _INT, _INT, _INTP, _INTP, _INTP, _INTP),
    "repro_ssm_scan": (_VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP),
    "repro_ssm_scan_bwd": (_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP),
    "repro_ssm_scan_attrs": (_INT, _INT, _INTP, _INTP, _INTP),
    "repro_selective_scan": (_VP,) * 10 + (_INT,) * 4 + (_I64,) * 4 + (_INT, _VP),
    "repro_selective_scan_attrs": (_INT, _INT, _INTP, _INTP, _INTP),
    "repro_list_schedule": (_VP, _VP, _VP, _INT, _INT, _INT, _F32, _INT, _VP, _VP,
                            _VP, _VP, _VP),
    "repro_list_schedule_plan": (_INT, _INT, _INT, _INT, _INTP),
    "repro_list_schedule_attrs": (_INT, _INTP, _INTP, _INTP),
}

_lib: Optional[ctypes.CDLL] = None


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def csrc_files() -> list:
    """Every file the build reads: the sources and the headers beside them."""
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in csrc_files():
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


def _run_all(cmds) -> str:
    """Start every command at once, wait for all; raise if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{o}")
    return "".join(outs)


def _compile(out: Path, verbose: bool) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in SOURCES]
        log = _run_all([[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", obj, str(src)]
                        for src, obj in zip(SOURCES, objs)])
        lib = str(Path(tmp) / out.name)
        log += _run_all([[nvcc, "-shared", "-o", lib, *objs]])
        if verbose and log:
            print(log, flush=True)
        os.replace(lib, out)  # atomic: a concurrent loader sees all or nothing


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
