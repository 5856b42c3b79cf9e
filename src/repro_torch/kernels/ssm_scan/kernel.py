"""ctypes binding of the CUDA SSM scan kernels (``csrc/ssm_scan.cu``).

Counterpart of ``repro/kernels/ssm_scan/kernel.py::ssm_scan``. The Pallas
kernel's grid of (channel block, time block) with a scratch row carrying
the state becomes one thread per channel on Hopper, walking time in order,
with every batch row in the same launch. The backward (the reference has
none: it differentiates the jnp scan) is the same design walking time
backwards.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["ssm_scan_cuda", "ssm_scan_bwd_cuda", "scan_kernel_attrs"]


def ssm_scan_cuda(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
    """Launch on ``a``, ``b`` [B, S, C] into ``out`` [B, S, C]; the caller
    has checked device, dtype, shape and contiguity."""
    lib = _build.load()
    B, S, C = a.shape
    err = lib.repro_ssm_scan(a.data_ptr(), b.data_ptr(), out.data_ptr(), B, S, C,
                             _build.DTYPE_CODES[a.dtype],
                             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check("repro_ssm_scan", err)


def ssm_scan_bwd_cuda(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor, da: torch.Tensor,
                      db: torch.Tensor) -> None:
    """Launch the reverse scan on ``a``, ``h`` (the forward's output) and
    ``dh`` [B, S, C] into ``da``, ``db`` [B, S, C], all of one dtype and
    contiguous (the caller has checked)."""
    lib = _build.load()
    B, S, C = a.shape
    err = lib.repro_ssm_scan_bwd(a.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(),
                                 db.data_ptr(), B, S, C, _build.DTYPE_CODES[a.dtype],
                                 torch.cuda.current_stream(a.device).cuda_stream)
    _build.check("repro_ssm_scan_bwd", err)


def scan_kernel_attrs(dtype: torch.dtype, backward: bool) -> dict:
    """Registers and spill bytes per thread, and static shared memory per
    block, of the forward or backward scan kernel in ``dtype``."""
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _build.check("repro_ssm_scan_attrs", _build.load().repro_ssm_scan_attrs(
        _build.DTYPE_CODES[dtype], int(backward), ctypes.byref(regs), ctypes.byref(local),
        ctypes.byref(smem)))
    return {"registers": regs.value, "spill_bytes": local.value, "smem_bytes": smem.value}
