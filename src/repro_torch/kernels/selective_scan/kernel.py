"""ctypes binding of the fused selective-scan kernel
(``csrc/selective_scan.cu``).

The JAX package has no kernel for this function: ``repro/models/mamba.py``
builds it from jnp around the ``ssm_scan`` Pallas kernel's scan. On Hopper
the chain's [B, S, di, n] f32 tensors are the cost, so the kernel keeps a
channel's states in registers (n over 4 lanes) and walks time in order.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

__all__ = ["selective_scan_cuda", "selective_scan_kernel_attrs", "STATES"]

STATES = (8, 16)    # the n the kernel is built for (2 or 4 states a lane)


def selective_scan_cuda(xc, dt, A, Bm, Cm, D, z, state: Optional[torch.Tensor],
                        out: torch.Tensor, state_out: torch.Tensor) -> None:
    """Launch into ``out`` [B, S, di] (z's dtype) and ``state_out``
    [B, di, n] f32; the caller has checked devices, dtypes, shapes, strides
    and alignment."""
    B, S, di = xc.shape
    err = _build.load().repro_selective_scan(
        xc.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
        z.data_ptr(), None if state is None else state.data_ptr(), out.data_ptr(),
        state_out.data_ptr(), B, S, di, A.shape[-1], z.stride(0), z.stride(1), Bm.stride(0),
        Bm.stride(1), _build.DTYPE_CODES[z.dtype], torch.cuda.current_stream(xc.device).cuda_stream)
    _build.check("repro_selective_scan", err)


def selective_scan_kernel_attrs(dtype: torch.dtype, n: int) -> dict:
    """Registers and spill bytes per thread, and static shared memory per
    block, of the instance for ``dtype`` (z and the output) and ``n``."""
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _build.check("repro_selective_scan_attrs", _build.load().repro_selective_scan_attrs(
        _build.DTYPE_CODES[dtype], n, ctypes.byref(regs), ctypes.byref(local),
        ctypes.byref(smem)))
    return {"registers": regs.value, "spill_bytes": local.value, "smem_bytes": smem.value}
