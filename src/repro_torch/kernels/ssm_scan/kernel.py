"""ctypes binding of the CUDA SSM scan kernel (``csrc/ssm_scan.cu``).

Counterpart of ``repro/kernels/ssm_scan/kernel.py::ssm_scan``. The Pallas
kernel's grid of (channel block, time block) with a scratch row carrying
the state becomes one thread per channel on Hopper, walking time in order,
with every batch row in the same launch.
"""
from __future__ import annotations

import torch

from .. import _build

__all__ = ["ssm_scan_cuda"]


def ssm_scan_cuda(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
    """Launch on ``a``, ``b`` [B, S, C] into ``out`` [B, S, C]; the caller
    has checked device, dtype, shape and contiguity."""
    lib = _build.load()
    B, S, C = a.shape
    err = lib.repro_ssm_scan(a.data_ptr(), b.data_ptr(), out.data_ptr(), B, S, C,
                             _build.DTYPE_CODES[a.dtype],
                             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check("repro_ssm_scan", err)
