"""ctypes binding of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

Counterpart of ``repro/kernels/rmsnorm/kernel.py::fused_rmsnorm``: the
Pallas kernel's row blocks become one warp per row on Hopper.
"""
from __future__ import annotations

import torch

from .. import _build

__all__ = ["rmsnorm_cuda"]


def rmsnorm_cuda(x2: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                 eps: float) -> None:
    """Launch on ``x2`` [rows, d] into ``out``; the caller has checked device,
    dtype, shape and contiguity."""
    lib = _build.load()
    rows, d = x2.shape
    err = lib.repro_rmsnorm(x2.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d,
                            float(eps), _build.DTYPE_CODES[x2.dtype],
                            torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check("repro_rmsnorm", err)
