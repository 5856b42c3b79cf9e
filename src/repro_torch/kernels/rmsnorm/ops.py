"""Dispatching wrapper for fused RMSNorm (counterpart of
``repro/kernels/rmsnorm/ops.py::rmsnorm``).

``rmsnorm(x, w, eps)`` normalises over the last dim of ``x`` [..., d].
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``rmsnorm.launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import torch

from .._build import DTYPE_CODES
from .kernel import rmsnorm_cuda
from .ref import rmsnorm_ref

__all__ = ["rmsnorm", "MAX_D"]

MAX_D = 8192


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    d = x.shape[-1]
    if w.device != x.device or w.dtype != x.dtype or tuple(w.shape) != (d,):
        raise ValueError(f"rmsnorm: w must be [{d}] {x.dtype} on {x.device}, "
                         f"got {tuple(w.shape)} {w.dtype} on {w.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"rmsnorm: dtype {x.dtype} not supported")
    if not 0 < d <= MAX_D:
        raise ValueError(f"rmsnorm: d={d} outside 1..{MAX_D}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = x.numel() // d
    if rows == 0:
        return out
    rmsnorm_cuda(x.contiguous().view(rows, d), w.contiguous(),
                 out.view(rows, d), eps)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
