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
    if not x.is_cuda:
        if x.device.type == "cpu":
            return rmsnorm_ref(x, w, eps)
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    d = x.shape[-1]
    if w.dtype != x.dtype or w.shape != (d,) or w.get_device() != x.get_device():
        raise ValueError(f"rmsnorm: w must be [{d}] {x.dtype} on {x.device}, "
                         f"got {tuple(w.shape)} {w.dtype} on {w.device}")
    code = DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"rmsnorm: dtype {x.dtype} not supported")
    if not 0 < d <= MAX_D:
        raise ValueError(f"rmsnorm: d={d} outside 1..{MAX_D}")
    if not x.is_contiguous():
        x = x.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    rmsnorm_cuda(x, w if w.is_contiguous() else w.contiguous(), out, rows, d, eps, code)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
