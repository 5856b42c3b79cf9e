"""Plain PyTorch version of fused RMSNorm (counterpart of
``repro/kernels/rmsnorm/ref.py::rmsnorm_ref``): math in f32, cast back."""
from __future__ import annotations

import torch

__all__ = ["rmsnorm_ref"]


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
