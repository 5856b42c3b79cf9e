"""Dispatching wrapper for the SSM scan (counterpart of
``repro/kernels/ssm_scan/ops.py::ssm_scan_batched``).

``ssm_scan_batched(a, b)`` takes a, b [S, C] or [B, S, C] and returns
h_t = a_t·h_{t-1} + b_t along axis -2 (h_{-1} = 0), state in f32, result
in ``a.dtype``. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. ``ssm_scan_batched.launches`` counts kernel
launches and nothing else.

The kernel has no backward yet: on the card, a call under autograd (grad
enabled and ``a`` or ``b`` requiring grad) raises ``NotImplementedError``
rather than return a result that would silently drop the gradient. On the
CPU, autograd of the plain version differentiates as before.
"""
from __future__ import annotations

import torch

from .._build import DTYPE_CODES
from .kernel import ssm_scan_cuda
from .ref import ssm_scan_ref

__all__ = ["ssm_scan_batched", "MAX_BATCH"]

MAX_BATCH = 65535   # grid.y of the launch


def ssm_scan_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return ssm_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"ssm_scan_batched: unsupported device {a.device}")
    if a.dim() not in (2, 3) or a.shape != b.shape:
        raise ValueError(f"ssm_scan_batched: want a, b [S, C] or [B, S, C] of one "
                         f"shape; got {tuple(a.shape)}, {tuple(b.shape)}")
    if b.device != a.device or b.dtype != a.dtype:
        raise ValueError("ssm_scan_batched: a and b must share device and dtype")
    if a.dtype not in DTYPE_CODES:
        raise TypeError(f"ssm_scan_batched: dtype {a.dtype} not supported")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise NotImplementedError("ssm_scan has no backward kernel yet")
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    if a.numel() == 0:
        return out
    a3, b3, o3 = (t.reshape((-1,) + t.shape[-2:]) for t in
                  (a.contiguous(), b.contiguous(), out))
    if a3.shape[0] > MAX_BATCH:
        raise ValueError(f"ssm_scan_batched: batch {a3.shape[0]} > {MAX_BATCH}")
    ssm_scan_cuda(a3, b3, o3)
    ssm_scan_batched.launches += 1
    return out


ssm_scan_batched.launches = 0
