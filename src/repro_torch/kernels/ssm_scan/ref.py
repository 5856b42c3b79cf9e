"""Plain PyTorch version of the SSM scan kernel (counterpart of
``repro/kernels/ssm_scan/ref.py::ssm_scan_ref``): h_t = a_t·h_{t-1} + b_t
along axis -2 with h_{-1} = 0, a sequential loop over S with the state in
f32, the result cast to ``a.dtype``."""
from __future__ import annotations

import torch

__all__ = ["ssm_scan_ref"]


def ssm_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b [..., S, C] -> h [..., S, C] in a.dtype."""
    S = a.shape[-2]
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    h = torch.zeros(a.shape[:-2] + a.shape[-1:], dtype=torch.float32,
                    device=a.device)
    for t in range(S):
        h = a[..., t, :].float() * h + b[..., t, :].float()
        out[..., t, :] = h
    return out.to(a.dtype)
