"""Plain PyTorch versions of the SSM scan kernels (counterpart of
``repro/kernels/ssm_scan/ref.py::ssm_scan_ref``).

``ssm_scan_ref``: h_t = a_t·h_{t-1} + b_t along axis -2 with h_{-1} = 0, a
sequential loop over S with the state in f32, the result cast to
``a.dtype``.

``ssm_scan_bwd_ref``: its backward, a reverse scan over the output
gradient dh. With g_t = dh_t + a_{t+1}·g_{t+1} (a_S = 0), db_t = g_t and
da_t = g_t·h_{t-1} (h_{-1} = 0). The reference has no backward kernel: it
differentiates ``repro/models/mamba.py::selective_scan`` (an associative
scan) with ``jax.grad``, which computes the same function.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["ssm_scan_ref", "ssm_scan_bwd_ref"]


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


def ssm_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, h (the forward's output), g = dL/dh, all [..., S, C] -> (da, db)
    in a.dtype, accumulated in f32."""
    S = a.shape[-2]
    db = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    acc = torch.zeros(a.shape[:-2] + a.shape[-1:], dtype=torch.float32, device=a.device)
    for t in range(S - 1, -1, -1):
        acc = g[..., t, :].float() + (a[..., t + 1, :].float() * acc if t + 1 < S else 0.0)
        db[..., t, :] = acc
    da = torch.zeros_like(db)
    da[..., 1:, :] = db[..., 1:, :] * h[..., :-1, :].float()
    return da.to(a.dtype), db.to(a.dtype)
