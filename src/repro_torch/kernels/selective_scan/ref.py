"""Plain PyTorch versions of the fused selective scan
(``csrc/selective_scan.cu``).

The function is the Mamba head's scan and readout in
``repro/models/mamba.py::mamba_mix``: per channel d and state j,

  h_t = exp(dt_t·A) ⊙ h_{t-1} + (dt_t·x_t)·B_t,   h_{-1} = state (or 0)
  y_t = (Σ_j h_t[j]·C_t[j] + D·x_t) · silu(z_t)

with x = xc [B, S, di], dt [B, S, di], A [di, n], B, C [B, S, n], D [di]
(all f32), z [B, S, di] in the activation dtype, the state in f32. Both
versions return (y [B, S, di] in z's dtype, h_{S-1} [B, di, n] f32).

``selective_scan_fused_ref``: one step at a time over [B, di, n], the
state never stored; the plain version the wrapper takes for a CPU tensor.

``selective_scan_fused_tiled``: the kernel's own loop, step for step, for
the CPU tests: groups of ``STEPS`` time steps (the state carried from one
to the next; steps past S read x = dt = 0, which leaves it unchanged; the
kernel's 16-step tiles only stage inputs and change no sum), n
split over ``LANES`` lanes of ``n / LANES`` states, each lane's sum of h·C
over its states in order, the four lanes' sums combined as
(p_0 + p_2) + (p_1 + p_3), exp as 2^(dt·(A·log2 e)), and the gate
z / (1 + e^-z) after the D skip. The kernel's fused multiply-adds round
once where this rounds twice, and its exponentials are the SFU's
approximations, so the two agree to f32 rounding, not in every bit.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["selective_scan_fused_ref", "selective_scan_fused_tiled", "LANES", "STEPS"]

LANES = 4            # lanes a channel: the kernel's split of n
STEPS = LANES        # time steps a group: each lane finishes one
LOG2E = math.log2(math.e)


def selective_scan_fused_ref(xc, dt, A, Bm, Cm, D, z, state: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, di = xc.shape
    A = A.float()
    h = (torch.zeros((B, di, A.shape[-1]), dtype=torch.float32, device=xc.device)
         if state is None else state.float().clone())
    ys = []
    for t in range(S):
        x_t, d_t = xc[:, t].float(), dt[:, t].float()
        h = torch.exp(d_t[..., None] * A) * h + (d_t * x_t)[..., None] * Bm[:, t, None, :].float()
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t].float()) + D.float() * x_t)
    y = torch.stack(ys, 1) if ys else xc.new_zeros((B, 0, di), dtype=torch.float32)
    return (y * F.silu(z.float())).to(z.dtype), h


def selective_scan_fused_tiled(xc, dt, A, Bm, Cm, D, z, state: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, di = xc.shape
    n = A.shape[-1]
    if n % LANES:
        raise ValueError(f"n = {n} does not split over {LANES} lanes")
    ns = n // LANES
    a2 = (A.float() * LOG2E).view(di, LANES, ns)                     # [di, lane, state]
    dev = xc.device
    h = (torch.zeros((B, di, n), dtype=torch.float32, device=dev) if state is None
         else state.float().clone()).view(B, di, LANES, ns)
    D = D.float()
    zero = xc.new_zeros((B, di), dtype=torch.float32)
    zero_bc = xc.new_zeros((B, LANES, ns), dtype=torch.float32)
    out = torch.empty((B, S, di), dtype=torch.float32, device=dev)
    for t0 in range(0, S, STEPS):
        for u in range(STEPS):
            t = t0 + u
            live = t < S
            x = xc[:, t].float() if live else zero
            d = dt[:, t].float() if live else zero
            bv = Bm[:, t].float().view(B, LANES, ns) if live else zero_bc
            cv = Cm[:, t].float().view(B, LANES, ns) if live else zero_bc
            dx = d * x
            p = torch.zeros((B, di, LANES), dtype=torch.float32, device=dev)
            for j in range(ns):
                a = torch.exp2(d[..., None] * a2[None, :, :, j])        # [B, di, lane]
                h[..., j] = a * h[..., j] + dx[..., None] * bv[:, None, :, j]
                p = p + h[..., j] * cv[:, None, :, j]
            if live:
                y = (p[..., 0] + p[..., 2]) + (p[..., 1] + p[..., 3])
                zf = z[:, t].float()
                out[:, t] = (D * x + y) * (zf / (1.0 + torch.exp(-zf)))
    return out.to(z.dtype), h.reshape(B, di, n)
