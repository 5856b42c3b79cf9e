"""Mamba-style selective SSM (diagonal state) for the Hymba hybrid heads.

Counterpart of ``repro/models/mamba.py``. Prefill and forward run the
recurrence h_t = a_t·h_{t-1} + bu_t (the reference reaches it through
``jax.lax.associative_scan``) and its readout in one of two ways:

* where no gradient is needed, on plain CUDA tensors (the serve engine's
  prefill under ``inference_mode``): the fused selective-scan kernel
  (``kernels/selective_scan``), which keeps the [B, di, n] states in
  registers and writes only y and the last state;
* elsewhere (training under autograd, CPU tensors, DTensors): the chain,
  which builds the f32 [B, S, di, n] ``a`` and ``bu``, scans them with the
  ``ssm_scan`` kernel on the card (whose backward needs the states h) and
  contracts h with C.

Decode is the O(1) recurrent update on (conv_state, ssm_state), plain
torch as in the reference.

Shapes: x_in [B, S, di]; A_log [di, n]; W_x projects di -> (dt_rank + 2n);
conv is depthwise causal, width K.

Spans (``obs/spans.py``, while a profiler records): the chain's
``mamba.expand`` (the [B, S, di, n] f32 ``a`` and ``bu``), ``mamba.scan``
and ``mamba.readout`` (C contraction, D skip, gate); the fused call sits
inside ``mamba.scan`` alone.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import constrain, mesh_of
from ..kernels.selective_scan.ops import selective_scan_fused
from ..kernels.ssm_scan.ops import ssm_scan_batched
from ..obs.spans import span
from .layers import dense

__all__ = ["selective_scan", "mamba_mix", "mamba_decode_mix", "MambaState"]


class MambaState(NamedTuple):
    conv: torch.Tensor   # [B, di, K-1] last inputs (for causal depthwise conv)
    ssm: torch.Tensor    # [B, di, n]   diagonal SSM state


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           carry: Optional[torch.Tensor] = None):
    """x [B,S,di], w [di,K] -> y [B,S,di]; optional left context carry."""
    B, S, di = x.shape
    K = w.shape[-1]
    if carry is None:
        pad = x.new_zeros((B, K - 1, di))
    else:
        pad = carry.transpose(1, 2).to(x.dtype)              # [B,K-1,di]
    xp = torch.cat([pad, x], dim=1)                          # [B,S+K-1,di]
    # sum_k w[:,k] * x[t-K+1+k] — K is tiny (4): unrolled adds, as the reference
    y = sum(xp[:, k:k + S] * w[:, k] for k in range(K))
    new_carry = xp[:, S:, :].transpose(1, 2)                 # [B,di,K-1]
    return y, new_carry


def selective_scan(a: torch.Tensor, bu: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + bu_t along axis 1. a, bu [B, S, di, n] (f32),
    flattened to [B, S, di·n] channels for the ``ssm_scan`` kernel."""
    B, S, di, n = a.shape
    h = ssm_scan_batched(a.reshape(B, S, di * n), bu.reshape(B, S, di * n))
    return h.view(B, S, di, n)


def _ssm_states(x_conv, dt, Bm, A, state: Optional[torch.Tensor]) -> torch.Tensor:
    """The SSM's states h [B,S,di,n] (f32). x_conv [B,S,di], dt [B,S,di],
    Bm [B,S,n]."""
    with span("mamba.expand"):
        a = (dt[..., None] * A).exp_()                       # [B,S,di,n]
        bu = (dt * x_conv)[..., None] * Bm[:, :, None, :]    # [B,S,di,n]
        if state is not None:
            # fold carried state into the first step: h_0' = a_0*h_prev + bu_0
            bu[:, 0] += a[:, 0] * state
    with span("mamba.scan"):
        return selective_scan(a, bu)


def _dt_and_bc(xc: torch.Tensor, x_dtype, w_x, w_dt, b_dt, n_state, dt_rank):
    """Input-dependent step and B/C: proj = xc @ W_x (in the activation
    dtype; under rules a row-parallel product over the split channels,
    summed whole over the sequence for the scan), dt = softplus(dt_in @ W_dt
    + b_dt) in f32."""
    proj = dense(xc.to(x_dtype), w_x, out=("batch", None, None)).float()
    dt_in, Bm, Cm = torch.split(proj, [dt_rank, n_state, n_state], dim=-1)
    dt = F.softplus(dense(dt_in, w_dt.float()) + b_dt.float())
    return dt, Bm, Cm


def _takes_fused(*ts) -> bool:
    """Whether the fused kernel computes this call: plain (not DTensor)
    CUDA tensors, and no gradient needed (grad mode off, or no input
    requires grad)."""
    ts = [t for t in ts if t is not None]
    if mesh_of(*ts) is not None or any(t.device.type != "cuda" for t in ts):
        return False
    return not (torch.is_grad_enabled() and any(t.requires_grad for t in ts))


def mamba_mix(
    x_in: torch.Tensor,
    z: torch.Tensor,
    conv_w: torch.Tensor,
    w_x: torch.Tensor,
    w_dt: torch.Tensor,
    b_dt: torch.Tensor,
    a_log: torch.Tensor,
    d_skip: torch.Tensor,
    *,
    n_state: int,
    dt_rank: int,
    state: Optional[MambaState] = None,
    return_state: bool = False,
):
    """Full Mamba mixing on a pre-projected pair (x_in, z) [B,S,di]: the
    conv + selective-scan + gate core that forward, prefill and decode share."""
    xc, conv_carry = _causal_depthwise_conv(
        x_in, conv_w, None if state is None else state.conv)
    xc = constrain(F.silu(xc.float()), "batch", None, "ssm_inner")
    dt, Bm, Cm = _dt_and_bc(xc, x_in.dtype, w_x, w_dt, b_dt, n_state, dt_rank)
    dt = constrain(dt, "batch", None, "ssm_inner")
    A = -torch.exp(a_log.float())                            # [di,n]
    D = d_skip.float()
    ssm = None if state is None else state.ssm.float()
    if _takes_fused(xc, dt, Bm, Cm, A, D, z, ssm):
        with span("mamba.scan"):
            out, last = selective_scan_fused(xc, dt, A, Bm, Cm, D, z, ssm)
    else:
        h = _ssm_states(xc, dt, Bm, A, ssm)
        with span("mamba.readout"):
            y = torch.einsum("bsdn,bsn->bsd", h, Cm) + D * xc
            out = constrain((y * F.silu(z.float())).to(x_in.dtype), "batch", None, "ssm_inner")
        last = h[:, -1]
    if return_state:
        return out, MambaState(conv=conv_carry, ssm=last)
    return out


def mamba_decode_mix(
    x_in: torch.Tensor,
    z: torch.Tensor,
    conv_w: torch.Tensor,
    w_x: torch.Tensor,
    w_dt: torch.Tensor,
    b_dt: torch.Tensor,
    a_log: torch.Tensor,
    d_skip: torch.Tensor,
    *,
    n_state: int,
    dt_rank: int,
    state: MambaState,
) -> Tuple[torch.Tensor, MambaState]:
    """One-token step: x_in, z [B,1,di]. O(1) state update."""
    # conv: append new token to carry, take one output step
    hist = torch.cat([state.conv.to(x_in.dtype), x_in.transpose(1, 2)],
                     dim=-1)                                 # [B,di,K]
    xc = torch.einsum("bdk,dk->bd", hist, conv_w)[:, None]   # [B,1,di]
    new_conv = hist[..., 1:]
    xc = F.silu(xc.float())
    dt, Bm, Cm = _dt_and_bc(xc, x_in.dtype, w_x, w_dt, b_dt, n_state, dt_rank)
    A = -torch.exp(a_log.float())
    a = torch.exp(dt[..., None] * A)[:, 0]                   # [B,di,n]
    bu = ((dt * xc)[..., None] * Bm[:, :, None, :])[:, 0]    # [B,di,n]
    h = a * state.ssm.float() + bu
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0]) + d_skip.float() * xc[:, 0]
    out = (y[:, None] * F.silu(z.float())).to(x_in.dtype)
    return out, MambaState(conv=new_conv, ssm=h)
