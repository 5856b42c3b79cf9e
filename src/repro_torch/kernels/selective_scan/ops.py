"""Dispatching wrapper for the fused selective scan (inference).

``selective_scan_fused(xc, dt, A, Bm, Cm, D, z, state=None)`` returns
(y [B, S, di] in z's dtype, the last state [B, di, n] f32) of the Mamba
head's scan and readout (``ref.py`` states the function). A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
``selective_scan_fused.launches`` counts kernel launches and nothing else.

The op has no backward: the model takes it only where no gradient is
needed (``models/mamba.py::mamba_mix``), and keeps the chain around the
``ssm_scan`` kernel, whose backward saves the states, elsewhere. On
plain tensors only: DTensors take that chain too. Under a program capture
(``graph/capture.py``) a call is one ``vector`` task of B·S·di·n elements.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...graph.capture import kernel_call
from .._build import DTYPE_CODES
from .kernel import STATES, selective_scan_cuda
from .ref import selective_scan_fused_ref

__all__ = ["selective_scan_fused", "MAX_BATCH"]

MAX_BATCH = 65535   # grid.y of the launch


def selective_scan_fused(xc, dt, A, Bm, Cm, D, z, state: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    ins = [t for t in (xc, dt, A, Bm, Cm, D, z, state) if t is not None]
    B, S, di = xc.shape
    n = A.shape[-1]
    if xc.device.type == "cpu":
        fn = lambda: selective_scan_fused_ref(xc, dt, A, Bm, Cm, D, z, state)  # noqa: E731
    elif xc.device.type == "cuda":
        fn = lambda: _launch(xc, dt, A, Bm, Cm, D, z, state)  # noqa: E731
    else:
        raise ValueError(f"selective_scan_fused: unsupported device {xc.device}")
    return kernel_call("selective_scan", "vector", fn, ins, lambda: {"elems": B * S * di * n})


def _launch(xc, dt, A, Bm, Cm, D, z, state):
    B, S, di = xc.shape
    n = A.shape[-1]
    _check(xc, dt, A, Bm, Cm, D, z, state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (xc, dt, A, Bm, Cm, D, z, state)):
        raise ValueError("selective_scan_fused: no backward; a gradient is needed here")
    if Bm.stride(-1) != 1 or Bm.stride() != Cm.stride():    # one pair of row strides
        Bm, Cm = Bm.contiguous(), Cm.contiguous()
    if z.stride(-1) != 1:
        z = z.contiguous()
    xc, dt, A, D = (t.contiguous() for t in (xc, dt, A, D))
    state = None if state is None else state.contiguous()
    out = torch.empty((B, S, di), dtype=z.dtype, device=xc.device)
    last = torch.empty((B, di, n), dtype=torch.float32, device=xc.device)
    selective_scan_cuda(xc, dt, A, Bm, Cm, D, z, state, out, last)
    selective_scan_fused.launches += 1
    return out, last


def _check(xc, dt, A, Bm, Cm, D, z, state) -> None:
    if xc.dim() != 3:
        raise ValueError(f"selective_scan_fused: want xc [B, S, di]; got {tuple(xc.shape)}")
    B, S, di = xc.shape
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"selective_scan_fused: want A [di, n]; got {tuple(A.shape)}")
    n = A.shape[1]
    want = {"dt": (dt, (B, S, di)), "Bm": (Bm, (B, S, n)), "Cm": (Cm, (B, S, n)),
            "D": (D, (di,)), "z": (z, (B, S, di))}
    if state is not None:
        want["state"] = (state, (B, di, n))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"selective_scan_fused: want {name} {shape}; got {tuple(t.shape)}")
    if any(t.device != xc.device for t, _ in want.values()) or A.device != xc.device:
        raise ValueError("selective_scan_fused: every input must be on one device")
    if any(t.dtype != torch.float32 for t in (xc, dt, A, Bm, Cm, D)) or (
            state is not None and state.dtype != torch.float32):
        raise TypeError("selective_scan_fused: xc, dt, A, Bm, Cm, D and the state must be f32")
    if z.dtype not in DTYPE_CODES:
        raise TypeError(f"selective_scan_fused: z dtype {z.dtype} not supported")
    if n not in STATES:
        raise ValueError(f"selective_scan_fused: n = {n}; the kernel takes n in {STATES}")
    if 0 in (B, S, di):
        raise ValueError(f"selective_scan_fused: empty input {(B, S, di)}")
    if B > MAX_BATCH:
        raise ValueError(f"selective_scan_fused: batch above {MAX_BATCH}")


selective_scan_fused.launches = 0
