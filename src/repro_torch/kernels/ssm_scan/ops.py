"""Dispatching wrapper for the SSM scan (counterpart of
``repro/kernels/ssm_scan/ops.py::ssm_scan_batched``).

``ssm_scan_batched(a, b)`` takes a, b [S, C] or [B, S, C] and returns
h_t = a_t·h_{t-1} + b_t along axis -2 (h_{-1} = 0), state in f32, result
in ``a.dtype``. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. ``ssm_scan_batched.launches`` counts forward
kernel launches and nothing else.

Under autograd (grad enabled and ``a`` or ``b`` requiring grad) the call
runs inside ``_SsmScanFn``, a ``torch.autograd.Function`` that saves ``a``
and its own output ``h`` (both of which the Mamba chain holds anyway: h
feeds the C contraction) and whose backward is the reverse scan: the
backward kernel (``csrc/ssm_scan.cu``, ``repro_ssm_scan_bwd``) on the card,
``ssm_scan_bwd_ref`` on the CPU. ``ssm_scan_batched.bwd_launches`` counts
backward kernel launches and nothing else. DTensors (under sharding
rules) run on each rank's local shards with the scanned dim whole. Under a
program capture (``graph/capture.py``) each call on local tensors is one
``vector`` task of a's elements, a and b read and h written, whichever
version runs.
"""
from __future__ import annotations

import torch

from ...distributed.sharding import kernel_placements, mesh_of, on_shards, to_mesh
from ...graph.capture import kernel_call
from .._build import DTYPE_CODES
from .kernel import ssm_scan_bwd_cuda, ssm_scan_cuda
from .ref import ssm_scan_bwd_ref, ssm_scan_ref

__all__ = ["ssm_scan_batched", "MAX_BATCH"]

MAX_BATCH = 65535   # grid.y of the launch


def ssm_scan_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mesh = mesh_of(a, b)
    if mesh is not None:          # DTensors: local shards, the scanned dim whole
        pl = kernel_placements(to_mesh(a, mesh), [d for d in range(a.ndim) if d != a.ndim - 2])
        return on_shards(ssm_scan_batched, mesh, (a, b), (pl, pl), pl)
    return kernel_call("ssm_scan", "vector", lambda: _local(a, b), (a, b),
                       lambda: {"elems": a.numel()})


def _local(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One call on plain tensors: the kernel on the card, the plain version
    on the CPU."""
    if a.device.type == "cuda":
        _check(a, b)
    elif a.device.type != "cpu":
        raise ValueError(f"ssm_scan_batched: unsupported device {a.device}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _SsmScanFn.apply(a, b)
    return _forward(a, b)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() not in (2, 3) or a.shape != b.shape:
        raise ValueError(f"ssm_scan_batched: want a, b [S, C] or [B, S, C] of one "
                         f"shape; got {tuple(a.shape)}, {tuple(b.shape)}")
    if b.device != a.device or b.dtype != a.dtype:
        raise ValueError("ssm_scan_batched: a and b must share device and dtype")
    if a.dtype not in DTYPE_CODES:
        raise TypeError(f"ssm_scan_batched: dtype {a.dtype} not supported")
    if a.numel() // (a.shape[-2] * a.shape[-1] or 1) > MAX_BATCH:
        raise ValueError(f"ssm_scan_batched: batch above {MAX_BATCH}")


def _as3(*ts):
    """Each tensor as a contiguous [B, S, C] view."""
    return [t.contiguous().reshape((-1,) + t.shape[-2:]) for t in ts]


def _forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return ssm_scan_ref(a, b)
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    if a.numel() == 0:
        return out
    ssm_scan_cuda(*_as3(a, b, out))
    ssm_scan_batched.launches += 1
    return out


def _backward(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor):
    if a.device.type == "cpu":
        return ssm_scan_bwd_ref(a, h, g)
    da = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    db = torch.empty_like(da)
    if a.numel() == 0:
        return da, db
    ssm_scan_bwd_cuda(*_as3(a, h, g, da, db))
    ssm_scan_batched.bwd_launches += 1
    return da, db


class _SsmScanFn(torch.autograd.Function):
    """The scan and its reverse scan as one differentiable op."""

    @staticmethod
    def forward(ctx, a, b):
        h = _forward(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        return _backward(a, h, g)


ssm_scan_batched.launches = 0
ssm_scan_batched.bwd_launches = 0
