"""Dispatching wrapper for fused RMSNorm (counterpart of
``repro/kernels/rmsnorm/ops.py::rmsnorm``).

``rmsnorm(x, w, eps)`` normalises over the last dim of ``x`` [..., d].
A CPU tensor takes the plain version (and autograd of it); a CUDA tensor
launches the kernel or raises. ``rmsnorm.launches`` counts forward kernel
launches and nothing else.

Under autograd (grad enabled and ``x`` or ``w`` requiring grad) the launch
runs inside ``_RmsnormFn``, a ``torch.autograd.Function`` that saves x and
w (not r: the backward recomputes it) and whose backward launches the
backward kernel (``csrc/rmsnorm_bwd.cu``: dx, and dw without atomics).
``rmsnorm.bwd_launches`` counts backward calls, each one such launch (two
kernels: dx with the dw partials, then their fixed-order sum).

A DTensor (under sharding rules) runs on each rank's local rows: its last
dim whole, w replicated (``distributed.sharding.on_shards``), so the kernel
only ever sees plain local tensors. Under a program capture
(``graph/capture.py``) each call on local tensors is one ``vector`` task
of x's elements, x and w read and y written, whichever version runs.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate

from ...distributed.sharding import kernel_placements, mesh_of, on_shards, to_mesh
from ...graph.capture import kernel_call
from .._build import DTYPE_CODES
from .kernel import rmsnorm_bwd_cuda, rmsnorm_cuda
from .ref import rmsnorm_ref

__all__ = ["rmsnorm", "MAX_D"]

MAX_D = 8192


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mesh = mesh_of(x, w)
    if mesh is not None:
        pl = kernel_placements(to_mesh(x, mesh), range(x.ndim - 1))
        return on_shards(lambda a, b: rmsnorm(a, b, eps), mesh, (x, w),
                         (pl, [Replicate()] * mesh.ndim), pl)
    return kernel_call("rmsnorm", "vector", lambda: _local(x, w, eps), (x, w),
                       lambda: {"elems": x.numel()})


def _local(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """One plain tensor's call: the plain version on the CPU, else the
    kernel."""
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
    if not w.is_contiguous():
        w = w.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RmsnormFn.apply(x, w, eps)
    return _forward(x, w, eps, d, code)


def _forward(x: torch.Tensor, w: torch.Tensor, eps: float, d: int, code: int) -> torch.Tensor:
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    rmsnorm_cuda(x, w, out, rows, d, eps, code)
    rmsnorm.launches += 1
    return out


class _RmsnormFn(torch.autograd.Function):
    """The kernel's forward and backward as one differentiable op (CUDA
    tensors only)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _forward(x, w, eps, x.shape[-1], DTYPE_CODES[x.dtype])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        d = x.shape[-1]
        rows = x.numel() // d
        dx, dw = torch.empty_like(x), torch.empty_like(w)
        if rows == 0:
            return dx, dw.zero_(), None
        g = g.contiguous()
        rmsnorm_bwd_cuda(x, w, g, dx, dw, rows, d, ctx.eps, DTYPE_CODES[x.dtype])
        rmsnorm.bwd_launches += 1
        return dx, dw, None


rmsnorm.launches = 0
rmsnorm.bwd_launches = 0
