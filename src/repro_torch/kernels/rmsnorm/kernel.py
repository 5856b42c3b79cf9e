"""ctypes binding of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

Counterpart of ``repro/kernels/rmsnorm/kernel.py::fused_rmsnorm``. The
Pallas kernel's row blocks become one of four variants on Hopper, chosen by
the kernel's plan (``ref.py::rmsnorm_plan`` is its twin): one block per row
for fewer rows than SMs (decode), lane groups per row in two passes for
many rows under 4 KiB (bf16 prefill, qk-norm heads), persistent blocks
streaming wider rows through shared memory by bulk copy (f32 prefill), and
element loads where 16-byte loads are ruled out.

``rmsnorm_bwd_cuda`` binds the backward (``csrc/rmsnorm_bwd.cu``): one pass
over each row held in registers (16-byte loads, ``tpr`` lanes a row, w and
the dw sums in registers; the scalar variant where 16-byte loads are ruled
out), dw summed without atomics as ``[blocks, d]`` f32 partial rows added
in a fixed order by a second launch. ``bwd_kernel_plan`` is the C plan
(twin ``ref.py::rmsnorm_bwd_plan``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import RmsnormBwdPlan, RmsnormPlan

__all__ = ["rmsnorm_cuda", "rmsnorm_variant_cuda", "rmsnorm_bwd_cuda", "bwd_blocks",
           "kernel_plan", "kernel_attrs", "bwd_kernel_plan", "bwd_kernel_attrs"]

# blocks of the backward's rows launch per SM, at most (each writes one
# partial row of dw; the plan takes fewer when fewer rows fill them). One:
# the vector instances hold 176-255 registers a thread, so one 256-thread
# block an SM is resident, and a second wave only adds partial rows
# (chip_smoke.py phase 7 times both counts)
BWD_BLOCKS_PER_SM = 1
_n_sm = {}          # device index -> SM count

_launch = None      # the C entry point, bound at the first launch
_raw_stream = None  # device index -> the current stream's cudaStream_t


def _bind() -> None:
    """Bind the entry point and the stream query once. The raw stream comes
    from ``torch._C._cuda_getCurrentRawStream``, as for PyTorch's own
    compiled kernels: ``torch.cuda.current_stream`` would build a Stream
    object on every call."""
    global _launch, _raw_stream
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _launch = _build.load().repro_rmsnorm


def rmsnorm_cuda(x2: torch.Tensor, w: torch.Tensor, out: torch.Tensor, rows: int,
                 d: int, eps: float, dtype_code: int) -> None:
    """Launch on ``x2`` (``rows * d`` contiguous elements) into ``out``; the
    caller has checked device, dtype, shape and contiguity."""
    if _launch is None:
        _bind()
    err = _launch(x2.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d, eps, dtype_code,
                  _raw_stream(x2.get_device()))
    if err:
        _build.check("repro_rmsnorm", err)


def rmsnorm_variant_cuda(x2: torch.Tensor, w: torch.Tensor, out: torch.Tensor, rows: int,
                         d: int, eps: float, variant: int) -> None:
    """Launch the many-rows variant ``variant`` (``ROWS`` or ``STREAM``) in
    place of the plan's choice (``repro_rmsnorm_variant``), to time the two
    against each other; the serve path never calls it and it counts no
    launch. The inputs must allow 16-byte loads."""
    stream = torch._C._cuda_getCurrentRawStream(x2.get_device())
    err = _build.load().repro_rmsnorm_variant(
        x2.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d, eps,
        _build.DTYPE_CODES[x2.dtype], variant, stream)
    _build.check("repro_rmsnorm_variant", err)


def kernel_plan(rows: int, d: int, dtype: torch.dtype, aligned: bool,
                n_sm: int = 0) -> RmsnormPlan:
    """The plan the C side takes (``repro_rmsnorm_plan``); ``n_sm`` 0 asks
    the current device."""
    out = (ctypes.c_int * 9)()
    _build.check("repro_rmsnorm_plan", _build.load().repro_rmsnorm_plan(
        rows, d, _build.DTYPE_CODES[dtype], int(aligned), n_sm, out))
    return RmsnormPlan(*out)


def kernel_attrs(plan: RmsnormPlan, dtype: torch.dtype) -> dict:
    """Registers and spill bytes per thread of the instance ``plan`` launches,
    and its shared memory per block (static plus the plan's dynamic)."""
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _build.check("repro_rmsnorm_attrs", _build.load().repro_rmsnorm_attrs(
        plan.variant, _build.DTYPE_CODES[dtype], plan.tpr, plan.vpt, ctypes.byref(regs),
        ctypes.byref(local), ctypes.byref(smem)))
    return {"registers": regs.value, "spill_bytes": local.value,
            "smem_bytes": smem.value + plan.smem}


def bwd_blocks(rows: int, device_index: int) -> int:
    """Most blocks of the backward's rows launch: min(rows, SMs); the dw
    partial buffer has one row per block."""
    n_sm = _n_sm.get(device_index)
    if n_sm is None:
        n_sm = _n_sm[device_index] = torch.cuda.get_device_properties(
            device_index).multi_processor_count
    return max(1, min(rows, BWD_BLOCKS_PER_SM * n_sm))


def rmsnorm_bwd_cuda(x2: torch.Tensor, w: torch.Tensor, g2: torch.Tensor, dx: torch.Tensor,
                     dw: torch.Tensor, rows: int, d: int, eps: float, dtype_code: int,
                     blocks: int | None = None) -> None:
    """Launch the backward on ``x2``, ``g2`` (``rows * d`` contiguous
    elements) into ``dx`` and ``dw``; the caller has checked device, dtype,
    shape and contiguity. The dw partial rows are allocated here, ``blocks``
    of them (default ``bwd_blocks``; a smaller cap is for timing only)."""
    dev = x2.get_device()
    if blocks is None:
        blocks = bwd_blocks(rows, dev)
    part = torch.empty((blocks, d), dtype=torch.float32, device=x2.device)
    err = _build.load().repro_rmsnorm_bwd(
        x2.data_ptr(), w.data_ptr(), g2.data_ptr(), dx.data_ptr(), dw.data_ptr(),
        part.data_ptr(), rows, d, blocks, eps, dtype_code,
        torch._C._cuda_getCurrentRawStream(dev))
    _build.check("repro_rmsnorm_bwd", err)


def bwd_kernel_plan(rows: int, d: int, dtype: torch.dtype, aligned: bool,
                    blocks: int) -> RmsnormBwdPlan:
    """The backward's plan on the C side (``repro_rmsnorm_bwd_plan``)."""
    out = (ctypes.c_int * 6)()
    _build.check("repro_rmsnorm_bwd_plan", _build.load().repro_rmsnorm_bwd_plan(
        rows, d, _build.DTYPE_CODES[dtype], int(aligned), blocks, out))
    return RmsnormBwdPlan(*out)


def bwd_kernel_attrs(plan: RmsnormBwdPlan, dtype: torch.dtype) -> dict:
    """Registers and spill bytes per thread of the rows kernel ``plan``
    launches, and its shared memory per block (static plus the plan's)."""
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _build.check("repro_rmsnorm_bwd_attrs", _build.load().repro_rmsnorm_bwd_attrs(
        plan.variant, plan.vpt, _build.DTYPE_CODES[dtype], ctypes.byref(regs),
        ctypes.byref(local), ctypes.byref(smem)))
    return {"registers": regs.value, "spill_bytes": local.value,
            "smem_bytes": smem.value + plan.smem}
