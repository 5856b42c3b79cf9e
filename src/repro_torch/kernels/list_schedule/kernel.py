"""ctypes binding of the CUDA list-schedule kernel (``csrc/list_schedule.cu``).

Counterpart of the XLA program of ``repro/core/vectorized.py``
(``_schedule_many_stats_impl``): ``jax.lax.scan`` over the tasks under
``jax.vmap`` over the parameter vectors becomes one thread per vector
walking the tasks in order, every vector in one launch.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["list_schedule_cuda", "kernel_attrs"]


def list_schedule_cuda(feats: torch.Tensor, ints: torch.Tensor, params: torch.Tensor,
                       n_units: int, repeats: int, done: torch.Tensor,
                       free: torch.Tensor, makespan: torch.Tensor,
                       busy: torch.Tensor) -> None:
    """Launch on checked tensors: feats [N, 8] f32, ints [N, 12] int32,
    params [K, 13] f32; scratch done [N, K], free [n_units, K]; out
    makespan [K], busy [K, 4]."""
    lib = _build.load()
    err = lib.repro_list_schedule(
        feats.data_ptr(), ints.data_ptr(), params.data_ptr(), feats.shape[0],
        params.shape[0], n_units, float(repeats), done.data_ptr(), free.data_ptr(),
        makespan.data_ptr(), busy.data_ptr(),
        torch.cuda.current_stream(feats.device).cuda_stream)
    _build.check("repro_list_schedule", err)


def kernel_attrs() -> dict:
    """Registers a thread, spilled bytes and static shared bytes."""
    regs, spill, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _build.check("repro_list_schedule_attrs", _build.load().repro_list_schedule_attrs(
        ctypes.byref(regs), ctypes.byref(spill), ctypes.byref(smem)))
    return {"registers": regs.value, "spill_bytes": spill.value, "smem_bytes": smem.value}
