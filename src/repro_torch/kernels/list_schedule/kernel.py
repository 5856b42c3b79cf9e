"""ctypes binding of the CUDA list-schedule kernel (``csrc/list_schedule.cu``).

Counterpart of the XLA program of ``repro/core/vectorized.py``
(``_schedule_many_stats_impl``): ``jax.lax.scan`` over the tasks under
``jax.vmap`` over the parameter vectors becomes one launch for every
vector, whose plan (``ref.py::list_schedule_plan`` is its twin) keeps the
chain of each vector in shared memory where it fits.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .ref import VARIANTS, ListSchedulePlan

__all__ = ["list_schedule_cuda", "kernel_plan", "kernel_attrs"]


def _code(variant: Optional[str]) -> int:
    return -1 if variant is None else VARIANTS.index(variant)


def list_schedule_cuda(feats: torch.Tensor, ints: torch.Tensor, params: torch.Tensor,
                       n_units: int, repeats: int, variant: Optional[str],
                       done: Optional[torch.Tensor], free: Optional[torch.Tensor],
                       makespan: torch.Tensor, busy: torch.Tensor) -> None:
    """Launch on checked tensors: feats [N, 8] f32, ints [N, 12] int32,
    params [K, 13] f32; out makespan [K], busy [K, 4]. ``variant`` None is
    the plan's choice; scratch done [N, K] and free [n_units, K] only for
    the global variant (None otherwise)."""
    lib = _build.load()
    err = lib.repro_list_schedule(
        feats.data_ptr(), ints.data_ptr(), params.data_ptr(), feats.shape[0],
        params.shape[0], n_units, float(repeats), _code(variant),
        None if done is None else done.data_ptr(),
        None if free is None else free.data_ptr(), makespan.data_ptr(), busy.data_ptr(),
        torch.cuda.current_stream(feats.device).cuda_stream)
    _build.check("repro_list_schedule", err)


def kernel_plan(n: int, k: int, n_units: int,
                variant: Optional[str] = None) -> ListSchedulePlan:
    """The plan the C side takes (``repro_list_schedule_plan``); its shared
    bytes are capped at the limit + 1."""
    out = (ctypes.c_int * 5)()
    _build.check("repro_list_schedule_plan", _build.load().repro_list_schedule_plan(
        n, k, n_units, _code(variant), out))
    return ListSchedulePlan(VARIANTS[out[0]], *out[1:])


def kernel_attrs(variant: str) -> dict:
    """Registers a thread, spilled bytes and static shared bytes of a
    variant's kernel."""
    regs, spill, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _build.check("repro_list_schedule_attrs", _build.load().repro_list_schedule_attrs(
        VARIANTS.index(variant), ctypes.byref(regs), ctypes.byref(spill),
        ctypes.byref(smem)))
    return {"registers": regs.value, "spill_bytes": spill.value, "smem_bytes": smem.value}
