"""Plain PyTorch version of the list-schedule kernel (counterpart of
``repro/core/vectorized.py``: ``_durations``, ``schedule`` and
``schedule_stats`` under ``jax.vmap``).

Inputs, packed task-major so that one task is one contiguous record:

* ``feats`` [N, 8] f32: flops, elems, bytes, io_bytes, gemm_m, gemm_n,
  coll_phases, coll_bytes (the order of ``FEATS``);
* ``ints`` [N, 12] int32: engine class, engine unit, cross-pod flag, a
  zero pad, then the 8 dependency slots (-1 = none);
* ``params`` [K, 13] f32, the order of ``core.vectorized.PARAM_NAMES``.

Every float operation is f32 and in the reference's order, one rounding
each, so the result equals the JAX package's bit for bit: the durations
as one [K, N] matrix, then a loop over the tasks on [K] vectors. A
dependency outside [0, i) reads 0.0, as the reference's ``done`` row
(zeros until task i writes it) does. The busy time of a class is summed
in task order.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["FEATS", "N_PARAMS", "N_CLASSES", "MAX_DEPS", "INT_COLS",
           "durations_ref", "list_schedule_ref"]

FEATS = ("flops", "elems", "bytes_", "io_bytes", "gemm_m", "gemm_n",
         "coll_phases", "coll_bytes")
N_PARAMS = 13
N_CLASSES = 4
MAX_DEPS = 8
INT_COLS = 4 + MAX_DEPS      # class, unit, cross_pod, pad, deps
ENG_MXU, ENG_VPU, ENG_DMA = 0, 1, 2


def durations_ref(feats: torch.Tensor, ints: torch.Tensor,
                  params: torch.Tensor) -> torch.Tensor:
    """[K, N] task durations (ns) under each parameter vector."""
    (macs, f, vpu_rate, hbm, dma_oh, link, lat, dcn, dcn_lat, rows,
     vmem_bw, t_oh, cols) = (params[:, j:j + 1] for j in range(N_PARAMS))
    (flops, elems, bytes_, io_bytes, gemm_m, gemm_n, phases,
     cbytes) = (feats[:, j] for j in range(len(FEATS)))
    one = torch.ones((), dtype=feats.dtype, device=feats.device)
    m = torch.maximum(gemm_m, one)
    nn = torch.maximum(gemm_n, one)
    pad = (torch.ceil(m / rows) * rows * torch.ceil(nn / cols) * cols) / (m * nn)
    io = io_bytes / vmem_bw
    d_mxu = torch.maximum(flops * pad / (2.0 * macs * f), io) + t_oh
    d_vpu = torch.maximum(elems / (vpu_rate * f), io) + t_oh
    d_dma = dma_oh + bytes_ / hbm
    cross = ints[:, 2] != 0
    bw = torch.where(cross, dcn, link)
    latv = torch.where(cross, dcn_lat, lat)
    d_ici = phases * (latv + cbytes / bw)
    cls = ints[:, 0]
    return torch.where(cls == ENG_MXU, d_mxu,
                       torch.where(cls == ENG_VPU, d_vpu,
                                   torch.where(cls == ENG_DMA, d_dma, d_ici)))


def list_schedule_ref(feats: torch.Tensor, ints: torch.Tensor,
                      params: torch.Tensor, n_units: int, repeats: int = 1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(makespan [K], busy [K, 4]) in f32, both times ``repeats``."""
    dur = durations_ref(feats, ints, params)
    K, N = dur.shape
    cls, unit, deps = ints[:, 0].tolist(), ints[:, 1].tolist(), ints[:, 4:].tolist()
    # column N of `done` stays 0.0: the slot a missing dependency reads
    done = torch.zeros((K, N + 1), dtype=dur.dtype, device=dur.device)
    free = torch.zeros((K, n_units), dtype=dur.dtype, device=dur.device)
    busy = torch.zeros((K, N_CLASSES), dtype=dur.dtype, device=dur.device)
    for i in range(N):
        idx = [d if 0 <= d < i else N for d in deps[i]]
        ready = torch.amax(done[:, idx], dim=1)
        u = unit[i]
        end = torch.maximum(ready, free[:, u]) + dur[:, i]
        done[:, i] = end
        free[:, u] = end
        busy[:, cls[i]] += dur[:, i]
    makespan = torch.amax(done[:, :N], dim=1)
    r = float(repeats)
    return makespan * r, busy * r
