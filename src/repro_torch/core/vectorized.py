"""Beyond-paper: vectorized analytic scheduler for parameter sweeps, on the
port's list-schedule kernel.

Counterpart of ``repro.core.vectorized``. The same task graph is compiled
into arrays and run through the same **list-scheduling recurrence**; where
the reference runs ``jax.lax.scan`` under ``jax.vmap`` in one XLA call,
the port makes one launch of its CUDA kernel
(``kernels/list_schedule``) for all K parameter vectors, or runs the
kernel's plain version for ``device="cpu"``. Either way the results are
f32 and equal the reference's bit for bit, and they come back as numpy
float32 arrays, as ``np.asarray`` of the reference's result does.

``TaskArrays``, ``from_tasks`` and ``params_of`` are the reference's,
unchanged (numpy). Durations are the engines' analytic models (no
pipeline/contention micro-behavior); the event engine remains ground
truth and tests bound the deviation between the two.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..graph.tasks import Task
from ..hw.dma import DmaDescriptor
from ..hw.ici import CollectiveSpec
from ..hw.mxu import GemmSpec
from ..hw.presets import HwConfig
from ..hw.vecunit import VecSpec
from ..kernels.list_schedule.ops import list_schedule
from ..kernels.list_schedule.ref import FEATS, INT_COLS

__all__ = ["TaskArrays", "from_tasks", "params_of", "task_tensors", "schedule",
           "schedule_many", "schedule_stats", "schedule_many_stats",
           "PARAM_NAMES", "N_ENGINE_CLASSES"]

MAX_DEPS = 8

# engine classes for the duration model
ENG_MXU, ENG_VPU, ENG_DMA, ENG_ICI = 0, 1, 2, 3
N_ENGINE_CLASSES = 4

PARAM_NAMES = ("macs", "clock_ghz", "vpu_flops_per_cycle", "hbm_gbps",
               "dma_overhead_ns", "ici_link_gbps", "ici_latency_ns",
               "dcn_gbps", "dcn_latency_ns", "mxu_rows", "vmem_bytes_per_ns",
               "task_overhead_ns", "mxu_cols")


@dataclass
class TaskArrays:
    engine_class: np.ndarray    # [N] int32 in {MXU, VPU, DMA, ICI}
    engine_unit: np.ndarray     # [N] int32 physical engine instance id
    n_units: int
    flops: np.ndarray           # [N]
    elems: np.ndarray
    bytes_: np.ndarray
    io_bytes: np.ndarray        # VMEM load/store traffic of compute tasks
    gemm_m: np.ndarray          # GEMM dims for ragged-edge efficiency
    gemm_n: np.ndarray
    coll_phases: np.ndarray
    coll_bytes: np.ndarray      # per-phase link bytes
    cross_pod: np.ndarray       # [N] bool
    deps: np.ndarray            # [N, MAX_DEPS] int32, -1 padded


def params_of(cfg: HwConfig, mxu_eff: float = 0.0) -> np.ndarray:
    del mxu_eff  # kept for API compat; efficiency is per-task now
    return np.array([
        cfg.macs, cfg.clock_ghz, cfg.vpu_flops_per_cycle, cfg.hbm_gbps,
        cfg.dma_desc_overhead_ns, cfg.ici_link_gbps, cfg.ici_latency_ns,
        cfg.dcn_gbps, cfg.dcn_latency_ns, cfg.mxu_rows,
        cfg.vmem_ports * cfg.vmem_port_bytes_per_cycle * cfg.clock_ghz,
        # per-task pipeline setup: fill/drain + FIFO/barrier hop
        # (calibrated vs the event engine on the small-op CNN workloads)
        (cfg.mxu_rows + 64) * cfg.cycle_ns + 450.0,
        cfg.mxu_cols,
    ], dtype=np.float64)


def from_tasks(tasks: Sequence[Task]) -> TaskArrays:
    """Task list (with barrier deps) -> dense arrays. Dependencies resolve
    each wait barrier to its producer task indices (capped at MAX_DEPS,
    keeping the latest producers — the binding ones under FIFO order)."""
    producers: Dict[int, List[int]] = {}
    unit_ids: Dict[str, int] = {}
    n = len(tasks)
    eng_cls = np.zeros(n, np.int32)
    eng_unit = np.zeros(n, np.int32)
    flops = np.zeros(n)
    elems = np.zeros(n)
    bytes_ = np.zeros(n)
    io_bytes = np.zeros(n)
    gemm_m = np.zeros(n)
    gemm_n = np.zeros(n)
    phases = np.zeros(n)
    cbytes = np.zeros(n)
    cross = np.zeros(n, bool)
    deps = np.full((n, MAX_DEPS), -1, np.int32)

    for i, t in enumerate(tasks):
        if t.engine not in unit_ids:
            unit_ids[t.engine] = len(unit_ids)
        eng_unit[i] = unit_ids[t.engine]
        p = t.payload
        if isinstance(p, GemmSpec):
            eng_cls[i] = ENG_MXU
            flops[i] = p.flops
            gemm_m[i], gemm_n[i] = p.m, p.n
            # pipeline overlaps the three streams; the largest paces
            io_bytes[i] = max(p.m * p.k * p.a_bytes_per_elem,
                              p.k * p.n * p.b_bytes_per_elem,
                              p.m * p.n * p.out_bytes_per_elem)
        elif isinstance(p, VecSpec):
            eng_cls[i] = ENG_VPU
            elems[i] = p.n_elems
            io_bytes[i] = (p.bytes_in or 2 * p.n_elems) + \
                (p.bytes_out or 2 * p.n_elems)
        elif isinstance(p, DmaDescriptor):
            eng_cls[i] = ENG_DMA
            bytes_[i] = p.nbytes
        elif isinstance(p, CollectiveSpec):
            eng_cls[i] = ENG_ICI
            phases[i] = p.phases()
            cbytes[i] = p.payload_bytes / max(p.group_size, 1)
            cross[i] = p.cross_pod
        else:
            raise TypeError(f"unknown payload {type(p)}")
        dlist: List[int] = []
        for bid, _need in t.waits:
            dlist.extend(producers.get(bid, []))
        for j, d in enumerate(dlist[-MAX_DEPS:]):
            deps[i, j] = d
        for bid in t.signals:
            producers.setdefault(bid, []).append(i)

    return TaskArrays(eng_cls, eng_unit, len(unit_ids), flops, elems, bytes_,
                      io_bytes, gemm_m, gemm_n, phases, cbytes, cross, deps)


Device = Optional[Union[str, torch.device]]


def task_tensors(arrays: TaskArrays, dev: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's packed task records on ``dev``: feats [N, 8] f32 (f64
    rounded to f32 on the host, as ``jnp.asarray`` does with x64 off) and
    ints [N, 12] int32 (class, unit, cross_pod, 0, deps)."""
    n = len(arrays.engine_class)
    cls = np.asarray(arrays.engine_class)
    unit = np.asarray(arrays.engine_unit)
    if not (((cls >= 0) & (cls < N_ENGINE_CLASSES)).all()
            and ((unit >= 0) & (unit < arrays.n_units)).all()):
        raise ValueError("TaskArrays: engine class outside [0, 4) or engine "
                         f"unit outside [0, {arrays.n_units})")
    feats = np.stack([np.asarray(getattr(arrays, f), np.float64) for f in FEATS],
                     axis=1).astype(np.float32)
    ints = np.zeros((n, INT_COLS), np.int32)
    ints[:, 0], ints[:, 1] = cls, unit
    ints[:, 2] = np.asarray(arrays.cross_pod, bool)
    ints[:, 4:] = arrays.deps
    return (torch.from_numpy(feats).to(dev), torch.from_numpy(ints).to(dev))


def _run(arrays: TaskArrays, param_matrix: np.ndarray, repeats: int,
         device: Device) -> Tuple[np.ndarray, np.ndarray]:
    dev = resolve_device(device)
    feats, ints = task_tensors(arrays, dev)
    params = torch.from_numpy(np.asarray(param_matrix, np.float64)
                              .astype(np.float32)).to(dev)
    mk, busy = list_schedule(feats, ints, params, arrays.n_units, repeats)
    return mk.cpu().numpy(), busy.cpu().numpy()


def schedule(arrays: TaskArrays, params: np.ndarray, *,
             device: Device = None) -> np.ndarray:
    """List-schedule makespan under one parameter vector (0-d f32)."""
    return _run(arrays, np.asarray(params)[None], 1, device)[0].reshape(())


def schedule_many(arrays: TaskArrays, param_matrix: np.ndarray, *,
                  device: Device = None) -> np.ndarray:
    """K parameter vectors -> K makespans in one kernel launch."""
    return _run(arrays, param_matrix, 1, device)[0]


def schedule_stats(arrays: TaskArrays, params: np.ndarray, *,
                   repeats: int = 1, device: Device = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Makespan + per-engine-class busy time under one parameter vector.

    The busy vector (``[N_ENGINE_CLASSES]``, summed task durations per
    class) is what the sweep pre-screen feeds the analytic Power-EM proxy:
    utilization(class) = busy / makespan, no event simulation needed.

    ``repeats`` is the **layer-replication fast path**: a workload made
    of ``repeats`` sequentially dependent copies of this task graph has
    makespan ``repeats * makespan(1)`` and busy ``repeats * busy(1)`` in
    closed form under the list-scheduling model (the reference's
    contract; cross-copy prefetch overlap at layer seams is ignored).
    """
    mk, busy = _run(arrays, np.asarray(params)[None], repeats, device)
    return mk.reshape(()), busy[0]


def schedule_many_stats(arrays: TaskArrays, param_matrix: np.ndarray, *,
                        repeats: int = 1, device: Device = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """K parameter vectors -> (K makespans, [K, 4] busy times) in one
    kernel launch — the sweep campaign's batched pre-screen. ``repeats``
    applies the closed-form layer replication of ``schedule_stats`` to
    every parameter vector."""
    return _run(arrays, param_matrix, int(repeats), device)
