"""Vectorized analytic pre-screen of one structural cell.

Compiles the cell's task graph once, then evaluates the whole analytic
sub-grid (all swept parameter vectors) in a single launch of the port's
list-schedule kernel via ``core.vectorized.schedule_many_stats`` (its
plain version for ``device="cpu"``; the reference makes one XLA call).
Per point, the busy-time vector feeds the analytic Power-EM proxy so the
Pareto selection has a real (time, energy) plane to work with — all
without ever stepping the event engine.

Full-model workloads (``graph.workloads.model_parts``) take the
**layer-replication fast path**: instead of compiling and scanning
``layers`` copies of the layer graph, the pre-screen compiles ONE layer
body and the model head, schedules each once, and composes the stats in
closed form (``model = layers * body + head`` — the
``core.vectorized.schedule_stats`` ``repeats`` contract). A ``memo``
dict shared across a campaign's cells dedupes the part compiles, so a
sweep axis over layer counts re-uses the same body screen — the event
engine still refines the full replicated op list.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..core.vectorized import (ENG_DMA, ENG_ICI, ENG_MXU, ENG_VPU,
                               N_ENGINE_CLASSES, Device, TaskArrays,
                               from_tasks, params_of, schedule_many_stats)
from ..graph.compiler import CompileOptions, compile_ops
from ..graph.workloads import model_parts, resolve_workload
from ..power.powerem import analytic_power_w
from .spec import SweepCell

__all__ = ["CellPrescreen", "prescreen_cell"]


@dataclass
class CellPrescreen:
    cell: SweepCell
    time_ns: np.ndarray          # [K] analytic makespans
    avg_w: np.ndarray            # [K] analytic chip power proxy
    energy_j: np.ndarray         # [K]
    util: np.ndarray             # [K, 4] per-engine-class utilization
    n_tasks: int
    spilled_layers: int
    total_flops: float
    hbm_bytes: float             # compiled HBM traffic (weights + spills)
    wall_s: float                # compile + batched schedule wall time


# engine-class utilization -> power-tree module families
_CLASS_FAMILIES = {
    ENG_MXU: ("mxu",),
    ENG_VPU: ("vpu",),
    ENG_DMA: ("hbm", "dma"),
    ENG_ICI: ("ici", "noc"),
}


def _class_units(arrays: TaskArrays) -> np.ndarray:
    """Engine instances per class (for utilization normalization)."""
    n_units = np.ones(N_ENGINE_CLASSES)
    for c in range(N_ENGINE_CLASSES):
        units = np.unique(arrays.engine_unit[arrays.engine_class == c])
        n_units[c] = max(len(units), 1)
    return n_units


@dataclass
class _PartScreen:
    """One compiled + batch-scheduled part graph (a layer body, a model
    head, or a whole single-graph workload)."""

    time_ns: np.ndarray          # [K]
    busy: np.ndarray             # [K, N_ENGINE_CLASSES]
    n_units: np.ndarray          # [N_ENGINE_CLASSES]
    n_tasks: int
    spilled: int
    total_flops: float
    hbm_bytes: float


def _screen_ops(ops, cell: SweepCell, opts: CompileOptions,
                pm: np.ndarray, device: Device) -> _PartScreen:
    cw = compile_ops(ops, cell.base_cfg(), opts)
    arrays = from_tasks(cw.tasks)
    mk, busy = schedule_many_stats(arrays, pm, device=device)
    return _PartScreen(time_ns=mk, busy=busy, n_units=_class_units(arrays),
                       n_tasks=len(cw.tasks), spilled=cw.spilled_layers,
                       total_flops=cw.total_flops, hbm_bytes=cw.hbm_bytes)


def prescreen_cell(cell: SweepCell,
                   memo: Optional[Dict[Any, _PartScreen]] = None,
                   device: Device = None) -> CellPrescreen:
    """One compile + ONE batched schedule launch for the whole cell
    (two for full-model cells on a part-memo miss: body + head), on
    ``device`` (None: the card).

    ``memo`` (optional, shared across the cells of one campaign run)
    caches part screens keyed by part identity x n_tiles x structural
    overrides x the analytic parameter matrix, so e.g. a ``layers`` axis
    compiles each distinct layer body once for the whole sweep. The key
    leaves the device out: both give the same bits.
    """
    t0 = time.time()
    spec = cell.spec
    opts = CompileOptions(n_tiles=cell.n_tiles, **spec.compile_opts)
    cfgs = [p.cfg(spec) for p in cell.points]
    pm = np.stack([params_of(c) for c in cfgs])
    parts = model_parts(cell.workload)
    if parts is None:
        scr = _screen_ops(resolve_workload(cell.workload)(), cell, opts, pm,
                          device)
        makespans, busy, n_units = scr.time_ns, scr.busy, scr.n_units
        n_tasks, spilled = scr.n_tasks, scr.spilled
        total_flops, hbm_bytes = scr.total_flops, scr.hbm_bytes
    else:
        def part(key: str, build) -> _PartScreen:
            if memo is None:
                return _screen_ops(build(), cell, opts, pm, device)
            mkey: Tuple = (key, cell.n_tiles,
                           tuple(sorted(cell.structural.items())),
                           pm.tobytes())
            if mkey not in memo:
                memo[mkey] = _screen_ops(build(), cell, opts, pm, device)
            return memo[mkey]

        body = part(parts.body_key, parts.body)
        head = part(parts.head_key, parts.head)
        L = parts.layers
        # closed-form layer replication: model = L x body + head (the
        # schedule_stats ``repeats`` contract; tests/test_invariants.py
        # pins prescreen == composed single-layer results)
        makespans = L * body.time_ns + head.time_ns
        busy = L * body.busy + head.busy
        n_units = np.maximum(body.n_units, head.n_units)
        n_tasks = L * body.n_tasks + head.n_tasks
        spilled = L * body.spilled + head.spilled
        total_flops = L * body.total_flops + head.total_flops
        hbm_bytes = L * body.hbm_bytes + head.hbm_bytes

    # busy time is summed over all engine instances of a class; normalize
    # by instance count so utilization stays in [0, 1]
    util = np.clip(busy / (np.maximum(makespans, 1e-9)[:, None] * n_units),
                   0.0, 1.0)

    avg_w = np.empty(len(cell.points))
    for i, cfg in enumerate(cfgs):
        fam_util: Dict[str, float] = {}
        for c, fams in _CLASS_FAMILIES.items():
            for fam in fams:
                fam_util[fam] = float(util[i, c])
        fam_util["vmem"] = max(fam_util["mxu"], fam_util["vpu"])
        avg_w[i] = analytic_power_w(cfg, fam_util, n_tiles=cell.n_tiles,
                                    freq_ghz=cfg.clock_ghz,
                                    temp_c=spec.refine.temp_c)
    energy = avg_w * makespans * 1e-9
    return CellPrescreen(cell=cell, time_ns=makespans, avg_w=avg_w,
                         energy_j=energy, util=util, n_tasks=n_tasks,
                         spilled_layers=spilled,
                         total_flops=total_flops,
                         hbm_bytes=hbm_bytes,
                         wall_s=time.time() - t0)
