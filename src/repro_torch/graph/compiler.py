"""The NN-compiler analog: op list -> tiled, barrier-synchronized task graph.

Mirrors the paper's processing-flow model (§3.3):

* operators are tiled across compute tiles (output rows split — "a
  computing task may contain a partial operator from tiling");
* weight tensors stream HBM->VMEM via tensor-aware DMA, **broadcast** to
  all tiles, optionally compressed (``_C`` variants);
* activations stay VMEM-resident while they fit (tracked against the tile
  VMEM budget); otherwise they spill/stream through HBM — this is what
  makes small-CB configs DDR-BW-bound (Fig 7);
* logical **barriers** express producer/consumer deps: compute of layer i
  waits on (weights-of-i arrived) and (all tiles finished layer i-1);
  weight DMA of layer i+1 is issued early (double buffering) so transfer
  overlaps compute exactly as in the DPU pipeline description;
* sparsity acceleration (``_S``) skips the sparse fraction of MACs.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..hw.dma import DmaDescriptor
from ..hw.ici import CollectiveSpec
from ..hw.mxu import GemmSpec
from ..hw.presets import HwConfig
from ..hw.vecunit import VecSpec
from .tasks import Task
from .workloads import Op

__all__ = ["CompileOptions", "compile_ops", "CompiledWorkload"]

# op kind -> hw.ici.CollectiveSpec op name
_COLLECTIVE_OPS = {"allreduce": "all-reduce", "alltoall": "all-to-all",
                   "allgather": "all-gather",
                   "reducescatter": "reduce-scatter",
                   "permute": "collective-permute"}


@dataclass
class CompileOptions:
    n_tiles: int = 1
    dtype_bytes: int = 1          # int8 inference (CNN); 2 for bf16 LM
    compression: bool = False     # "_C" variants
    sparsity: bool = False        # "_S" variants
    weight_prefetch: bool = True  # double-buffer next layer's weights
    resident_fraction: float = 0.5  # VMEM fraction usable for activations


@dataclass
class CompiledWorkload:
    tasks: List[Task]
    total_flops: float
    hbm_bytes: float
    n_barriers: int   # dense per-compile count: ids are exactly 0..n-1
    spilled_layers: int


def compile_ops(ops: Sequence[Op], cfg: HwConfig,
                opts: Optional[CompileOptions] = None) -> CompiledWorkload:
    """Compile an op list into a barrier-synchronized task graph.

    Barrier ids are **per-compile and dense from 0** (``n_barriers`` is
    the exact count), so array consumers (``core.fastsim``) can index
    barriers directly; ``graph.stackem`` re-instances templates with its
    own remapping, and every other caller runs one compile per System.
    """
    opts = opts or CompileOptions()
    _bid = itertools.count(0)
    nt = max(opts.n_tiles, 1)
    tasks: List[Task] = []
    hbm_addr = 0
    hbm_bytes = 0.0
    total_flops = 0.0
    spilled = 0
    # (barrier id, signal count) of the previous layer: nt for tiled
    # compute layers, 1 for single-task collective layers
    prev_barrier: Optional[Tuple[int, int]] = None
    budget = cfg.vmem_bytes * opts.resident_fraction

    def alloc(nbytes: float) -> int:
        nonlocal hbm_addr
        a = hbm_addr
        hbm_addr += int(nbytes) + 256
        return a

    for i, op in enumerate(ops):
        dtb = opts.dtype_bytes
        w_bytes = op.w_bytes * dtb
        in_bytes = op.in_bytes * dtb
        out_bytes = op.out_bytes * dtb
        total_flops += op.flops * (1.0 - (op.sparsity if opts.sparsity else 0))

        waits: List[Tuple[int, int]] = []
        if prev_barrier is not None:
            waits.append(prev_barrier)

        # collectives run on the ICI fabric: one per-device task, no
        # tiling, no weight traffic. allreduce = Megatron TP combine /
        # DP gradient sync; alltoall = MoE expert-parallel dispatch/
        # combine (ring phases and per-link bytes come from
        # hw.ici.CollectiveSpec); rings that leave the pod
        # (Op.cross_pod, set by the PodShape placement) are paced by
        # DCN instead of ICI
        if op.kind in _COLLECTIVE_OPS:
            done_b = next(_bid)
            tasks.append(Task(
                engine="ici",
                payload=CollectiveSpec(op=_COLLECTIVE_OPS[op.kind],
                                       payload_bytes=in_bytes,
                                       group_size=op.group,
                                       cross_pod=op.cross_pod,
                                       name=op.name),
                waits=tuple(waits), signals=(done_b,), name=op.name))
            prev_barrier = (done_b, 1)
            continue

        # weight DMA (broadcast to all tiles, optionally compressed)
        if w_bytes > 0:
            wb = next(_bid)
            tasks.append(Task(
                engine="dma",
                payload=DmaDescriptor(
                    nbytes=w_bytes, src="hbm", dst="vmem", addr=alloc(w_bytes),
                    contiguous_run=min(int(w_bytes), 1 << 20),
                    compressed=opts.compression, broadcast=nt,
                    name=f"{op.name}.w"),
                waits=(),  # prefetch: no dependency on previous layer
                signals=(wb,),
                name=f"dma.{op.name}.w"))
            hbm_bytes += w_bytes * (cfg.dma_compression_ratio
                                    if opts.compression else 1.0)
            waits.append((wb, 1))

        # activation residency: spill to HBM when the tile working set
        # exceeds the budget; ops flagged ``stream`` (KV-cache reads /
        # appends, which live in HBM across decode steps) always stream
        act_ws = (in_bytes + out_bytes) / nt
        streams = (act_ws + w_bytes) > budget or op.stream
        if streams:
            spilled += 1
            ab = next(_bid)
            tasks.append(Task(
                engine="dma",
                payload=DmaDescriptor(
                    nbytes=in_bytes / nt, src="hbm", dst="vmem",
                    addr=alloc(in_bytes),
                    contiguous_run=min(int(in_bytes / nt) or 1, 1 << 20),
                    compressed=opts.compression, name=f"{op.name}.act"),
                waits=tuple(waits),
                signals=(ab,),
                name=f"dma.{op.name}.act"))
            hbm_bytes += in_bytes * (cfg.dma_compression_ratio
                                     if opts.compression else 1.0)
            waits = [(ab, 1)]

        done_b = next(_bid)
        for t in range(nt):
            if op.kind in ("conv", "matmul"):
                m_tile = -(-op.m // nt)
                payload = GemmSpec(
                    m=min(m_tile, max(op.m - t * m_tile, 1)), n=op.n, k=op.k,
                    a_bytes_per_elem=dtb, b_bytes_per_elem=dtb,
                    out_bytes_per_elem=dtb,
                    name=f"{op.name}@t{t}")
                if opts.sparsity and op.sparsity > 0:
                    # sparsity acceleration: skip the sparse MAC fraction by
                    # shrinking the contraction dim the array actually walks
                    payload = GemmSpec(
                        m=payload.m, n=payload.n,
                        k=max(int(op.k * (1 - op.sparsity)), 1),
                        a_bytes_per_elem=dtb, b_bytes_per_elem=dtb,
                        out_bytes_per_elem=dtb, name=payload.name)
                engine = f"tile{t}.mxu"
            else:
                payload = VecSpec(
                    n_elems=op.elems / nt, kind=op.vec_kind,
                    bytes_in=in_bytes / nt, bytes_out=out_bytes / nt,
                    name=f"{op.name}@t{t}")
                engine = f"tile{t}.vpu"
            tasks.append(Task(engine=engine, payload=payload,
                              waits=tuple(waits), signals=(done_b,),
                              name=f"{op.name}@t{t}"))
        prev_barrier = (done_b, nt)

        if streams:
            tasks.append(Task(
                engine="dma",
                payload=DmaDescriptor(
                    nbytes=out_bytes, src="vmem", dst="hbm",
                    addr=alloc(out_bytes),
                    contiguous_run=min(int(out_bytes) or 1, 1 << 20),
                    compressed=opts.compression, name=f"{op.name}.out"),
                waits=((done_b, nt),),
                signals=(),
                name=f"dma.{op.name}.out"))
            hbm_bytes += out_bytes * (cfg.dma_compression_ratio
                                      if opts.compression else 1.0)

    n_barriers = next(_bid)
    used = {b for t in tasks for b in t.signals}
    used.update(b for t in tasks for b, _ in t.waits)
    assert used <= set(range(n_barriers)), \
        f"barrier ids not dense: {sorted(used)} vs n={n_barriers}"
    return CompiledWorkload(tasks=tasks, total_flops=total_flops,
                            hbm_bytes=hbm_bytes, n_barriers=n_barriers,
                            spilled_layers=spilled)
