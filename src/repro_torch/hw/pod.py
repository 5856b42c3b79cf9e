"""Pod-scale simulation: replay a compiled (SPMD) program through TPU-EM.

SPMD symmetry argument: post-GSPMD, all 256 (or 512) chips execute the
same per-device program; chips are interchangeable, so ONE detailed chip
model paces the pod while collectives run on the ICI/DCN fabric model with
ring schedules. This is the "at scale" adaptation of the paper's multi-tile
simulation — the paper simulates 1-4 tiles exhaustively; at 256+ chips the
symmetric-replay is what keeps full-model simulation within the paper's
"minutes" speed objective (§2.3).

``hlo_to_tasks`` converts the HLO-extracted TaskSpec DAG (graph.hlo_parser)
into engine tasks with one barrier per producer, preserving the real
dependency structure of the compiled program, including the
compute/collective overlap XLA scheduled.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

from ..graph.hlo_parser import TaskSpec
from ..graph.tasks import Task
from .chip import Report, System
from .dma import DmaDescriptor
from .ici import CollectiveSpec
from .mxu import GemmSpec
from .presets import HwConfig
from .vecunit import VecSpec

__all__ = ["PodShape", "hlo_to_tasks", "simulate_program"]


@dataclass(frozen=True)
class PodShape:
    """Placement of a DP x EP x TP parallelism cube onto pods.

    Chips are laid out with TP innermost (contiguous chips, fastest
    collectives), EP next, DP outermost — the standard serving/training
    placement. ``pod_chips`` is the size of one ICI domain; a collective
    whose group *span* (group size x chip stride of its axis) exceeds it
    has at least one ring hop crossing pod boundaries, so the whole ring
    is paced by the DCN segment (``CollectiveSpec.cross_pod`` routes it
    onto the DCN resource in ``hw.ici.IciFabric``). ``pod_chips == 0``
    means a single unbounded pod (nothing crosses).
    """

    dp: int = 1
    tp: int = 1
    ep: int = 1
    pod_chips: int = 0

    def __post_init__(self):
        if min(self.dp, self.tp, self.ep) < 1 or self.pod_chips < 0:
            raise ValueError(f"bad pod shape {self}")

    @property
    def chips(self) -> int:
        return self.dp * self.tp * self.ep

    @property
    def n_pods(self) -> int:
        if not self.pod_chips:
            return 1
        return -(-self.chips // self.pod_chips)

    def span(self, axis: str) -> int:
        """Chip span of one collective group on ``axis``: group size
        times the stride between successive members (TP stride 1, EP
        stride tp, DP stride tp*ep)."""
        if axis == "tp":
            return self.tp
        if axis == "ep":
            return self.tp * self.ep
        if axis == "dp":
            return self.tp * self.ep * self.dp
        raise ValueError(f"axis must be tp|ep|dp, got {axis!r}")

    def crosses_pod(self, axis: str) -> bool:
        """True when an ``axis`` collective's ring leaves the pod."""
        return bool(self.pod_chips) and self.span(axis) > self.pod_chips


def _gemm_dims(flops: float, bytes_in: float, bytes_out: float
               ) -> GemmSpec:
    """Reconstruct plausible GEMM dims from flops + IO bytes.

    Output elems ~ bytes_out/2 = M*N; flops = 2*M*N*K -> K; split M,N evenly.
    Falls back to a cube when IO hints are degenerate. Approximation is
    recorded in DESIGN.md (the block-efficiency model only needs the
    magnitude + raggedness of the dims, not their exact split).
    """
    f = max(flops, 1.0)
    out_elems = max(bytes_out / 2.0, 1.0)
    k = max(f / (2.0 * out_elems), 1.0)
    mn = out_elems
    m = max(int(math.sqrt(mn)), 1)
    n = max(int(mn / m), 1)
    return GemmSpec(m=m, n=n, k=max(int(k), 1))


def hlo_to_tasks(specs: Sequence[TaskSpec], *, min_flops: float = 0.0,
                 stream_io: bool = True,
                 io_threshold: float = 4 * 2**20) -> List[Task]:
    """TaskSpec DAG -> engine task list with per-producer barriers.

    stream_io: HLO buffers are HBM-resident on the target, so compute tasks
    whose IO exceeds ``io_threshold`` get a DMA prologue (HBM->VMEM input
    stream) the compute depends on — without this, large-working-set
    programs under-run the memory-roofline bound (small tiles are assumed
    VMEM-resident/forwarded)."""
    tasks: List[Task] = []
    barrier_of: Dict[int, int] = {}
    next_b = 1
    for i, s in enumerate(specs):
        waits = tuple((barrier_of[d], 1) for d in s.deps if d in barrier_of)
        own = next_b
        next_b += 1
        barrier_of[i] = own
        if s.engine == "ici" and s.collective is not None:
            payload = CollectiveSpec(
                op=s.collective.op, payload_bytes=s.collective.payload_bytes,
                group_size=s.collective.group_size,
                cross_pod=s.collective.crosses_pod, name=s.name)
            engine = "ici"
        elif s.engine == "mxu" and s.flops > min_flops:
            payload = _gemm_dims(s.flops, s.bytes_in, s.bytes_out)
            engine = "tile0.mxu"
        elif s.engine == "dma":
            payload = DmaDescriptor(nbytes=max(s.bytes_in + s.bytes_out, 1.0),
                                    contiguous_run=1 << 20, name=s.name)
            engine = "dma"
        else:
            payload = VecSpec(n_elems=max(s.elems, 1.0),
                              bytes_in=s.bytes_in, bytes_out=s.bytes_out,
                              name=s.name)
            engine = "tile0.vpu"
        io = s.bytes_in + s.bytes_out
        if stream_io and engine.startswith("tile0") and io > io_threshold:
            pre_b = next_b
            next_b += 1
            tasks.append(Task(
                engine="dma",
                payload=DmaDescriptor(nbytes=io, contiguous_run=1 << 20,
                                      name=s.name + ".io"),
                waits=waits, signals=(pre_b,), name=s.name + ".io"))
            waits = waits + ((pre_b, 1),)
        tasks.append(Task(engine=engine, payload=payload, waits=waits,
                          signals=(own,), name=s.name))
    return tasks


def simulate_program(specs: Sequence[TaskSpec], cfg: HwConfig) -> Report:
    """Replay one compiled per-device program on the chip+fabric model."""
    tasks = hlo_to_tasks(specs)
    sysm = System(cfg, n_tiles=1)
    return sysm.run_workload(tasks)
