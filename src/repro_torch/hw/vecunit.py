"""Vector unit model — the VLIW-DSP analog (paper §3.2, Figure 4).

3-stage pipeline (load -> exec -> store) over SIMD data blocks, with the
paper's **kernel characterization table**: per elementwise kernel kind,

    cycles = offset + a * unroll_blocks + b * vectors + c * scalars

where a vector is one SIMD row (lanes*sublanes elements) and an unroll
block is ``unroll`` vectors. The paper fits these from MoviSim ISA runs;
MoviSim is proprietary, so ``fit_table`` provides the same least-squares
fit from (n_elems, cycles) samples — tests fit against a golden cost
model to validate the machinery, and the default table carries hand-set
constants for the common kernels (DESIGN.md §assumption-changes).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Generator, Iterable, Tuple

import numpy as np

from ..core import Environment, Store, Tracer
from .memory import VMem
from .presets import HwConfig

__all__ = ["VecKernel", "VecSpec", "VecUnit", "fit_table", "DEFAULT_TABLE"]


@dataclass(frozen=True)
class VecKernel:
    """Characterization row: cycles = offset + a*unroll_blocks + b*vectors
    + c*scalars."""

    offset: float
    a: float       # per unroll block (``unroll`` vectors)
    b: float       # per SIMD vector
    c: float       # per scalar remainder element
    unroll: int = 8

    def cycles(self, n_elems: float, lane_width: int) -> float:
        vectors = int(n_elems // lane_width)
        scalars = n_elems - vectors * lane_width
        blocks = vectors // self.unroll
        rem_vectors = vectors - blocks * self.unroll
        return (self.offset + self.a * blocks + self.b * rem_vectors
                + self.c * scalars)


# offsets/slopes in cycles; a ~= unroll * b with slight amortization gain
DEFAULT_TABLE: Dict[str, VecKernel] = {
    "add": VecKernel(offset=24, a=7.0, b=1.0, c=1.0),
    "mul": VecKernel(offset=24, a=7.0, b=1.0, c=1.0),
    "copy": VecKernel(offset=16, a=6.5, b=1.0, c=1.0),
    "exp": VecKernel(offset=40, a=22.0, b=3.0, c=6.0),
    "tanh": VecKernel(offset=40, a=26.0, b=3.5, c=7.0),
    "sigmoid": VecKernel(offset=40, a=24.0, b=3.2, c=6.5),
    "hswish": VecKernel(offset=36, a=14.0, b=2.0, c=3.0),
    "rsqrt": VecKernel(offset=40, a=18.0, b=2.5, c=5.0),
    "reduce": VecKernel(offset=32, a=8.0, b=1.2, c=1.5),
    "softmax": VecKernel(offset=64, a=46.0, b=6.2, c=12.0),
    "generic": VecKernel(offset=32, a=10.0, b=1.4, c=2.0),
}


@dataclass(frozen=True)
class VecSpec:
    """One vector-unit task."""

    n_elems: float
    kind: str = "generic"
    bytes_in: float = 0.0
    bytes_out: float = 0.0
    name: str = ""


class VecUnit:
    def __init__(self, env: Environment, cfg: HwConfig, vmem: VMem,
                 tracer: Tracer, name: str = "vpu",
                 table: Dict[str, VecKernel] = None):
        self.env = env
        self.cfg = cfg
        self.vmem = vmem
        self.tracer = tracer
        self.name = name
        self.table = dict(DEFAULT_TABLE if table is None else table)
        self.lane_width = cfg.vpu_lanes * cfg.vpu_sublanes

    def kernel(self, kind: str) -> VecKernel:
        return self.table.get(kind, self.table["generic"])

    def run(self, spec: VecSpec) -> Generator:
        """3-stage pipeline over SIMD blocks of the element stream."""
        env, cfg = self.env, self.cfg
        kern = self.kernel(spec.kind)
        block_elems = self.lane_width * kern.unroll * 64  # data block
        n_blocks = max(1, int(-(-spec.n_elems // block_elems)))
        bytes_in = (spec.bytes_in or spec.n_elems * 2) / n_blocks
        bytes_out = (spec.bytes_out or spec.n_elems * 2) / n_blocks

        q_in = Store(env, capacity=cfg.pipeline_depth)
        q_out = Store(env, capacity=cfg.pipeline_depth)
        done = env.event()

        def load_proc():
            rem = spec.n_elems
            for _ in range(n_blocks):
                elems = min(block_elems, rem)
                rem -= elems
                yield from self.vmem.transfer(bytes_in)
                yield q_in.put(elems)

        def exec_proc():
            for _ in range(n_blocks):
                elems = yield q_in.get()
                cycles = kern.cycles(elems, self.lane_width)
                t0 = env.now
                yield env.timeout(cycles * cfg.cycle_ns)
                self.tracer.emit(self.name, "ops", t0, env.now, elems)
                yield q_out.put(elems)

        def store_proc():
            for _ in range(n_blocks):
                yield q_out.get()
                yield from self.vmem.transfer(bytes_out)
            done.succeed()

        env.process(load_proc(), name=f"{self.name}.load")
        env.process(exec_proc(), name=f"{self.name}.exec")
        env.process(store_proc(), name=f"{self.name}.store")
        yield done

    def ideal_time_ns(self, spec: VecSpec) -> float:
        kern = self.kernel(spec.kind)
        return kern.cycles(spec.n_elems, self.lane_width) * self.cfg.cycle_ns


def fit_table(samples: Iterable[Tuple[float, float]], lane_width: int,
              unroll: int = 8) -> VecKernel:
    """Least-squares fit of (n_elems, cycles) samples to the paper's
    offset + 3-linear-curves model (the MoviSim-characterization stand-in)."""
    rows = []
    ys = []
    for n_elems, cycles in samples:
        vectors = int(n_elems // lane_width)
        scalars = n_elems - vectors * lane_width
        blocks = vectors // unroll
        rem_vectors = vectors - blocks * unroll
        rows.append([1.0, blocks, rem_vectors, scalars])
        ys.append(cycles)
    coef, *_ = np.linalg.lstsq(np.asarray(rows), np.asarray(ys), rcond=None)
    return VecKernel(offset=float(coef[0]), a=float(coef[1]),
                     b=float(coef[2]), c=float(coef[3]), unroll=unroll)
