"""MXU engine model — the DPU analog (paper §3.2, Figure 3).

Faithful structure, TPU-adapted constants:

  * 4-stage pipeline: **load -> MAC -> post-process -> store**, connected by
    depth-``pipeline_depth`` Stores (double buffering). Each stage is its
    own process, so load of block i+1 overlaps MAC of block i — the
    compute-bound vs memory-bound character emerges from the pipeline, not
    from a formula.
  * unit of processing = a **data block** (the paper's stencil-multiple
    sub-partition): a GEMM (M,N,K) is tiled into (bm,bn,bk) blocks chosen so
    the working set fits the VMEM block budget and dims align to the
    128-lane hardware. Utilization loss from ragged edges (bm<128 etc.) is
    exactly how "2K->4K MACs only +25-45%" reproduces.
  * post-processing stage executes fused ops (bias/activation/residual) at
    vector-unit rate, like the DPU's post-stage.
  * emits Table-2 activity: "ops" = issued MACs (ideal = rows*cols*n_mxu *
    busy-cycles), consumed by Power-EM utilization.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Generator, Tuple

from ..core import Environment, Store, Tracer
from .memory import VMem
from .presets import HwConfig

__all__ = ["GemmSpec", "Mxu", "choose_block"]


@dataclass(frozen=True)
class GemmSpec:
    """One MXU task: C[M,N] += A[M,K] @ B[K,N] (+ fused post ops)."""

    m: int
    n: int
    k: int
    a_bytes_per_elem: int = 2
    b_bytes_per_elem: int = 2
    out_bytes_per_elem: int = 2
    fused_post_elems: float = 0.0   # elementwise ops fused after the GEMM
    name: str = ""

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.n * self.k


def _align(x: int, a: int) -> int:
    return max(a, -(-x // a) * a)


def choose_block(spec: GemmSpec, cfg: HwConfig) -> Tuple[int, int, int]:
    """Stencil selection: largest (bm,bn,bk), multiples of the PE geometry,
    whose A+B+C working set fits the VMEM block budget."""
    budget = cfg.vmem_block_budget
    bm = min(_align(spec.m, cfg.mxu_rows), 8 * cfg.mxu_rows)
    bn = min(_align(spec.n, cfg.mxu_cols), 8 * cfg.mxu_cols)
    bk = min(_align(spec.k, 128), 16 * 128)

    def ws(bm, bn, bk):
        return (bm * bk * spec.a_bytes_per_elem
                + bk * bn * spec.b_bytes_per_elem
                + bm * bn * 4)  # accumulator f32

    # shrink the largest dim until the working set fits
    while ws(bm, bn, bk) > budget:
        if bk >= bm and bk >= bn and bk > 128:
            bk = max(128, bk // 2)
        elif bm >= bn and bm > cfg.mxu_rows:
            bm = max(cfg.mxu_rows, bm // 2)
        elif bn > cfg.mxu_cols:
            bn = max(cfg.mxu_cols, bn // 2)
        else:
            break
    return bm, bn, bk


class Mxu:
    """One chip's MXU complex (all ``n_mxu`` arrays operate as a unit on a
    block, matching XLA's single-kernel dispatch)."""

    def __init__(self, env: Environment, cfg: HwConfig, vmem: VMem,
                 tracer: Tracer, name: str = "mxu"):
        self.env = env
        self.cfg = cfg
        self.vmem = vmem
        self.tracer = tracer
        self.name = name

    # -- per-block stage costs ---------------------------------------------
    def _mac_cycles(self, bm: int, bn: int, bk: int) -> float:
        cfg = self.cfg
        # systolic: rows x cols MACs per array per cycle; ragged edges
        # waste lanes (ceil to hardware geometry)
        eff_m = -(-bm // cfg.mxu_rows) * cfg.mxu_rows
        eff_n = -(-bn // cfg.mxu_cols) * cfg.mxu_cols
        cycles = (eff_m * eff_n * bk) / (cfg.macs)
        if not cfg.mxu_fill_overlap:
            cycles += cfg.mxu_rows + bn  # array fill + drain
        return cycles

    def run(self, spec: GemmSpec) -> Generator:
        """Execute one GEMM through the 4-stage pipeline. Yields until done."""
        env, cfg = self.env, self.cfg
        bm, bn, bk = choose_block(spec, cfg)
        n_blocks_m = -(-spec.m // bm)
        n_blocks_n = -(-spec.n // bn)
        n_blocks_k = -(-spec.k // bk)
        total_blocks = n_blocks_m * n_blocks_n * n_blocks_k

        q_load = Store(env, capacity=cfg.pipeline_depth)
        q_mac = Store(env, capacity=cfg.pipeline_depth)
        q_post = Store(env, capacity=cfg.pipeline_depth)
        done = env.event()

        def gen_blocks():
            for im in range(n_blocks_m):
                m = min(bm, spec.m - im * bm)
                for i_n in range(n_blocks_n):
                    n = min(bn, spec.n - i_n * bn)
                    for ik in range(n_blocks_k):
                        k = min(bk, spec.k - ik * bk)
                        yield (m, n, k, ik == n_blocks_k - 1)

        def load_proc():
            for blk in gen_blocks():
                m, n, k, last_k = blk
                nbytes = (m * k * spec.a_bytes_per_elem
                          + k * n * spec.b_bytes_per_elem)
                yield from self.vmem.transfer(nbytes)
                yield q_load.put(blk)

        def mac_proc():
            for _ in range(total_blocks):
                blk = yield q_load.get()
                m, n, k, last_k = blk
                cycles = self._mac_cycles(m, n, k)
                t0 = env.now
                yield env.timeout(cycles * cfg.cycle_ns)
                # Table-2 activity: processed MACs (vs ideal macs*cycles)
                self.tracer.emit(self.name, "ops", t0, env.now,
                                 m * n * k)
                if last_k:
                    yield q_mac.put((m, n))

        def post_proc():
            out_blocks = n_blocks_m * n_blocks_n
            per_block_fused = (spec.fused_post_elems / max(out_blocks, 1))
            for _ in range(out_blocks):
                m, n = yield q_mac.get()
                if per_block_fused > 0:
                    cycles = per_block_fused / self.cfg.vpu_flops_per_cycle
                    t0 = env.now
                    yield env.timeout(cycles * cfg.cycle_ns)
                    self.tracer.emit(self.name + ".post", "ops", t0, env.now,
                                     per_block_fused)
                yield q_post.put((m, n))

        def store_proc():
            out_blocks = n_blocks_m * n_blocks_n
            for i in range(out_blocks):
                m, n = yield q_post.get()
                yield from self.vmem.transfer(m * n * spec.out_bytes_per_elem)
            done.succeed()

        env.process(load_proc(), name=f"{self.name}.load")
        env.process(mac_proc(), name=f"{self.name}.mac")
        env.process(post_proc(), name=f"{self.name}.post")
        env.process(store_proc(), name=f"{self.name}.store")
        yield done

    # -- analytic reference (used by tests / the vectorized engine) -------
    def ideal_time_ns(self, spec: GemmSpec) -> float:
        bm, bn, bk = choose_block(spec, self.cfg)
        n_m, n_n, n_k = -(-spec.m // bm), -(-spec.n // bn), -(-spec.k // bk)
        mac = 0.0
        for im in range(n_m):
            m = min(bm, spec.m - im * bm)
            for i_n in range(n_n):
                n = min(bn, spec.n - i_n * bn)
                for ik in range(n_k):
                    k = min(bk, spec.k - ik * bk)
                    mac += self._mac_cycles(m, n, k)
        return mac * self.cfg.cycle_ns
