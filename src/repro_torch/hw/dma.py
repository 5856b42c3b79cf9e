"""Tensor-aware multi-channel DMA model (paper §3.2 "DMA").

A ``DmaDescriptor`` describes a (possibly strided) tensor transfer between
HBM and VMEM (or HBM->HBM, VMEM->VMEM). The engine splits a descriptor into
pipelined transfer requests (max ``dma_max_request_bytes``), issues them on
one of ``dma_channels`` channels, and aggregates latency/BW per request —
"models how a DMA descriptor is split into pipelined data transfer
requests ... projects latency and BW data ... aggregated to provide the
final result of a DMA task".

Inline processing is retained from the paper: optional compression
(HBM bytes scaled by the compression ratio + per-KB decompress latency)
and broadcast (one HBM read fanned out to N tile VMEMs).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Generator, List, Optional, Sequence, Tuple

from ..core import Environment, Resource, Tracer
from .memory import Hbm, VMem
from .presets import HwConfig

__all__ = ["DmaDescriptor", "Dma"]


@dataclass(frozen=True)
class DmaDescriptor:
    nbytes: float
    src: str = "hbm"                 # hbm | vmem
    dst: str = "vmem"
    addr: int = 0                    # linear base address (hbm side)
    contiguous_run: int = 0          # bytes per contiguous row (0 = all)
    compressed: bool = False
    broadcast: int = 1               # fan-out count (multi-tile weights)
    name: str = ""


class Dma:
    def __init__(self, env: Environment, cfg: HwConfig, hbm: Hbm,
                 vmem: VMem, tracer: Tracer, name: str = "dma",
                 peer_vmems: Optional[Sequence[VMem]] = None):
        self.env = env
        self.cfg = cfg
        self.hbm = hbm
        self.vmem = vmem
        self.tracer = tracer
        self.name = name
        self.peer_vmems = list(peer_vmems or [])
        self.channels = Resource(env, cfg.dma_channels, name=name + ".ch")

    def _requests(self, d: DmaDescriptor) -> List[Tuple[int, float]]:
        """Split a descriptor into (addr, nbytes) pipelined requests."""
        run = d.contiguous_run or int(d.nbytes)
        run = min(run, self.cfg.dma_max_request_bytes)
        reqs = []
        left = d.nbytes
        addr = d.addr
        while left > 0:
            n = min(run, left)
            reqs.append((addr, n))
            addr += int(n)
            left -= n
        return reqs

    def run(self, d: DmaDescriptor) -> Generator:
        """Execute one DMA task; yields until all requests complete."""
        env, cfg = self.env, self.cfg
        reqs = self._requests(d)
        done = env.event()
        outstanding = len(reqs)
        t_start = env.now
        state = {"left": outstanding}

        def one(addr: int, nbytes: float):
            nonlocal_state = state
            ch = self.channels.request()
            yield ch
            yield env.timeout(cfg.dma_desc_overhead_ns)
            hbm_bytes = nbytes
            if d.compressed and cfg.dma_compression:
                hbm_bytes = nbytes * cfg.dma_compression_ratio
            # source side
            if d.src == "hbm":
                yield from self.hbm.access(addr, hbm_bytes)
            else:
                yield from self.vmem.transfer(nbytes)
            if d.compressed and cfg.dma_compression:
                yield env.timeout(cfg.dma_decomp_ns_per_kb * nbytes / 1024.0)
            # destination side (broadcast: one read, N writes)
            fanout = max(1, d.broadcast)
            targets = [self.vmem] + self.peer_vmems
            for i in range(fanout):
                tgt = targets[i % len(targets)] if d.dst == "vmem" else None
                if tgt is not None:
                    yield from tgt.transfer(nbytes)
                else:
                    yield from self.hbm.access(addr + (1 << 20), hbm_bytes,
                                               write=True)
            self.channels.release(ch)
            nonlocal_state["left"] -= 1
            self.tracer.emit(self.name, "bytes", t_start, env.now, nbytes)
            if nonlocal_state["left"] == 0:
                done.succeed()

        for addr, nbytes in reqs:
            env.process(one(addr, nbytes), name=f"{self.name}.req")
        yield done

    def ideal_time_ns(self, d: DmaDescriptor) -> float:
        hbm_bytes = d.nbytes
        if d.compressed and self.cfg.dma_compression:
            hbm_bytes *= self.cfg.dma_compression_ratio
        return (self.cfg.dma_desc_overhead_ns
                + self.hbm.stream_time_ns(hbm_bytes))
