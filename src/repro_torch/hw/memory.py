"""Memory models: VMEM (compute-buffer analog) and HBM (DDR analog).

VMEM — multi-port high-BW local RAM (paper §3.2 "Compute Buffer Memory"):
capacity is a Container (allocation/residency), bandwidth is N port
Resources each moving ``port_bytes_per_cycle``; MXU/VPU load-store stages,
the DMA and ICI all contend for ports, which is how CB pressure shows up
in the timeline exactly as the paper describes.

HBM — same base-class memory model re-parameterized from DDR to HBM2e
(paper §3.2 "DDR Memory"): linear addresses translate to
(channel, bank, row) with channel interleaving; per-access latency follows
the open/closed page policy against per-(channel,bank) open-row state;
bandwidth is per-channel. The paper's DDR timing/bank/page machinery is
retained, only the constants changed (recorded in DESIGN.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Generator, Tuple

from ..core import Container, Environment, Resource, Tracer
from .presets import HwConfig

__all__ = ["VMem", "Hbm"]


class VMem:
    """Multi-port local RAM. ``transfer`` seizes one port for the duration
    bytes/port_bw; ``alloc``/``free`` manage capacity residency."""

    def __init__(self, env: Environment, cfg: HwConfig, tracer: Tracer,
                 name: str = "vmem"):
        self.env = env
        self.cfg = cfg
        self.tracer = tracer
        self.name = name
        self.capacity = Container(env, capacity=cfg.vmem_bytes,
                                  init=cfg.vmem_bytes, name=name + ".cap")
        self.ports = Resource(env, capacity=cfg.vmem_ports,
                              name=name + ".ports")
        self._port_bytes_per_ns = (cfg.vmem_port_bytes_per_cycle
                                   * cfg.clock_ghz)

    def alloc(self, nbytes: float):
        """Blocks until nbytes of VMEM are free (compiler-planned residency)."""
        return self.capacity.get(nbytes)

    def free(self, nbytes: float):
        return self.capacity.put(nbytes)

    def transfer(self, nbytes: float, priority: float = 0.0) -> Generator:
        """Process helper: move nbytes through one port."""
        req = self.ports.request(priority)
        yield req
        t0 = self.env.now
        dur = nbytes / self._port_bytes_per_ns
        yield self.env.timeout(dur)
        self.ports.release(req)
        self.tracer.emit(self.name, "bytes", t0, self.env.now, nbytes)

    @property
    def level(self) -> float:
        return self.capacity.level


@dataclass(slots=True)
class _BankState:
    open_row: int = -1


class Hbm:
    """Banked, paged, channel-interleaved memory with open/closed page
    policy. Addresses are synthetic linear offsets assigned by the
    compiler's tensor allocator."""

    def __init__(self, env: Environment, cfg: HwConfig, tracer: Tracer,
                 name: str = "hbm"):
        self.env = env
        self.cfg = cfg
        self.tracer = tracer
        self.name = name
        self.channels = [Resource(env, 1, name=f"{name}.ch{i}")
                         for i in range(cfg.hbm_channels)]
        self._banks: Dict[Tuple[int, int], _BankState] = {}
        self._ch_bytes_per_ns = cfg.hbm_gbps / cfg.hbm_channels
        self._rr = 0
        self.row_hits = 0
        self.row_misses = 0

    def _translate(self, addr: int) -> Tuple[int, int, int]:
        """linear addr -> (channel, bank, row): bursts interleave across
        channels; rows are page-sized within a (channel, bank)."""
        cfg = self.cfg
        burst_idx = addr // cfg.hbm_burst_bytes
        ch = burst_idx % cfg.hbm_channels
        within = burst_idx // cfg.hbm_channels * cfg.hbm_burst_bytes
        row_global = within // cfg.hbm_page_bytes
        bank = row_global % cfg.hbm_banks
        row = row_global // cfg.hbm_banks
        return ch, bank, row

    def access(self, addr: int, nbytes: float, *, write: bool = False
               ) -> Generator:
        """One contiguous access: split across channels, page-policy latency
        on the first burst per channel, then streaming at channel BW."""
        cfg = self.cfg
        n_ch = min(cfg.hbm_channels,
                   max(1, int(nbytes // cfg.hbm_burst_bytes) or 1))
        per_ch = nbytes / n_ch
        _, bank, row = self._translate(int(addr))
        t0 = self.env.now
        # a long access interleaves its bursts over ALL channels; the
        # pacing-channel abstraction rotates so concurrent streams share
        # aggregate bandwidth instead of false-serializing on channel 0
        ch0 = self._rr
        self._rr = (self._rr + 1) % cfg.hbm_channels
        chan = self.channels[ch0]
        req = chan.request()
        yield req
        st = self._banks.setdefault((ch0, bank), _BankState())
        if cfg.hbm_page_policy == "open" and st.open_row == row:
            lat = cfg.hbm_t_hit_ns
            self.row_hits += 1
        else:
            lat = cfg.hbm_t_miss_ns
            self.row_misses += 1
        st.open_row = row if cfg.hbm_page_policy == "open" else -1
        dur = lat + per_ch / self._ch_bytes_per_ns
        yield self.env.timeout(dur)
        chan.release(req)
        self.tracer.emit(self.name, "bytes", t0, self.env.now, nbytes)

    def stream_time_ns(self, nbytes: float) -> float:
        """Analytic lower bound (all channels, no page misses)."""
        return nbytes / self.cfg.hbm_gbps
