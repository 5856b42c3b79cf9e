"""Interconnect models: intra-pod ICI (the NOC analog) and cross-pod DCN.

Paper §3.2 "Interconnect": parameterized NOC with slave/master ports, a
router forwarding unicast/multicast with configurable arbitration, latency
and BW. TPU adaptation: the same router model carries point-to-point
traffic between tiles (multi-tile CNN mode), and collectives are scheduled
on the torus **links** as ring phases (reduce-scatter / all-gather), so
concurrent collectives contend for link Resources and the contention shows
up in the timeline.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Generator

from ..core import Environment, PriorityItem, PriorityStore, Resource, Tracer
from .presets import HwConfig

__all__ = ["Router", "IciFabric", "CollectiveSpec"]


@dataclass(frozen=True)
class CollectiveSpec:
    """One collective task (per-device view)."""

    op: str              # all-reduce | all-gather | reduce-scatter |
    #                      all-to-all | collective-permute
    payload_bytes: float  # per-device payload (post-GSPMD shard bytes)
    group_size: int
    cross_pod: bool = False
    name: str = ""

    def link_bytes(self) -> float:
        """Ring-schedule bytes crossing each device's link."""
        n = max(self.group_size, 1)
        if n == 1:
            return 0.0
        if self.op.startswith("all-reduce"):
            return self.payload_bytes * 2 * (n - 1) / n
        if self.op.startswith("collective-permute"):
            return self.payload_bytes
        return self.payload_bytes * (n - 1) / n

    def phases(self) -> int:
        n = max(self.group_size, 1)
        if n == 1:
            return 0
        if self.op.startswith("all-reduce"):
            return 2 * (n - 1)
        if self.op.startswith("collective-permute"):
            return 1
        return n - 1


class Router:
    """Paper-faithful NOC router: N input (slave) ports feed a centralized
    router process that forwards packets to output (master) port queues
    with round-robin or priority arbitration."""

    def __init__(self, env: Environment, cfg: HwConfig, tracer: Tracer,
                 n_ports: int, name: str = "noc"):
        self.env = env
        self.cfg = cfg
        self.tracer = tracer
        self.name = name
        self.n_ports = n_ports
        self.in_q = PriorityStore(env, capacity=64, name=name + ".in")
        self.out_q = [PriorityStore(env, capacity=64, name=f"{name}.out{i}")
                      for i in range(n_ports)]
        self._proc = env.process(self._route(), name=name + ".router")
        self._bytes_per_ns = cfg.ici_link_gbps

    def send(self, src: int, dst: int, nbytes: float, priority: float = 1.0):
        """Enqueue a packet; returns the completion event."""
        done = self.env.event()
        item = PriorityItem(priority, (src, dst, nbytes, done))
        return self.in_q.put(item), done

    def _route(self) -> Generator:
        while True:
            item = yield self.in_q.get()
            src, dst, nbytes, done = item.item
            # forwarding: header latency + serialization on the output port
            yield self.env.timeout(self.cfg.ici_latency_ns * 0.1)
            q = self.out_q[dst % self.n_ports]
            yield q.put(PriorityItem(item.priority, (nbytes, done)))
            if not getattr(q, "_drainer", None):
                q._drainer = self.env.process(
                    self._drain(dst % self.n_ports),
                    name=f"{self.name}.drain{dst % self.n_ports}")

    def _drain(self, port: int) -> Generator:
        q = self.out_q[port]
        while True:
            if q.level == 0:
                q._drainer = None
                return
            item = yield q.get()
            nbytes, done = item.item
            t0 = self.env.now
            yield self.env.timeout(nbytes / self._bytes_per_ns)
            self.tracer.emit(f"{self.name}.port{port}", "bytes", t0,
                             self.env.now, nbytes)
            done.succeed()


class IciFabric:
    """Per-chip link set + collective scheduling. One ``IciFabric`` models
    the SPMD-symmetric view: every chip executes the same phases, so one
    fabric instance paces the pod (chips are interchangeable by symmetry).
    Cross-pod segments run at DCN bandwidth/latency."""

    def __init__(self, env: Environment, cfg: HwConfig, tracer: Tracer,
                 name: str = "ici"):
        self.env = env
        self.cfg = cfg
        self.tracer = tracer
        self.name = name
        self.links = Resource(env, cfg.ici_links, name=name + ".links")
        self.dcn = Resource(env, 1, name=name + ".dcn")
        self._link_bytes_per_ns = cfg.ici_link_gbps
        self._dcn_bytes_per_ns = cfg.dcn_gbps

    def run(self, spec: CollectiveSpec) -> Generator:
        """Execute a collective as ring phases over one link (a 2D-torus
        ring uses one link per direction; concurrent collectives contend)."""
        env, cfg = self.env, self.cfg
        phases = spec.phases()
        if phases == 0 or spec.payload_bytes <= 0:
            return
        per_phase = spec.payload_bytes / max(spec.group_size, 1)
        bw = self._dcn_bytes_per_ns if spec.cross_pod else \
            self._link_bytes_per_ns
        lat = cfg.dcn_latency_ns if spec.cross_pod else cfg.ici_latency_ns
        res = self.dcn if spec.cross_pod else self.links
        req = res.request()
        yield req
        t0 = env.now
        yield env.timeout(phases * (lat + per_phase / bw))
        res.release(req)
        self.tracer.emit(self.name + (".dcn" if spec.cross_pod else ""),
                         "bytes", t0, env.now, spec.link_bytes())

    def ideal_time_ns(self, spec: CollectiveSpec) -> float:
        phases = spec.phases()
        if phases == 0:
            return 0.0
        per_phase = spec.payload_bytes / max(spec.group_size, 1)
        bw = self._dcn_bytes_per_ns if spec.cross_pod else \
            self._link_bytes_per_ns
        lat = self.cfg.dcn_latency_ns if spec.cross_pod else \
            self.cfg.ici_latency_ns
        return phases * (lat + per_phase / bw)
