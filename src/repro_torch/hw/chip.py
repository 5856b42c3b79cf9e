"""Chip/tile assembly — the paper's Figure 1 brought to TPU terms.

A **Tile** is one compute tile: MXU complex + vector unit sharing a local
VMEM (the CB analog). A **System** is the testbench: ``n_tiles`` tiles, a
shared HBM + tensor-aware DMA (with broadcast to tile VMEMs), an inter-tile
router, an ICI fabric for pod-level collectives, the barrier scoreboard and
the centralized scheduler. ``System.run_workload`` executes a task list and
returns the timeline report.

Engine processes implement the paper's task loop: pop task from FIFO ->
wait consumer barriers -> execute (sub-task pipeline inside the hw model)
-> signal producer barriers -> emit a task-level trace record.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Generator, Optional, Sequence

from ..core import Environment, Store, TaskRecord, Tracer
from ..graph.tasks import BarrierScoreboard, Scheduler, Task
from ..obs.metrics import REGISTRY
from .dma import Dma
from .ici import IciFabric, Router
from .memory import Hbm, VMem
from .mxu import Mxu
from .presets import HwConfig
from .vecunit import VecUnit

__all__ = ["Tile", "System", "simulate", "Report"]


class Tile:
    def __init__(self, env: Environment, cfg: HwConfig, tracer: Tracer,
                 name: str):
        self.name = name
        self.vmem = VMem(env, cfg, tracer, name=f"{name}.vmem")
        self.mxu = Mxu(env, cfg, self.vmem, tracer, name=f"{name}.mxu")
        self.vpu = VecUnit(env, cfg, self.vmem, tracer, name=f"{name}.vpu")


@dataclass
class Report:
    makespan_ns: float
    busy_ns: Dict[str, float]
    amounts: Dict[str, float]
    n_tasks: int
    row_hits: int = 0
    row_misses: int = 0

    def utilization(self, module: str) -> float:
        if self.makespan_ns <= 0:
            return 0.0
        return self.busy_ns.get(module, 0.0) / self.makespan_ns


class System:
    """One simulated NPU sub-system (n_tiles compute tiles)."""

    def __init__(self, cfg: HwConfig, *, n_tiles: int = 1,
                 tracer: Optional[Tracer] = None,
                 env: Optional[Environment] = None):
        self.cfg = cfg
        # kernel telemetry follows the global metrics switch: the stats
        # run-loop variant is only paid for when observability is on
        self.env = env or Environment(stats=REGISTRY.enabled)
        self.tracer = tracer or Tracer()
        self.scoreboard = BarrierScoreboard(self.env)
        self.tiles = [Tile(self.env, cfg, self.tracer, f"tile{i}")
                      for i in range(n_tiles)]
        self.hbm = Hbm(self.env, cfg, self.tracer)
        self.dma = Dma(self.env, cfg, self.hbm, self.tiles[0].vmem,
                       self.tracer,
                       peer_vmems=[t.vmem for t in self.tiles[1:]])
        self.router = Router(self.env, cfg, self.tracer,
                             n_ports=max(n_tiles, 2))
        self.ici = IciFabric(self.env, cfg, self.tracer)

        # engine task FIFOs (bounded: backpressure to the scheduler)
        q = cfg.queue_depth
        self.fifos: Dict[str, Store] = {}
        for t in self.tiles:
            self.fifos[f"{t.name}.mxu"] = Store(self.env, q)
            self.fifos[f"{t.name}.vpu"] = Store(self.env, q)
        self.fifos["dma"] = Store(self.env, q)
        self.fifos["ici"] = Store(self.env, q)
        self.scheduler = Scheduler(self.env, self.tracer, self.fifos,
                                   self.scoreboard)
        self._spawn_engines()

    # ------------------------------------------------------------------
    def _spawn_engines(self):
        for t in self.tiles:
            self.env.process(
                self._engine_loop(f"{t.name}.mxu", t.mxu.run),
                name=f"{t.name}.mxu.loop")
            self.env.process(
                self._engine_loop(f"{t.name}.vpu", t.vpu.run),
                name=f"{t.name}.vpu.loop")
        self.env.process(self._engine_loop("dma", self.dma.run),
                         name="dma.loop")
        self.env.process(self._engine_loop("ici", self.ici.run),
                         name="ici.loop")

    def _engine_loop(self, engine: str, run_fn) -> Generator:
        fifo = self.fifos[engine]
        while True:
            task: Task = yield fifo.get()
            for bid, need in task.waits:
                yield self.scoreboard.wait(bid, need)
            t_start = self.env.now
            yield from run_fn(task.payload)
            for bid in task.signals:
                self.scoreboard.signal(bid)
            self.tracer.emit_task(TaskRecord(
                task=task.name or str(task.tid), engine=engine,
                t_enqueue=getattr(task, "_enqueue_time", t_start),
                t_start=t_start, t_end=self.env.now, tid=task.tid))
            task._done_event.succeed()

    # ------------------------------------------------------------------
    def run_workload(self, tasks: Sequence[Task],
                     until: Optional[float] = None) -> Report:
        done = self.scheduler.run(tasks)
        self.env.run(until=done if until is None else until)
        self.emit_metrics()
        return self.report(n_tasks=len(tasks))

    def emit_metrics(self, registry=None) -> None:
        """Flush kernel + resource-contention telemetry into a metrics
        registry (the global one by default; no-op while disabled).

        Counters are pure functions of the simulated inputs — event
        counts, heap high-water mark, and per-resource-class stall
        counts (a *stall* is a ``Resource.request`` that could not be
        granted at issue time: VMEM-port, HBM-bank, DMA-channel, or
        ICI-link contention — exactly the effects the analytic
        relaxation cannot see)."""
        reg = registry if registry is not None else REGISTRY
        if not reg.enabled:
            return
        reg.counter("engine.events_processed").inc(
            self.env.events_processed)
        reg.counter("engine.events_scheduled").inc(self.env._eid)
        reg.gauge("engine.peak_heap_depth").set_max(self.env.peak_heap)
        reg.counter("engine.tasks_done").inc(self.scheduler.n_done)
        reg.counter("engine.runs").inc()
        groups = {
            "vmem_port": [t.vmem.ports for t in self.tiles],
            "hbm_bank": list(self.hbm.channels),
            "dma_channel": [self.dma.channels],
            "ici_link": [self.ici.links, self.ici.dcn],
        }
        for cls, resources in groups.items():
            reqs = sum(r.n_requests for r in resources)
            stalls = sum(r.n_stalls for r in resources)
            if reqs:
                reg.counter("engine.resource_requests",
                            resource=cls).inc(reqs)
            if stalls:
                reg.counter("engine.resource_stalls",
                            resource=cls).inc(stalls)

    def report(self, n_tasks: int = 0) -> Report:
        tr = self.tracer
        modules = tr.modules()
        return Report(
            makespan_ns=tr.makespan(),
            busy_ns={m: tr.busy_time(m) for m in modules},
            amounts={m + "/" + k: tr.total_amount(m, k)
                     for m in modules for k in ("ops", "bytes")
                     if tr.total_amount(m, k) > 0},
            n_tasks=n_tasks,
            row_hits=self.hbm.row_hits,
            row_misses=self.hbm.row_misses,
        )


def simulate(tasks: Sequence[Task], cfg: HwConfig, *, n_tiles: int = 1
             ) -> Report:
    """One-shot: build a System, run the task list, return the report."""
    sys = System(cfg, n_tiles=n_tiles)
    return sys.run_workload(tasks)
