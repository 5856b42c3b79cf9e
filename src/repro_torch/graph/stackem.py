"""Stack-EM mode (the paper's §6.2 future work, implemented).

"the addition of Stack-EM mode to analyze the performance impacts of
different layers of the software stack with multi-context use case based
scheduling pipeline"

A **context** is one inference stream (its own workload + submission
period + priority). Stack-EM submits several contexts to ONE System and
models the software-stack layers above the hardware scheduler:

  * per-context submission queues with arrival periods (use-case rate)
  * a stack-dispatch process that interleaves contexts into the hardware
    task FIFOs by priority (preemption boundary = task, as on real NPUs)
  * per-request end-to-end latency accounting (queueing + hardware), so
    stack-level effects — head-of-line blocking, priority inversion,
    context switch overhead — are visible separately from hardware time.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Sequence

from ..hw.chip import System
from ..hw.presets import HwConfig
from .tasks import Task

__all__ = ["StackContext", "StackReport", "run_stack"]

_ids = itertools.count()


@dataclass
class StackContext:
    name: str
    tasks: List[Task]                 # one inference's task list (template)
    period_ns: float                  # submission period (use-case rate)
    n_requests: int = 4
    priority: int = 1                 # lower = more important
    dispatch_overhead_ns: float = 2_000.0   # driver/runtime cost / request


@dataclass
class StackReport:
    latencies_ns: Dict[str, List[float]]
    hw_busy_ns: float
    makespan_ns: float

    def avg_latency_ms(self, ctx: str) -> float:
        ls = self.latencies_ns[ctx]
        return sum(ls) / len(ls) / 1e6 if ls else 0.0

    def p_worst_ms(self, ctx: str) -> float:
        return max(self.latencies_ns[ctx], default=0.0) / 1e6


def _clone_tasks(tasks: Sequence[Task], tag: str) -> List[Task]:
    """Re-instance a task-list template with fresh barrier ids."""
    mapping: Dict[int, int] = {}

    def remap(bid: int) -> int:
        if bid not in mapping:
            mapping[bid] = 1_000_000 + next(_ids)
        return mapping[bid]

    out = []
    for t in tasks:
        out.append(Task(
            engine=t.engine, payload=t.payload,
            waits=tuple((remap(b), n) for b, n in t.waits),
            signals=tuple(remap(b) for b in t.signals),
            name=f"{tag}.{t.name}"))
    return out


def run_stack(contexts: Sequence[StackContext], cfg: HwConfig, *,
              n_tiles: int = 1) -> StackReport:
    sysm = System(cfg, n_tiles=n_tiles)
    env = sysm.env
    latencies: Dict[str, List[float]] = {c.name: [] for c in contexts}

    def context_proc(ctx: StackContext):
        for r in range(ctx.n_requests):
            # arrival
            target = r * ctx.period_ns
            if env.now < target:
                yield env.timeout(target - env.now)
            t_submit = env.now
            yield env.timeout(ctx.dispatch_overhead_ns)  # stack layers
            tasks = _clone_tasks(ctx.tasks, f"{ctx.name}.r{r}")
            done = sysm.scheduler.run(tasks)
            yield done
            latencies[ctx.name].append(env.now - t_submit)

    # priority ordering: start high-priority contexts first (the shared
    # FIFO depth then arbitrates naturally; finer-grained preemption would
    # need per-engine priority queues — recorded as a limitation)
    for ctx in sorted(contexts, key=lambda c: c.priority):
        env.process(context_proc(ctx), name=f"stack.{ctx.name}")
    env.run()
    busy = sum(sysm.tracer.busy_time(m) for m in sysm.tracer.modules()
               if m.endswith(".mxu"))
    return StackReport(latencies_ns=latencies, hw_busy_ns=busy,
                       makespan_ns=sysm.tracer.makespan())
