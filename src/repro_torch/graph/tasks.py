"""Tasks, barrier scoreboard and the centralized scheduler (paper §3.3).

* The unit of scheduling is a **Task**: a computing task (a partial operator
  from tiling, or multiple fused operators) or a DMA task (one or more
  descriptors). Tasks are factory-extensible records targeting one engine.
* A **centralized scheduler** parses the workload into a task list and
  enqueues tasks into bounded per-engine FIFOs *when there is room*
  (backpressure). Engines process asynchronously; completions are tracked
  in separate watcher processes.
* **Barrier scoreboard**: logical barriers with semaphore counters inserted
  by the compiler; engines wait on consumer barriers before executing and
  signal producer barriers after, forming atomic producer-consumer
  relationships.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, Sequence, Tuple

from ..core import Environment, Event, Store, Tracer

__all__ = ["Task", "BarrierScoreboard", "Scheduler"]

_task_ids = itertools.count()


@dataclass
class Task:
    engine: str                 # e.g. "tile0.mxu", "dma", "ici"
    payload: Any                # GemmSpec | VecSpec | DmaDescriptor | ...
    waits: Tuple[Tuple[int, int], ...] = ()    # (barrier_id, required_count)
    signals: Tuple[int, ...] = ()
    name: str = ""
    tid: int = field(default_factory=lambda: next(_task_ids))


class BarrierScoreboard:
    """Semaphore-counter barriers with globally observable events."""

    def __init__(self, env: Environment):
        self.env = env
        self._count: Dict[int, int] = {}
        self._waiters: Dict[Tuple[int, int], Event] = {}

    def count(self, bid: int) -> int:
        return self._count.get(bid, 0)

    def signal(self, bid: int, n: int = 1) -> None:
        c = self._count.get(bid, 0) + n
        self._count[bid] = c
        for (wb, need), ev in list(self._waiters.items()):
            if wb == bid and c >= need and not ev.triggered:
                ev.succeed(c)
                del self._waiters[(wb, need)]

    def wait(self, bid: int, need: int = 1) -> Event:
        ev = self.env.event()
        if self._count.get(bid, 0) >= need:
            ev.succeed(self._count[bid])
            return ev
        key = (bid, need)
        # coalesce identical waits onto one event via chaining
        if key in self._waiters:
            base = self._waiters[key]
            base.callbacks.append(lambda e: ev.succeed(e._value))
            return ev
        self._waiters[key] = ev
        return ev


class Scheduler:
    """Centralized scheduler: task list -> per-engine FIFOs + completion
    tracking. ``run`` returns the completion event for the whole list."""

    def __init__(self, env: Environment, tracer: Tracer,
                 fifos: Dict[str, Store], scoreboard: BarrierScoreboard):
        self.env = env
        self.tracer = tracer
        self.fifos = fifos
        self.scoreboard = scoreboard
        self.n_done = 0
        self.n_total = 0

    def run(self, tasks: Sequence[Task]) -> Event:
        done = self.env.event()
        self.n_total += len(tasks)
        state = {"left": len(tasks)}
        if not tasks:
            done.succeed()
            return done

        def feeder():
            for t in tasks:
                if t.engine not in self.fifos:
                    raise KeyError(
                        f"task {t.name or t.tid} targets unknown engine "
                        f"{t.engine!r}; have {sorted(self.fifos)}")
                t._enqueue_time = self.env.now
                yield self.fifos[t.engine].put(t)   # blocks when FIFO full

        def watcher(t: Task):
            yield t._done_event
            self.n_done += 1
            state["left"] -= 1
            if state["left"] == 0:
                done.succeed()

        for t in tasks:
            t._done_event = self.env.event()
            self.env.process(watcher(t), name=f"watch.{t.tid}")
        self.env.process(feeder(), name="scheduler.feeder")
        return done
