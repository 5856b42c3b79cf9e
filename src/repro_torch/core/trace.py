"""Activity tracing — the data spine between performance and power models.

Every hardware model emits ``ActivitySample`` records into a shared
``Tracer`` while it processes events. The same records serve three consumers
(paper §3.3/§5.1):

  1. performance reports (per-engine busy time, utilization, timelines),
  2. Power-EM PTI (power-trace-interval) activity aggregation,
  3. test assertions (determinism, pipelining overlap).

Samples are intervals, not instants: ``(module, kind, t0, t1, amount)``.
``amount`` is in the module's native activity unit (bytes for DMA/NOC/memory,
ops for MXU/vector unit — exactly the paper's Table 2).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = ["ActivitySample", "Tracer", "TaskRecord", "SampleArrays"]


@dataclass(frozen=True, slots=True)
class ActivitySample:
    module: str       # hierarchical name, e.g. "pod0.chip3.mxu0"
    kind: str         # "ops" | "bytes" | "busy"
    t0: float         # ns
    t1: float         # ns
    amount: float     # native units over [t0, t1]

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


@dataclass(frozen=True, slots=True)
class TaskRecord:
    """Task-level event record (scheduler view)."""

    task: str
    engine: str
    t_enqueue: float
    t_start: float
    t_end: float
    meta: Tuple[Tuple[str, object], ...] = ()
    tid: int = -1     # graph.tasks.Task.tid, for array alignment


@dataclass
class SampleArrays:
    """Column-major view of an activity-sample stream.

    The array twin of ``Tracer.samples``: one row per sample, module
    names interned to ids, row order preserved (PTI binning accumulates
    in row order, so loop- and array-based consumers agree bitwise).
    Produced by ``Tracer.sample_arrays`` after an event simulation, or
    synthesized directly by ``core.fastsim`` when it extrapolates a
    steady state instead of replaying it.
    """

    modules: List[str]          # id -> module name
    kinds: List[str]            # id -> kind name
    module_id: np.ndarray       # [M] int32
    kind_id: np.ndarray         # [M] int32
    t0: np.ndarray              # [M] float64
    t1: np.ndarray              # [M] float64
    amount: np.ndarray          # [M] float64

    def __len__(self) -> int:
        return int(self.module_id.shape[0])

    def makespan(self) -> float:
        return float(self.t1.max()) if len(self) else 0.0

    def module_ids_with_prefix(self, prefix: str) -> List[int]:
        return [i for i, m in enumerate(self.modules)
                if m.startswith(prefix)]


@dataclass
class Tracer:
    enabled: bool = True
    samples: List[ActivitySample] = field(default_factory=list)
    tasks: List[TaskRecord] = field(default_factory=list)

    # -- emission ------------------------------------------------------------
    def emit(self, module: str, kind: str, t0: float, t1: float, amount: float) -> None:
        if self.enabled:
            if t1 < t0:
                raise ValueError(f"sample ends before it starts: {t0}..{t1}")
            self.samples.append(ActivitySample(module, kind, t0, t1, amount))

    def emit_task(self, rec: TaskRecord) -> None:
        if self.enabled:
            self.tasks.append(rec)

    # -- queries ---------------------------------------------------------------
    def modules(self) -> List[str]:
        return sorted({s.module for s in self.samples})

    def by_module(self, module: str, kind: Optional[str] = None) -> List[ActivitySample]:
        return [
            s
            for s in self.samples
            if s.module == module and (kind is None or s.kind == kind)
        ]

    def busy_time(self, module: str) -> float:
        """Union length of the module's busy intervals (overlap-safe)."""
        ivals = sorted((s.t0, s.t1) for s in self.samples if s.module == module)
        total, cur0, cur1 = 0.0, None, None
        for t0, t1 in ivals:
            if cur1 is None or t0 > cur1:
                if cur1 is not None:
                    total += cur1 - cur0
                cur0, cur1 = t0, t1
            else:
                cur1 = max(cur1, t1)
        if cur1 is not None:
            total += cur1 - cur0
        return total

    def total_amount(self, module: str, kind: str) -> float:
        return sum(s.amount for s in self.samples if s.module == module and s.kind == kind)

    def makespan(self) -> float:
        return max((s.t1 for s in self.samples), default=0.0)

    # -- PTI binning (Power-EM §5.1) ------------------------------------------
    def pti_activity(
        self,
        module_prefix: str,
        kind: str,
        pti: float,
        t_end: Optional[float] = None,
    ) -> List[float]:
        """Per-interval activity amounts for modules under ``module_prefix``.

        A sample spanning several intervals contributes pro-rata (its rate is
        assumed uniform over [t0, t1]) — this is how Power-EM captures
        activity *temporally* as well as spatially.
        """
        if pti <= 0:
            raise ValueError("pti must be > 0")
        horizon = t_end if t_end is not None else self.makespan()
        n = max(1, math.ceil(horizon / pti)) if horizon > 0 else 1
        bins = [0.0] * n
        for s in self.samples:
            if not s.module.startswith(module_prefix) or s.kind != kind:
                continue
            if s.duration == 0:
                idx = min(int(s.t0 / pti), n - 1)
                bins[idx] += s.amount
                continue
            rate = s.amount / s.duration
            b0 = int(s.t0 / pti)
            b1 = min(int(math.ceil(s.t1 / pti)), n)
            for b in range(b0, b1):
                lo = max(s.t0, b * pti)
                hi = min(s.t1, (b + 1) * pti)
                if hi > lo:
                    bins[b] += rate * (hi - lo)
        return bins

    def clear(self) -> None:
        self.samples.clear()
        self.tasks.clear()

    # -- array export (core.fastsim / vectorized Power-EM) --------------------
    def sample_arrays(self) -> "SampleArrays":
        """Lower the sample list to ``SampleArrays`` (row order kept)."""
        mod_ids: Dict[str, int] = {}
        kind_ids: Dict[str, int] = {}
        n = len(self.samples)
        mid = np.empty(n, np.int32)
        kid = np.empty(n, np.int32)
        t0 = np.empty(n, np.float64)
        t1 = np.empty(n, np.float64)
        amt = np.empty(n, np.float64)
        for i, s in enumerate(self.samples):
            mid[i] = mod_ids.setdefault(s.module, len(mod_ids))
            kid[i] = kind_ids.setdefault(s.kind, len(kind_ids))
            t0[i] = s.t0
            t1[i] = s.t1
            amt[i] = s.amount
        return SampleArrays(modules=list(mod_ids), kinds=list(kind_ids),
                            module_id=mid, kind_id=kid, t0=t0, t1=t1,
                            amount=amt)

    def task_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
        """``(tid, t_enqueue, t_start, t_end)`` arrays in record order."""
        n = len(self.tasks)
        tid = np.empty(n, np.int64)
        enq = np.empty(n, np.float64)
        st = np.empty(n, np.float64)
        en = np.empty(n, np.float64)
        for i, r in enumerate(self.tasks):
            tid[i], enq[i], st[i], en[i] = r.tid, r.t_enqueue, r.t_start, \
                r.t_end
        return tid, enq, st, en


def pti_bins(sa: SampleArrays, module_ids: Iterable[int], kind: str,
             pti: float, t_end: Optional[float] = None) -> np.ndarray:
    """Array twin of ``Tracer.pti_activity`` — bitwise-identical bins.

    Every sample expands to its covered bins via ``np.repeat`` (so
    contributions accumulate in sample order, exactly like the Python
    loop) and lands with one ``np.add.at``. The per-contribution
    arithmetic replicates the loop's expressions operation for
    operation, which is what lets the vectorized Power-EM produce
    byte-identical records.
    """
    if pti <= 0:
        raise ValueError("pti must be > 0")
    horizon = t_end if t_end is not None else sa.makespan()
    n = max(1, math.ceil(horizon / pti)) if horizon > 0 else 1
    bins = np.zeros(n, np.float64)
    ids = list(module_ids)
    if not ids or kind not in sa.kinds:
        return bins
    sel = np.isin(sa.module_id, np.asarray(ids, np.int32)) & \
        (sa.kind_id == sa.kinds.index(kind))
    if not sel.any():
        return bins
    t0, t1, amt = sa.t0[sel], sa.t1[sel], sa.amount[sel]
    dur = t1 - t0
    zero = dur == 0.0
    # int(x / pti) truncates the IEEE quotient — replicate exactly
    b0 = (t0 / pti).astype(np.int64)
    b1 = np.minimum(np.ceil(t1 / pti).astype(np.int64), n)
    # zero-duration samples land whole in one clamped bin
    b0 = np.where(zero, np.minimum(b0, n - 1), b0)
    nb = np.where(zero, 1, np.maximum(b1 - b0, 0))
    total = int(nb.sum())
    if total == 0:
        return bins
    row = np.repeat(np.arange(len(nb)), nb)
    k = np.arange(total) - np.repeat(np.cumsum(nb) - nb, nb)
    b = b0[row] + k
    rate = np.where(zero, 0.0, amt / np.where(zero, 1.0, dur))
    lo = np.maximum(t0[row], b * pti)
    hi = np.minimum(t1[row], (b + 1) * pti)
    contrib = np.where(zero[row], amt[row],
                       np.where(hi > lo, rate[row] * (hi - lo), 0.0))
    np.add.at(bins, b, contrib)
    return bins


def to_chrome_trace(tracer: "Tracer") -> dict:
    """Export the activity + task timeline as a Chrome/Perfetto trace
    (chrome://tracing 'traceEvents' JSON). Engines become pids/tids;
    task-level records and sub-task activity samples become complete
    events — load the file in Perfetto to see the paper's Fig-8-style
    pipeline/concurrency picture interactively."""
    events = []
    pids = {}

    def pid_of(module: str) -> int:
        root = module.split(".")[0]
        if root not in pids:
            pids[root] = len(pids) + 1
            events.append({"ph": "M", "pid": pids[root], "name":
                           "process_name", "args": {"name": root}})
        return pids[root]

    for rec in tracer.tasks:
        events.append({
            "ph": "X", "name": rec.task, "cat": "task",
            "pid": pid_of(rec.engine), "tid": rec.engine,
            "ts": rec.t_start / 1e3,              # us
            "dur": max(rec.t_end - rec.t_start, 1e-3) / 1e3,
            "args": {"queued_us": (rec.t_start - rec.t_enqueue) / 1e3},
        })
    for s in tracer.samples:
        events.append({
            "ph": "X", "name": f"{s.kind}={s.amount:.3g}", "cat": "activity",
            "pid": pid_of(s.module), "tid": s.module,
            "ts": s.t0 / 1e3, "dur": max(s.duration, 1e-3) / 1e3,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
