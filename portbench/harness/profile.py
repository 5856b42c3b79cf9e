"""The traced stretch: ``torch.profiler`` (CPU and CUDA activity) around a
few steady units of work, read back from its Chrome trace.

What it yields (``Trace``): every device interval (kernels, copies, fills)
with its name, start and length; the host's operations per thread; the
union of the device intervals (busy seconds); the stretch's wall seconds
and units of work; the top device operations by time and the idle gaps,
each labelled by the innermost host operation running at its middle.
The profiler starts before the window and stops after the profiled units;
its trace is exported (to the temporary directory, deleted once read) and
read after the window has closed.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

__all__ = ["Stretch", "Trace", "union_seconds"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (any unit)."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class Trace:
    def __init__(self, events: List[dict], wall_s: float, units: int):
        self.wall_s = wall_s
        self.units = units
        self.device = [(e["name"], e["ts"], e["dur"], e["cat"]) for e in events
                       if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
        self.host = [e for e in events if e.get("ph") == "X" and e.get("cat") in _HOST_CATS]
        iv = [(ts, ts + dur) for _, ts, dur, _ in self.device]
        self.busy_s = union_seconds(iv) * 1e-6

    def kernel_seconds(self, patterns) -> float:
        """Device seconds of the kernels whose name holds one of ``patterns``."""
        return sum(dur for name, _, dur, cat in self.device
                   if cat == "kernel" and any(p in name for p in patterns)) * 1e-6

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for name, _, dur, _ in self.device:
            by[name[:160]] += dur * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle seconds between device intervals, summed by the innermost
        host operation running at each gap's middle."""
        merged: List[List[float]] = []
        for s, e in sorted((ts, ts + dur) for _, ts, dur, _ in self.device):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)
                if merged[i + 1][0] > merged[i][1]]
        mids = [(a + b) / 2 for a, b in gaps]
        labels = self._innermost(mids)
        by: Dict[str, float] = defaultdict(float)
        for (a, b), lab in zip(gaps, labels):
            by[lab] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def _innermost(self, mids: List[float]) -> List[str]:
        """Per time point, the host event of latest start that contains it
        (host events nest within a thread)."""
        order = sorted(range(len(mids)), key=lambda i: mids[i])
        best: List[Optional[Tuple[float, str]]] = [None] * len(mids)
        threads = defaultdict(list)
        for e in self.host:
            threads[(e.get("pid"), e.get("tid"))].append((e["ts"], e["ts"] + e["dur"],
                                                            e["name"]))
        for evs in threads.values():
            evs.sort()
            starts = [s for s, _, _ in evs]
            stack: List[Tuple[float, float, str]] = []
            j = 0
            for i in order:
                m = mids[i]
                hi = bisect.bisect_right(starts, m)
                while j < hi:
                    s, e, name = evs[j]
                    while stack and stack[-1][1] < s:
                        stack.pop()
                    stack.append((s, e, name))
                    j += 1
                while stack and stack[-1][1] < m:
                    stack.pop()
                if stack and (best[i] is None or stack[-1][0] > best[i][0]):
                    best[i] = (stack[-1][0], stack[-1][2])
        return [b[1][:160] if b else "no host operation" for b in best]


class Stretch:
    """The profiled stretch of a traced run. ``start()`` before the window
    (the profiler's own start-up is set-up), ``with st: ...; st.units = n``
    around the units it profiles (the profiler stops at the end, after a
    synchronise), and ``read()`` once the window has closed gives the
    ``Trace`` (None when the run is not traced)."""

    def __init__(self, on: bool, sync):
        self.on, self.sync = on, sync
        self.units = 0
        self.wall = 0.0
        self.prof = None

    def start(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sync()
        self.wall = time.perf_counter() - self.t0
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def read(self) -> Optional[Trace]:
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.prof = None
        return Trace(events, self.wall, self.units)
