"""The program's own spans (``repro_torch.obs.spans``) in a traced run.

The program records a span only while a profiler runs, so a traced run's
records are those of its profiled stretch: from the window's start to the
end of the profiled units (``rec.unprofiled_t0``), on the host's
``perf_counter`` clock. Records left in the process by an earlier run fall
outside that stretch. A program without the spans module, or a run that
profiled nothing, gives no records, and the readers then report nothing.
"""
from __future__ import annotations

from typing import List, Optional

__all__ = ["profiled", "under", "device_ms"]


def profiled(rec) -> List:
    """The span records of the run's profiled stretch, with their device
    time; empty where there are none."""
    if rec.get("trace") is None:
        return []
    try:
        from repro_torch.obs import spans
    except ImportError:                 # a program that records no spans
        return []
    return spans.records(rec.t_start + rec.setup_s, rec.unprofiled_t0)


def under(records, ancestor: str) -> List:
    """The records that have an enclosing span named ``ancestor`` on their
    thread."""
    by_id = {r.id: r for r in records}

    def inside(r):
        p = by_id.get(r.parent)
        while p is not None:
            if p.name == ancestor:
                return True
            p = by_id.get(p.parent)
        return False

    return [r for r in records if inside(r)]


def device_ms(records) -> Optional[float]:
    """Σ device milliseconds of ``records``; None where there are none or
    one has no device time (a CPU run)."""
    if not records or any(r.device_ms is None for r in records):
        return None
    return sum(r.device_ms for r in records)
