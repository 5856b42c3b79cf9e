"""Arithmetic that several metric readers share. A traced run profiles the
first units of its window (``Record.trace``) and times the rest without
the profiler: rates and wall times come from that unprofiled stretch,
device busy time from the profiled one."""
from __future__ import annotations

from typing import List, Optional, Tuple

from .peaks import BF16_FLOPS

__all__ = ["unprofiled", "idle_pct", "mfu_pct", "roofline_pct"]


def unprofiled(rec) -> Tuple[List[dict], float]:
    """The units timed without the profiler and the wall seconds from the
    end of the profiled stretch (or the window's start) to the last one's
    end."""
    units = [u for u in rec.units if not u["profiled"]]
    if not units:
        return [], 0.0
    return units, units[-1]["t1"] - rec.unprofiled_t0


def idle_pct(rec) -> Optional[float]:
    """100 · (1 − device busy a unit in the profiled stretch ÷ wall a unit
    in the unprofiled one)."""
    tr = rec.get("trace")
    units, wall = unprofiled(rec)
    if tr is None or not tr.units or not units or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - (tr.busy_s / tr.units) / (wall / len(units)))


def mfu_pct(rec, flops_of_unit) -> Optional[float]:
    """Model FLOPs of the unprofiled units ÷ their wall ÷ the bf16 peak."""
    units, wall = unprofiled(rec)
    if not units or wall <= 0:
        return None
    return 100.0 * sum(flops_of_unit(u) for u in units) / wall / BF16_FLOPS


def roofline_pct(rec, patterns, bound_of_unit) -> Optional[float]:
    """Σ bound of the profiled units' calls ÷ the device time of the kernels
    matching ``patterns``; None where the profiler saw none of them."""
    tr = rec.get("trace")
    if tr is None:
        return None
    dev = tr.kernel_seconds(patterns)
    if dev <= 0:
        return None
    return 100.0 * sum(bound_of_unit(u) for u in rec.units if u["profiled"]) / dev
