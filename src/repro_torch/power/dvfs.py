"""DVFS sweeps + workload-aware policy search (paper §5.2, Fig 9).

``sweep`` re-simulates a workload at each frequency step (the event models
derive all timing from ``clock_ghz``), runs Power-EM at the matching
operating point (voltage from the VF curve), and returns the joint
perf/power table. ``choose_operating_point`` is the paper's punchline use
case: pick the lowest-energy frequency that still meets a minimum
performance requirement (battery-life-optimal DVFS policy).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

from ..graph.tasks import Task
from ..hw.chip import System
from ..hw.presets import HwConfig
from .characterization import NOMINAL_TEMP_C
from .powerem import PowerEM

__all__ = ["DvfsPoint", "sweep", "choose_operating_point"]


@dataclass
class DvfsPoint:
    freq_ghz: float
    volt: float
    time_ns: float
    inf_per_s: float
    avg_w: float
    peak_w: float
    energy_j: float
    inf_per_j: float

    @classmethod
    def from_record(cls, rec: dict) -> "DvfsPoint":
        """One refined sweep-campaign record (repro_torch.sweep) -> DvfsPoint.
        The campaign's clock axis is the operating frequency."""
        return cls(freq_ghz=rec["overrides"]["clock_ghz"],
                   volt=rec["volt"], time_ns=rec["time_ns"],
                   inf_per_s=rec["inf_per_s"], avg_w=rec["avg_w"],
                   peak_w=rec["peak_w"], energy_j=rec["energy_j"],
                   inf_per_j=rec["inf_per_j"])


def sweep(task_builder: Callable[[HwConfig], Sequence[Task]],
          cfg: HwConfig, freqs_ghz: Sequence[float], *, n_tiles: int = 1,
          pti_ns: float = 10_000.0,
          temp_c: float = NOMINAL_TEMP_C) -> List[DvfsPoint]:
    """Joint perf/power at each frequency (task_builder re-tiles per cfg —
    block choices may legitimately change with clock)."""
    out: List[DvfsPoint] = []
    for f in freqs_ghz:
        cfg_f = cfg.replace(clock_ghz=f)
        tasks = task_builder(cfg_f)
        sysm = System(cfg_f, n_tiles=n_tiles)
        rep = sysm.run_workload(tasks)
        pem = PowerEM(cfg_f, n_tiles=n_tiles, freq_ghz=f, temp_c=temp_c)
        prep = pem.analyze(sysm.tracer, pti_ns=pti_ns)
        t = rep.makespan_ns
        e = prep.energy_j()
        out.append(DvfsPoint(
            freq_ghz=f,
            volt=pem.tree.char.vf.f2v(f, temp_c),
            time_ns=t,
            inf_per_s=1e9 / t if t > 0 else 0.0,
            avg_w=prep.avg_w,
            peak_w=prep.peak_w,
            energy_j=e,
            inf_per_j=(1.0 / e) if e > 0 else 0.0,
        ))
    return out


def choose_operating_point(points: Sequence[DvfsPoint],
                           min_inf_per_s: float) -> Optional[DvfsPoint]:
    """Lowest-energy point meeting the performance floor (DVFS policy)."""
    ok = [p for p in points if p.inf_per_s >= min_inf_per_s]
    if not ok:
        return None
    return min(ok, key=lambda p: p.energy_j)
