"""Sweep-campaign subsystem: batched design-space exploration (paper §4).

VPU-EM's purpose is evaluating NPU perf/power *at scale* across a large
design-parameter space. This package turns each ad-hoc point-by-point
sweep script into a declarative **campaign**:

1. **Spec** (``spec.py``) — model workloads x hardware preset x parameter
   grid (DVFS points, HBM bandwidth, MXU geometry, tile count, ...),
   loadable from JSON (builtin specs live in ``repro_torch/configs/sweeps/``).
2. **Pre-screen** (``prescreen.py``) — the whole grid is evaluated in one
   ``jax.vmap``/XLA call per structural cell via the analytic scheduler
   (``core.vectorized.schedule_many_stats``), yielding makespan + an
   analytic Power-EM proxy for every point.
3. **Select** (``pareto.py``) — the Pareto-interesting points (time x
   energy front, plus extremes) are chosen for refinement.
4. **Refine** (``refine.py``/``runner.py``) — only the selected points
   re-run in detail (Power-EM included) on the refinement engine the
   spec picks: the ground-truth event engine, or ``core.fastsim``'s
   interval replay with steady-state layer extrapolation
   (``refine.engine="fast"|"auto"`` — >=10x points/sec on full-model
   LM points, byte-identical records whenever it replays). Execution
   goes through a pluggable ``repro_torch.exec`` backend (inline / local
   process pool / resumable filesystem job spool) behind a
   content-hashed on-disk result cache (``cache.py``) so repeated —
   and interrupted — campaigns are incremental. A per-point JSONL
   journal records status, wall time, worker id, and cache-hit
   counters.

CLI: ``python -m repro_torch.sweep run <spec.json | builtin-name>
[--backend inline|pool|spool]``; workers attach with
``python -m repro_torch.exec worker <spool>``; cache maintenance with
``python -m repro_torch.sweep cache``.

Attribute access is lazy (PEP 562): refinement worker processes import
``repro_torch.sweep.refine`` without paying for jax/XLA initialization.
"""
from typing import TYPE_CHECKING

__all__ = [
    "ANALYTIC_AXES",
    "CampaignResult",
    "GridPoint",
    "RefineSpec",
    "ResultCache",
    "SweepSpec",
    "builtin_spec_names",
    "load_builtin_spec",
    "load_spec",
    "pareto_front",
    "run_campaign",
    "select_points",
]

_EXPORTS = {
    "ANALYTIC_AXES": "spec",
    "GridPoint": "spec",
    "RefineSpec": "spec",
    "SweepSpec": "spec",
    "builtin_spec_names": "spec",
    "load_builtin_spec": "spec",
    "load_spec": "spec",
    "ResultCache": "cache",
    "pareto_front": "pareto",
    "select_points": "pareto",
    "CampaignResult": "runner",
    "run_campaign": "runner",
}

if TYPE_CHECKING:  # pragma: no cover
    from .cache import ResultCache
    from .pareto import pareto_front, select_points
    from .runner import CampaignResult, run_campaign
    from .spec import (ANALYTIC_AXES, GridPoint, RefineSpec, SweepSpec,
                       builtin_spec_names, load_builtin_spec, load_spec)


def __getattr__(name: str):
    try:
        modname = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}") from None
    import importlib

    mod = importlib.import_module(f".{modname}", __name__)
    value = getattr(mod, name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
