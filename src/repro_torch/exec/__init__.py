"""Execution service: pluggable refinement backends for sweep campaigns.

``repro_torch.sweep`` decides *what* to refine (pre-screen -> Pareto select);
this package decides *how* those refinements execute. Every backend
implements the same tiny contract (``backend.Backend``): take an ordered
list of refinement payloads, return the refined records in the same
order. Three implementations:

* ``InlineBackend``  — sequential, in-process. Deterministic and
  test-friendly; zero setup cost.
* ``PoolBackend``    — a local ``ProcessPoolExecutor`` (the refinement
  import path is jax-free, so workers start in milliseconds).
* ``SpoolBackend``   — a filesystem job spool (``spool.Spool``): jobs are
  claimed by atomic rename, leases are kept alive by heartbeat, dead
  jobs are reclaimed, and any number of independent worker daemons
  (``python -m repro_torch.exec worker <spool>``) drain the queue — across
  processes, container restarts, or a shared filesystem — with no
  network dependency. Campaigns become interruptible and resumable.

``journal.CampaignJournal`` is the append-only per-point telemetry
stream (status, wall time, worker id, cache-hit counters) every backend
feeds; ``python -m repro_torch.exec journal <file> --expect-done`` turns it
into a CI assertion.

Attribute access is lazy (PEP 562) so worker processes never pay for
imports they don't need.
"""
from typing import TYPE_CHECKING

__all__ = [
    "Backend",
    "BackendError",
    "CampaignJournal",
    "FaultPlan",
    "InjectedCrash",
    "InlineBackend",
    "JournalView",
    "PoolBackend",
    "PublishError",
    "Spool",
    "SpoolBackend",
    "get_backend",
    "janitor_pass",
    "run_janitor",
    "run_worker",
]

_EXPORTS = {
    "Backend": "backend",
    "BackendError": "backend",
    "InlineBackend": "backend",
    "get_backend": "backend",
    "FaultPlan": "faults",
    "InjectedCrash": "faults",
    "PoolBackend": "pool",
    "PublishError": "spool",
    "Spool": "spool",
    "SpoolBackend": "spool",
    "CampaignJournal": "journal",
    "JournalView": "journal",
    "janitor_pass": "janitor",
    "run_janitor": "janitor",
    "run_worker": "worker",
}

if TYPE_CHECKING:  # pragma: no cover
    from .backend import Backend, BackendError, InlineBackend, get_backend
    from .faults import FaultPlan, InjectedCrash
    from .janitor import janitor_pass, run_janitor
    from .journal import CampaignJournal, JournalView
    from .pool import PoolBackend
    from .spool import PublishError, Spool, SpoolBackend
    from .worker import run_worker


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
