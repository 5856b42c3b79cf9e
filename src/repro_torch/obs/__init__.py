"""Observability subsystem: metrics, Perfetto timelines, live progress.

Three cross-cutting pieces over the whole simulator stack:

* ``obs.metrics`` — zero-dep counters/gauges/histograms with labels and
  deterministic JSON snapshots, instrumented into the event engine
  (heap depth, events processed, resource-contention stalls), the fast
  engine (extrapolation hits vs full-replay fallbacks), the serving
  fleet (KV-slot occupancy, batch composition, admission/eviction,
  queue depth), and the exec backends (claims/reclaims/quarantines,
  cache hit rates). Off by default (``REPRO_METRICS=1`` enables).
* ``obs.perfetto`` — Chrome-trace/Perfetto exporter with three track
  families: engine task timelines with Power-EM counter tracks,
  serving-fleet request-lifecycle spans with KV-occupancy counters,
  and campaign worker lanes reconstructed from the exec journal.
  CLI: ``python -m repro_torch.obs trace <point|journal> -o trace.json``.
* ``obs.progress`` — the incremental campaign-journal fold behind
  ``python -m repro_torch.exec status --watch`` (per-phase throughput,
  per-worker liveness, ETA) and the ``progress`` block in campaign
  summaries.

``obs.metrics`` is eagerly importable from anywhere (pure stdlib, no
repro_torch imports — instrumented hot paths depend on it, never the other
way around). The exporters are lazy (PEP 562) so importing the metrics
plane never drags simulation modules in.
"""
from typing import TYPE_CHECKING

from .metrics import (MetricsRegistry, REGISTRY, collecting, enabled,
                      set_enabled)

__all__ = ["MetricsRegistry", "REGISTRY", "collecting", "enabled",
           "set_enabled", "trace_event_point", "trace_serve_point",
           "trace_campaign_journal", "write_trace", "CampaignProgress",
           "JournalFollower", "render_progress"]

if TYPE_CHECKING:  # pragma: no cover - static analysis only
    from .perfetto import (trace_campaign_journal, trace_event_point,
                           trace_serve_point, write_trace)
    from .progress import CampaignProgress, JournalFollower

_LAZY = {
    "trace_event_point": "perfetto",
    "trace_serve_point": "perfetto",
    "trace_campaign_journal": "perfetto",
    "write_trace": "perfetto",
    "CampaignProgress": "progress",
    "JournalFollower": "progress",
    "render_progress": "progress",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is not None:
        import importlib

        return getattr(importlib.import_module(f".{mod}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
