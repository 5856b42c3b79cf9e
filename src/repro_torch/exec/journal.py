"""Campaign journal: append-only JSONL telemetry for refinement runs.

One line per event, written with ``O_APPEND`` semantics so concurrent
writers (the runner plus any backend) never corrupt each other. Three
event kinds:

* ``start`` — campaign name, backend, grid size, refinement count;
* ``point`` — one refinement point changed status: ``cached`` (served
  from the result cache, zero re-simulation), ``done`` (simulated, with
  worker id + wall seconds), or ``failed``;
* ``end``   — the campaign summary (includes the cache hit counters the
  resume acceptance check reads);
* ``janitor`` — a maintenance pass touched the spool (lease reclaims,
  ``.tmp`` GC, quarantines, compaction) — emitted by the standalone
  janitor daemon and by the runner's in-loop reclaim, and rendered as
  its own lane by the Perfetto exporter.

``JournalView`` (``CampaignJournal.load``) folds the stream into the
latest status per point so CI / tooling can assert "all points done"
(``python -m repro_torch.exec journal <file> --expect-done``).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["CampaignJournal", "JournalView"]


class CampaignJournal:
    """Append-only JSONL writer; safe for multiple processes."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)

    def log(self, ev: str, **fields: Any) -> None:
        line = json.dumps({"ev": ev, "t": time.time(), **fields},
                          sort_keys=True, default=float)
        # one write() of one line: O_APPEND keeps concurrent writers whole
        with open(self.path, "a") as f:
            f.write(line + "\n")

    def start(self, *, campaign: str, backend: str, grid_points: int,
              to_refine: int) -> None:
        self.log("start", campaign=campaign, backend=backend,
                 grid_points=grid_points, to_refine=to_refine)

    def point(self, key: str, status: str, *,
              point_id: Optional[str] = None, worker: Optional[str] = None,
              wall_s: Optional[float] = None,
              error: Optional[str] = None) -> None:
        fields: Dict[str, Any] = {"key": key, "status": status}
        if point_id is not None:
            fields["point_id"] = point_id
        if worker is not None:
            fields["worker"] = worker
        if wall_s is not None:
            fields["wall_s"] = wall_s
        if error is not None:
            fields["error"] = error
        self.log("point", **fields)

    def end(self, summary: Dict[str, Any]) -> None:
        self.log("end", summary=summary)

    def janitor(self, *, worker: str, **stats: Any) -> None:
        """One maintenance pass (reclaims/GC counts ride in ``stats``)."""
        self.log("janitor", worker=worker,
                 **{k: v for k, v in stats.items() if v is not None})

    @staticmethod
    def load(path: str) -> "JournalView":
        return JournalView.from_file(path)


@dataclass
class JournalView:
    """Folded view of a journal stream: latest status per point.

    Torn lines (a writer killed mid-``write`` leaves a truncated final
    line; a line missing its newline gets the next event glued onto it)
    are skipped, never fatal — each skip is recorded in ``warnings`` so
    CLI consumers can surface them instead of silently under-counting.
    """

    events: List[Dict[str, Any]] = field(default_factory=list)
    points: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    start_ev: Optional[Dict[str, Any]] = None
    end_ev: Optional[Dict[str, Any]] = None
    janitor_events: List[Dict[str, Any]] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)

    @classmethod
    def from_file(cls, path: str) -> "JournalView":
        view = cls()
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    view.warnings.append(
                        f"{path}:{lineno}: skipped torn/unparseable "
                        f"journal line ({len(line)} bytes)")
                    continue
                if not isinstance(ev, dict):
                    view.warnings.append(
                        f"{path}:{lineno}: skipped non-object journal "
                        f"line ({type(ev).__name__})")
                    continue
                view.fold(ev)
        return view

    def fold(self, ev: Dict[str, Any]) -> None:
        """Fold one parsed event into the view (incremental consumers —
        ``obs.progress`` — feed events here as they tail the file)."""
        self.events.append(ev)
        kind = ev.get("ev")
        if kind == "start":
            self.start_ev = ev
        elif kind == "end":
            self.end_ev = ev
        elif kind == "point" and "key" in ev:
            self.points[ev["key"]] = ev
        elif kind == "janitor":
            self.janitor_events.append(ev)

    @property
    def summary(self) -> Dict[str, Any]:
        return (self.end_ev or {}).get("summary", {})

    def counts(self) -> Dict[str, int]:
        c = {"done": 0, "cached": 0, "failed": 0, "other": 0}
        for ev in self.points.values():
            c[ev.get("status") if ev.get("status") in c else "other"] += 1
        c["total"] = len(self.points)
        return c

    def cache_hits(self) -> int:
        return self.counts()["cached"]

    def simulated(self) -> int:
        return self.counts()["done"]

    def all_done(self, min_points: int = 1,
                 allow_failed: bool = False) -> bool:
        """True when the campaign finished and every point resolved to
        ``done`` or ``cached`` (the CI smoke assertion).
        ``allow_failed=True`` relaxes to *every point terminal* —
        ``failed`` points count, matching ``--allow-partial`` runs."""
        c = self.counts()
        terminal = c["done"] + c["cached"]
        if allow_failed:
            terminal += c["failed"]
        return (self.end_ev is not None and c["total"] >= min_points
                and (allow_failed or c["failed"] == 0)
                and c["other"] == 0 and terminal == c["total"])
