"""Live campaign progress: incremental journal fold -> throughput + ETA.

Two pieces:

* ``JournalFollower`` — a byte-offset tail over an append-only JSONL
  journal. Each ``poll()`` consumes only *complete* lines (the offset
  never advances past a line missing its newline), so a writer caught
  mid-``write`` just means the torn tail is parsed on the next poll —
  the watch loop never sees a corrupt event.
* ``CampaignProgress`` — folds journal events (one at a time, so the
  follower can stream into it) into per-phase throughput (points/s,
  cached vs simulated), per-worker liveness, and an ETA extrapolated
  from the simulated-point rate.

Everything here is a pure function of journal content: timestamps are
the journal's own wall-clock fields (``t``, ``wall_s``), never
``time.time()`` — so the same journal always folds to the same
``summary()``, and the ``progress`` block in campaign records stays
reproducible from the journal alone. The CLI (``python -m repro_torch.exec
status --watch``) passes ``now=time.time()`` explicitly to age
liveness against the real clock.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from ..exec.journal import JournalView

__all__ = ["CampaignProgress", "JournalFollower", "render_progress"]

#: a worker with no journal event for this long is reported stalled
STALL_S = 120.0


class JournalFollower:
    """Tail a JSONL file incrementally, yielding parsed complete lines."""

    def __init__(self, path: str):
        self.path = path
        self.offset = 0
        self.warnings: List[str] = []
        self._lineno = 0

    def poll(self) -> List[Dict[str, Any]]:
        """Parse every complete line appended since the last poll."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size <= self.offset:
            return []
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            data = f.read(size - self.offset)
        # consume up to the last newline only: a torn tail line stays
        # buffered in the file until its writer finishes it
        cut = data.rfind(b"\n")
        if cut < 0:
            return []
        chunk, self.offset = data[: cut + 1], self.offset + cut + 1
        events: List[Dict[str, Any]] = []
        for raw in chunk.split(b"\n"):
            if not raw.strip():
                continue
            self._lineno += 1
            try:
                ev = json.loads(raw)
            except json.JSONDecodeError:
                self.warnings.append(
                    f"{self.path}:{self._lineno}: skipped unparseable "
                    f"journal line ({len(raw)} bytes)")
                continue
            if isinstance(ev, dict):
                events.append(ev)
        return events


class CampaignProgress:
    """Fold journal events into phase throughput, liveness, and ETA."""

    def __init__(self) -> None:
        self.view = JournalView()
        self.workers: Dict[str, Dict[str, Any]] = {}
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.wall_s_sum = 0.0

    # -- folding -----------------------------------------------------------
    def feed(self, ev: Dict[str, Any]) -> None:
        self.view.fold(ev)
        t = ev.get("t")
        if isinstance(t, (int, float)):
            if self.t_first is None or t < self.t_first:
                self.t_first = float(t)
            if self.t_last is None or t > self.t_last:
                self.t_last = float(t)
        if ev.get("ev") != "point":
            return
        w = ev.get("worker")
        if w:
            st = self.workers.setdefault(
                str(w), {"points": 0, "wall_s": 0.0, "last_t": 0.0})
            st["points"] += 1
            st["wall_s"] += float(ev.get("wall_s") or 0.0)
            if isinstance(t, (int, float)) and t > st["last_t"]:
                st["last_t"] = float(t)
        if ev.get("status") == "done":
            self.wall_s_sum += float(ev.get("wall_s") or 0.0)

    def feed_all(self, events: List[Dict[str, Any]]) -> None:
        for ev in events:
            self.feed(ev)

    @classmethod
    def from_file(cls, path: str) -> "CampaignProgress":
        prog = cls()
        view = JournalView.from_file(path)
        for ev in view.events:
            prog.feed(ev)
        prog.view.warnings = list(view.warnings)
        return prog

    # -- derived view ------------------------------------------------------
    def summary(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The ``progress`` block: phase counts/rates, workers, ETA.

        ``now`` defaults to the last journal timestamp (deterministic);
        the watch CLI passes ``time.time()`` to age worker liveness
        against the real clock.
        """
        c = self.view.counts()
        start = self.view.start_ev or {}
        to_refine = int(start.get("to_refine", 0)) or c["total"]
        resolved = c["done"] + c["cached"] + c["failed"]
        t_ref = now if now is not None else self.t_last
        elapsed = ((t_ref - self.t_first)
                   if (t_ref is not None and self.t_first is not None)
                   else 0.0)
        rate = resolved / elapsed if elapsed > 0 else 0.0
        sim_rate = c["done"] / elapsed if elapsed > 0 else 0.0
        remaining = max(to_refine - resolved, 0)
        finished = self.view.end_ev is not None or (
            to_refine > 0 and remaining == 0)
        if finished or remaining == 0:
            eta_s: Optional[float] = 0.0
        elif sim_rate > 0:
            # pending points will be simulated, not cache-served: the
            # simulated rate is the honest extrapolation basis
            eta_s = remaining / sim_rate
        elif rate > 0:
            eta_s = remaining / rate
        else:
            eta_s = None
        workers = {}
        for w in sorted(self.workers):
            st = self.workers[w]
            age = ((t_ref - st["last_t"])
                   if (t_ref is not None and st["last_t"]) else None)
            workers[w] = {
                "points": st["points"],
                "wall_s": st["wall_s"],
                "idle_s": age,
                "alive": age is not None and age < STALL_S,
            }
        return {
            "campaign": start.get("campaign"),
            "backend": start.get("backend"),
            "to_refine": to_refine,
            "resolved": resolved,
            "cached": c["cached"],
            "simulated": c["done"],
            "failed": c["failed"],
            "remaining": remaining,
            "elapsed_s": elapsed,
            "points_per_s": rate,
            "sim_points_per_s": sim_rate,
            "mean_point_wall_s": (self.wall_s_sum / c["done"]
                                  if c["done"] else 0.0),
            "eta_s": eta_s,
            "finished": finished,
            "workers": workers,
        }


def render_progress(s: Dict[str, Any]) -> List[str]:
    """Human-readable lines of a ``CampaignProgress.summary()``."""
    eta = s.get("eta_s")
    eta_txt = "done" if s.get("finished") else (
        f"{eta:.0f}s" if eta is not None else "?")
    lines = [
        f"campaign {s.get('campaign') or '?'} "
        f"[{s.get('backend') or '?'}]: "
        f"{s['resolved']}/{s['to_refine']} resolved "
        f"({s['cached']} cached, {s['simulated']} simulated, "
        f"{s['failed']} failed)",
        f"  rate {s['points_per_s']:.2f} pts/s "
        f"(sim {s['sim_points_per_s']:.2f}/s, "
        f"mean point {s['mean_point_wall_s']:.2f}s)  eta {eta_txt}",
    ]
    for w, st in s.get("workers", {}).items():
        mark = "+" if st["alive"] else "-"
        idle = (f"{st['idle_s']:.0f}s ago"
                if st["idle_s"] is not None else "never")
        lines.append(f"  worker {mark} {w}: {st['points']} pts "
                     f"({st['wall_s']:.1f}s busy, last {idle})")
    return lines
