"""Standalone spool janitor: the maintenance duties that must outlive
any single campaign runner.

``SpoolBackend`` reclaims dead jobs while it polls — but a long-lived
shared spool (multi-host workers on one filesystem, detached daemons)
has no guarantee a runner is alive. A SIGKILLed runner used to strand
the fleet: leases expire, nobody reclaims, workers starve. The janitor
is a tiny daemon (``python -m repro_torch.exec janitor <spool>``) that owns
four periodic duties:

* **lease reclaim + poison quarantine** — ``Spool.reclaim()``: orphaned
  active jobs go back to ``jobs/`` with a retry backoff; jobs past the
  retry budget are quarantined to ``failed/`` with a diagnosis;
* **stale ``.tmp`` GC** — staging files from atomic publishes whose
  writer died mid-``mkstemp``/``os.replace`` accumulate forever on a
  shared directory; anything matching ``*.tmp`` older than
  ``tmp_age_s`` is removed (``spool.tmp_gc`` counter);
* **corrupt-done GC** — a torn ``done/<key>.json`` (non-atomic
  filesystem) reads as *not finished* everywhere, but the wreckage
  blocks nothing and tells nobody; older than ``corrupt_age_s`` it is
  deleted so the key is cleanly resubmittable;
* **``done/`` compaction** — thousands of finished single-result files
  make every ``listdir`` slow; results older than ``compact_age_s``
  are appended to ``done/_compact.jsonl`` (append-then-unlink, so a
  janitor killed mid-pass duplicates a line at worst — the compact
  index is last-write-wins by key) and the per-key files removed.
  ``Spool.result``/``done_keys``/``counts`` consult the compacted
  archive transparently.

Every pass bumps ``janitor.passes`` and, when a campaign journal is
attached, appends an ``ev: "janitor"`` line the Perfetto exporter
renders as its own lane.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Optional

from ..obs.metrics import REGISTRY
from .journal import CampaignJournal
from .spool import COMPACT_FILE, Spool, _STATES, worker_id

__all__ = ["janitor_pass", "run_janitor", "DEFAULT_TMP_AGE_S",
           "DEFAULT_CORRUPT_AGE_S", "DEFAULT_COMPACT_AGE_S"]

DEFAULT_TMP_AGE_S = 300.0      # staging files are normally sub-second
DEFAULT_CORRUPT_AGE_S = 300.0  # give in-flight rewrites time to win
DEFAULT_COMPACT_AGE_S = 60.0   # keep hot results as plain files


def _gc_tmp(spool: Spool, age_s: float, now: float) -> int:
    """Remove orphaned atomic-write staging files (``*.tmp``)."""
    n = 0
    for state in _STATES:
        d = spool._dir(state)
        try:
            names = os.listdir(d)
        except OSError:
            continue
        for fname in names:
            if not fname.endswith(".tmp"):
                continue
            p = os.path.join(d, fname)
            try:
                if now - os.stat(p).st_mtime > age_s:
                    os.unlink(p)
                    n += 1
            except FileNotFoundError:
                pass
    if n and REGISTRY.enabled:
        REGISTRY.counter("spool.tmp_gc").inc(n)
    return n


def _gc_corrupt_done(spool: Spool, age_s: float, now: float) -> int:
    """Remove torn ``done/`` files old enough that no writer is coming
    back for them. The key simply reads as unfinished (it already did)
    and can be resubmitted cleanly."""
    n = 0
    d = spool._dir("done")
    for fname in spool._list("done"):
        p = os.path.join(d, fname)
        try:
            if now - os.stat(p).st_mtime <= age_s:
                continue
            with open(p) as f:
                obj = json.load(f)
            if isinstance(obj, dict) and "record" in obj:
                continue               # healthy
        except FileNotFoundError:
            continue
        except json.JSONDecodeError:
            pass                       # torn: fall through to unlink
        try:
            os.unlink(p)
            n += 1
        except FileNotFoundError:
            pass
    if n and REGISTRY.enabled:
        REGISTRY.counter("spool.corrupt_gc").inc(n)
    return n


def _compact_done(spool: Spool, age_s: float, now: float) -> int:
    """Fold cold ``done/<key>.json`` files into ``done/_compact.jsonl``.

    Append-then-unlink per file: a crash in between leaves both copies,
    which is harmless — ``Spool.result`` prefers the per-key file and
    the compact index is last-write-wins by key. One ``O_APPEND`` write
    per line keeps concurrent janitors from interleaving bytes."""
    n = 0
    d = spool._dir("done")
    compact = os.path.join(d, COMPACT_FILE)
    for fname in spool._list("done"):
        p = os.path.join(d, fname)
        try:
            if now - os.stat(p).st_mtime <= age_s:
                continue
            with open(p) as f:
                obj = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            continue                   # corrupt-GC's department
        if not (isinstance(obj, dict) and "key" in obj
                and "record" in obj):
            continue
        line = json.dumps(obj, sort_keys=True, default=float)
        with open(compact, "a") as f:
            f.write(line + "\n")
        try:
            os.unlink(p)
        except FileNotFoundError:
            pass
        n += 1
    if n and REGISTRY.enabled:
        REGISTRY.counter("spool.compacted").inc(n)
    return n


def janitor_pass(spool: Spool, *,
                 tmp_age_s: float = DEFAULT_TMP_AGE_S,
                 corrupt_age_s: float = DEFAULT_CORRUPT_AGE_S,
                 compact_age_s: Optional[float] = DEFAULT_COMPACT_AGE_S,
                 now: Optional[float] = None) -> Dict[str, int]:
    """One full maintenance sweep; returns per-duty counts.

    ``compact_age_s=None`` disables compaction (e.g. while debugging a
    spool with plain ``ls``)."""
    now = now if now is not None else spool._now()
    stats = {
        "reclaimed": spool.reclaim(now=now),
        "tmp_gc": _gc_tmp(spool, tmp_age_s, now),
        "corrupt_gc": _gc_corrupt_done(spool, corrupt_age_s, now),
        "compacted": (_compact_done(spool, compact_age_s, now)
                      if compact_age_s is not None else 0),
    }
    if REGISTRY.enabled:
        REGISTRY.counter("janitor.passes").inc()
    return stats


def run_janitor(root: str, *, interval_s: float = 10.0,
                lease_s: Optional[float] = None,
                tmp_age_s: float = DEFAULT_TMP_AGE_S,
                corrupt_age_s: float = DEFAULT_CORRUPT_AGE_S,
                compact_age_s: Optional[float] = DEFAULT_COMPACT_AGE_S,
                iterations: Optional[int] = None,
                journal_path: Optional[str] = None,
                log: Optional[Callable[[str], None]] = None) -> int:
    """The janitor daemon loop: sweep every ``interval_s`` seconds.

    ``iterations=None`` runs forever (the deployed mode — pair one
    janitor with any shared spool); a finite count makes one-shot
    sweeps scriptable (``--once`` in the CLI). Returns the total number
    of jobs reclaimed across all passes."""
    spool = Spool(root) if lease_s is None else Spool(root,
                                                     lease_s=lease_s)
    journal = CampaignJournal(journal_path) if journal_path else None
    wid = f"janitor-{worker_id()}"
    total_reclaimed = 0
    i = 0
    while iterations is None or i < iterations:
        i += 1
        stats = janitor_pass(spool, tmp_age_s=tmp_age_s,
                             corrupt_age_s=corrupt_age_s,
                             compact_age_s=compact_age_s)
        total_reclaimed += stats["reclaimed"]
        if journal is not None and any(stats.values()):
            journal.janitor(worker=wid, **stats)
        if log and any(stats.values()):
            log(f"[{wid}] pass {i}: " +
                ", ".join(f"{k}={v}" for k, v in stats.items() if v))
        if iterations is not None and i >= iterations:
            break
        time.sleep(interval_s)
    return total_reclaimed


def janitor_status(root: str) -> Dict[str, Any]:
    """The ``exec status`` payload for a spool: state counts plus
    backoff/quarantine detail."""
    return Spool(root).status()
