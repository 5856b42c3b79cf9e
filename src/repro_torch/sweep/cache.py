"""Content-hashed on-disk result cache for event-engine refinements.

A refinement's inputs — workload name, full resolved ``HwConfig``, tile
count, compile options, Power-EM settings — are canonicalized to JSON and
hashed; the record is stored at ``<dir>/<hh>/<hash>.json``. Re-running a
campaign (or a bigger campaign that overlaps a previous grid) only pays
for the points it has never simulated. ``SCHEMA_VERSION`` is part of the
key: bump it when event-engine or Power-EM semantics change and every
cached record transparently invalidates.

Robustness: a worker killed mid-write on a filesystem without atomic
rename can leave a truncated/corrupt entry. ``get`` treats any
unreadable entry as a miss and deletes it — it never raises. Entries
carry their schema version inline (``_schema``, stripped on read) so
``stats``/``prune`` can report and clear stale generations, and each
campaign appends its hit/miss counters to ``<dir>/stats.jsonl`` so the
CLI (``python -m repro_torch.sweep cache``) can report a lifetime hit rate.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from typing import Any, Dict, Optional

__all__ = ["ResultCache", "SCHEMA_VERSION", "content_key",
           "atomic_write_json"]

SCHEMA_VERSION = 1

STATS_FILE = "stats.jsonl"


def content_key(payload: Dict[str, Any]) -> str:
    """Canonical sha256 of a refinement-input payload."""
    blob = json.dumps({"schema": SCHEMA_VERSION, **payload},
                      sort_keys=True, default=float)
    return hashlib.sha256(blob.encode()).hexdigest()


def atomic_write_json(path: str, obj: Dict[str, Any], *,
                      sort_keys: bool = False) -> str:
    """All-or-nothing JSON write: stage a temp file in the destination
    directory, publish with ``os.replace`` — readers never observe a
    torn file. The shared primitive behind the result cache and the job
    spool."""
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, sort_keys=sort_keys, default=float)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


class ResultCache:
    """Tiny sharded JSON store; safe under concurrent writers (atomic
    rename, last-writer-wins — all writers produce identical content for
    a given key by construction)."""

    def __init__(self, root: str):
        self.root = root
        self.hits = 0
        self.misses = 0

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key[:2], key + ".json")

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        """Fetch a record; corrupt/truncated entries are deleted and
        reported as a miss — this never raises."""
        p = self._path(key)
        try:
            with open(p) as f:
                rec = json.load(f)
            if not isinstance(rec, dict):
                raise json.JSONDecodeError("not a record", "", 0)
        except FileNotFoundError:
            self.misses += 1
            return None
        except (json.JSONDecodeError, UnicodeDecodeError, OSError):
            # killed worker mid-write (non-atomic fs), disk hiccup, ...:
            # drop the entry and re-simulate
            try:
                os.unlink(p)
            except OSError:
                pass
            self.misses += 1
            return None
        rec.pop("_schema", None)
        self.hits += 1
        return rec

    def put(self, key: str, record: Dict[str, Any]) -> str:
        return atomic_write_json(self._path(key),
                                 {"_schema": SCHEMA_VERSION, **record})

    # -- introspection / maintenance --------------------------------------

    def _entries(self):
        if not os.path.isdir(self.root):
            return
        for shard in sorted(os.listdir(self.root)):
            d = os.path.join(self.root, shard)
            if not os.path.isdir(d):
                continue
            for f in sorted(os.listdir(d)):
                if f.endswith(".json"):
                    yield os.path.join(d, f)

    def stats(self) -> Dict[str, Any]:
        """Entry count, total bytes, and per-schema-generation counts
        (``None`` = unreadable/legacy entries with no schema tag)."""
        n = 0
        nbytes = 0
        by_schema: Dict[Optional[int], int] = {}
        for p in self._entries():
            n += 1
            try:
                nbytes += os.path.getsize(p)
                with open(p) as f:
                    schema = json.load(f).get("_schema")
            except (OSError, json.JSONDecodeError, UnicodeDecodeError,
                    AttributeError):
                schema = None
            by_schema[schema] = by_schema.get(schema, 0) + 1
        return {"entries": n, "bytes": nbytes, "by_schema": by_schema,
                "schema_version": SCHEMA_VERSION}

    def prune(self, *, keep_schema: int = SCHEMA_VERSION) -> int:
        """Delete entries from other schema generations (including
        unreadable/untagged ones); returns the number removed."""
        removed = 0
        for p in self._entries():
            try:
                with open(p) as f:
                    schema = json.load(f).get("_schema")
            except (OSError, json.JSONDecodeError, UnicodeDecodeError,
                    AttributeError):
                schema = None
            if schema != keep_schema:
                try:
                    os.unlink(p)
                    removed += 1
                except OSError:
                    pass
        return removed

    def log_stats(self, campaign: str = "") -> None:
        """Append this process's hit/miss counters (one JSON line,
        O_APPEND-safe) for lifetime hit-rate reporting."""
        if self.hits == 0 and self.misses == 0:
            return
        os.makedirs(self.root, exist_ok=True)
        line = json.dumps({"t": time.time(), "campaign": campaign,
                           "hits": self.hits, "misses": self.misses})
        with open(os.path.join(self.root, STATS_FILE), "a") as f:
            f.write(line + "\n")

    def lifetime_stats(self) -> Dict[str, Any]:
        """Aggregate hit/miss counters across every logged campaign."""
        hits = misses = runs = 0
        p = os.path.join(self.root, STATS_FILE)
        try:
            with open(p) as f:
                for raw in f:
                    raw = raw.strip()
                    if not raw:
                        continue
                    try:
                        d = json.loads(raw)
                    except json.JSONDecodeError:
                        continue
                    hits += int(d.get("hits", 0))
                    misses += int(d.get("misses", 0))
                    runs += 1
        except FileNotFoundError:
            pass
        total = hits + misses
        return {"runs": runs, "hits": hits, "misses": misses,
                "hit_rate": (hits / total) if total else None}

    def __len__(self) -> int:
        return sum(1 for _ in self._entries())
