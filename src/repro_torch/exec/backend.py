"""The ``Backend`` contract and the inline reference implementation.

A backend executes an ordered batch of refinement payloads (the
cache-keyed dicts built by ``repro_torch.sweep.refine.refine_payload``) and
returns the refined records **in the same order**. The campaign runner
owns everything else — pre-screen, selection, the result cache, journal
cache-hit events — so backends stay small and interchangeable:
``run_campaign(..., backend="inline"|"pool"|"spool")`` is the only
switch.

Payloads are opaque to backends: the ``engine`` field
(``"event"|"fast"|"auto"``, routing between the event engine and the
``core.fastsim`` interval-replay engine) rides inside the payload and
is resolved by ``refine_point`` wherever the job lands — an external
spool worker on another host refines with the same engine the campaign
asked for, and the cache key covers it.

Implementations must be deterministic in *content*: for a given payload
list every backend produces the same records (the equivalence tests and
the byte-identical acceptance check rely on it).

Worked example — refining two points by hand (normally ``run_campaign``
does this for you)::

    >>> from repro_torch.exec.backend import get_backend
    >>> from repro_torch.sweep.refine import refine_payload
    >>> from repro_torch.hw.presets import resolve_preset, to_dict
    >>> hw = to_dict(resolve_preset("v5e"))
    >>> payloads = [refine_payload(workload=w, n_tiles=2, hw=hw,
    ...                            compile_opts={}, pti_ns=50_000.0,
    ...                            temp_c=65.0, keep_series=False)
    ...             for w in ("lm/qwen3-32b/s512b1tp1",
    ...                       "lm/qwen3-32b/decode/kv512b1tp1")]
    >>> bk = get_backend("inline")          # or "pool" / "spool"
    >>> recs = bk.refine(payloads)          # records in payload order
    >>> sorted(recs[0]) == sorted(recs[1])  # uniform record shape
    True
    >>> recs[1]["time_ns"] > 0              # the decode step, simulated
    True

Swapping ``"inline"`` for ``get_backend("pool", workers=4)`` or
``get_backend("spool", spool_dir="...")`` changes *where* the payloads
run, never the records.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Protocol, \
    runtime_checkable

__all__ = ["Backend", "BackendError", "InlineBackend", "get_backend",
           "BACKEND_NAMES", "is_batch_record", "is_failure_record",
           "failure_record"]

BACKEND_NAMES = ("inline", "pool", "spool")

Payload = Dict[str, Any]
Record = Dict[str, Any]
Progress = Optional[Callable[[str], None]]


class BackendError(RuntimeError):
    """A backend could not produce a record for one or more payloads."""


@runtime_checkable
class Backend(Protocol):
    """Refinement execution strategy."""

    name: str

    def refine(self, payloads: List[Payload], *,
               keys: Optional[List[str]] = None,
               journal: Optional[Any] = None,
               cache: Optional[Any] = None,
               progress: Progress = None,
               allow_partial: bool = False) -> List[Record]:
        """Refine every payload; return records in payload order.

        ``keys`` are the content-hash job ids (one per payload — the
        same keys the result cache uses), ``journal`` an optional
        ``CampaignJournal`` receiving per-point ``done`` events, and
        ``cache`` an optional ``ResultCache`` each record is written
        through to **as soon as it lands** — so a runner killed
        mid-batch loses nothing already refined, and the re-invocation
        sees those points as cache hits.

        With ``allow_partial=True`` a payload whose refinement fails
        yields a ``failure_record`` at its position (journaled as
        ``failed``, never cached) instead of the whole call raising
        ``BackendError`` — graceful degradation for long campaigns
        where one poison cell must not discard 71 finished ones.
        """
        ...


def is_batch_record(rec: Record) -> bool:
    """A batch-job result (``sweep.refine.refine_batch``): per-item
    records plus their own content keys. Backends expand it into
    per-point cache entries and journal events so batching stays
    invisible to the cache, the journal, and resumed campaigns."""
    return rec.get("kind") == "batch" and "records" in rec and "keys" in rec


def is_failure_record(rec: Record) -> bool:
    """A degraded placeholder from an ``allow_partial`` run — the point
    failed and carries a diagnosis instead of simulation results."""
    return isinstance(rec, dict) and rec.get("kind") == "refine_failed"


def failure_record(error: str, *, worker: str = "?") -> Record:
    """The record shape a failed point degrades to under
    ``allow_partial``: no simulation fields, ``failed: True``, and the
    diagnosis attached. Never cached (a transient failure must not
    poison future runs)."""
    return {"kind": "refine_failed", "failed": True,
            "error": str(error), "worker": worker}


def _cache_put(cache, key: Optional[str], rec: Record) -> None:
    if cache is None or is_failure_record(rec):
        return
    if is_batch_record(rec):
        # per-point write-through under each item's own key — never
        # under the batch-job key, so unbatched reruns hit the cache
        for sub_key, sub in zip(rec["keys"], rec["records"]):
            cache.put(sub_key, canonical(sub))
        return
    if key is not None:
        cache.put(key, canonical(rec))


def canonical(rec: Record) -> Record:
    """JSON round-trip (sorted keys) — the one shape records ever take
    on disk or in results, so backends, cache, and resumed runs are
    byte-identical."""
    import json

    return json.loads(json.dumps(rec, sort_keys=True, default=float))


def _journal_done(journal, key: Optional[str], *, worker: str,
                  wall_s: Optional[float],
                  rec: Optional[Record] = None) -> None:
    if journal is None:
        return
    if rec is not None and is_batch_record(rec):
        # one "done" event per point (the journal's unit is the point,
        # whatever the dispatch unit was); the job's wall time is split
        # evenly — per-point attribution inside a shared simulation is
        # not meaningful
        per = (wall_s / len(rec["keys"])
               if wall_s is not None and rec["keys"] else wall_s)
        for sub_key in rec["keys"]:
            journal.point(sub_key, "done", worker=worker, wall_s=per)
        return
    if key is not None:
        journal.point(key, "done", worker=worker, wall_s=wall_s)


class InlineBackend:
    """Sequential in-process refinement — deterministic, zero setup."""

    name = "inline"

    def refine(self, payloads: List[Payload], *,
               keys: Optional[List[str]] = None,
               journal: Optional[Any] = None,
               cache: Optional[Any] = None,
               progress: Progress = None,
               allow_partial: bool = False) -> List[Record]:
        from ..sweep.refine import refine_point

        keys = keys or [None] * len(payloads)
        out: List[Record] = []
        for payload, key in zip(payloads, keys):
            t0 = time.time()
            try:
                rec = refine_point(payload)
            except Exception as e:
                if not allow_partial:
                    raise
                rec = failure_record(e, worker="inline")
                if journal is not None and key is not None:
                    journal.point(key, "failed", worker="inline",
                                  error=rec["error"])
                out.append(rec)
                continue
            _cache_put(cache, key, rec)
            _journal_done(journal, key, worker="inline",
                          wall_s=time.time() - t0, rec=rec)
            out.append(rec)
        return out


def get_backend(name: str, *, workers: Optional[int] = None,
                spool_dir: Optional[str] = None, **opts: Any) -> Backend:
    """Build a backend from its CLI name.

    * ``inline``            — sequential in-process.
    * ``pool``              — ``workers`` local processes (None = per core).
    * ``spool``             — filesystem job spool at ``spool_dir`` with
      ``workers`` locally-spawned daemons (0 = rely on external workers
      attached via ``python -m repro_torch.exec worker <spool_dir>``).
    """
    if name == "inline":
        return InlineBackend()
    if name == "pool":
        from .pool import PoolBackend
        return PoolBackend(workers=workers, **opts)
    if name == "spool":
        from .spool import SpoolBackend
        if not spool_dir:
            raise ValueError("spool backend needs spool_dir")
        n = workers if workers is not None else 1
        return SpoolBackend(spool_dir, workers=n, **opts)
    raise ValueError(f"unknown backend {name!r}; "
                     f"have {'|'.join(BACKEND_NAMES)}")
