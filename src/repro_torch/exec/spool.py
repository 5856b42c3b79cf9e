"""Filesystem job spool: durable, multi-process refinement queue.

Layout (everything is plain JSON under one root directory)::

    <root>/jobs/<key>.json            pending   {"key", "payload",
                                                 "attempts"?, "not_before"?}
    <root>/active/<key>@<worker>.json claimed   (heartbeat = file mtime)
    <root>/done/<key>.json            finished  {"key","record","worker",..}
    <root>/done/_compact.jsonl        janitor-compacted finished jobs
    <root>/failed/<key>.json          errored   {"key","error","worker",..}

Concurrency is pure POSIX filesystem semantics — no locks, no network:

* **claim** — ``rename(jobs/k.json, active/k@w.json)``. Rename is
  atomic; exactly one of any number of racing workers wins, the losers
  get ``FileNotFoundError`` and move on.
* **heartbeat lease** — a claiming worker touches its active file
  periodically. An active file whose mtime is older than ``lease_s`` is
  presumed orphaned (killed worker) and **reclaimed**: returned to
  ``jobs/`` where any worker can claim it again.
* **retry budget** — every reclaim/requeue increments the job's
  ``attempts`` counter. A job past ``retry_budget`` attempts is a
  *poison job* (it kills every worker that touches it — an OOM, a
  segfaulting extension, a pathological input): it is quarantined to
  ``failed/`` instead of being lease-reclaimed forever, so a campaign
  fails fast with a diagnosable error instead of cycling the fleet.
* **retry backoff** — a requeued job carries a ``not_before`` timestamp
  (exponential in ``attempts`` with deterministic jitter keyed on the
  job key) that ``claim()`` honors, so a flaky job stops hot-looping
  the queue while healthy jobs flow around it.
* **complete** — results are staged as invisible ``.tmp`` files and
  published with ``os.replace`` so readers never observe a torn
  ``done`` file. The complete/fail paths are *release-safe*: a
  recoverable exception after the outcome publish still releases the
  lease, and a failed outcome publish requeues the job immediately
  instead of leaking the claim until lease expiry.

Job ids are the refinement content keys (``sweep.cache.content_key``),
so the spool is naturally idempotent: re-submitting a campaign after a
kill re-creates only the jobs that never finished, and a ``done`` file
surviving a dead runner is picked up without re-simulation.

Failure injection: every mutation site here consults
``exec.faults.active_plan()`` (inert unless ``REPRO_FAULTS`` is set or
a test installs a plan), which is how the chaos suite proves the
exactly-once/quarantine invariant. ``exec.janitor`` owns the
maintenance duties (periodic reclaim, ``.tmp`` GC, corrupt-done GC,
``done/`` compaction) for spools that outlive any single runner.

``SpoolBackend`` drives a campaign's misses through a spool: submit,
optionally spawn local worker daemons, poll for completion while
reclaiming dead jobs, and collect records in payload order.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..obs.metrics import REGISTRY
from ..sweep.cache import atomic_write_json
from . import faults
from .backend import BackendError, Progress, _cache_put, _journal_done, \
    failure_record

__all__ = ["Spool", "SpoolJob", "SpoolBackend", "PublishError",
           "DEFAULT_LEASE_S", "DEFAULT_RETRY_BUDGET", "DEFAULT_BACKOFF_S",
           "DEFAULT_BACKOFF_CAP_S", "backoff_s", "worker_id"]

DEFAULT_LEASE_S = 60.0
DEFAULT_RETRY_BUDGET = 3       # reclaims/requeues before quarantine
DEFAULT_BACKOFF_S = 2.0        # base of the exponential retry backoff
DEFAULT_BACKOFF_CAP_S = 60.0   # backoff ceiling (before jitter)
_STATES = ("jobs", "active", "done", "failed")
COMPACT_FILE = "_compact.jsonl"


class PublishError(RuntimeError):
    """A job outcome (done/failed file) could not be published. The job
    was requeued (or left leased for reclaim) — the worker should log
    and move on, never die on it."""


def worker_id() -> str:
    return f"{os.uname().nodename}-{os.getpid()}"


def backoff_s(key: str, attempts: int, *,
              base_s: float = DEFAULT_BACKOFF_S,
              cap_s: float = DEFAULT_BACKOFF_CAP_S) -> float:
    """Exponential retry backoff with deterministic jitter.

    ``base * 2^(attempts-1)`` capped at ``cap_s``, scaled by a jitter
    factor in [0.75, 1.25) keyed on ``(key, attempts)`` — a pure hash,
    so every host computes the same ``not_before`` for the same retry
    (records and replays stay deterministic) while distinct jobs
    de-synchronize instead of thundering back together."""
    if base_s <= 0.0 or attempts <= 0:
        return 0.0
    raw = min(base_s * (2.0 ** (attempts - 1)), cap_s)
    h = hashlib.sha256(f"{key}:{attempts}".encode()).digest()
    jitter = 0.75 + 0.5 * (int.from_bytes(h[:8], "big") / 2.0 ** 64)
    return raw * jitter


def _publish(directory: str, key: str, obj: Dict[str, Any], *,
             site: str = "publish-job", salt: int = 0) -> str:
    """Atomic in-place publish; the .tmp staging files are invisible to
    every listing (they all filter on the .json suffix). The active
    fault plan can inject slow-filesystem latency or a torn write (the
    final path holds truncated JSON and the call raises)."""
    path = os.path.join(directory, key + ".json")
    plan = faults.active_plan()
    if plan is not None:
        plan.sleep_fs()
        if plan.torn_write(site, key, salt):
            os.makedirs(directory, exist_ok=True)
            blob = json.dumps(obj, sort_keys=True, default=float)
            with open(path, "w") as f:
                f.write(blob[: max(1, len(blob) // 2)])
            raise faults.TornWrite(
                f"injected torn write at {site} for {key[:12]}")
    return atomic_write_json(path, obj, sort_keys=True)


@dataclass
class SpoolJob:
    """A claimed job: payload plus the active-file lease to heartbeat."""

    key: str
    payload: Dict[str, Any]
    active_path: str
    worker: str
    t_claim: float
    attempts: int = 0          # completed reclaim cycles before this claim

    def heartbeat(self) -> bool:
        """Refresh the lease; False if the job was reclaimed under us.
        An injected heartbeat stall silently stops refreshing (the
        worker thinks everything is fine — a paged-out process)."""
        plan = faults.active_plan()
        if plan is not None and plan.heartbeat_stalls(self.key,
                                                      self.attempts):
            return True
        try:
            os.utime(self.active_path)
            return True
        except FileNotFoundError:
            return False


class Spool:
    """One job spool rooted at a directory; see module docstring."""

    def __init__(self, root: str, *, lease_s: float = DEFAULT_LEASE_S,
                 retry_budget: int = DEFAULT_RETRY_BUDGET,
                 backoff_base_s: float = DEFAULT_BACKOFF_S,
                 backoff_cap_s: float = DEFAULT_BACKOFF_CAP_S):
        self.root = os.path.abspath(root)
        self.lease_s = lease_s
        self.retry_budget = retry_budget
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self._compact_cache: Tuple[Any, Dict[str, Dict[str, Any]]] = \
            (None, {})
        for d in _STATES:
            os.makedirs(os.path.join(self.root, d), exist_ok=True)

    def _dir(self, state: str) -> str:
        return os.path.join(self.root, state)

    def _list(self, state: str) -> List[str]:
        return sorted(f for f in os.listdir(self._dir(state))
                      if f.endswith(".json"))

    def _now(self) -> float:
        """The spool's clock — wall time through any injected skew."""
        return faults.now()

    # -- compacted done files ---------------------------------------------

    def _compact_path(self) -> str:
        return os.path.join(self._dir("done"), COMPACT_FILE)

    def _compact_index(self) -> Dict[str, Dict[str, Any]]:
        """Key -> done-dict for janitor-compacted results. Cached on the
        compact file's (mtime_ns, size) signature; torn tail lines (a
        janitor killed mid-append) are skipped, the file stays
        append-only so earlier lines are never at risk."""
        p = self._compact_path()
        try:
            st = os.stat(p)
        except OSError:
            return {}
        sig = (st.st_mtime_ns, st.st_size)
        if self._compact_cache[0] == sig:
            return self._compact_cache[1]
        idx: Dict[str, Dict[str, Any]] = {}
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(d, dict) and "key" in d:
                    idx[d["key"]] = d
        self._compact_cache = (sig, idx)
        return idx

    # -- producer side ----------------------------------------------------

    def submit(self, key: str, payload: Dict[str, Any]) -> bool:
        """Enqueue one job; no-op (False) if the key is already pending,
        claimed, or done — submission is idempotent. A ``failed`` entry
        from an earlier run is cleared and retried."""
        if os.path.exists(os.path.join(self._dir("jobs"), key + ".json")):
            return False
        if any(f.startswith(key + "@")
               for f in os.listdir(self._dir("active"))):
            return False
        if self.result(key) is not None:
            return False
        try:
            os.unlink(os.path.join(self._dir("failed"), key + ".json"))
        except FileNotFoundError:
            pass
        _publish(self._dir("jobs"), key,
                 {"key": key, "payload": payload})
        return True

    def result(self, key: str) -> Optional[Dict[str, Any]]:
        """The done-file dict for ``key`` (or None), looking through the
        janitor's compacted archive too. A torn done file (non-atomic
        filesystem) reads as *not finished* — the job stays claimable
        and the next complete atomically overwrites the wreckage."""
        p = os.path.join(self._dir("done"), key + ".json")
        try:
            with open(p) as f:
                d = json.load(f)
            if isinstance(d, dict) and "record" in d:
                return d
        except (FileNotFoundError, json.JSONDecodeError):
            pass
        return self._compact_index().get(key)

    def failure(self, key: str) -> Optional[Dict[str, Any]]:
        p = os.path.join(self._dir("failed"), key + ".json")
        try:
            with open(p) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def counts(self) -> Dict[str, int]:
        c = {state: len(self._list(state)) for state in _STATES}
        compact = self._compact_index()
        if compact:
            listed = {f[:-len(".json")] for f in self._list("done")}
            c["done"] += len(set(compact) - listed)
        return c

    def done_keys(self) -> set:
        """Keys with a published result — one listdir (plus the cached
        compact index), no per-key file reads."""
        keys = {f[:-len(".json")] for f in self._list("done")}
        keys.update(self._compact_index())
        return keys

    def failed_keys(self) -> set:
        return {f[:-len(".json")] for f in self._list("failed")}

    def next_retry_eta(self, now: Optional[float] = None
                       ) -> Optional[float]:
        """Seconds until the earliest backed-off pending job becomes
        claimable; None when no pending job is backed off."""
        now = now if now is not None else self._now()
        eta: Optional[float] = None
        for fname in self._list("jobs"):
            try:
                with open(os.path.join(self._dir("jobs"), fname)) as f:
                    nb = float(json.load(f).get("not_before", 0.0))
            except (OSError, json.JSONDecodeError, TypeError, ValueError):
                continue
            if nb > now and (eta is None or nb - now < eta):
                eta = nb - now
        return eta

    def status(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Operator view: state counts plus backoff/quarantine detail
        (``python -m repro_torch.exec status <spool>``)."""
        now = now if now is not None else self._now()
        st: Dict[str, Any] = dict(self.counts())
        backed_off = 0
        eta: Optional[float] = None
        for fname in self._list("jobs"):
            try:
                with open(os.path.join(self._dir("jobs"), fname)) as f:
                    d = json.load(f)
                nb = float(d.get("not_before", 0.0))
            except (OSError, json.JSONDecodeError, TypeError, ValueError):
                continue
            if nb > now:
                backed_off += 1
                if eta is None or nb - now < eta:
                    eta = nb - now
        quarantined = 0
        for fname in self._list("failed"):
            try:
                with open(os.path.join(self._dir("failed"), fname)) as f:
                    d = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            if int(d.get("attempts", 0)) > 0:
                quarantined += 1
        st["backed_off"] = backed_off
        st["next_retry_eta_s"] = eta
        st["quarantined"] = quarantined
        return st

    # -- worker side ------------------------------------------------------

    def claim(self, worker: Optional[str] = None) -> Optional[SpoolJob]:
        """Claim one pending job by atomic rename; None when empty.

        Honors retry backoff (``not_before`` in the job file), drops
        stale duplicates of finished jobs, quarantines corrupt job
        files and over-budget retries."""
        worker = worker or worker_id()
        now = self._now()
        for fname in self._list("jobs"):
            key = fname[:-len(".json")]
            src = os.path.join(self._dir("jobs"), fname)
            # peek for backoff before claiming — skipping must not cost
            # a rename round-trip
            try:
                with open(src) as f:
                    peek = json.load(f)
                nb = float(peek.get("not_before", 0.0))
            except FileNotFoundError:
                continue               # claimed/unlinked under us
            except (json.JSONDecodeError, TypeError, ValueError):
                nb = 0.0               # torn: claim it to quarantine below
            if nb > now:
                if REGISTRY.enabled:
                    REGISTRY.counter("spool.backoff_skips").inc()
                continue
            if self.result(key) is not None:
                # finished elsewhere (e.g. requeued by an over-eager
                # reclaim while its worker kept computing): drop it
                try:
                    os.unlink(src)
                except FileNotFoundError:
                    pass
                continue
            dst = os.path.join(self._dir("active"), f"{key}@{worker}.json")
            plan = faults.active_plan()
            if plan is not None:
                plan.sleep_fs()
            try:
                # rename preserves mtime and the job file's may already
                # be older than the lease (a resumed spool): restart the
                # lease clock BEFORE the rename so the active file is
                # never observable with a stale heartbeat
                os.utime(src)
                os.rename(src, dst)
                with open(dst) as f:
                    job_d = json.load(f)
                payload = job_d["payload"]
            except FileNotFoundError:
                continue               # lost the race for this job
            except (json.JSONDecodeError, KeyError):
                # torn job file (non-atomic producer fs): surface it as
                # a failure so a waiting backend fails fast instead of
                # hanging; resubmission retries the key
                _publish(self._dir("failed"), key,
                         {"key": key, "error": "corrupt job file",
                          "worker": worker, "t_failed": now},
                         site="publish-fail")
                os.unlink(dst)
                continue
            attempts = int(job_d.get("attempts", 0))
            if attempts > self.retry_budget:
                # requeue paths (failed publishes) bump attempts without
                # passing through reclaim — enforce the budget here too
                self._quarantine(key, worker=worker, attempts=attempts,
                                 now=now)
                try:
                    os.unlink(dst)
                except FileNotFoundError:
                    pass
                continue
            if REGISTRY.enabled:
                REGISTRY.counter("spool.jobs_claimed").inc()
            return SpoolJob(key=key, payload=payload, active_path=dst,
                            worker=worker, t_claim=now,
                            attempts=attempts)
        return None

    def complete(self, job: SpoolJob, record: Dict[str, Any], *,
                 wall_s: float) -> str:
        """Publish the result, then release the lease.

        Release-safe: a recoverable exception between the done publish
        and the release (the satellite crash-window) still releases; a
        *failed* done publish (torn write, full disk) requeues the job
        immediately — with a backoff and a bumped attempt counter —
        instead of leaking the claim until lease expiry, and raises
        ``PublishError`` so the worker logs and moves on. An injected
        hard crash (``InjectedCrash``/SIGKILL) runs neither path: the
        lease is left for reclaim, which is exactly what it models."""
        try:
            dst = _publish(
                self._dir("done"), job.key,
                {"key": job.key, "record": record, "worker": job.worker,
                 "wall_s": wall_s, "t_done": self._now()},
                site="publish-done", salt=job.attempts)
        except Exception as e:
            self._requeue(job)
            if REGISTRY.enabled:
                REGISTRY.counter("spool.publish_errors",
                                 site="publish-done").inc()
            raise PublishError(f"done publish failed for "
                               f"{job.key[:12]}: {e}") from e
        try:
            faults.crash_point("after-publish", job.key, job.attempts)
        except Exception:
            self._release(job)         # release-safe crash window
            raise
        self._release(job)
        return dst

    def fail(self, job: SpoolJob, error: str) -> str:
        """Publish a failure diagnosis, then release. Same
        release-safety contract as ``complete``."""
        try:
            dst = _publish(
                self._dir("failed"), job.key,
                {"key": job.key, "error": error, "worker": job.worker,
                 "t_failed": self._now()},
                site="publish-fail", salt=job.attempts)
        except Exception as e:
            self._requeue(job)
            if REGISTRY.enabled:
                REGISTRY.counter("spool.publish_errors",
                                 site="publish-fail").inc()
            raise PublishError(f"failure publish failed for "
                               f"{job.key[:12]}: {e}") from e
        self._release(job)
        return dst

    def _release(self, job: SpoolJob) -> None:
        try:
            os.unlink(job.active_path)
        except FileNotFoundError:
            pass                       # reclaimed while we worked: the
            #                            done/failed file still wins

    def _requeue(self, job: SpoolJob) -> bool:
        """Return a claimed job to ``jobs/`` with a bumped attempt
        counter and a backoff window. Best-effort: if even the requeue
        publish fails, the lease is left in place for reclaim (the
        last-resort recovery path) and False is returned."""
        attempts = job.attempts + 1
        now = self._now()
        entry = {"key": job.key, "payload": job.payload,
                 "attempts": attempts}
        b = backoff_s(job.key, attempts, base_s=self.backoff_base_s,
                      cap_s=self.backoff_cap_s)
        if b > 0:
            entry["not_before"] = now + b
        try:
            _publish(self._dir("jobs"), job.key, entry, salt=attempts)
        except Exception:
            return False
        self._release(job)
        if REGISTRY.enabled:
            REGISTRY.counter("spool.jobs_requeued").inc()
        return True

    def _quarantine(self, key: str, *, worker: str, attempts: int,
                    now: float, error: Optional[str] = None) -> None:
        _publish(self._dir("failed"), key,
                 {"key": key, "worker": worker, "t_failed": now,
                  "attempts": attempts,
                  "error": error or
                  f"retry budget exhausted: {attempts} attempts from "
                  f"dead/failing workers (budget {self.retry_budget}); "
                  f"quarantined as a poison job"},
                 site="publish-fail", salt=attempts)
        if REGISTRY.enabled:
            REGISTRY.counter("spool.jobs_quarantined").inc()

    # -- janitor duties ---------------------------------------------------

    def reclaim(self, *, lease_s: Optional[float] = None,
                now: Optional[float] = None) -> int:
        """Return orphaned active jobs (stale heartbeat) to ``jobs/``.

        Each reclaim cycle increments the job's ``attempts`` counter
        and stamps a ``not_before`` backoff; a job past
        ``retry_budget`` reclaims is quarantined to ``failed/`` (poison
        job: it keeps killing its workers) instead of being requeued
        forever. Quarantined jobs count toward the return value (they
        were taken off a dead worker)."""
        lease = lease_s if lease_s is not None else self.lease_s
        now = now if now is not None else self._now()
        n = 0
        for fname in self._list("active"):
            p = os.path.join(self._dir("active"), fname)
            try:
                age = now - os.stat(p).st_mtime
            except FileNotFoundError:
                continue
            if age <= lease:
                continue
            # partition, not split: a stray active file without an "@"
            # (shared-directory operator artifact) must not abort the
            # whole reclaim pass — it falls through to the corrupt-file
            # quarantine below
            key, _, worker = fname[:-len(".json")].partition("@")
            if self.result(key) is not None:
                # finished but the worker died before releasing the claim
                try:
                    os.unlink(p)
                except FileNotFoundError:
                    pass
                continue
            try:
                with open(p) as f:
                    job_d = json.load(f)
                attempts = int(job_d.get("attempts", 0)) + 1
            except FileNotFoundError:
                continue               # released/reclaimed under us
            except (json.JSONDecodeError, KeyError, ValueError):
                self._quarantine(key, worker=worker, attempts=0, now=now,
                                 error="corrupt active file")
                try:
                    os.unlink(p)
                except FileNotFoundError:
                    pass
                n += 1
                continue
            if attempts > self.retry_budget:
                self._quarantine(key, worker=worker, attempts=attempts,
                                 now=now)
            else:
                # requeue with the bumped counter and a retry backoff:
                # publish-then-unlink so a crash in between leaves a
                # claimable job file, never a lost one (claim() drops
                # stale duplicates)
                entry = {**job_d, "key": key, "attempts": attempts}
                b = backoff_s(key, attempts, base_s=self.backoff_base_s,
                              cap_s=self.backoff_cap_s)
                if b > 0:
                    entry["not_before"] = now + b
                else:
                    entry.pop("not_before", None)
                _publish(self._dir("jobs"), key, entry, salt=attempts)
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass
            n += 1
        if n and REGISTRY.enabled:
            REGISTRY.counter("spool.jobs_reclaimed").inc(n)
        return n


class SpoolBackend:
    """Refine through a ``Spool``, optionally spawning local workers.

    ``workers=N`` (N>=1) spawns N ``python -m repro_torch.exec worker --drain``
    subprocesses that exit when the queue empties; ``workers=0`` relies
    entirely on externally attached workers (detached daemons, other
    hosts on a shared filesystem). Either way the backend polls for
    completion, reclaims dead jobs, and respawns local drain workers
    (up to ``respawns``, default ``max(workers, 1)``) if its fleet dies
    with jobs still pending.

    **Stall fail-fast**: when jobs are pending but no worker is making
    heartbeat progress — the local fleet is dead with no respawns left
    and no external worker ever attached — the backend raises a
    diagnosable ``BackendError`` naming the spool root after
    ``stall_s`` seconds (default ``max(2*lease_s, 30)``) instead of
    spinning until ``timeout_s`` (default: forever). ``stall_s=0``
    disables the check.

    ``allow_partial=True`` (threaded through ``Backend.refine``)
    degrades failed/quarantined jobs into ``refine_failed`` records
    instead of aborting the whole batch with ``BackendError``.
    """

    name = "spool"

    def __init__(self, root: str, *, workers: int = 1,
                 lease_s: float = DEFAULT_LEASE_S, poll_s: float = 0.2,
                 timeout_s: Optional[float] = None,
                 respawns: Optional[int] = None,
                 stall_s: Optional[float] = None):
        self.root = root
        self.workers = workers
        self.lease_s = lease_s
        self.poll_s = poll_s
        self.timeout_s = timeout_s
        self.respawns = respawns if respawns is not None \
            else max(workers, 1)
        self.stall_s = stall_s if stall_s is not None \
            else max(2.0 * lease_s, 30.0)

    def _spawn_worker(self) -> subprocess.Popen:
        import repro_torch
        src = os.path.dirname(repro_torch.__path__[0])
        env = dict(os.environ)
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.exec", "worker", self.root],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def _heartbeat_mtime(self, spool: Spool) -> float:
        """Newest active-file mtime — external workers show up here."""
        latest = 0.0
        d = spool._dir("active")
        try:
            names = os.listdir(d)
        except OSError:
            return latest
        for f in names:
            try:
                latest = max(latest, os.stat(os.path.join(d, f)).st_mtime)
            except OSError:
                pass
        return latest

    def refine(self, payloads: List[Dict[str, Any]], *,
               keys: Optional[List[str]] = None,
               journal: Optional[Any] = None,
               cache: Optional[Any] = None,
               progress: Progress = None,
               allow_partial: bool = False) -> List[Dict[str, Any]]:
        if keys is None:
            from ..sweep.cache import content_key
            keys = [content_key(p) for p in payloads]
        spool = Spool(self.root, lease_s=self.lease_s)

        submitted = 0
        for key, payload in zip(keys, payloads):
            if spool.result(key) is None:  # resume: keep surviving results
                submitted += spool.submit(key, payload)
        if progress:
            progress(f"spool {self.root}: {submitted} submitted, "
                     f"{len(keys) - submitted} already queued/finished")

        procs = [self._spawn_worker() for _ in range(self.workers)]
        respawns_left = self.respawns
        pending = set(keys)
        collected: Dict[str, Dict[str, Any]] = {}
        journaled: set = set()
        t0 = time.time()
        t_report = t0
        t_progress = t0
        progress_sig: Tuple[Any, ...] = ()
        try:
            while pending:
                # one listdir per state per tick; files are read only
                # for newly resolved keys
                for key in sorted(pending & spool.done_keys()):
                    res = spool.result(key)
                    if res is None:
                        continue       # torn listing race; next tick
                    pending.discard(key)
                    collected[key] = res["record"]
                    if cache is not None:
                        # write-through: durable even if this runner
                        # dies before the batch completes
                        _cache_put(cache, key, res["record"])
                    if journal is not None and key not in journaled:
                        # batch-job records expand to per-point events
                        _journal_done(journal, key,
                                      worker=res.get("worker"),
                                      wall_s=res.get("wall_s"),
                                      rec=res["record"])
                        journaled.add(key)
                for key in sorted(pending & spool.failed_keys()):
                    fail = spool.failure(key)
                    if fail is None:
                        continue
                    pending.discard(key)
                    if journal is not None and key not in journaled:
                        journal.point(key, "failed",
                                      worker=fail.get("worker"),
                                      error=fail.get("error"))
                        journaled.add(key)
                if not pending:
                    break
                reclaimed = spool.reclaim()
                if reclaimed and journal is not None:
                    journal.janitor(worker="runner", reclaimed=reclaimed)
                procs = [p for p in procs if p.poll() is None]
                if (not procs and self.workers > 0 and respawns_left > 0
                        and spool.counts()["jobs"] > 0):
                    # local fleet died with work pending (e.g. a reclaim
                    # landed after the drain workers exited)
                    procs.append(self._spawn_worker())
                    respawns_left -= 1
                now = time.time()
                # stall detection: any resolution, worker heartbeat, or
                # upcoming backoff retry counts as progress
                sig = (len(pending), self._heartbeat_mtime(spool),
                       reclaimed)
                if sig != progress_sig or procs:
                    progress_sig = sig
                    t_progress = now
                eta = spool.next_retry_eta()
                if (self.stall_s and not procs
                        and now - t_progress > self.stall_s
                        and (eta is None or eta > self.stall_s)):
                    counts = spool.counts()
                    raise BackendError(
                        f"spool backend stalled: {len(pending)} point(s) "
                        f"pending with no live workers and no heartbeat "
                        f"progress for {self.stall_s:.0f}s "
                        f"(spool root: {self.root}; counts: {counts}) — "
                        f"attach workers with `python -m repro_torch.exec "
                        f"worker {self.root}` or start a janitor with "
                        f"`python -m repro_torch.exec janitor {self.root}`")
                if progress and now - t_report > 2.0:
                    done = len(keys) - len(pending)
                    progress(f"spool: {done}/{len(keys)} done "
                             f"({len(procs)} local workers)")
                    t_report = now
                if (self.timeout_s is not None
                        and now - t0 > self.timeout_s):
                    raise BackendError(
                        f"spool backend timed out after {self.timeout_s}s "
                        f"with {len(pending)} points pending "
                        f"(spool: {self.root})")
                time.sleep(self.poll_s)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()

        out: List[Dict[str, Any]] = []
        failures: List[str] = []
        for key in keys:
            rec = collected.get(key)
            if rec is None:
                fail = spool.failure(key) or {}
                err = fail.get("error", "?")
                if allow_partial:
                    out.append(failure_record(
                        err, worker=fail.get("worker", "spool")))
                    continue
                failures.append(f"{key[:12]}: {err}")
                continue
            out.append(rec)
        if failures:
            raise BackendError(
                f"{len(failures)} refinement(s) failed in spool "
                f"{self.root}: " + "; ".join(failures[:3]))
        return out
