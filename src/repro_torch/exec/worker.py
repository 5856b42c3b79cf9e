"""Spool worker: claim -> heartbeat -> refine -> publish, in a loop.

``run_worker`` is the whole daemon; ``python -m repro_torch.exec worker
<spool>`` wraps it. Two modes:

* ``drain=True``  — exit once the queue is empty (the mode the
  ``SpoolBackend`` uses for the workers it spawns itself);
* ``drain=False`` — keep polling forever (a detached daemon that
  outlives any single campaign; new jobs are picked up as they appear).

While a refinement runs, a daemon thread refreshes the job's lease every
``hb_s`` seconds so long simulations survive the spool's dead-job
reclamation; a worker that is SIGKILLed simply stops heartbeating and
its job is reclaimed by someone else after ``lease_s``.

The claim->publish lifecycle is threaded with the named crash-points
from ``exec.faults`` (``after-claim``, ``mid-refine``,
``before-publish``; ``after-publish`` lives inside
``Spool.complete``), which is how the chaos suite kills a worker at
every interesting instant. A simulated kill (``InjectedCrash``) tears
down only the heartbeat thread — a real SIGKILL would take that down
too — and deliberately leaks the lease for reclaim to recover, exactly
like the real failure it models. A failed outcome *publish*
(``PublishError``) is never fatal: the spool already requeued the job,
the worker logs and moves on.

The import path is jax-free (``repro_torch.sweep.refine``), so worker startup
is milliseconds, not an XLA initialization.
"""
from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

from ..obs.metrics import REGISTRY
from . import faults
from .spool import PublishError, Spool, SpoolJob, worker_id

__all__ = ["run_worker"]


def _heartbeat_loop(job: SpoolJob, stop: threading.Event,
                    hb_s: float) -> None:
    while not stop.wait(hb_s):
        if not job.heartbeat():
            return                     # reclaimed under us; stop touching


def _stop_hb(stop: threading.Event, hb: threading.Thread,
             hb_s: float) -> None:
    stop.set()
    if hb.ident is not None:           # never started if we crashed early
        hb.join(timeout=hb_s + 1)


def run_worker(root: str, *, drain: bool = True, poll_s: float = 0.5,
               hb_s: float = 5.0, max_jobs: Optional[int] = None,
               worker: Optional[str] = None,
               refine_fn: Optional[Callable[[Dict[str, Any]],
                                            Dict[str, Any]]] = None,
               log: Optional[Callable[[str], None]] = None,
               spool: Optional[Spool] = None) -> int:
    """Drain (or follow) a spool; returns the number of jobs completed.

    ``refine_fn`` is injectable for tests; the default is the real
    refinement entrypoint (``repro_torch.sweep.refine.refine_point``), which
    honors each payload's ``engine`` field — jobs spooled by a
    ``refine.engine="fast"`` campaign run on the fastsim engine here
    too, whichever host drains them. ``spool`` injects a
    pre-configured ``Spool`` (non-default lease/backoff — the chaos
    suite); default is ``Spool(root)``.
    """
    if refine_fn is None:
        from ..sweep.refine import refine_point
        refine_fn = refine_point
    spool = spool or Spool(root)
    wid = worker or worker_id()
    n_done = 0
    while True:
        job = spool.claim(wid)
        if job is None:
            # maybe a dead worker holds the remaining jobs
            reclaimed = spool.reclaim()
            if reclaimed:
                continue
            if drain:
                eta = spool.next_retry_eta()
                if eta is not None:
                    # backed-off retries still pending: a drain worker
                    # waits them out instead of stranding them
                    time.sleep(min(max(eta, 0.01), poll_s))
                    continue
                break
            time.sleep(poll_s)
            continue
        if log:
            log(f"[{wid}] claim {job.key[:12]} (attempt {job.attempts})")
        stop = threading.Event()
        hb = threading.Thread(target=_heartbeat_loop, args=(job, stop, hb_s),
                              daemon=True)
        t0 = time.time()
        try:
            faults.crash_point("after-claim", job.key, job.attempts)
            hb.start()
            faults.crash_point("mid-refine", job.key, job.attempts)
            record = refine_fn(job.payload)
            faults.crash_point("before-publish", job.key, job.attempts)
        except Exception:
            err = traceback.format_exc(limit=8)
            _stop_hb(stop, hb, hb_s)
            try:
                spool.fail(job, err)
            except PublishError:
                pass                   # requeued; someone retries it
            if REGISTRY.enabled:
                REGISTRY.counter("worker.jobs_failed").inc()
            if log:
                log(f"[{wid}] FAIL {job.key[:12]}")
            continue
        except BaseException:
            # simulated kill (or genuine KeyboardInterrupt): stop the
            # lease keep-alive — a real SIGKILL takes the heartbeat
            # thread down with the process — but do NOT release the
            # lease; reclaim is the recovery path being modeled
            _stop_hb(stop, hb, hb_s)
            raise
        _stop_hb(stop, hb, hb_s)
        try:
            spool.complete(job, record, wall_s=time.time() - t0)
        except PublishError:
            if log:
                log(f"[{wid}] PUBLISH-FAIL {job.key[:12]} (requeued)")
            continue
        except Exception:
            # the done file IS published and the lease released
            # (complete's release-safe crash window) — the job counts
            pass
        if REGISTRY.enabled:
            REGISTRY.counter("worker.jobs_done").inc()
        n_done += 1
        if log:
            log(f"[{wid}] done {job.key[:12]} ({time.time() - t0:.2f}s)")
        if max_jobs is not None and n_done >= max_jobs:
            break
    return n_done
