"""Process-pool backend — today's parallel path, extracted from the
campaign runner into a ``Backend``.

Uses ``fork`` where available: the refinement import path is jax-free
(``repro_torch.sweep.refine``), so forked workers never re-enter jax/XLA and
start in milliseconds. Falls back to inline refinement when the pool
cannot start (e.g. ``spawn`` re-importing an unguarded ``__main__``) —
refinement is pure, so the records are identical either way.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import time
import warnings
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Any, Dict, List, Optional

from .backend import Progress, _cache_put, _journal_done, \
    failure_record, is_failure_record

__all__ = ["PoolBackend", "mp_start_method"]


def mp_start_method() -> str:
    """Worker start method; override with ``SWEEP_MP_CONTEXT``."""
    env = os.environ.get("SWEEP_MP_CONTEXT")
    if env:
        return env
    return "fork" if "fork" in mp.get_all_start_methods() else "spawn"


class PoolBackend:
    """Refine on a local ``ProcessPoolExecutor``."""

    name = "pool"

    def __init__(self, workers: Optional[int] = None):
        # None -> one process per core (ProcessPoolExecutor default-ish)
        self.workers = workers if workers is not None else (os.cpu_count()
                                                            or 1)

    def refine(self, payloads: List[Dict[str, Any]], *,
               keys: Optional[List[str]] = None,
               journal: Optional[Any] = None,
               cache: Optional[Any] = None,
               progress: Progress = None,
               allow_partial: bool = False) -> List[Dict[str, Any]]:
        from ..sweep.refine import refine_point

        keys = keys or [None] * len(payloads)
        fresh: Optional[List[Dict[str, Any]]] = None
        t0 = time.time()
        if self.workers > 1 and len(payloads) > 1:
            try:
                ctx = mp.get_context(mp_start_method())
                with warnings.catch_warnings():
                    # jax warns about fork+threads; refinement workers
                    # never re-enter jax/XLA (refine.py is jax-free)
                    warnings.filterwarnings(
                        "ignore", message=".*os.fork.*",
                        category=RuntimeWarning)
                    with ProcessPoolExecutor(
                            max_workers=min(self.workers, len(payloads)),
                            mp_context=ctx) as pool:
                        # submit (not map): per-future results so one
                        # failed point can degrade instead of poisoning
                        # the whole ordered stream
                        futs = [pool.submit(refine_point, p)
                                for p in payloads]
                        fresh = []
                        # consume in order so each record is
                        # cache-durable before the batch finishes
                        for key, fut in zip(keys, futs):
                            try:
                                rec = fut.result()
                            except BrokenProcessPool:
                                raise
                            except Exception as e:
                                if not allow_partial:
                                    raise
                                rec = failure_record(e, worker=self.name)
                            _cache_put(cache, key, rec)
                            fresh.append(rec)
            except BrokenProcessPool:
                if progress:
                    progress("worker pool unavailable; refining inline")
                fresh = None
        if fresh is None:
            fresh = []
            for key, p in zip(keys, payloads):
                try:
                    rec = refine_point(p)
                except Exception as e:
                    if not allow_partial:
                        raise
                    rec = failure_record(e, worker=self.name)
                _cache_put(cache, key, rec)
                fresh.append(rec)
        # the futures give no per-point timing; journal the batch
        # average (batch-job records expand to per-point events inside)
        avg = (time.time() - t0) / max(len(payloads), 1)
        for key, rec in zip(keys, fresh):
            if is_failure_record(rec):
                if journal is not None and key is not None:
                    journal.point(key, "failed", worker=self.name,
                                  error=rec["error"])
                continue
            _journal_done(journal, key, worker=self.name, wall_s=avg,
                          rec=rec)
        return fresh
