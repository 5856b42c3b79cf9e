"""Campaign runner: pre-screen -> select -> cached backend refinement.

``run_campaign`` is the one entrypoint every sweep benchmark drives:

* expands the spec into structural cells,
* pre-screens each cell's full analytic sub-grid in one launch of the
  list-schedule kernel (on ``device``: the card unless told otherwise),
* selects the Pareto-interesting points per cell,
* refines only those on the ground-truth event engine + Power-EM through
  a pluggable execution **backend** (``repro_torch.exec``: inline / local
  process pool / resumable filesystem job spool) behind a content-hashed
  on-disk cache,
* journals per-point progress (status, wall time, worker id, cache-hit
  counters) to an append-only JSONL stream,
* returns uniform JSON-ready campaign records that ``benchmarks/report``
  renders and downstream analyses (DVFS policy picks, scaling summaries)
  post-process.

Records are canonicalized through a JSON round-trip before they enter a
result, so inline, pool, and spool backends — and cached re-runs —
produce byte-identical campaign records for the same spec.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

# fresh records are canonicalized (JSON round-trip, sorted keys) so
# in-memory results match cache/spool-served ones byte-for-byte
from ..exec.backend import Backend, canonical as _canon, get_backend, \
    is_failure_record
from ..core.vectorized import Device
from ..exec.journal import CampaignJournal
from ..hw.presets import to_dict
from ..obs.metrics import REGISTRY
from ..serve.fleet import serve_payload
from .cache import ResultCache, content_key
from .pareto import select_points
from .prescreen import prescreen_cell
from .refine import plan_batches, refine_payload
from .spec import SweepSpec

__all__ = ["CampaignResult", "run_campaign", "save_result", "load_result",
           "default_spool_dir", "annotate_hlo_crosscheck"]

RESULT_SCHEMA = 1


def _best(records: List[Dict[str, Any]], key: str
          ) -> Optional[Dict[str, Any]]:
    """Deterministic argmin over refined records: ties on the metric are
    broken by grid index, so reports are stable across runs/backends.
    Serving-fleet records are excluded — their metrics (fleet energy,
    request latency) are not comparable to per-inference ones; the
    summary ranks them separately (``best_goodput_point``)."""
    refined = [r for r in records
               if r.get("refined") and key in r and not r.get("serve")]
    if not refined:
        return None
    return min(refined,
               key=lambda r: (r[key], r.get("grid_index", len(records))))


@dataclass
class CampaignResult:
    spec: Dict[str, Any]
    records: List[Dict[str, Any]]
    summary: Dict[str, Any]
    schema: int = RESULT_SCHEMA

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @property
    def refined(self) -> List[Dict[str, Any]]:
        return [r for r in self.records if r["refined"]]

    def best(self, key: str = "time_ns") -> Optional[Dict[str, Any]]:
        return _best(self.records, key)


def save_result(res: CampaignResult, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(res.to_dict(), f, indent=1, default=float)
    return path


def load_result(path: str) -> CampaignResult:
    with open(path) as f:
        d = json.load(f)
    return CampaignResult(spec=d["spec"], records=d["records"],
                          summary=d["summary"],
                          schema=d.get("schema", RESULT_SCHEMA))


def default_spool_dir(campaign: str, cache_dir: Optional[str]) -> str:
    """Deterministic spool location so an interrupted campaign and its
    re-invocation agree on where surviving jobs/results live."""
    root = os.path.dirname(cache_dir) if cache_dir else "."
    return os.path.join(root, "spool", campaign)


def _log(progress: Optional[Callable[[str], None]], msg: str) -> None:
    if progress:
        progress(msg)




def _resolve_backend(backend: Union[str, Backend, None],
                     workers: Optional[int], spec: SweepSpec,
                     cache_dir: Optional[str],
                     spool_dir: Optional[str]) -> Backend:
    if backend is not None and not isinstance(backend, str):
        return backend
    if backend is None:
        # legacy ``workers`` semantics: 0/1 inline, else local pool
        backend = "inline" if workers is not None and workers <= 1 else "pool"
    if backend == "spool" and not spool_dir:
        spool_dir = default_spool_dir(spec.name, cache_dir)
    return get_backend(backend, workers=workers, spool_dir=spool_dir)


def annotate_hlo_crosscheck(records: List[Dict[str, Any]]
                            ) -> Optional[Dict[str, Any]]:
    """Pair every ingested ``hlo/<fixture>`` record with its hand-built
    twin record at the same (overrides, n_tiles) point and attach the
    deviation ratios the differential harness asserts on.

    Each paired record gains ``hlo_twin`` (the twin workload name) and
    ``hlo_deviation`` — analytic-latency / FLOP / HBM-byte ratios
    (ingested over hand-built), a refined-latency ratio when both points
    were refined, the fixture's documented band from the manifest, and
    the in-band verdict. Returns the per-fixture summary (cells checked,
    in-band count, ratio extrema) or None when the campaign pairs
    nothing — ``run_campaign`` runs this after refinement on every
    campaign, so crosscheck results land in records/summary/golden
    fixtures uniformly across backends.
    """
    from ..graph import ingest

    def pt_key(workload: str, rec: Dict[str, Any]) -> str:
        return json.dumps([workload, rec["overrides"], rec["n_tiles"]],
                          sort_keys=True)

    by_key = {pt_key(r["workload"], r): r for r in records}
    summary: Dict[str, Any] = {}
    for rec in records:
        h = ingest.parse_hlo_name(rec["workload"])
        if h is None or h["layers_keep"] is not None:
            continue
        try:
            meta = ingest.fixture_meta(h["fixture"])
        except KeyError:
            continue                       # fixture gone: nothing to pair
        twin = by_key.get(pt_key(meta["twin"], rec))
        if twin is None:
            continue
        band = meta.get("band")

        def ratio(key: str) -> Optional[float]:
            a, b = rec.get(key), twin.get(key)
            if a is None or not b:
                return None
            return float(a) / float(b)

        dev: Dict[str, Any] = {
            "analytic_ratio": ratio("analytic_time_ns"),
            "flops_ratio": ratio("total_flops"),
            "hbm_ratio": ratio("hbm_bytes"),
            "band": band,
        }
        if rec.get("refined") and twin.get("refined"):
            dev["refined_ratio"] = ratio("time_ns")
        dev["in_band"] = (band is not None and dev["analytic_ratio"]
                          is not None and
                          band[0] <= dev["analytic_ratio"] <= band[1])
        rec["hlo_twin"] = meta["twin"]
        rec["hlo_deviation"] = dev
        s = summary.setdefault(h["fixture"], {
            "twin": meta["twin"], "band": band, "cells": 0, "in_band": 0,
            "analytic_ratio_min": None, "analytic_ratio_max": None})
        s["cells"] += 1
        s["in_band"] += int(dev["in_band"])
        r = dev["analytic_ratio"]
        if r is not None:
            s["analytic_ratio_min"] = (r if s["analytic_ratio_min"] is None
                                       else min(s["analytic_ratio_min"], r))
            s["analytic_ratio_max"] = (r if s["analytic_ratio_max"] is None
                                       else max(s["analytic_ratio_max"], r))
    return summary or None


def run_campaign(spec: SweepSpec, *, workers: Optional[int] = 0,
                 use_cache: bool = True,
                 cache_dir: Optional[str] = None,
                 progress: Optional[Callable[[str], None]] = None,
                 backend: Union[str, Backend, None] = None,
                 spool_dir: Optional[str] = None,
                 journal_path: Optional[str] = None,
                 allow_partial: bool = False,
                 device: Device = None) -> CampaignResult:
    """Execute one campaign.

    ``backend`` picks the refinement execution service: ``"inline"``
    (deterministic, test-friendly), ``"pool"`` (``workers`` local
    processes; None = one per core), ``"spool"`` (resumable filesystem
    job queue at ``spool_dir``, drained by ``workers`` spawned daemons
    plus any externally attached ``python -m repro_torch.exec worker``),
    or a ready ``repro_torch.exec`` Backend instance. When ``backend`` is
    None the legacy ``workers`` convention applies: 0/1 inline, else pool.
    Refinement is numpy only and never touches the card, so the pool may
    fork its workers after the pre-screen has initialised CUDA.

    The cache (``cache_dir`` or ``spec.cache_dir``) makes repeated and
    interrupted campaigns incremental; ``journal_path`` streams
    per-point status/wall-time/worker telemetry as JSONL.

    ``allow_partial=True`` is graceful degradation: a point whose
    refinement fails (or is quarantined as a poison job by the spool)
    becomes a ``status: "failed"`` record with the error attached
    instead of a ``BackendError`` aborting the whole campaign; the
    summary reports ``failed``/``coverage``/``failed_points`` so
    reports can annotate what's missing.

    ``device`` is where the pre-screen runs: None (the card) or "cpu"
    (the list schedule's plain version); the records are the same bits.
    """
    t_start = time.time()
    cells = spec.cells()
    cdir = cache_dir or spec.cache_dir
    cache = ResultCache(cdir) if (use_cache and cdir) else None
    bk = _resolve_backend(backend, workers, spec, cdir, spool_dir)
    journal = CampaignJournal(journal_path) if journal_path else None

    # -- phase 1: batched analytic pre-screen (one launch per part) -------
    t0 = time.time()
    screens = []
    part_memo: Dict[Any, Any] = {}     # full-model body/head screens are
    #                                    shared across cells (layers axis)
    for cell in cells:
        scr = prescreen_cell(cell, memo=part_memo, device=device)
        screens.append(scr)
        _log(progress, f"prescreen {cell.label}: {len(cell.points)} points "
             f"in one kernel launch ({scr.wall_s:.2f}s)")
    prescreen_s = time.time() - t0

    # -- phase 2: Pareto selection per cell ------------------------------
    records: List[Dict[str, Any]] = []
    todo: List[Dict[str, Any]] = []        # refinement payload per record
    todo_idx: List[int] = []               # record index per payload
    for scr in screens:
        cell = scr.cell
        obj = np.stack([scr.time_ns, scr.energy_j], axis=1)
        picked = set(select_points(obj, mode=spec.refine.mode,
                                   max_points=spec.refine.max_points))
        for i, pt in enumerate(cell.points):
            cfg = pt.cfg(spec)
            rec: Dict[str, Any] = {
                "point_id": pt.point_id(),
                "grid_index": len(records),
                "campaign": spec.name,
                "workload": pt.workload,
                "n_tiles": pt.n_tiles,
                "overrides": dict(pt.overrides),
                "hw_name": cfg.name,
                "analytic_time_ns": float(scr.time_ns[i]),
                "analytic_inf_per_s": float(1e9 / scr.time_ns[i])
                if scr.time_ns[i] > 0 else 0.0,
                "analytic_avg_w": float(scr.avg_w[i]),
                "analytic_energy_j": float(scr.energy_j[i]),
                # cell-level compiled-workload intensity: weights+spill
                # HBM traffic vs total flops — decode points sit far
                # below prefill points (memory-bound regime)
                "total_flops": scr.total_flops,
                "hbm_bytes": scr.hbm_bytes,
                "flops_per_byte": (scr.total_flops / scr.hbm_bytes
                                   if scr.hbm_bytes > 0 else 0.0),
                "selected": i in picked,
                "refined": False,
                "cached": False,
            }
            if i in picked:
                payload = refine_payload(
                    workload=pt.workload, n_tiles=pt.n_tiles,
                    hw=to_dict(cfg), compile_opts=dict(spec.compile_opts),
                    pti_ns=spec.refine.pti_ns, temp_c=spec.refine.temp_c,
                    keep_series=spec.refine.keep_series,
                    engine=spec.refine.engine)
                todo.append(payload)
                todo_idx.append(len(records))
            records.append(rec)
        _log(progress, f"select {cell.label}: {len(picked)}/"
             f"{len(cell.points)} points for event-engine refinement")

    # -- phase 2b: serving-fleet cells -----------------------------------
    # serve_grid points bypass the analytic pre-screen (their metric is
    # request-level, not step-level): every one becomes a `kind: "serve"`
    # refinement payload and flows through the same backend/cache/journal
    # machinery as classic points
    serve_pts = spec.serve_points()
    if serve_pts:
        cfg = spec.hw_config({})
        hw = to_dict(cfg)
        nt = spec.n_tiles[0]
        for sp in serve_pts:
            rec = {
                "point_id": sp.point_id(),
                "grid_index": len(records),
                "campaign": spec.name,
                "workload": sp.workload,
                "n_tiles": nt,
                "overrides": dict(sp.overrides),
                "hw_name": cfg.name,
                "selected": True,
                "refined": False,
                "cached": False,
            }
            todo.append(serve_payload(
                workload=sp.workload, n_tiles=nt, hw=hw,
                temp_c=spec.refine.temp_c,
                compile_opts=dict(spec.compile_opts), **sp.params))
            todo_idx.append(len(records))
            records.append(rec)
        _log(progress, f"serve: {len(serve_pts)} fleet cells queued "
             f"for trace-driven simulation")

    # -- phase 3: cached backend refinement ------------------------------
    t0 = time.time()
    keys = [content_key(p) for p in todo]
    if journal:
        journal.start(campaign=spec.name, backend=bk.name,
                      grid_points=len(records), to_refine=len(todo))
    cache_hits = 0
    misses: List[int] = []                 # indices into todo
    results: List[Optional[Dict[str, Any]]] = [None] * len(todo)
    if cache is not None:
        for i, key in enumerate(keys):
            hit = cache.get(key)
            if hit is not None:
                results[i] = hit
                records[todo_idx[i]]["cached"] = True
                cache_hits += 1
                if journal:
                    journal.point(
                        key, "cached",
                        point_id=records[todo_idx[i]]["point_id"])
            else:
                misses.append(i)
    else:
        misses = list(range(len(todo)))

    if misses:
        # keyword passed only when set, so minimal Backend stand-ins
        # (tests, external plugins) predating allow_partial keep working
        bk_extra = {"allow_partial": True} if allow_partial else {}
        batch_n = spec.refine.batch
        if batch_n > 1:
            # batched cross-point refinement: group fast-engine misses
            # by structural class into batch jobs (deterministic — grid
            # order in and out); batch records expand back to per-point
            # results here and to per-point cache/journal entries in
            # the backends
            jobs = plan_batches([todo[i] for i in misses], batch_n)
            job_payloads = [jp for jp, _ in jobs]
            job_keys = [content_key(jp) if jp.get("kind") == "batch"
                        else keys[misses[pos[0]]] for jp, pos in jobs]
            n_batched = sum(len(pos) for jp, pos in jobs
                            if jp.get("kind") == "batch")
            _log(progress,
                 f"refine: {len(misses)} points via {bk.name} backend "
                 f"({n_batched} batched into "
                 f"{sum(1 for jp, _ in jobs if jp.get('kind') == 'batch')}"
                 f" jobs of <= {batch_n}, "
                 f"{len(misses) - n_batched} single)")
            if REGISTRY.enabled:
                REGISTRY.counter("runner.batch_jobs",
                                 backend=bk.name).inc(len(jobs))
            fresh = bk.refine(job_payloads, keys=job_keys,
                              journal=journal, cache=cache,
                              progress=progress, **bk_extra)
            for (jp, pos), rec in zip(jobs, fresh):
                if rec.get("kind") == "batch":
                    for p_i, sub in zip(pos, rec["records"]):
                        results[misses[p_i]] = _canon(sub)
                elif is_failure_record(rec):
                    # a failed batch job degrades every point it carried
                    for p_i in pos:
                        results[misses[p_i]] = _canon(rec)
                else:
                    results[misses[pos[0]]] = _canon(rec)
        else:
            _log(progress,
                 f"refine: {len(misses)} points via {bk.name} backend")
            # the backend owns cache write-through (each record is
            # persisted as soon as it is refined, not after the batch)
            # — no second put
            fresh = bk.refine([todo[i] for i in misses],
                              keys=[keys[i] for i in misses],
                              journal=journal, cache=cache,
                              progress=progress, **bk_extra)
            for i, rec in zip(misses, fresh):
                results[i] = _canon(rec)
    refine_s = time.time() - t0
    if REGISTRY.enabled:
        REGISTRY.counter("runner.cache_hits", backend=bk.name
                         ).inc(cache_hits)
        REGISTRY.counter("runner.cache_misses", backend=bk.name
                         ).inc(len(misses))

    deviations = []
    failed_points: List[str] = []
    for i, res in enumerate(results):
        assert res is not None
        rec = records[todo_idx[i]]
        if is_failure_record(res):
            # graceful degradation: the point is terminal-but-failed;
            # `refined` stays False so _best/reports skip it, and the
            # diagnosis travels with the record
            rec["status"] = "failed"
            rec["failed"] = True
            rec["error"] = res.get("error", "?")
            failed_points.append(rec["point_id"])
            continue
        rec.update(res)
        rec["refined"] = True
        if rec.get("analytic_time_ns", 0) > 0:
            rec["deviation"] = rec["time_ns"] / rec["analytic_time_ns"]
            deviations.append(rec["deviation"])
    _log(progress, f"refine: {len(todo)} points "
         f"({cache_hits} cache hits, {len(misses)} simulated, "
         f"{len(failed_points)} failed, {refine_s:.2f}s)")

    hlo_xck = annotate_hlo_crosscheck(records)
    if hlo_xck:
        for fx, s in sorted(hlo_xck.items()):
            _log(progress, f"hlo crosscheck {fx}: {s['in_band']}/"
                 f"{s['cells']} cells in band {s['band']}")

    summary = {
        "grid_points": len(records),
        "serve_points": len(serve_pts),
        "cells": len(cells),
        "prescreen_calls": len(cells),
        "backend": bk.name,
        "refined": len(todo),
        "cache_hits": cache_hits,
        "simulated": len(misses),
        "prescreen_s": prescreen_s,
        "refine_s": refine_s,
        "wall_s": time.time() - t_start,
        "deviation_min": min(deviations) if deviations else None,
        "deviation_max": max(deviations) if deviations else None,
    }
    if failed_points:
        summary["failed"] = len(failed_points)
        summary["failed_points"] = failed_points
        summary["coverage"] = ((len(todo) - len(failed_points))
                               / len(todo) if todo else 1.0)
    if hlo_xck:
        summary["hlo_crosscheck"] = hlo_xck
    best = _best(records, "time_ns")
    if best is not None:
        summary["best_time_point"] = {
            "point_id": best["point_id"], "workload": best["workload"],
            "overrides": best["overrides"], "time_ns": best["time_ns"]}
        beste = _best(records, "energy_j")
        summary["best_energy_point"] = {
            "point_id": beste["point_id"], "workload": beste["workload"],
            "overrides": beste["overrides"], "energy_j": beste["energy_j"]}
    serve_recs = [r for r in records
                  if r.get("refined") and r.get("serve")]
    if serve_recs:
        bg = max(serve_recs,
                 key=lambda r: (r["goodput_rps"], -r["grid_index"]))
        summary["best_goodput_point"] = {
            "point_id": bg["point_id"], "workload": bg["workload"],
            "overrides": bg["overrides"],
            "goodput_rps": bg["goodput_rps"], "chips": bg["chips"],
            "energy_per_req_j": bg["energy_per_req_j"]}
    if cache is not None:
        cache.log_stats(campaign=spec.name)
    if journal:
        journal.end({k: summary[k] for k in
                     ("grid_points", "refined", "cache_hits", "simulated",
                      "backend", "wall_s")})
        # the same fold that powers `exec status --watch`: phase rates,
        # per-worker totals, ETA (0 — the campaign just finished)
        from ..obs.progress import CampaignProgress
        summary["progress"] = CampaignProgress.from_file(
            journal.path).summary()
    return CampaignResult(spec=spec.to_dict(), records=records,
                          summary=summary)
