"""Ground-truth refinement of one grid point (event engine + Power-EM).

Kept in its own module with **no jax imports anywhere on its import
path** so parallel refinement workers (``spawn`` context) start in
milliseconds instead of re-initializing XLA per process.

A refinement payload carries an ``engine`` field:

* ``"event"`` — the classic path: compile, walk the full task list on
  the generator-driven event engine, Power-EM the tracer.
* ``"fast"``  — ``core.fastsim``: exact interval replay with
  steady-state layer extrapolation for full-model LM workloads (replay
  a reduced-layer twin, verify periodicity, synthesize the rest in
  arrays), exact full replay otherwise. Records are byte-identical to
  ``"event"`` whenever fastsim replays (it *is* the event engine then);
  extrapolated points agree to float-rounding noise.
* ``"auto"``  — ``"fast"`` for layered full-model workloads with at
  least ``fastsim.FAST_MIN_LAYERS`` layers (where extrapolation pays),
  ``"event"`` for everything else.

The field is part of the payload, so it travels through every
``repro_torch.exec`` backend unchanged and lands in the result-cache content
key — switching engines never serves a stale record.

A payload may instead carry ``kind: "serve"``: a
serving-fleet cell (``serve.fleet.simulate_serve_point`` — trace-driven
continuous batching over analytic step costs). The kind field routes it
here and keys the cache, so serve cells flow through every backend, the
journal, and the result cache exactly like classic refinements.

A payload may carry ``kind: "batch"``: many classic
fast-engine points refined as one job (``refine_batch``), grouped by
structural class so points differing only along latency-rescaling
hardware axes share compiles, event-engine twin replays, and — when the
dead-axis analysis proves the records identical — the records
themselves (``core.batchsim``). The batch record is expanded back into
per-point cache entries and journal events by ``exec.backend``, so
downstream consumers never see the batching.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core import batchsim, fastsim
from ..graph import ingest
from ..graph.compiler import CompileOptions, CompiledWorkload, compile_ops
from ..graph.workloads import lm_workload_name, parse_lm_name, \
    resolve_workload
from ..hw.chip import System
from ..hw.presets import HwConfig, from_dict
from ..obs.metrics import REGISTRY
from ..power.powerem import PowerEM
from .cache import content_key
from .spec import ANALYTIC_AXES

__all__ = ["refine_point", "refine_payload", "resolve_engine",
           "crosscheck_point", "ENGINES", "batch_payload", "plan_batches",
           "refine_batch"]

ENGINES = ("event", "fast", "auto")


def refine_payload(*, workload: str, n_tiles: int, hw: Dict[str, Any],
                   compile_opts: Dict[str, Any], pti_ns: float,
                   temp_c: float, keep_series: bool,
                   engine: str = "event") -> Dict[str, Any]:
    """The cache-keyed, process-picklable input of one refinement."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    return {"workload": workload, "n_tiles": n_tiles, "hw": hw,
            "compile_opts": compile_opts, "pti_ns": pti_ns,
            "temp_c": temp_c, "keep_series": keep_series, "engine": engine}


def resolve_engine(engine: str, workload: str) -> str:
    """Collapse ``auto`` to a concrete engine for one workload."""
    if engine != "auto":
        return engine
    h = ingest.parse_hlo_name(workload)
    if h is not None:
        layers = _hlo_layers(h)
        return "fast" if layers >= fastsim.FAST_MIN_LAYERS else "event"
    try:
        p = parse_lm_name(workload)
    except KeyError:
        p = None
    if p and p["layers"] and p["layers"] >= fastsim.FAST_MIN_LAYERS:
        return "fast"
    return "event"


def _hlo_layers(parsed: Dict[str, Any]) -> int:
    """Layer-block count of a parsed ``hlo/...`` name (0 when the
    fixture is unknown — resolution will fail loudly later anyway)."""
    if parsed["layers_keep"] is not None:
        return parsed["layers_keep"]
    try:
        return int(ingest.fixture_meta(parsed["fixture"]).get("layers", 0))
    except KeyError:
        return 0


def _compile(payload: Dict[str, Any]) -> Tuple[HwConfig, int,
                                               CompiledWorkload]:
    cfg = from_dict(payload["hw"])
    nt = payload["n_tiles"]
    ops = resolve_workload(payload["workload"])()
    cw = compile_ops(ops, cfg,
                     CompileOptions(n_tiles=nt, **payload["compile_opts"]))
    return cfg, nt, cw


def _reduced_workloads(workload: str) -> List[str]:
    """Reduced-layer replay-twin names, shallow first (the warmup
    transient varies with phase AND problem size, so a shallow attempt
    that fails its lock-in check retries deeper); empty when the
    workload is not an extrapolation candidate."""
    h = ingest.parse_hlo_name(workload)
    if h is not None:
        if h["layers_keep"] is not None:      # already a reduced twin
            return []
        layers = _hlo_layers(h)
        if layers < fastsim.FAST_MIN_LAYERS:
            return []
        phase = ""
        try:
            phase = ingest.fixture_meta(h["fixture"]).get("phase", "")
        except KeyError:
            pass
        depths = [fastsim.FAST_REPLAY_LAYERS_BY_PHASE.get(
            phase, fastsim.FAST_REPLAY_LAYERS)]
        if fastsim.FAST_REPLAY_LAYERS not in depths:
            depths.append(fastsim.FAST_REPLAY_LAYERS)
        return [ingest.hlo_workload_name(h["fixture"], layers=r)
                for r in depths if r < layers]
    try:
        p = parse_lm_name(workload)
    except KeyError:
        return []
    if not p or not p["layers"] or p["layers"] < fastsim.FAST_MIN_LAYERS:
        return []
    depths = [fastsim.FAST_REPLAY_LAYERS_BY_PHASE.get(
        p["phase"], fastsim.FAST_REPLAY_LAYERS)]
    if fastsim.FAST_REPLAY_LAYERS not in depths:
        depths.append(fastsim.FAST_REPLAY_LAYERS)
    return [lm_workload_name(
        p["arch"], seq=p["seq"], batch=p["batch"], tp=p["tp"],
        phase=p["phase"], kv_len=p["kv_len"], ep=p["ep"],
        layers=r, dp=p["dp"], pod=p["pod"])
        for r in depths if r < p["layers"]]


def _simulate_fast(payload: Dict[str, Any]) -> Tuple[
        HwConfig, int, CompiledWorkload, "fastsim.FastRun"]:
    cfg, nt, cw = _compile(payload)
    opts = CompileOptions(n_tiles=nt, **payload["compile_opts"])
    reduced = [compile_ops(resolve_workload(n)(), cfg, opts)
               for n in _reduced_workloads(payload["workload"])]
    run = fastsim.simulate_fast(cw, cfg, n_tiles=nt, reduced=reduced)
    return cfg, nt, cw, run


def _record(cfg: HwConfig, nt: int, cw: CompiledWorkload, *,
            makespan_ns: float, n_tasks: int, prep, pem,
            payload: Dict[str, Any]) -> Dict[str, Any]:
    t = makespan_ns
    e = prep.energy_j()
    rec = {
        "time_ns": t,
        "inf_per_s": 1e9 / t if t > 0 else 0.0,
        "avg_w": prep.avg_w,
        "peak_w": prep.peak_w,
        "energy_j": e,
        "inf_per_j": (1.0 / e) if e > 0 else 0.0,
        "volt": pem.tree.char.vf.f2v(cfg.clock_ghz, payload["temp_c"]),
        "n_tasks": n_tasks,
        "spilled_layers": cw.spilled_layers,
        "total_flops": cw.total_flops,
    }
    if payload.get("keep_series"):
        rec["series_w"] = prep.series
        rec["pti_ns"] = prep.pti_ns
    return rec


def refine_point(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Compile + simulate + Power-EM one hardware point.

    ``payload["kind"]`` routes whole refinement families first
    (``"serve"`` -> the fleet simulator); within the classic family,
    ``payload["engine"]`` routes between the event engine and the
    ``core.fastsim`` interval-replay engine (see module docstring).
    """
    if payload.get("kind") == "serve":
        from ..serve.fleet import simulate_serve_point
        return simulate_serve_point(payload)
    if payload.get("kind") == "batch":
        return refine_batch(payload)
    engine = resolve_engine(payload.get("engine", "event"),
                            payload["workload"])
    cfg = from_dict(payload["hw"])
    nt = payload["n_tiles"]
    pem = PowerEM(cfg, n_tiles=nt, freq_ghz=cfg.clock_ghz,
                  temp_c=payload["temp_c"])
    if engine == "fast":
        cfg, nt, cw, run = _simulate_fast(payload)
        prep = pem.analyze(run.samples, pti_ns=payload["pti_ns"])
        return _record(cfg, nt, cw, makespan_ns=run.makespan_ns,
                       n_tasks=len(cw.tasks), prep=prep, pem=pem,
                       payload=payload)
    cfg, nt, cw = _compile(payload)
    sysm = System(cfg, n_tiles=nt)
    rep = sysm.run_workload(cw.tasks)
    prep = pem.analyze(sysm.tracer, pti_ns=payload["pti_ns"])
    return _record(cfg, nt, cw, makespan_ns=rep.makespan_ns,
                   n_tasks=rep.n_tasks, prep=prep, pem=pem, payload=payload)


# ---------------------------------------------------------------------------
# batched cross-point refinement (``core.batchsim``)


def batch_payload(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Wrap classic refinement payloads into one batch-job payload.

    The wrapper travels through every backend like any other payload
    (``kind: "batch"`` routes it in ``refine_point``); the result is a
    batch record — per-item records plus their content keys — which
    ``exec.backend`` expands into per-point cache entries and journal
    events, so batching is invisible downstream.
    """
    if not items:
        raise ValueError("batch_payload needs at least one item")
    for it in items:
        if it.get("kind") is not None:
            raise ValueError("only classic refinement payloads batch "
                             f"(got kind={it.get('kind')!r})")
    return {"kind": "batch", "items": [dict(it) for it in items]}


def _class_key(payload: Dict[str, Any]) -> str:
    """Structural-class planning key: everything in the payload except
    the analytic hw axes. Two payloads with equal keys compile to the
    same task graph (the compiler never reads the analytic fields), so
    they are grouped without compiling — ``stack_tables``' structural
    check and the duration/relaxation fan-out defense backstop the
    claim at refinement time."""
    hw = {k: v for k, v in payload["hw"].items() if k not in ANALYTIC_AXES}
    rest = {k: v for k, v in payload.items() if k != "hw"}
    return json.dumps({"hw": hw, "rest": rest}, sort_keys=True,
                      default=float)


def plan_batches(payloads: List[Dict[str, Any]], batch: int
                 ) -> List[Tuple[Dict[str, Any], List[int]]]:
    """Group a refinement work list into dispatchable jobs.

    Returns ``[(job_payload, positions), ...]`` where ``positions``
    index into ``payloads`` (record order is reconstructed from them).
    Fast-engine classic points are grouped by structural class and
    greedily packed — whole classes when they fit — into batch jobs of
    at most ``batch`` points; serve/event/auto-event points and lone
    leftovers stay single-point jobs. Deterministic: classes are
    ordered by their first member's position and in-class points keep
    work-list (grid) order, so every backend sees the same jobs in the
    same order regardless of how the caller discovered the misses.
    """
    if batch < 2:
        raise ValueError(f"plan_batches needs batch >= 2, got {batch}")
    classes: Dict[str, List[int]] = {}
    singles: List[int] = []
    for i, p in enumerate(payloads):
        if p.get("kind") is None and resolve_engine(
                p.get("engine", "event"), p["workload"]) == "fast":
            classes.setdefault(_class_key(p), []).append(i)
        else:
            singles.append(i)
    jobs: List[Tuple[Dict[str, Any], List[int]]] = []
    cur: List[int] = []

    def flush() -> None:
        if len(cur) == 1:
            jobs.append((payloads[cur[0]], [cur[0]]))
        elif cur:
            jobs.append((batch_payload([payloads[i] for i in cur]),
                         list(cur)))
        cur.clear()

    for key in sorted(classes, key=lambda k: classes[k][0]):
        members = classes[key]
        for c0 in range(0, len(members), batch):
            chunk = members[c0:c0 + batch]
            if len(cur) + len(chunk) > batch:
                flush()
            cur.extend(chunk)
    flush()
    for i in singles:
        jobs.append((payloads[i], [i]))
    jobs.sort(key=lambda j: min(j[1]))
    return jobs


def _refine_class(cls_items: List[Dict[str, Any]], members: List[int],
                  records: List[Optional[Dict[str, Any]]],
                  memo: Dict[Tuple, Tuple]) -> None:
    """Refine one structural class (>= 2 fast-engine points) sharing
    one compile, one stacked relaxation, and — per live-axis subgroup —
    one twin replay, one splice, one Power-EM pass, one record."""
    it0 = cls_items[0]
    cfg0, nt, cw = _compile(it0)
    opts = CompileOptions(n_tiles=nt, **it0["compile_opts"])
    opts_json = json.dumps(it0["compile_opts"], sort_keys=True,
                           default=float)
    twin_names = _reduced_workloads(it0["workload"])
    twins = [compile_ops(resolve_workload(n)(), cfg0, opts)
             for n in twin_names]
    twin_ix = {id(t): i for i, t in enumerate(twins)}
    twin_dead = [batchsim.dead_axes(t) for t in twins]
    dead = batchsim.dead_axes(cw)
    cfgs = [from_dict(it["hw"]) for it in cls_items]
    # batched lowering + one stacked list-scheduling relaxation for the
    # whole class — the batch-scale analogue of the analytic pre-screen,
    # and half of the record-sharing defense below
    dur = batchsim.batch_durations(cw, cfgs)
    bt = batchsim.BatchTaskTable(table=fastsim.lower(cw, cfgs[0]),
                                 duration=dur, n_points=len(cls_items))
    b_start, b_end, _ = batchsim.list_schedule_batched(bt)
    groups: Dict[str, List[int]] = {}
    for j, it in enumerate(cls_items):
        groups.setdefault(batchsim.live_key(it["hw"], dead), []).append(j)
    if REGISTRY.enabled:
        REGISTRY.counter("batch.classes").inc()
        REGISTRY.histogram("batch.class_size",
                           bounds=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0)
                           ).observe(len(cls_items))
        REGISTRY.histogram("batch.groups_per_class",
                           bounds=(1.0, 2.0, 4.0, 8.0, 16.0)
                           ).observe(len(groups))
    for gkey in sorted(groups, key=lambda k: groups[k][0]):
        g = groups[gkey]
        head = g[0]
        # record-sharing defense: a member may ride the head's record
        # only when it is provably simulation-identical — bitwise-equal
        # analytic durations AND stacked-relaxation intervals. A
        # mismatch means the dead-axis proof missed something for this
        # graph; those members refine individually instead.
        shared = [j for j in g
                  if np.array_equal(dur[j], dur[head])
                  and np.array_equal(b_start[j], b_start[head])
                  and np.array_equal(b_end[j], b_end[head])]
        solo = [j for j in g if j not in set(shared)]
        cfg_h = cfgs[head]
        hw_h = cls_items[head]["hw"]

        def verify(rcw: CompiledWorkload, _cfg: HwConfig = cfg_h,
                   _hw: Dict[str, Any] = hw_h):
            # one event-engine twin replay per (twin, live-config) —
            # shared across subgroups AND classes of this batch job
            # (the `layers` axis reuses the same shallow twins)
            ti = twin_ix[id(rcw)]
            k = (twin_names[ti], nt, opts_json,
                 batchsim.live_key(_hw, twin_dead[ti]))
            hit = memo.get(k)
            if hit is not None:
                if REGISTRY.enabled:
                    REGISTRY.counter("batch.replay_memo",
                                     result="hit").inc()
                return hit
            res = fastsim.verify_replay(rcw, _cfg, n_tiles=nt)
            memo[k] = res
            if REGISTRY.enabled:
                REGISTRY.counter("batch.replay_memo", result="miss").inc()
            return res

        run = fastsim.simulate_fast(cw, cfg_h, n_tiles=nt, reduced=twins,
                                    verify=verify)
        pem = PowerEM(cfg_h, n_tiles=nt, freq_ghz=cfg_h.clock_ghz,
                      temp_c=it0["temp_c"])
        prep = pem.analyze(run.samples, pti_ns=it0["pti_ns"])
        rec = _record(cfg_h, nt, cw, makespan_ns=run.makespan_ns,
                      n_tasks=len(cw.tasks), prep=prep, pem=pem,
                      payload=cls_items[head])
        for j in shared:
            records[members[j]] = rec
        for j in solo:
            records[members[j]] = refine_point(cls_items[j])
        if REGISTRY.enabled:
            REGISTRY.counter("batch.points", path="shared").inc(len(shared))
            if solo:
                REGISTRY.counter("batch.points",
                                 path="fallback").inc(len(solo))


def refine_batch(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Refine a ``kind: "batch"`` job: every item, grouped for sharing.

    Items are grouped by structural class; classes of one point — and
    anything not on the fast engine — fall back to ``refine_point``
    per item, **bitwise** identical to unbatched refinement. Returns a
    batch record ``{"kind": "batch", "records": [...], "keys": [...]}``
    with records in item order and each item's own content key, so the
    exec layer can expand it into per-point cache/journal entries.
    """
    items = payload["items"]
    if not items:
        raise ValueError("batch payload has no items")
    records: List[Optional[Dict[str, Any]]] = [None] * len(items)
    classes: Dict[str, List[int]] = {}
    for i, it in enumerate(items):
        classes.setdefault(_class_key(it), []).append(i)
    memo: Dict[Tuple, Tuple] = {}     # twin replays, shared job-wide
    for key in sorted(classes, key=lambda k: classes[k][0]):
        members = classes[key]
        it0 = items[members[0]]
        eng = resolve_engine(it0.get("engine", "event"), it0["workload"])
        if len(members) == 1 or eng != "fast" or \
                it0.get("kind") is not None:
            for m in members:
                records[m] = refine_point(items[m])
            if REGISTRY.enabled:
                REGISTRY.counter("batch.points",
                                 path="fallback").inc(len(members))
            continue
        _refine_class([items[m] for m in members], members, records, memo)
    return {"kind": "batch", "records": records,
            "keys": [content_key(it) for it in items]}


def crosscheck_point(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Run one point on BOTH engines and quantify the disagreement.

    Returns per-task interval deltas and record-level deltas; the fast
    engine's contract is ``max_interval_diff_ns == 0.0`` whenever it
    replayed (``extrapolated=False``) and float-rounding noise
    otherwise. Used by tests and ``python -m repro_torch.sweep crosscheck``.

    Each engine simulates exactly once: records are assembled from the
    already-computed interval/sample arrays (bit-identical to what
    ``refine_point`` would produce — the event path's Power-EM consumes
    the same ``SampleArrays`` export). Also reports the array-lowered
    ``list_schedule`` relaxation as the analytic estimate.
    """
    import numpy as np

    cfg, nt, cw, run = _simulate_fast(payload)
    if run.extrapolated:
        ev_start, ev_end, ev_sa = fastsim.replay_intervals(cw.tasks, cfg,
                                                           n_tiles=nt)
    else:
        # the fallback already IS a full event replay of these tasks
        ev_start, ev_end, ev_sa = run.start, run.end, run.samples
    dstart = float(np.abs(run.start - ev_start).max(initial=0.0))
    dend = float(np.abs(run.end - ev_end).max(initial=0.0))
    pem = PowerEM(cfg, n_tiles=nt, freq_ghz=cfg.clock_ghz,
                  temp_c=payload["temp_c"])
    rec_fa = _record(cfg, nt, cw, makespan_ns=run.makespan_ns,
                     n_tasks=len(cw.tasks), pem=pem, payload=payload,
                     prep=pem.analyze(run.samples,
                                      pti_ns=payload["pti_ns"]))
    rec_ev = _record(cfg, nt, cw, makespan_ns=ev_sa.makespan(),
                     n_tasks=len(cw.tasks), pem=pem, payload=payload,
                     prep=pem.analyze(ev_sa, pti_ns=payload["pti_ns"]))
    num_keys = [k for k, v in rec_ev.items() if isinstance(v, float)]
    rec_diff = {k: abs(rec_fa[k] - rec_ev[k]) /
                (abs(rec_ev[k]) if rec_ev[k] else 1.0) for k in num_keys}
    _, _, analytic_mk = fastsim.list_schedule(fastsim.lower(cw, cfg))
    return {
        "workload": payload["workload"],
        "extrapolated": run.extrapolated,
        "replayed_tasks": run.replayed_tasks,
        "n_tasks": len(cw.tasks),
        "max_interval_diff_ns": max(dstart, dend),
        "makespan_diff_ns": abs(run.makespan_ns - ev_sa.makespan()),
        "record_rel_diff": rec_diff,
        "analytic_makespan_ns": analytic_mk,
        "analytic_ratio": (ev_sa.makespan() / analytic_mk
                           if analytic_mk > 0 else 0.0),
        "detail": run.detail,
    }
