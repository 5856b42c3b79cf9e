"""Perfetto/Chrome-trace exporter: every simulation plane as a timeline.

Generalizes ``core.trace.to_chrome_trace`` (one tracer's task/activity
events) into three track families over the whole stack, all emitted in
'traceEvents' JSON that chrome://tracing and ui.perfetto.dev load
directly:

* **Engine points** (``trace_event_point``) — per-engine task timelines
  and sub-task activity samples from one event-engine simulation, plus
  Power-EM counter tracks: one watts counter per power node (and the
  chip total), sampled at the payload's PTI.
* **Serve points** (``trace_serve_point``) — request-lifecycle spans
  (queued -> prefill -> decode, colored by final status) on per-replica
  lanes, plus per-replica counter tracks for KV-resident tokens, queue
  depth, and batch composition, captured step by step from the fleet
  event loop.
* **Campaign journals** (``trace_campaign_journal``) — worker lanes
  reconstructed from the exec journal: each simulated point becomes a
  span of its journaled wall time ending at its completion timestamp;
  cache hits and failures become instant events.

Everything an exporter needs is re-simulated from the payload (points)
or folded from the journal (campaigns) — traces are derived artifacts,
never inputs, so point traces are as deterministic as the records.

CLI: ``python -m repro_torch.obs trace <point.json|journal.jsonl|workload>``.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

__all__ = ["TraceBuilder", "trace_event_point", "trace_serve_point",
           "trace_campaign_journal", "write_trace"]

_STATUS_CATS = {"done": "good", "evicted": "warn", "rejected": "bad",
                "failed": "bad"}


class TraceBuilder:
    """Chrome-trace 'traceEvents' assembler: pids by process name,
    complete/instant/counter events, metadata emitted on first use."""

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []
        self._pids: Dict[str, int] = {}

    def pid(self, process: str) -> int:
        p = self._pids.get(process)
        if p is None:
            p = self._pids[process] = len(self._pids) + 1
            self.events.append({"ph": "M", "pid": p,
                                "name": "process_name",
                                "args": {"name": process}})
        return p

    def span(self, process: str, tid: Any, name: str, *, ts_us: float,
             dur_us: float, cat: str = "span",
             args: Optional[Dict[str, Any]] = None) -> None:
        ev: Dict[str, Any] = {"ph": "X", "name": name, "cat": cat,
                              "pid": self.pid(process), "tid": tid,
                              "ts": ts_us, "dur": max(dur_us, 1e-3)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, process: str, tid: Any, name: str, *, ts_us: float,
                cat: str = "instant",
                args: Optional[Dict[str, Any]] = None) -> None:
        ev: Dict[str, Any] = {"ph": "i", "name": name, "cat": cat,
                              "pid": self.pid(process), "tid": tid,
                              "ts": ts_us, "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, process: str, name: str, *, ts_us: float,
                values: Dict[str, float]) -> None:
        self.events.append({"ph": "C", "name": name, "cat": "counter",
                            "pid": self.pid(process), "tid": 0,
                            "ts": ts_us, "args": values})

    def trace(self) -> Dict[str, Any]:
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}


def _tracer_events(tb: TraceBuilder, tracer) -> None:
    """The ``core.trace.to_chrome_trace`` family: task timeline spans
    (engines as threads of their root module) + activity samples."""
    for rec in tracer.tasks:
        tb.span(rec.engine.split(".")[0], rec.engine, rec.task,
                ts_us=rec.t_start / 1e3,
                dur_us=(rec.t_end - rec.t_start) / 1e3, cat="task",
                args={"queued_us": (rec.t_start - rec.t_enqueue) / 1e3})
    for s in tracer.samples:
        tb.span(s.module.split(".")[0], s.module,
                f"{s.kind}={s.amount:.3g}",
                ts_us=s.t0 / 1e3, dur_us=s.duration / 1e3,
                cat="activity")


def _power_counters(tb: TraceBuilder, prep) -> None:
    """Power-EM counter tracks: watts per node per PTI + chip total."""
    pti_us = prep.pti_ns / 1e3
    for node in sorted(prep.series):
        watts = prep.series[node]
        if not any(watts):
            continue
        for i, w in enumerate(watts):
            tb.counter("power", f"W {node}", ts_us=i * pti_us,
                       values={"watts": w})
    for i, w in enumerate(prep.total_series):
        tb.counter("power", "W total", ts_us=i * pti_us,
                   values={"watts": w})


def trace_event_point(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Simulate one refinement payload on the event engine and export
    its task timelines, activity samples, and Power-EM power counters."""
    from ..hw.chip import System
    from ..power.powerem import PowerEM
    from ..sweep.refine import _compile

    cfg, nt, cw = _compile(payload)
    sysm = System(cfg, n_tiles=nt)
    sysm.run_workload(cw.tasks)
    tb = TraceBuilder()
    _tracer_events(tb, sysm.tracer)
    pem = PowerEM(cfg, n_tiles=nt, freq_ghz=cfg.clock_ghz,
                  temp_c=payload.get("temp_c", 60.0))
    prep = pem.analyze(sysm.tracer,
                       pti_ns=payload.get("pti_ns", 10_000.0))
    _power_counters(tb, prep)
    return tb.trace()


def trace_serve_point(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Simulate one serve cell and export request-lifecycle spans plus
    per-replica KV-occupancy / queue / batch counter tracks."""
    from ..serve.fleet import fleet_from_payload

    timeline: List[Dict[str, Any]] = []
    res, p, _costs = fleet_from_payload(payload, timeline=timeline)
    tb = TraceBuilder()
    for i, r in enumerate(res.requests):
        proc = f"replica{r.replica}"
        tid = f"req{i}"
        cat = _STATUS_CATS.get(r.status, "span")
        if r.status == "rejected":
            tb.instant(proc, tid, "rejected", ts_us=r.arrival_ns / 1e3,
                       cat=cat, args={"prompt": r.prompt})
            continue
        if r.admit_ns >= 0:
            tb.span(proc, tid, "queued", ts_us=r.arrival_ns / 1e3,
                    dur_us=(r.admit_ns - r.arrival_ns) / 1e3, cat="queue",
                    args={"admit_depth": r.admit_depth})
        if r.first_ns >= 0:
            tb.span(proc, tid, "prefill", ts_us=r.admit_ns / 1e3,
                    dur_us=(r.first_ns - r.admit_ns) / 1e3, cat="prefill",
                    args={"prompt": r.prompt})
        if r.done_ns >= 0:
            tb.span(proc, tid, f"decode:{r.status}",
                    ts_us=r.first_ns / 1e3,
                    dur_us=(r.done_ns - r.first_ns) / 1e3, cat=cat,
                    args={"tokens": r.tokens, "status": r.status})
    # per-step counters: appended replica by replica, each in time
    # order, so every (pid, name) counter track is monotone
    for stp in timeline:
        proc = f"replica{stp['replica']}"
        ts = stp["t0"] / 1e3
        tb.counter(proc, "kv_tokens", ts_us=ts,
                   values={"tokens": stp["kv_tokens"]})
        tb.counter(proc, "queue_depth", ts_us=ts,
                   values={"requests": stp["queue"]})
        tb.counter(proc, "batch", ts_us=ts,
                   values={"prefill": stp["prefill"],
                           "decode": stp["decode"]})
    return tb.trace()


def trace_campaign_journal(path: str) -> Dict[str, Any]:
    """Fold an exec journal into campaign-execution worker lanes.

    Wall-clock timestamps are re-zeroed to the journal's first event so
    the trace starts at t=0 like the simulation traces."""
    from ..exec.journal import JournalView

    view = JournalView.from_file(path)

    def t0_of(ev: Dict[str, Any]) -> float:
        # a done point's span *starts* wall_s before its journal line —
        # possibly before the journal's first event; zero on the
        # earliest span start so no event lands at negative ts
        t = float(ev["t"])
        if ev.get("ev") == "point" and ev.get("status") == "done":
            return t - float(ev.get("wall_s") or 0.0)
        return t

    ts0 = min((t0_of(ev) for ev in view.events
               if isinstance(ev.get("t"), (int, float))), default=0.0)

    def us(t: float) -> float:
        return (t - ts0) * 1e6

    tb = TraceBuilder()
    start = view.start_ev
    if start is not None:
        tb.instant("campaign", "runner",
                   f"start {start.get('campaign', '?')}",
                   ts_us=us(start["t"]),
                   args={"backend": start.get("backend"),
                         "to_refine": start.get("to_refine")})
    for ev in view.events:
        if ev.get("ev") != "point" or not isinstance(
                ev.get("t"), (int, float)):
            continue
        status = ev.get("status")
        worker = str(ev.get("worker") or "runner")
        key = str(ev.get("key", ""))[:12]
        if status == "done":
            wall_s = float(ev.get("wall_s") or 0.0)
            tb.span("campaign", worker, key,
                    ts_us=us(ev["t"] - wall_s), dur_us=wall_s * 1e6,
                    cat="point", args={"status": status})
        else:
            tb.instant("campaign", worker, f"{status}:{key}",
                       ts_us=us(ev["t"]),
                       cat=_STATUS_CATS.get(status, "instant"),
                       args={"status": status,
                             "error": ev.get("error")})
    for ev in view.janitor_events:
        # maintenance passes get their own lane so reclaim/GC activity
        # is visually separable from refinement work
        if not isinstance(ev.get("t"), (int, float)):
            continue
        stats = {k: v for k, v in ev.items()
                 if k not in ("ev", "t", "worker")}
        label = ",".join(f"{k}={v}" for k, v in sorted(stats.items())
                         if v) or "pass"
        tb.instant("campaign", "janitor", label, ts_us=us(ev["t"]),
                   cat="janitor", args=stats)
    if view.end_ev is not None:
        tb.instant("campaign", "runner", "end", ts_us=us(view.end_ev["t"]),
                   args=view.end_ev.get("summary"))
    return tb.trace()


def write_trace(trace: Dict[str, Any], path: str) -> str:
    with open(path, "w") as f:
        json.dump(trace, f, sort_keys=True)
    return path
