"""Event-based serving-fleet simulator over the modeled pod.

The real ``serve.engine.ServeEngine`` runs actual jax decode steps and
stays the correctness reference; it cannot answer fleet questions
("what pod shape serves 40 req/s within SLO cheapest?") because one
request-level simulation at that fidelity costs minutes. This module
answers them by splitting the problem:

* **Step costs** come from the analytic model stack: one transformer
  layer body + model head per (phase, batch-bucket, context-bucket) are
  compiled (``graph.compiler``), lowered to arrays and list-scheduled
  (``core.fastsim.lower`` / ``list_schedule``), and scaled in closed
  form — ``step = layers x body + head`` — exactly the layer-
  replication contract the sweep pre-screen and the fast engine's
  steady-state extrapolation rely on. Buckets are powers of two, so a
  whole campaign cell touches a handful of compiles no matter how many
  requests flow through it.
* **Request dynamics** are a discrete-event loop per replica:
  continuous batching (new prefills interleaved into the in-flight
  decode batch each iteration, vLLM-style) or static batching (admit a
  batch, drain it to completion, repeat), over a fixed number of KV
  slots with admission control and mid-decode eviction when a sequence
  outgrows the KV budget. Requests are assigned to the ``dp`` fleet
  replicas round-robin at arrival.

With ~µs-scale Python bookkeeping per step, 100k+ requests per cell
simulate in seconds — cheap enough to grid arrival rate x batch policy
x pod shape like any other campaign axis.

Accounting per request: TTFT (first token latency, >= queue wait by
construction) and TPOT (steady decode interval). A cell rolls up into
one SLO record: TTFT/TPOT p50/p95/p99, goodput (completed requests
meeting both SLO bounds per second), slot occupancy, and fleet energy
— per-engine-class busy fractions feed ``power.powerem.pod_power_w``,
the same characterized power tree every other record uses.

Determinism contract: everything here is pure float math over a trace
that regenerates from its payload-embedded spec (``serve.traffic``), so
serve records are byte-identical across the inline/pool/spool backends
— the ``tests/test_golden.py`` contract. No jax anywhere on this import
path: ``sweep.refine`` dispatches serve payloads here from spawn-
context worker processes.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.fastsim import lower, list_schedule
from ..graph.compiler import CompileOptions, compile_ops
from ..graph.workloads import lm_workload_name, model_parts
from ..hw.presets import HwConfig, from_dict
from ..obs.metrics import REGISTRY
from ..power.powerem import pod_power_w
from .traffic import TraceRequest, make_trace

__all__ = ["StepCost", "ServeCostModel", "FleetParams", "FleetResult",
           "simulate_fleet", "simulate_serve_point", "serve_payload",
           "fleet_from_payload", "POLICIES", "SERVE_SCHEMA_VERSION"]

POLICIES = ("static", "continuous")
# bumped when serve-record semantics change: lives in the payload, so
# the result cache never serves a record computed under old semantics
# (v2: queue-depth-at-admission + queue-wait percentiles in records)
SERVE_SCHEMA_VERSION = 2

_PCTS = (50.0, 95.0, 99.0)
# per-step histogram bounds: batch/queue sizes are power-of-two-ish,
# occupancy is a fraction of the slot budget
_BATCH_BOUNDS = tuple(float(1 << i) for i in range(11))
_OCC_BOUNDS = (0.125, 0.25, 0.5, 0.75, 0.9, 1.0)


def _bucket(n: int) -> int:
    """Smallest power of two >= n (>=1): the step-cost quantization."""
    return 1 << max(int(n) - 1, 0).bit_length()


# ---------------------------------------------------------------------------
# step-cost model


@dataclass(frozen=True)
class StepCost:
    """One fleet iteration's cost: wall time + per-engine-class busy
    time (per engine unit, for utilization/power rollup)."""

    ns: float
    busy: Dict[str, float]        # mxu|vpu|dma|ici -> busy ns per unit


def _class_of(engine: str) -> Optional[str]:
    """Task-engine name -> engine class (mirrors the compiler's naming:
    ``tile<t>.mxu`` / ``tile<t>.vpu`` / ``dma`` / ``ici``)."""
    if engine.endswith(".mxu"):
        return "mxu"
    if engine.endswith(".vpu"):
        return "vpu"
    if engine in ("dma", "ici"):
        return engine
    return None


class ServeCostModel:
    """Analytic per-step costs for one serving replica.

    ``prefill_cost(batch, prompt)`` / ``decode_cost(batch, kv)`` compile
    lazily per (phase, bucketed batch, bucketed context) and memoize —
    the simulator calls them every iteration, the lattice stays tiny.
    The fleet simulator only duck-types these two methods, so tests
    drive ``simulate_fleet`` with synthetic constant-cost stubs.
    """

    def __init__(self, cfg: HwConfig, *, arch: str, layers: int,
                 tp: int = 1, ep: int = 1, pod: int = 0, n_tiles: int = 1,
                 compile_opts: Optional[Dict[str, Any]] = None):
        if layers < 1:
            raise ValueError(f"need layers >= 1, got {layers}")
        self.cfg = cfg
        self.arch = arch
        self.layers = layers
        self.tp = tp
        self.ep = ep
        self.pod = pod
        self.n_tiles = n_tiles
        self.compile_opts = dict(compile_opts or {})
        self._memo: Dict[Tuple[str, int, int], StepCost] = {}

    def _part_cost(self, ops) -> Tuple[float, Dict[str, float]]:
        cw = compile_ops(ops, self.cfg,
                         CompileOptions(n_tiles=self.n_tiles,
                                        **self.compile_opts))
        table = lower(cw, self.cfg)
        _, _, makespan = list_schedule(table)
        busy = {"mxu": 0.0, "vpu": 0.0, "dma": 0.0, "ici": 0.0}
        units = {"mxu": 0, "vpu": 0, "dma": 0, "ici": 0}
        for name in table.engines:
            c = _class_of(name)
            if c:
                units[c] += 1
        for eid, name in enumerate(table.engines):
            c = _class_of(name)
            if c:
                busy[c] += float(
                    table.duration[table.engine_id == eid].sum())
        for c in busy:
            busy[c] /= max(units[c], 1)
        return makespan, busy

    def _cost(self, phase: str, batch: int, ctx: int) -> StepCost:
        key = (phase, batch, ctx)
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        name = lm_workload_name(
            self.arch, seq=ctx if phase == "prefill" else 0, batch=batch,
            tp=self.tp, phase=phase,
            kv_len=ctx if phase == "decode" else 0, ep=self.ep,
            layers=self.layers, dp=1, pod=self.pod)
        parts = model_parts(name)
        body_ns, body_busy = self._part_cost(parts.body())
        head_ns, head_busy = self._part_cost(parts.head())
        ns = self.layers * body_ns + head_ns
        busy = {c: self.layers * body_busy[c] + head_busy[c]
                for c in body_busy}
        cost = StepCost(ns=ns, busy=busy)
        self._memo[key] = cost
        return cost

    def prefill_cost(self, batch: int, prompt: int) -> StepCost:
        return self._cost("prefill", _bucket(batch), _bucket(prompt))

    def decode_cost(self, batch: int, kv: int) -> StepCost:
        return self._cost("decode", _bucket(batch), _bucket(kv))


# ---------------------------------------------------------------------------
# fleet event loop


@dataclass(frozen=True)
class FleetParams:
    """Serving-policy knobs of one fleet cell."""

    replicas: int = 1             # dp: independent model replicas
    slots: int = 8                # concurrent sequences per replica
    kv_capacity: int = 4096       # max prompt+generated tokens per slot
    policy: str = "continuous"    # static | continuous
    max_queue: int = 0            # reject beyond this backlog (0 = inf)

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {self.policy!r}")
        if self.replicas < 1 or self.slots < 1 or self.kv_capacity < 2:
            raise ValueError(f"bad fleet shape: replicas={self.replicas} "
                             f"slots={self.slots} "
                             f"kv_capacity={self.kv_capacity}")


@dataclass
class _Req:
    arrival_ns: float
    prompt: int
    max_new: int
    admit_ns: float = -1.0        # leaves the queue, takes a slot
    first_ns: float = -1.0        # first token lands (end of its step)
    done_ns: float = -1.0
    tokens: int = 0               # generated so far
    status: str = "queued"        # queued|active|done|evicted|rejected
    admit_depth: int = -1         # queue backlog left behind at admission
    replica: int = 0              # which dp replica served it


@dataclass
class FleetResult:
    """Per-request detail + per-replica aggregates of one simulation.

    ``record()`` flattens this into the JSON-safe SLO record that lands
    in campaign results; tests assert on the detail arrays directly.
    """

    requests: List[_Req]
    duration_ns: float            # fleet makespan (max over replicas)
    steps: int
    slot_ns: float                # sum over steps of occupied x step
    capacity_ns: float            # slots x per-replica duration, summed
    max_active: int               # peak concurrent sequences (1 replica)
    busy: Dict[str, float]        # engine-class busy ns, fleet total
    detail: Dict[str, Any] = field(default_factory=dict)

    def record(self, *, slo_ttft_ms: float,
               slo_tpot_ms: float) -> Dict[str, Any]:
        done = [r for r in self.requests if r.status == "done"]
        evicted = [r for r in self.requests if r.status == "evicted"]
        rejected = [r for r in self.requests if r.status == "rejected"]
        served = done + evicted       # got at least one token
        ttft = np.array([r.first_ns - r.arrival_ns
                         for r in served]) / 1e6
        tpot = np.array([(r.done_ns - r.first_ns) / (r.tokens - 1)
                         for r in served if r.tokens > 1]) / 1e6
        dur_s = self.duration_ns / 1e9
        arr_span = max(r.arrival_ns for r in self.requests) / 1e9
        good = [r for r in done
                if (r.first_ns - r.arrival_ns) / 1e6 <= slo_ttft_ms
                and (r.tokens < 2 or (r.done_ns - r.first_ns)
                     / (r.tokens - 1) / 1e6 <= slo_tpot_ms)]
        rec: Dict[str, Any] = {
            "requests": len(self.requests),
            "completed": len(done),
            "evicted": len(evicted),
            "rejected": len(rejected),
            "tokens_out": sum(r.tokens for r in self.requests),
            "duration_s": dur_s,
            "steps": self.steps,
            "max_active": self.max_active,
            "slot_occupancy": (self.slot_ns / self.capacity_ns
                               if self.capacity_ns > 0 else 0.0),
            "offered_rps": (len(self.requests) / arr_span
                            if arr_span > 0 else 0.0),
            "throughput_rps": len(done) / dur_s if dur_s > 0 else 0.0,
            "goodput_rps": len(good) / dur_s if dur_s > 0 else 0.0,
            "slo_attainment": (len(good) / len(self.requests)
                               if self.requests else 0.0),
        }
        # admission detail (serve schema v2): how deep the backlog ran
        # and how long requests queued before taking a slot
        admitted = [r for r in self.requests if r.admit_ns >= 0]
        depth = np.array([r.admit_depth for r in admitted], np.float64)
        qwait = np.array([r.admit_ns - r.arrival_ns
                          for r in admitted]) / 1e6
        for tag, arr in (("ttft", ttft), ("tpot", tpot),
                         ("admit_depth", depth), ("queue_wait", qwait)):
            unit = "" if tag == "admit_depth" else "_ms"
            for p, v in zip(_PCTS, np.percentile(arr, _PCTS)
                            if len(arr) else (0.0,) * len(_PCTS)):
                rec[f"{tag}_p{p:.0f}{unit}"] = float(v)
        return rec


def _drain(batch: List[_Req], t_end: float, kv_capacity: int,
           completed_into: List[_Req]) -> List[_Req]:
    """Post-step bookkeeping: finish / evict / keep each sequence."""
    live: List[_Req] = []
    for r in batch:
        if r.tokens >= r.max_new:
            r.status, r.done_ns = "done", t_end
        elif r.prompt + r.tokens >= kv_capacity:
            # out of KV budget mid-decode: slot freed, partial output
            # surfaces in the record (mirrors ServeEngine's eviction)
            r.status, r.done_ns = "evicted", t_end
        else:
            live.append(r)
            continue
        completed_into.append(r)
    return live


def _run_replica(reqs: List[_Req], costs, p: FleetParams,
                 busy: Dict[str, float], *, rep: int = 0,
                 timeline: Optional[List[Dict[str, Any]]] = None
                 ) -> Tuple[float, int, float, int]:
    """Simulate one replica over its (arrival-ordered) request stream.

    Returns ``(end_ns, steps, slot_ns, max_active)`` and accumulates
    engine-class busy time into ``busy``. Continuous policy admits into
    free slots every iteration (one fused prefill+decode step);
    static policy drains each admitted batch to completion first.
    When ``timeline`` is given, every step appends one dict (replica,
    window, batch composition, queue depth, resident KV tokens) — the
    Perfetto exporter's counter-track source.
    """
    queue: deque = deque()
    active: List[_Req] = []
    finished: List[_Req] = []
    t = 0.0
    i = 0
    steps = 0
    slot_ns = 0.0
    max_active = 0
    n = len(reqs)
    # hoisted per-step instruments: zero hot-loop cost while disabled
    reg = REGISTRY if REGISTRY.enabled else None
    if reg is not None:
        h_batch = reg.histogram("serve.batch_size",
                                bounds=_BATCH_BOUNDS, replica=str(rep))
        h_queue = reg.histogram("serve.queue_depth",
                                bounds=_BATCH_BOUNDS, replica=str(rep))
        h_occ = reg.histogram("serve.slot_occupancy",
                              bounds=_OCC_BOUNDS, replica=str(rep))

    def pull(now: float) -> None:
        nonlocal i
        while i < n and reqs[i].arrival_ns <= now:
            r = reqs[i]
            i += 1
            if r.prompt + 1 > p.kv_capacity or \
                    (p.max_queue and len(queue) >= p.max_queue):
                r.status = "rejected"
            else:
                queue.append(r)

    def step(admitted: List[_Req], decoding: List[_Req]) -> None:
        nonlocal t, steps, slot_ns, max_active, active
        cost = 0.0
        if admitted:
            c = costs.prefill_cost(len(admitted),
                                   max(r.prompt for r in admitted))
            cost += c.ns
            for k, v in c.busy.items():
                busy[k] += v
        if decoding:
            c = costs.decode_cost(len(decoding),
                                  max(r.prompt + r.tokens
                                      for r in decoding))
            cost += c.ns
            for k, v in c.busy.items():
                busy[k] += v
        t_end = t + cost
        steps += 1
        occ = len(admitted) + len(decoding)
        slot_ns += occ * cost
        max_active = max(max_active, occ)
        if reg is not None:
            h_batch.observe(occ)
            h_queue.observe(len(queue))
            h_occ.observe(occ / p.slots)
        if timeline is not None:
            timeline.append({
                "replica": rep, "t0": t, "t1": t_end,
                "prefill": len(admitted), "decode": len(decoding),
                "queue": len(queue),
                "kv_tokens": sum(r.prompt + r.tokens
                                 for r in admitted + decoding)})
        for r in admitted:
            r.status = "active"
            r.first_ns = t_end
            r.tokens = 1
        for r in decoding:
            r.tokens += 1
        active = _drain(decoding + admitted, t_end, p.kv_capacity,
                        finished)
        t = t_end

    while i < n or queue or active:
        pull(t)
        if not active and not queue:
            t = reqs[i].arrival_ns     # idle: jump to the next arrival
            continue
        admitted: List[_Req] = []
        while queue and len(active) + len(admitted) < p.slots:
            r = queue.popleft()
            r.admit_ns = t
            r.admit_depth = len(queue)   # backlog left behind
            admitted.append(r)
        if p.policy == "continuous":
            step(admitted, active)
        else:
            # static: prefill the batch, then decode it dry — no
            # admissions until every sequence finishes
            step(admitted, [])
            while active:
                step([], active)
    return t, steps, slot_ns, max_active


def simulate_fleet(trace: Sequence[TraceRequest], costs,
                   p: FleetParams, *,
                   timeline: Optional[List[Dict[str, Any]]] = None
                   ) -> FleetResult:
    """Run a trace through ``p.replicas`` round-robin-balanced replicas.

    ``costs`` duck-types ``prefill_cost(batch, prompt)`` /
    ``decode_cost(batch, kv)`` -> ``StepCost``. Pass a list as
    ``timeline`` to capture one entry per fleet step (see
    ``_run_replica``) for the Perfetto exporter.
    """
    if not trace:
        raise ValueError("empty trace")
    reqs = [_Req(r.arrival_ns, r.prompt_tokens, r.max_new) for r in trace]
    busy: Dict[str, float] = {"mxu": 0.0, "vpu": 0.0, "dma": 0.0,
                              "ici": 0.0}
    duration = 0.0
    steps = 0
    slot_ns = 0.0
    capacity_ns = 0.0
    max_active = 0
    for rep in range(p.replicas):
        shard = reqs[rep::p.replicas]
        if not shard:
            continue
        for r in shard:
            r.replica = rep
        end, st, sn, ma = _run_replica(shard, costs, p, busy, rep=rep,
                                       timeline=timeline)
        duration = max(duration, end)
        steps += st
        slot_ns += sn
        max_active = max(max_active, ma)
    capacity_ns = p.replicas * p.slots * duration
    res = FleetResult(requests=reqs, duration_ns=duration, steps=steps,
                      slot_ns=slot_ns, capacity_ns=capacity_ns,
                      max_active=max_active, busy=busy)
    if REGISTRY.enabled:
        by_status: Dict[str, int] = {}
        for r in reqs:
            by_status[r.status] = by_status.get(r.status, 0) + 1
        for status, cnt in sorted(by_status.items()):
            REGISTRY.counter("serve.requests", status=status).inc(cnt)
        REGISTRY.counter("serve.admissions").inc(
            sum(1 for r in reqs if r.admit_ns >= 0))
        REGISTRY.counter("serve.steps").inc(steps)
        REGISTRY.gauge("serve.max_active").set_max(max_active)
    return res


# ---------------------------------------------------------------------------
# campaign payload plumbing (the `kind: "serve"` refinement family)


def serve_payload(*, workload: str, arch: str, layers: int, prompt: int,
                  max_new: int, tp: int, ep: int, dp: int, pod: int,
                  slots: int, kv_capacity: int, policy: str,
                  traffic: Dict[str, Any], slo: Dict[str, float],
                  n_tiles: int, hw: Dict[str, Any], temp_c: float,
                  max_queue: int = 0,
                  compile_opts: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    """The cache-keyed, process-picklable input of one serve cell.

    ``kind: "serve"`` is what ``sweep.refine.refine_point`` dispatches
    on, so these payloads flow through the inline/pool/spool backends,
    the result cache, and the journal exactly like classic refinement
    payloads."""
    return {"kind": "serve", "serve_schema": SERVE_SCHEMA_VERSION,
            "workload": workload, "arch": arch, "layers": layers,
            "prompt": prompt, "max_new": max_new, "tp": tp, "ep": ep,
            "dp": dp, "pod": pod, "slots": slots,
            "kv_capacity": kv_capacity, "policy": policy,
            "max_queue": max_queue, "traffic": dict(traffic),
            "slo": dict(slo), "n_tiles": n_tiles, "hw": hw,
            "temp_c": temp_c, "compile_opts": dict(compile_opts or {})}


def fleet_from_payload(payload: Dict[str, Any], *,
                       timeline: Optional[List[Dict[str, Any]]] = None
                       ) -> Tuple[FleetResult, FleetParams,
                                  ServeCostModel]:
    """Rebuild a serve cell from its payload and run the fleet loop.

    Shared by ``simulate_serve_point`` (records) and the Perfetto
    exporter (request-lifecycle spans + per-step counter tracks)."""
    cfg = from_dict(payload["hw"])
    trace = make_trace(payload["traffic"],
                       prompt_tokens=payload["prompt"],
                       max_new=payload["max_new"])
    costs = ServeCostModel(cfg, arch=payload["arch"],
                           layers=payload["layers"], tp=payload["tp"],
                           ep=payload["ep"], pod=payload["pod"],
                           n_tiles=payload["n_tiles"],
                           compile_opts=payload["compile_opts"])
    p = FleetParams(replicas=payload["dp"], slots=payload["slots"],
                    kv_capacity=payload["kv_capacity"],
                    policy=payload["policy"],
                    max_queue=payload.get("max_queue", 0))
    res = simulate_fleet(trace, costs, p, timeline=timeline)
    return res, p, costs


def simulate_serve_point(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Simulate one serve cell end to end: regenerate the trace, build
    the cost model, run the fleet, roll up the SLO record + fleet power.
    """
    cfg = from_dict(payload["hw"])
    res, p, costs = fleet_from_payload(payload)
    slo = payload["slo"]
    rec = res.record(slo_ttft_ms=slo["ttft_ms"],
                     slo_tpot_ms=slo["tpot_ms"])
    # fleet power: per-class busy fractions (fleet-total busy over
    # replicas x duration) through the characterized power tree, scaled
    # to every chip of the fleet (symmetric SPMD replicas)
    chips = payload["dp"] * payload["tp"] * payload["ep"]
    denom = max(p.replicas * res.duration_ns, 1e-9)
    util = {c: min(b / denom, 1.0) for c, b in res.busy.items()}
    fam_util = {"mxu": util["mxu"], "vpu": util["vpu"],
                "vmem": max(util["mxu"], util["vpu"]),
                "hbm": util["dma"], "dma": util["dma"],
                "ici": util["ici"], "noc": util["ici"]}
    avg_w = pod_power_w(cfg, fam_util, chips=chips,
                        n_tiles=payload["n_tiles"],
                        freq_ghz=cfg.clock_ghz, temp_c=payload["temp_c"])
    energy = avg_w * rec["duration_s"]
    rec.update({
        "serve": True,
        "chips": chips,
        "avg_w": avg_w,
        "energy_j": energy,
        "energy_per_req_j": (energy / rec["completed"]
                             if rec["completed"] else 0.0),
        "prefill_step_ns": costs.prefill_cost(
            payload["slots"], payload["prompt"]).ns,
        "decode_step_ns": costs.decode_cost(
            payload["slots"], payload["prompt"] + payload["max_new"]).ns,
    })
    return rec
