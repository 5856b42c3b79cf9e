"""Batched cross-point refinement: one simulation, many campaign cells.

A campaign sweeps *hardware* axes (clock, HBM bandwidth, link rates —
``sweep.spec.ANALYTIC_AXES``) over a fixed set of workloads. Points that
differ only along those axes compile to **the same task graph**: the
compiler never reads the analytic config fields, so engines, barrier
waits/signals and op payloads are identical and only the per-task
analytic latencies change. This module exploits that three ways:

1. **Structural hashing** (``structural_hash``): a process-stable
   content hash of everything in a lowered ``TaskTable`` *except* the
   latencies — engine ids, dense barrier waits/signals, structural
   payload signatures (``fastsim._payload_sig``). Points with equal
   hashes form a *structural class*: isomorphic graphs differing only
   along latency-rescaling axes. Task names are deliberately excluded,
   so graphs that are isomorphic under renaming (e.g. two batch sizes
   whose per-chip op shapes coincide) share a class too.
2. **Table stacking** (``stack_tables`` + ``list_schedule_batched``):
   one ``BatchTaskTable`` holds the shared structure plus a ``[P, N]``
   duration matrix, and the list-scheduling relaxation runs once for
   all P points with numpy inner ops over the point axis — mirroring
   how ``core.vectorized.schedule_many_stats`` batches the analytic
   pre-screen. Per point it is bitwise-equal to ``fastsim.
   list_schedule`` (locked by tests).
3. **Dead-axis analysis** (``dead_axes`` / ``live_key``): which
   analytic axes can change *nothing* about a point's exact record —
   neither the event-engine replay nor the Power-EM pass reads them
   for this graph. Points in a class that also agree on every *live*
   axis share one event-engine twin replay, one splice, one Power-EM
   pass, and one (bitwise-identical) record. ``sweep.refine.
   refine_batch`` drives that sharing; ``fastsim.simulate_fast``'s
   ``verify=`` hook is where the shared ``VerifiedReplay`` enters.

Like ``fastsim``, this import path is jax-free — it runs inside
spawn-context worker processes.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, List, Sequence, Tuple

import numpy as np

from ..graph.compiler import CompiledWorkload
from ..hw.ici import CollectiveSpec
from ..hw.presets import HwConfig
from .fastsim import TaskTable, _analytic_duration, _payload_sig

__all__ = ["structural_hash", "dead_axes", "live_key", "batch_durations",
           "BatchTaskTable", "stack_tables", "list_schedule_batched"]


# ---------------------------------------------------------------------------
# structural hashing


def structural_hash(cw: CompiledWorkload, *, n_tiles: int = 0) -> str:
    """Content hash of a compiled workload's *structure*.

    Covers everything the event engine's schedule shape depends on
    except per-task latencies: engine ids, dense barrier waits/signals
    (per-compile, dense from 0 — compiler contract), and structural
    payload signatures. Excludes task names (isomorphism under
    renaming) and any memory address (``_payload_sig`` already strips
    the per-layer HBM base). Stable across processes: built purely
    from ints/strings/bools, no ``id()``, no dict iteration order.
    """
    h = hashlib.sha256()
    h.update(json.dumps({"n_tiles": n_tiles, "n_barriers": cw.n_barriers,
                         "n_tasks": len(cw.tasks)},
                        sort_keys=True).encode())
    for t in cw.tasks:
        sig = (t.engine, _payload_sig(t.payload),
               tuple((int(b), int(nd)) for b, nd in t.waits),
               tuple(int(b) for b in t.signals))
        h.update(repr(sig).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# dead-axis analysis


def dead_axes(cw: CompiledWorkload) -> FrozenSet[str]:
    """Analytic axes that provably cannot affect this graph's record.

    An axis is *dead* when neither the event-engine replay nor the
    Power-EM pass reads it for any payload in ``cw``:

    - ``dcn_gbps`` / ``dcn_latency_ns`` are only read by
      ``IciFabric.ideal_time_ns`` for ``cross_pod`` collectives — dead
      whenever no collective leaves the pod.
    - ``ici_latency_ns`` is only read for (non-cross-pod) collectives —
      dead when the graph has no collectives at all.
    - ``ici_link_gbps`` is **never** dead: even with no collectives,
      Power-EM sizes the ici/noc power-tree nodes by the link rate, so
      two configs differing there produce different power records.

    Dead axes define record-sharing groups: class members agreeing on
    every live axis get one shared simulation and bitwise-identical
    records (``live_key``).
    """
    has_coll = False
    has_cross = False
    for t in cw.tasks:
        p = t.payload
        if isinstance(p, CollectiveSpec):
            has_coll = True
            if p.cross_pod:
                has_cross = True
                break
    dead: set = set()
    if not has_cross:
        dead.update(("dcn_gbps", "dcn_latency_ns"))
    if not has_coll:
        dead.add("ici_latency_ns")
    return frozenset(dead)


def live_key(hw: Dict[str, Any], dead: FrozenSet[str]) -> str:
    """Canonical key of a point's hw config restricted to live axes —
    class members with equal live keys share one exact simulation."""
    return json.dumps({k: v for k, v in hw.items() if k not in dead},
                      sort_keys=True, default=float)


# ---------------------------------------------------------------------------
# batched lowering + list scheduling


def batch_durations(cw: CompiledWorkload, cfgs: Sequence[HwConfig]
                    ) -> np.ndarray:
    """Per-task analytic latencies for P configs at once: ``[P, N]``.

    Row p is bitwise-equal to ``lower(cw, cfgs[p]).duration`` — same
    cost-model objects, same call per task — but payload-signature
    memoization collapses the per-task model calls to one per distinct
    payload shape (full-model LMs repeat each shape ``layers`` times).
    """
    n = len(cw.tasks)
    out = np.zeros((len(cfgs), n), np.float64)
    for p, cfg in enumerate(cfgs):
        memo: Dict[int, Any] = {}
        by_sig: Dict[Tuple, float] = {}
        row = out[p]
        for i, t in enumerate(cw.tasks):
            sig = _payload_sig(t.payload)
            d = by_sig.get(sig)
            if d is None:
                d = _analytic_duration(t.payload, cfg, _memo=memo)
                by_sig[sig] = d
            row[i] = d
    return out


@dataclass
class BatchTaskTable:
    """One structural class's shared graph + per-point latencies."""

    table: TaskTable              # structure (duration column ignored)
    duration: np.ndarray          # [P, N] float64
    n_points: int


def stack_tables(tables: Sequence[TaskTable]) -> BatchTaskTable:
    """Stack structurally identical ``TaskTable``s along the point axis.

    Raises ``ValueError`` when any structural field differs — the
    defense behind the structural hash (hash collisions across truly
    distinct graphs would be caught here, not silently mis-batched).
    """
    if not tables:
        raise ValueError("stack_tables needs at least one table")
    base = tables[0]
    for t in tables[1:]:
        if (t.n_tasks != base.n_tasks or t.engines != base.engines
                or t.n_barriers != base.n_barriers
                or not np.array_equal(t.engine_id, base.engine_id)
                or not np.array_equal(t.wait_off, base.wait_off)
                or not np.array_equal(t.wait_bid, base.wait_bid)
                or not np.array_equal(t.wait_need, base.wait_need)
                or not np.array_equal(t.signal_off, base.signal_off)
                or not np.array_equal(t.signal_bid, base.signal_bid)
                or not np.array_equal(t.layer, base.layer)):
            raise ValueError("tables are not structurally identical")
    dur = np.stack([t.duration for t in tables])
    return BatchTaskTable(table=base, duration=dur, n_points=len(tables))


def list_schedule_batched(bt: BatchTaskTable
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``fastsim.list_schedule`` vectorized over the point axis.

    The task loop stays scalar (the barrier DAG is shared), but every
    inner op — engine-free times, barrier ``need``-th-signal selection,
    readiness max — runs on ``[P]`` vectors. Returns ``(start [P, N],
    end [P, N], makespan [P])``; each point's row is bitwise-equal to
    the scalar schedule of that point's own table (locked by tests).
    """
    tb = bt.table
    n, P = tb.n_tasks, bt.n_points
    start = np.zeros((P, n), np.float64)
    end = np.zeros((P, n), np.float64)
    free = np.zeros((P, len(tb.engines)), np.float64)
    # per-barrier signal times, each entry a [P] vector
    sig_times: List[List[np.ndarray]] = [[] for _ in range(tb.n_barriers)]
    eng = tb.engine_id
    dur = bt.duration
    woff, wbid, wneed = tb.wait_off, tb.wait_bid, tb.wait_need
    soff, sbid = tb.signal_off, tb.signal_bid
    for i in range(n):
        t = free[:, eng[i]].copy()
        for j in range(woff[i], woff[i + 1]):
            times = sig_times[wbid[j]]
            need = wneed[j]
            if len(times) < need:
                raise ValueError(
                    f"task {i} waits for signal {need} of barrier "
                    f"{wbid[j]}, only {len(times)} producers precede it")
            # need-th chronological signal, independently per point
            ready = np.partition(np.stack(times), need - 1, axis=0)[need - 1]
            np.maximum(t, ready, out=t)
        start[:, i] = t
        e = t + dur[:, i]
        end[:, i] = e
        free[:, eng[i]] = e
        for j in range(soff[i], soff[i + 1]):
            sig_times[sbid[j]].append(e)
    mk = end.max(axis=1) if n else np.zeros(P, np.float64)
    return start, end, mk
