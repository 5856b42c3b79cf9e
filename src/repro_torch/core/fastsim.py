"""Compiled interval-replay refinement: the campaign fast path.

The generator-driven event engine (``core.engine``) is ground truth, but
since the ``layers`` axis landed a full-model refinement walks
``layers x ops x n_tiles`` heap events while the analytic pre-screen
handles 13k points in seconds. This module closes that gap with three
pieces, all operating on **flat arrays** instead of Python object
graphs:

1. **Array lowering** (``lower``): a ``CompiledWorkload`` + ``HwConfig``
   become a ``TaskTable`` — engine ids, dense barrier waits/signals
   (``graph.compiler`` guarantees per-compile ids ``0..n-1``), and
   per-task latencies from the existing ``GemmSpec``/``VecSpec``/
   ``DmaDescriptor``/``CollectiveSpec`` cost models.
2. **List-scheduling sweep** (``list_schedule``): an event-free numpy
   relaxation over the static barrier DAG, respecting per-engine FIFO
   order. Durations are the analytic (contention-free) models, so this
   is a fast *estimate* — the event engine's sub-task pipelines and
   shared VMEM-port/HBM-bank contention make true intervals longer.
   Used for ordering/sanity, never for records.
3. **Steady-state interval replay** (``simulate_fast``): the exact
   path. Full-model LM workloads are ``layers`` identical ``L<i>.*``
   blocks; the event engine's schedule becomes periodic after a warmup
   layer (verified per run, never assumed). So: replay a *reduced*
   model (``FAST_REPLAY_LAYERS`` layers — its compiled prefix is
   task-for-task identical to the full model's), detect the periodic
   steady state by comparing consecutive layer blocks' task intervals
   and activity-sample windows, then extrapolate the remaining layers
   in O(1) each — synthesized intervals/samples are the steady block
   shifted by multiples of the measured period. When periodicity does
   not lock in (pattern diff beyond ``FAST_PATTERN_ATOL_NS``, irregular
   block structure, unexpected tail), it falls back to an **exact full
   replay** — event-engine intervals exported as arrays, bit-identical
   to ``engine="event"`` records.

Accuracy contract: replayed runs (the fallback, and every non-layered
workload) are *bitwise* equal to the event engine. Extrapolated runs
agree to float-rounding noise (measured ~1e-13 relative on makespan;
``sweep.refine.crosscheck_point`` quantifies it per point).

No jax anywhere on this import path — ``sweep.refine`` imports this
module from spawn-context worker processes.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..graph.compiler import CompiledWorkload
from ..graph.tasks import Task
from ..hw.dma import Dma, DmaDescriptor
from ..hw.ici import CollectiveSpec, IciFabric
from ..hw.memory import Hbm
from ..hw.mxu import GemmSpec, Mxu
from ..hw.presets import HwConfig
from ..hw.vecunit import VecSpec, VecUnit
from ..obs.metrics import REGISTRY
from .trace import SampleArrays

__all__ = ["TaskTable", "lower", "list_schedule", "FastRun",
           "simulate_fast", "try_extrapolate", "replay_intervals",
           "BlockMatch", "VerifiedReplay", "match_blocks",
           "verify_replay", "splice",
           "FAST_REPLAY_LAYERS", "FAST_REPLAY_LAYERS_BY_PHASE",
           "FAST_MIN_LAYERS", "FAST_PATTERN_ATOL_NS"]

# reduced-model replay depth: warmup blocks, verified-steady interior
# blocks, and the final block + head (which see the head-weight
# prefetch exactly as the full model's last layer does). The warmup
# transient is phase-dependent: compute-bound prefill settles after one
# layer, while decode (DMA-paced, deep FIFO run-ahead) and train (3x
# op list) need two or three — measured via the lock-in check, which
# falls back to exact replay whenever a depth proves too shallow.
FAST_REPLAY_LAYERS = 6
FAST_REPLAY_LAYERS_BY_PHASE = {"prefill": 4, "decode": 6, "train": 6}
# extrapolate only when it pays (and leaves >= 1 block to insert)
FAST_MIN_LAYERS = 8
# steady-state lock-in tolerance on relative task/sample times. Float
# accumulation noise across layers measures ~1e-7 ns; a single HBM
# page-policy flip is >= 25 ns — so 1e-2 ns separates the two regimes
# by orders of magnitude on both sides.
FAST_PATTERN_ATOL_NS = 1e-2

_LAYER_RE = re.compile(r"^(?:dma\.)?L(\d+)\.")


# ---------------------------------------------------------------------------
# array lowering


@dataclass
class TaskTable:
    """Flat-array form of a compiled task graph."""

    n_tasks: int
    engines: List[str]            # engine-unit id -> name
    engine_id: np.ndarray         # [N] int32
    duration: np.ndarray          # [N] float64, analytic cost models
    # ragged waits: waits of task i are wait_bid/wait_need[wait_off[i]:
    # wait_off[i+1]] (dense barrier ids straight from the compiler)
    wait_off: np.ndarray          # [N+1] int32
    wait_bid: np.ndarray          # [W] int32
    wait_need: np.ndarray         # [W] int32
    signal_off: np.ndarray        # [N+1] int32
    signal_bid: np.ndarray        # [S] int32
    n_barriers: int
    layer: np.ndarray             # [N] int32, L<i> block id or -1


def _analytic_duration(payload: Any, cfg: HwConfig, *,
                       _memo: Dict[int, Any]) -> float:
    """Per-task latency from the existing hw cost models (``ideal_time_ns``
    is a pure function of config; the model objects are built once)."""
    models = _memo.get(id(cfg))
    if models is None:
        hbm = Hbm(None, cfg, None)
        models = (Mxu(None, cfg, None, None), VecUnit(None, cfg, None, None),
                  Dma(None, cfg, hbm, None, None), IciFabric(None, cfg, None))
        _memo[id(cfg)] = models
    mxu, vpu, dma, ici = models
    if isinstance(payload, GemmSpec):
        return mxu.ideal_time_ns(payload)
    if isinstance(payload, VecSpec):
        return vpu.ideal_time_ns(payload)
    if isinstance(payload, DmaDescriptor):
        return dma.ideal_time_ns(payload)
    if isinstance(payload, CollectiveSpec):
        return ici.ideal_time_ns(payload)
    raise TypeError(f"unknown payload {type(payload)}")


def layer_of(name: str) -> int:
    """``L<i>.*`` block id of a task/op name (handles the ``dma.``
    prefix), or -1 for non-layer (head/tail) tasks."""
    m = _LAYER_RE.match(name)
    return int(m.group(1)) if m else -1


def lower(cw: CompiledWorkload, cfg: HwConfig) -> TaskTable:
    """Lower a compiled workload to flat arrays (see module docstring)."""
    tasks = cw.tasks
    n = len(tasks)
    eng_ids: Dict[str, int] = {}
    engine_id = np.zeros(n, np.int32)
    duration = np.zeros(n, np.float64)
    layer = np.full(n, -1, np.int32)
    wait_off = np.zeros(n + 1, np.int32)
    signal_off = np.zeros(n + 1, np.int32)
    wb: List[int] = []
    wn: List[int] = []
    sb: List[int] = []
    memo: Dict[int, Any] = {}
    for i, t in enumerate(tasks):
        engine_id[i] = eng_ids.setdefault(t.engine, len(eng_ids))
        duration[i] = _analytic_duration(t.payload, cfg, _memo=memo)
        layer[i] = layer_of(t.name)
        for bid, need in t.waits:
            wb.append(bid)
            wn.append(need)
        for bid in t.signals:
            sb.append(bid)
        wait_off[i + 1] = len(wb)
        signal_off[i + 1] = len(sb)
    return TaskTable(n_tasks=n, engines=list(eng_ids), engine_id=engine_id,
                     duration=duration, wait_off=wait_off,
                     wait_bid=np.asarray(wb, np.int32),
                     wait_need=np.asarray(wn, np.int32),
                     signal_off=signal_off,
                     signal_bid=np.asarray(sb, np.int32),
                     n_barriers=cw.n_barriers, layer=layer)


def list_schedule(table: TaskTable) -> Tuple[np.ndarray, np.ndarray, float]:
    """Event-free list-scheduling relaxation over the lowered arrays.

    ``start[i] = max(engine_free[e_i], barrier-ready times of waits)``;
    barriers become ready when their ``need``-th signal (chronologically)
    lands. Respects per-engine FIFO order (the event engine pops its
    FIFO strictly in compile order). Returns ``(start, end, makespan)``
    under the analytic durations — a contention-free estimate.
    """
    n = table.n_tasks
    start = np.zeros(n, np.float64)
    end = np.zeros(n, np.float64)
    free = np.zeros(len(table.engines), np.float64)
    sig_times: List[List[float]] = [[] for _ in range(table.n_barriers)]
    eng = table.engine_id
    dur = table.duration
    woff, wbid, wneed = table.wait_off, table.wait_bid, table.wait_need
    soff, sbid = table.signal_off, table.signal_bid
    for i in range(n):
        t = free[eng[i]]
        for j in range(woff[i], woff[i + 1]):
            times = sig_times[wbid[j]]
            need = wneed[j]
            if len(times) < need:
                raise ValueError(
                    f"task {i} waits for signal {need} of barrier "
                    f"{wbid[j]}, only {len(times)} producers precede it")
            ready = float(np.partition(np.asarray(times), need - 1)[need - 1])
            if ready > t:
                t = ready
        start[i] = t
        e = t + dur[i]
        end[i] = e
        free[eng[i]] = e
        for j in range(soff[i], soff[i + 1]):
            sig_times[sbid[j]].append(e)
    return start, end, float(end.max()) if n else 0.0


# ---------------------------------------------------------------------------
# exact interval replay + steady-state extrapolation


@dataclass
class FastRun:
    """Result of one fast-engine simulation of a full task list."""

    tasks: List[Task]             # the FULL compiled task list
    start: np.ndarray             # [N] exact (or extrapolated) task starts
    end: np.ndarray               # [N] task ends
    samples: SampleArrays         # full activity-sample set
    makespan_ns: float
    extrapolated: bool
    replayed_tasks: int           # how many tasks were event-simulated
    detail: Dict[str, Any] = field(default_factory=dict)


def replay_intervals(tasks: Sequence[Task], cfg: HwConfig, *,
                     n_tiles: int) -> Tuple[np.ndarray, np.ndarray,
                                            SampleArrays]:
    """Run the event engine and export per-task intervals (task-list
    order) + the sample stream as arrays — the tracer interval export."""
    from ..hw.chip import System

    sysm = System(cfg, n_tiles=n_tiles)
    # run_workload minus the Report reduction (busy-time unions over
    # every module) — interval consumers reduce arrays themselves
    done = sysm.scheduler.run(tasks)
    sysm.env.run(until=done)
    # kernel/contention telemetry flows from fast-engine replays too
    sysm.emit_metrics()
    tid, _enq, st, en = sysm.tracer.task_arrays()
    pos = {t.tid: i for i, t in enumerate(tasks)}
    idx = np.fromiter((pos[t] for t in tid.tolist()), np.int64, len(tid))
    start = np.empty(len(tasks), np.float64)
    end = np.empty(len(tasks), np.float64)
    start[idx] = st
    end[idx] = en
    return start, end, sysm.tracer.sample_arrays()


def _payload_sig(p: Any) -> Tuple:
    """Structural payload identity: everything timing-relevant except
    the HBM base address (which advances layer to layer — periodicity
    of its *effect* is what the steady-state check verifies) and the
    embedded op name."""
    if isinstance(p, GemmSpec):
        return ("gemm", p.m, p.n, p.k, p.a_bytes_per_elem,
                p.b_bytes_per_elem, p.out_bytes_per_elem,
                p.fused_post_elems)
    if isinstance(p, VecSpec):
        return ("vec", p.n_elems, p.kind, p.bytes_in, p.bytes_out)
    if isinstance(p, DmaDescriptor):
        return ("dma", p.nbytes, p.src, p.dst, p.contiguous_run,
                p.compressed, p.broadcast)
    if isinstance(p, CollectiveSpec):
        return ("coll", p.op, p.payload_bytes, p.group_size, p.cross_pod)
    return ("other", repr(p))


_STRIP_RE = re.compile(r"^(dma\.)?L\d+\.")


def _strip_layer(name: str) -> str:
    return _STRIP_RE.sub(lambda m: m.group(1) or "", name)


def _block_slices(tasks: Sequence[Task]) -> Optional[Tuple[List[slice],
                                                           slice]]:
    """Split a task list into contiguous ``L<i>`` blocks + trailing tail.

    Returns ``None`` when the layer structure is irregular (non-layer
    tasks between blocks, non-ascending ids, ...) — caller falls back.
    """
    labels = [layer_of(t.name) for t in tasks]
    slices: List[slice] = []
    i, n = 0, len(tasks)
    expect = 0
    while i < n and labels[i] == expect:
        j = i
        while j < n and labels[j] == expect:
            j += 1
        slices.append(slice(i, j))
        i = j
        expect += 1
    if any(lb != -1 for lb in labels[i:]):
        return None          # layer tasks after the tail started
    if not slices:
        return None
    return slices, slice(i, n)


def _block_sig(tasks: Sequence[Task], sl: slice) -> Tuple:
    return tuple((_strip_layer(t.name), t.engine, _payload_sig(t.payload))
                 for t in tasks[sl])


def _ici_duration(spec: CollectiveSpec, cfg: HwConfig) -> float:
    """Closed-form collective latency — ``IciFabric.run`` executes one
    timeout of exactly ``ideal_time_ns`` (the ici engine serializes its
    FIFO, so collectives never contend in-engine), except that a
    zero-byte payload short-circuits to 0."""
    if spec.phases() == 0 or spec.payload_bytes <= 0:
        return 0.0
    return IciFabric(None, cfg, None).ideal_time_ns(spec)


def _full_replay(tasks: Sequence[Task], cfg: HwConfig, n_tiles: int,
                 reason: str) -> FastRun:
    start, end, sa = replay_intervals(tasks, cfg, n_tiles=n_tiles)
    return FastRun(tasks=list(tasks), start=start, end=end, samples=sa,
                   makespan_ns=sa.makespan(), extrapolated=False,
                   replayed_tasks=len(tasks), detail={"fallback": reason})


@dataclass
class BlockMatch:
    """Config-independent structural match of a full model against one
    reduced twin: the full model's block layout plus the tail payloads
    that must be patched in closed form after splicing. Pure graph
    structure — valid for every hardware config the pair compiles under
    (``graph.compiler`` output is invariant along the analytic axes)."""

    f_blocks: List[slice]         # full model's L<i> block slices
    f_tail: slice                 # full model's trailing (head) tasks
    n_extra: int                  # layers to synthesize (L - R)
    patches: List[Tuple[int, CollectiveSpec]]   # tail pos -> payload
    layers: int                   # L
    reduced_layers: int           # R


@dataclass
class VerifiedReplay:
    """One reduced twin replayed on the event engine and steady-state
    verified at one hardware config — the shareable unit of the batched
    refinement path (``core.batchsim``): every full model whose blocks
    structurally match this twin splices from the same verified replay,
    so a batch of campaign points pays for the event engine once."""

    n_tasks: int                  # twin task count (FastRun accounting)
    start: np.ndarray             # [n_tasks] exact twin task starts
    end: np.ndarray
    samples: SampleArrays         # twin activity-sample stream
    blocks: List[slice]           # twin L<i> block slices
    tail: slice
    q: int                        # steady block index (last interior)
    delta: float                  # measured steady-state period (ns)
    drift: float                  # task-pattern lock-in drift (ns)
    sdrift: float                 # sample-window lock-in drift (ns)
    win: np.ndarray               # bool mask: the captured steady window
    w1: float                     # window end (the period cut)


def match_blocks(full: CompiledWorkload, reduced: CompiledWorkload
                 ) -> Tuple[Optional[BlockMatch], str]:
    """Structural half of an extrapolation attempt (no simulation).

    Verifies both task lists split into regular ``L<i>`` blocks, every
    block carries the same structural signature, and the tails agree up
    to closed-form-patchable collectives. Returns ``(match, "")`` or
    ``(None, reason)``.
    """
    tasks = full.tasks
    fb = _block_slices(tasks)
    rb = _block_slices(reduced.tasks)
    if fb is None or rb is None:
        return None, "irregular layer blocks"
    f_blocks, f_tail = fb
    r_blocks, r_tail = rb
    L, R = len(f_blocks), len(r_blocks)
    n_extra = L - R
    if R < 4 or n_extra < 1 or L < FAST_MIN_LAYERS:
        return None, f"too few layers (L={L}, R={R})"

    # -- structural identity: every block matches, tails match ------------
    sig = _block_sig(reduced.tasks, r_blocks[0])
    if any(_block_sig(reduced.tasks, s) != sig for s in r_blocks[1:]) or \
       any(_block_sig(tasks, s) != sig for s in f_blocks):
        return None, "layer blocks differ"
    r_tail_tasks = reduced.tasks[r_tail]
    f_tail_tasks = tasks[f_tail]
    if len(r_tail_tasks) != len(f_tail_tasks):
        return None, "tail length differs"
    patches: List[Tuple[int, CollectiveSpec]] = []   # tail pos -> payload
    for k, (rt, ft) in enumerate(zip(r_tail_tasks, f_tail_tasks)):
        if _strip_layer(rt.name) != _strip_layer(ft.name) or \
           rt.engine != ft.engine:
            return None, "tail names differ"
        if _payload_sig(rt.payload) != _payload_sig(ft.payload):
            # layer-count-dependent tail payloads (the train-phase DP
            # gradient all-reduce scales with `layers`) are patchable in
            # closed form — but only with nothing scheduled after them
            if not (isinstance(ft.payload, CollectiveSpec)
                    and k == len(f_tail_tasks) - 1):
                return None, "unpatchable tail payload"
            patches.append((k, ft.payload))
    return BlockMatch(f_blocks=f_blocks, f_tail=f_tail, n_extra=n_extra,
                      patches=patches, layers=L, reduced_layers=R), ""


def verify_replay(reduced: CompiledWorkload, cfg: HwConfig, *,
                  n_tiles: int) -> Tuple[Optional[VerifiedReplay], str]:
    """Replay one reduced twin exactly and verify its steady state.

    Depends only on ``(reduced, cfg, n_tiles)`` — never on the full
    model — so the result is memoizable and shareable across every
    campaign point whose graph matches the twin (``match_blocks``) at a
    config that replays identically (``batchsim.dead_axes``).
    """
    rb = _block_slices(reduced.tasks)
    if rb is None:
        return None, "irregular layer blocks"
    r_blocks, r_tail = rb
    R = len(r_blocks)
    if R < 4:
        return None, f"too few replay layers (R={R})"

    # -- exact replay of the reduced model --------------------------------
    r_start, r_end, r_sa = replay_intervals(reduced.tasks, cfg,
                                            n_tiles=n_tiles)
    anchors = np.array([r_start[s.start] for s in r_blocks])
    q = R - 2                      # steady block (last interior one)
    delta = float(anchors[q] - anchors[q - 1])
    if delta <= 0:
        return None, "non-positive period"

    # -- steady-state lock-in: task patterns ------------------------------
    def pat(b: int) -> np.ndarray:
        s = r_blocks[b]
        return np.stack([r_start[s] - anchors[b], r_end[s] - anchors[b]])

    drift = float(np.abs(pat(q) - pat(q - 1)).max())
    if drift > FAST_PATTERN_ATOL_NS:
        return None, f"task pattern drift {drift:.3g} ns"

    # -- steady-state lock-in: activity-sample windows ---------------------
    # The period cut must not sit on a sample start: block anchors are
    # exactly where next-layer DMA prefetches launch, so an anchor-
    # aligned cut flips boundary samples between windows on ~1e-7 ns
    # accumulation noise. Place the cut mid-way through the largest gap
    # in sample starts (mod period) instead.
    a_prev = float(anchors[q - 1])
    region = (r_sa.t0 >= a_prev) & (r_sa.t0 < a_prev + delta)
    rel = np.sort(np.mod(r_sa.t0[region] - a_prev, delta))
    if len(rel) == 0:
        off = delta / 2.0
    else:
        gaps = np.diff(np.concatenate([rel, rel[:1] + delta]))
        gi = int(np.argmax(gaps))
        off = float(np.mod(rel[gi] + gaps[gi] / 2.0, delta))
    cut = float(anchors[q]) + off             # end of the captured window
    w0, w1 = cut - delta, cut
    win = (r_sa.t0 >= w0) & (r_sa.t0 < w1)
    prev = (r_sa.t0 >= w0 - delta) & (r_sa.t0 < w0)
    if int(win.sum()) != int(prev.sum()):
        return None, "sample window size drift"
    # Windows are compared in *canonical* order: same-time emissions on
    # different modules may swap raw emission order layer to layer (heap
    # ties resolve by global event id), which is timing-irrelevant —
    # PTI binning is per module.

    def canon(mask: np.ndarray, t_ref: float):
        rel0 = r_sa.t0[mask] - t_ref
        rel1 = r_sa.t1[mask] - t_ref
        order = np.lexsort((r_sa.amount[mask], np.round(rel1, 3),
                            np.round(rel0, 3), r_sa.kind_id[mask],
                            r_sa.module_id[mask]))
        return (r_sa.module_id[mask][order], r_sa.kind_id[mask][order],
                r_sa.amount[mask][order], rel0[order], rel1[order])

    cw_mid, cw_kid, cw_amt, cw_t0, cw_t1 = canon(win, w0)
    cp_mid, cp_kid, cp_amt, cp_t0, cp_t1 = canon(prev, w0 - delta)
    if not (np.array_equal(cw_mid, cp_mid) and np.array_equal(cw_kid, cp_kid)
            and np.array_equal(cw_amt, cp_amt)):
        return None, "sample pattern drift"
    sdrift = max(float(np.abs(cw_t0 - cp_t0).max(initial=0)),
                 float(np.abs(cw_t1 - cp_t1).max(initial=0)))
    if sdrift > FAST_PATTERN_ATOL_NS:
        return None, f"sample time drift {sdrift:.3g} ns"
    return VerifiedReplay(n_tasks=len(reduced.tasks), start=r_start,
                          end=r_end, samples=r_sa, blocks=r_blocks,
                          tail=r_tail, q=q, delta=delta, drift=drift,
                          sdrift=sdrift, win=win, w1=w1), ""


def splice(full: CompiledWorkload, match: BlockMatch, vr: VerifiedReplay,
           cfg: HwConfig) -> Tuple[Optional[FastRun], str]:
    """Synthesize the full model's intervals/samples from a verified
    twin replay (O(1) per extra layer). Never mutates ``vr`` — the same
    verified replay splices any number of campaign points."""
    tasks = full.tasks
    f_blocks, f_tail = match.f_blocks, match.f_tail
    n_extra, patches = match.n_extra, match.patches
    r_blocks, r_tail = vr.blocks, vr.tail
    r_start, r_end, r_sa = vr.start, vr.end, vr.samples
    q, delta, win, w1 = vr.q, vr.delta, vr.win, vr.w1

    # -- splice task intervals --------------------------------------------
    n_full = len(tasks)
    start = np.empty(n_full, np.float64)
    end = np.empty(n_full, np.float64)
    shift_after = n_extra * delta
    for i, s in enumerate(f_blocks):
        if i <= q:
            src = r_blocks[i]
            off = 0.0
        elif i <= q + n_extra:
            src = r_blocks[q]
            off = (i - q) * delta
        else:
            src = r_blocks[i - n_extra]
            off = shift_after
        start[s] = r_start[src] + off
        end[s] = r_end[src] + off
    start[f_tail] = r_start[r_tail] + shift_after
    end[f_tail] = r_end[r_tail] + shift_after

    # -- splice samples ----------------------------------------------------
    pre = r_sa.t0 < w1
    post = ~pre
    parts_t0 = [r_sa.t0[pre]]
    parts_t1 = [r_sa.t1[pre]]
    parts_mid = [r_sa.module_id[pre]]
    parts_kid = [r_sa.kind_id[pre]]
    parts_amt = [r_sa.amount[pre]]
    for j in range(1, n_extra + 1):
        parts_t0.append(r_sa.t0[win] + j * delta)
        parts_t1.append(r_sa.t1[win] + j * delta)
        parts_mid.append(r_sa.module_id[win])
        parts_kid.append(r_sa.kind_id[win])
        parts_amt.append(r_sa.amount[win])
    parts_t0.append(r_sa.t0[post] + shift_after)
    parts_t1.append(r_sa.t1[post] + shift_after)
    parts_mid.append(r_sa.module_id[post])
    parts_kid.append(r_sa.kind_id[post])
    parts_amt.append(r_sa.amount[post])
    sa = SampleArrays(modules=list(r_sa.modules), kinds=list(r_sa.kinds),
                      module_id=np.concatenate(parts_mid),
                      kind_id=np.concatenate(parts_kid),
                      t0=np.concatenate(parts_t0),
                      t1=np.concatenate(parts_t1),
                      amount=np.concatenate(parts_amt))

    # -- patch layer-count-dependent tail collectives ----------------------
    for k, payload in patches:
        ti = f_tail.start + k
        old_end = end[ti]
        end[ti] = start[ti] + _ici_duration(payload, cfg)
        if payload.phases() == 0 or payload.payload_bytes <= 0:
            continue       # instant collective: no sample on either engine
        mod = "ici.dcn" if payload.cross_pod else "ici"
        if mod not in sa.modules:
            return None, "tail sample patch failed (module missing)"
        mid = sa.modules.index(mod)
        rows = np.nonzero((sa.module_id == mid) & (sa.t0 == start[ti])
                          & (sa.t1 == old_end))[0]
        if len(rows) != 1:
            # ambiguous or missing sample: patching would leave the
            # record internally inconsistent — make the caller fall
            # back to exact replay instead
            return None, "tail sample patch failed (no unique row)"
        sa.t1[rows[0]] = end[ti]
        sa.amount[rows[0]] = payload.link_bytes()

    # event-engine semantics: makespan is the last sample's t1
    return FastRun(tasks=list(tasks), start=start, end=end, samples=sa,
                   makespan_ns=sa.makespan(),
                   extrapolated=True,
                   replayed_tasks=vr.n_tasks,
                   detail={"layers": match.layers,
                           "replayed_layers": match.reduced_layers,
                           "period_ns": delta, "task_drift_ns": vr.drift,
                           "sample_drift_ns": vr.sdrift,
                           "patched_tail": len(patches)}), ""


def try_extrapolate(full: CompiledWorkload, cfg: HwConfig, *,
                    n_tiles: int, reduced: CompiledWorkload
                    ) -> Tuple[Optional[FastRun], str]:
    """One steady-state extrapolation attempt against one reduced twin.

    Composition of the three reusable stages — ``match_blocks`` (pure
    structure), ``verify_replay`` (one event-engine twin replay +
    steady-state lock-in), ``splice`` (O(1)/layer synthesis). Returns
    ``(run, "")`` on lock-in, ``(None, reason)`` otherwise — the caller
    decides whether to try a deeper twin or fall back to an exact full
    replay (``simulate_fast`` runs that ladder).
    """
    match, reason = match_blocks(full, reduced)
    if match is None:
        return None, reason
    vr, reason = verify_replay(reduced, cfg, n_tiles=n_tiles)
    if vr is None:
        return None, reason
    return splice(full, match, vr, cfg)


def _reason_class(reasons: Sequence[str], extrapolate: bool) -> str:
    """Low-cardinality metric label for a fallback: the deepest attempt's
    reason with point-specific detail (numbers, parens) stripped."""
    if not extrapolate:
        return "disabled"
    if not reasons:
        return "no_reduced_workload"
    head = re.split(r"[(\d]", reasons[-1])[0].strip()
    return head.replace(" ", "_") or "unknown"


def simulate_fast(full: CompiledWorkload, cfg: HwConfig, *, n_tiles: int,
                  reduced: Sequence[CompiledWorkload] = (),
                  extrapolate: bool = True,
                  verify: Optional[Callable[[CompiledWorkload],
                                            Tuple[Optional[VerifiedReplay],
                                                  str]]] = None) -> FastRun:
    """Fast-engine simulation of ``full``.

    ``reduced`` is a ladder of compiled reduced-layer twins (same
    workload at increasing ``FAST_REPLAY_LAYERS_BY_PHASE`` depths — the
    warmup transient varies with phase and problem size, so a shallow
    attempt that fails lock-in retries deeper). Without candidates, or
    when every attempt fails its steady-state checks, this is an exact
    full replay, bit-identical to the event engine.

    ``verify`` overrides how a twin gets its ``VerifiedReplay`` — the
    batched refinement path (``core.batchsim``) passes a memoizing
    closure here so one event-engine twin replay serves every campaign
    point in a structural class. Default: fresh ``verify_replay`` per
    attempt (identical behavior, replay just isn't shared).
    """
    if verify is None:
        def verify(rcw: CompiledWorkload):
            return verify_replay(rcw, cfg, n_tiles=n_tiles)
    reasons: List[str] = []
    if extrapolate:
        for rw in reduced:
            run = None
            match, reason = match_blocks(full, rw)
            if match is not None:
                vr, reason = verify(rw)
                if vr is not None:
                    run, reason = splice(full, match, vr, cfg)
            if run is not None:
                if reasons:
                    run.detail["retried"] = reasons
                if REGISTRY.enabled:
                    REGISTRY.counter("fastsim.extrapolated").inc()
                    REGISTRY.histogram("fastsim.retry_depth",
                                       bounds=(0.0, 1.0, 2.0, 4.0)
                                       ).observe(len(reasons))
                return run
            reasons.append(reason)
    fallback = ("; ".join(reasons) if reasons else
                ("extrapolation disabled" if not extrapolate
                 else "no reduced workload"))
    if REGISTRY.enabled:
        REGISTRY.counter("fastsim.full_replay",
                         reason=_reason_class(reasons, extrapolate)).inc()
        if reasons:
            REGISTRY.histogram("fastsim.retry_depth",
                               bounds=(0.0, 1.0, 2.0, 4.0)
                               ).observe(len(reasons))
    return _full_replay(full.tasks, cfg, n_tiles, fallback)
