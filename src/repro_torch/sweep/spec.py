"""Declarative sweep-campaign specs.

A ``SweepSpec`` is the JSON-serializable description of a campaign:
which workloads, which hardware preset, which parameter grid, and how to
refine. Axes split into two kinds:

* **analytic** axes (``ANALYTIC_AXES``) only move the parameter vector of
  the vectorized scheduler — every combination inside a structural cell
  is pre-screened in *one* XLA call without recompiling the task graph.
* **structural** axes (everything else: ``n_tiles``, VMEM capacity, DMA
  channel count, ...) change task-graph compilation or system topology,
  so each distinct combination forms its own cell (one compile + one
  batched pre-screen per cell).

Worked example — an LM campaign over inference phase and KV length::

    >>> from repro_torch.sweep import SweepSpec, RefineSpec, run_campaign
    >>> spec = SweepSpec(
    ...     name="demo",
    ...     lm_grid={"arch": "qwen3-32b",
    ...              "phase": ["prefill", "decode"],
    ...              "seq": [512], "kv_len": [512, 2048],
    ...              "batch": [1, 8], "tp": [1, 2]},
    ...     preset="v5e",
    ...     axes={"clock_ghz": [0.6, 0.94], "hbm_gbps": [819.0, 1640.0]},
    ...     refine=RefineSpec(mode="pareto", max_points=2))
    >>> spec.workloads[:2]
    ['lm/qwen3-32b/s512b1tp1', 'lm/qwen3-32b/s512b1tp2']
    >>> spec.workloads[-1]
    'lm/qwen3-32b/decode/kv2048b8tp2'
    >>> spec.grid_size               # 12 workloads x 4 analytic points
    48
    >>> result = run_campaign(spec, workers=0)   # doctest: +SKIP

``lm_grid`` keys: ``arch`` (registry id), ``phase`` (subset of
``["prefill", "decode", "train"]``, default prefill), ``seq``
(prefill/train prompt lengths), ``kv_len`` (decode KV-cache lengths),
``batch``, ``tp`` (tensor-parallel degrees) and ``ep`` (MoE
expert-parallel degrees — ``ep > 1`` adds alltoall dispatch/combine
collectives and needs a MoE arch). Adding a ``layers`` key switches the
grid to **full-model** workloads (``graph.workloads.lm_model_ops``) and
unlocks the pod-shape axes: ``dp`` (data-parallel degrees; ``batch``
becomes the global batch, and ``phase="train"`` adds the DP gradient
all-reduce) and ``pod`` (chips per ICI domain — collectives whose ring
leaves the pod run at DCN speed). Every expanded workload is its own
structural cell, but full-model cells share their per-layer pre-screen
across the ``layers`` axis (the layer-replication fast path). Scalars
are accepted wherever a list is expected. Full field reference:
``docs/CAMPAIGNS.md``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..graph.workloads import (is_workload, lm_grid_names,
                               lm_workload_name, parse_lm_name)
from ..hw.presets import HwConfig, resolve_preset
from ..power.characterization import NOMINAL_TEMP_C
from ..serve.fleet import POLICIES
from ..serve.traffic import TRAFFIC_KINDS

__all__ = ["ANALYTIC_AXES", "RefineSpec", "SweepSpec", "GridPoint",
           "SweepCell", "ServePoint", "load_spec", "load_builtin_spec",
           "builtin_spec_names", "BUILTIN_SPEC_DIR"]

# HwConfig fields fully captured by core.vectorized.params_of — safe to
# sweep inside one compiled task graph (see module docstring).
ANALYTIC_AXES = frozenset({
    "clock_ghz", "hbm_gbps", "dma_desc_overhead_ns",
    "ici_link_gbps", "ici_latency_ns", "dcn_gbps", "dcn_latency_ns",
    "n_mxu", "mxu_rows", "mxu_cols",
    "vpu_lanes", "vpu_sublanes", "vpu_flops_per_lane",
    "vmem_ports", "vmem_port_bytes_per_cycle",
})

_HW_FIELDS = {f.name for f in dataclasses.fields(HwConfig)}

BUILTIN_SPEC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "sweeps")


@dataclass
class RefineSpec:
    """How the pre-screened grid is refined (engine + budget + Power-EM).

    ``engine`` picks the refinement simulator per point: ``"event"``
    (the generator-driven event engine — ground truth), ``"fast"``
    (``core.fastsim`` interval replay with steady-state layer
    extrapolation; byte-identical to ``event`` whenever it replays) or
    ``"auto"`` (``fast`` for big layered full models, ``event``
    otherwise). The default honors ``REPRO_REFINE_ENGINE`` so CI can
    run whole campaign lanes on either engine; the value is part of
    every refinement payload and therefore of the result-cache key.

    ``batch`` > 1 turns on batched cross-point refinement
    (``sweep.refine.plan_batches`` / ``core.batchsim``): fast-engine
    points are grouped by structural class and dispatched as batch jobs
    of at most ``batch`` points, sharing compiles / twin replays /
    records within a job. 0 or 1 (default; ``REPRO_REFINE_BATCH``
    overrides) keeps the one-payload-per-point path. Records are
    identical either way — batching only changes how much work is
    shared — and individual points keep their own cache keys, so
    flipping ``batch`` never invalidates the cache.
    """

    mode: str = "pareto"          # pareto | all | none
    max_points: int = 16          # refinement budget per structural cell
    pti_ns: float = 10_000.0      # Power-EM trace interval
    temp_c: float = NOMINAL_TEMP_C
    keep_series: bool = False     # keep per-module PTI power series
    engine: str = field(default_factory=lambda: os.environ.get(
        "REPRO_REFINE_ENGINE", "event"))   # event | fast | auto
    batch: int = field(default_factory=lambda: int(os.environ.get(
        "REPRO_REFINE_BATCH", "0")))   # max points per batch job

    def __post_init__(self):
        if self.mode not in ("pareto", "all", "none"):
            raise ValueError(f"refine.mode must be pareto|all|none, "
                             f"got {self.mode!r}")
        if self.engine not in ("event", "fast", "auto"):
            raise ValueError(f"refine.engine must be event|fast|auto, "
                             f"got {self.engine!r}")
        if self.batch < 0:
            raise ValueError(f"refine.batch must be >= 0, "
                             f"got {self.batch}")


@dataclass
class SweepSpec:
    """One campaign: workloads x preset x grid (+ refinement policy)."""

    name: str
    workloads: List[str] = field(default_factory=list)
    preset: str = "paper_skew"
    base: Dict[str, Any] = field(default_factory=dict)
    axes: Dict[str, List[Any]] = field(default_factory=dict)
    n_tiles: List[int] = field(default_factory=lambda: [2])
    compile_opts: Dict[str, Any] = field(default_factory=dict)
    refine: RefineSpec = field(default_factory=RefineSpec)
    cache_dir: Optional[str] = None
    description: str = ""
    # LM workload grid: {"arch": ..., "phase": ["prefill"|"decode"],
    # "seq": [...], "kv_len": [...], "batch": [...], "tp": [...],
    # "ep": [...]} — expands into ``lm/<arch>/s<S>b<B>tp<T>[ep<E>]``
    # (prefill) / ``lm/<arch>/decode/kv<K>b<B>tp<T>[ep<E>]`` (decode)
    # workloads (each combination is its own structural cell)
    lm_grid: Optional[Dict[str, Any]] = None
    # serving-fleet grid (``serve.fleet``): one model deployment swept
    # over arrival rate x batch policy x traffic shape x pod shape.
    # Scalars: arch, layers, prompt, max_new, kv_capacity, n_requests,
    # seed, slo {ttft_ms, tpot_ms} (+ optional max_queue, burst_x,
    # dwell_s, trace_path). Axes (scalar or list): rate_rps, policy,
    # traffic, tp, ep, dp, pod, slots. Expands into ServePoints — each
    # refines through the ``kind: "serve"`` payload family, not the
    # pre-screen. Full reference: docs/CAMPAIGNS.md.
    serve_grid: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        if isinstance(self.refine, dict):
            self.refine = RefineSpec(**self.refine)
        if isinstance(self.n_tiles, int):
            self.n_tiles = [self.n_tiles]
        if self.lm_grid:
            g = {k: [v] if isinstance(v, (int, str)) else list(v)
                 for k, v in self.lm_grid.items()}   # scalar convenience
            archs = g.pop("arch", [None])
            if len(archs) != 1:
                raise ValueError(f"lm_grid takes exactly one arch, "
                                 f"got {archs}")
            arch = archs[0]
            phase = g.pop("phase", ["prefill"])
            bad_ph = [p for p in phase
                      if p not in ("prefill", "decode", "train")]
            if bad_ph:
                raise ValueError(f"lm_grid phase must be prefill|decode|"
                                 f"train, got {bad_ph}")
            seq = g.pop("seq", [])
            kv_len = g.pop("kv_len", [])
            ep = g.pop("ep", [1])
            layers = g.pop("layers", [])
            dp = g.pop("dp", [1])
            pod = g.pop("pod", [0])
            seq_phases = [p for p in phase if p != "decode"]
            missing = [k for k, need in
                       [("arch", arch is None), ("batch", "batch" not in g),
                        ("tp", "tp" not in g),
                        ("seq", bool(seq_phases) and not seq),
                        ("kv_len", "decode" in phase and not kv_len)]
                       if need]
            if missing:
                raise KeyError(
                    f"lm_grid needs arch/batch/tp, plus seq for prefill/"
                    f"train and kv_len for decode; missing {missing}")
            # dp/pod/train are pod-shape semantics of full-model
            # workloads; without a layers axis they would be silently
            # meaningless — reject them
            needs_layers = [k for k, bad in
                            [("dp", any(d > 1 for d in dp)),
                             ("pod", any(p > 0 for p in pod)),
                             ("phase=train", "train" in phase)] if bad]
            if needs_layers and not layers:
                raise KeyError(
                    f"lm_grid {needs_layers} need a 'layers' axis "
                    f"(full-model workloads)")
            if any(lyr < 1 for lyr in layers):
                raise ValueError(f"lm_grid layers must be >= 1, "
                                 f"got {layers}")
            # an axis whose phase is absent would silently vanish from
            # the grid — reject it like an unknown key
            stray = [k for k, vals, ok in
                     [("seq", seq, bool(seq_phases)),
                      ("kv_len", kv_len, "decode" in phase)]
                     if vals and not ok]
            if stray:
                raise KeyError(
                    f"lm_grid axis {stray} given but its phase is not in "
                    f"phase={phase}")
            names = lm_grid_names(arch, seq, g.pop("batch"), g.pop("tp"),
                                  phase=phase, kv_len=kv_len, ep=ep,
                                  layers=layers or [0], dp=dp, pod=pod)
            if g:
                raise KeyError(f"unknown lm_grid keys {sorted(g)}")
            # idempotent: to_dict/from_dict round-trips re-expand the
            # same names, so only append ones not already present
            self.workloads = list(self.workloads) + \
                [n for n in names if n not in self.workloads]
        if self.serve_grid:
            self.serve_points()       # validate eagerly: fail at load
        if not self.workloads and not self.serve_grid:
            raise ValueError("spec needs workloads (or a non-empty "
                             "lm_grid or serve_grid)")
        unknown = [w for w in self.workloads if not is_workload(w)]
        if unknown:
            raise KeyError(f"unknown workloads {unknown}; have builtin "
                           f"CNNs or 'lm/<arch>/s<seq>b<batch>tp<tp>'")
        bad = [a for a in list(self.axes) + list(self.base)
               if a not in _HW_FIELDS]
        if bad:
            raise KeyError(f"unknown HwConfig fields {bad}")
        for a, vals in self.axes.items():
            if not isinstance(vals, (list, tuple)) or not vals:
                raise ValueError(f"axis {a!r} needs a non-empty value list")
        # probe the preset early so a bad name fails at load, not mid-run
        resolve_preset(self.preset)

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SweepSpec":
        return cls(**d)

    # -- grid -------------------------------------------------------------
    @property
    def analytic_axes(self) -> Dict[str, List[Any]]:
        return {a: v for a, v in self.axes.items() if a in ANALYTIC_AXES}

    @property
    def structural_axes(self) -> Dict[str, List[Any]]:
        return {a: v for a, v in self.axes.items() if a not in ANALYTIC_AXES}

    @property
    def grid_size(self) -> int:
        n = len(self.workloads) * len(self.n_tiles)
        for vals in self.axes.values():
            n *= len(vals)
        if not self.workloads:
            n = 0
        return n + len(self.serve_points())

    def cells(self) -> List["SweepCell"]:
        """Structural cells, each carrying its analytic sub-grid."""
        s_axes = self.structural_axes
        a_axes = self.analytic_axes
        a_combos = [dict(zip(a_axes, vs))
                    for vs in itertools.product(*a_axes.values())] or [{}]
        out: List[SweepCell] = []
        for w in self.workloads:
            for nt in self.n_tiles:
                for svals in itertools.product(*s_axes.values()):
                    structural = dict(zip(s_axes, svals))
                    pts = [GridPoint(workload=w, n_tiles=nt,
                                     overrides={**structural, **a},
                                     structural=dict(structural))
                           for a in a_combos]
                    out.append(SweepCell(spec=self, workload=w, n_tiles=nt,
                                         structural=structural, points=pts))
        return out

    def hw_config(self, overrides: Dict[str, Any]) -> HwConfig:
        return resolve_preset(self.preset, **{**self.base, **overrides})

    # -- serving-fleet grid -----------------------------------------------
    def serve_points(self) -> List["ServePoint"]:
        """Expand (and validate) ``serve_grid`` into ServePoints.

        Grid order: tp-major, then ep, dp, pod, slots, policy, traffic,
        rate_rps innermost — fleet shape first, then scheduling policy,
        then load. Serving cells bypass the analytic pre-screen, so the
        spec's hw ``axes`` do not cross with them (``preset`` + ``base``
        define the chip); every ServePoint is one refinement payload.
        """
        if not self.serve_grid:
            return []
        g = dict(self.serve_grid)

        def axis(key: str, default: Any) -> List[Any]:
            v = g.pop(key, default)
            return [v] if isinstance(v, (int, float, str)) else list(v)

        try:
            arch = g.pop("arch")
            layers = int(g.pop("layers"))
            prompt = int(g.pop("prompt"))
            max_new = int(g.pop("max_new"))
            kv_capacity = int(g.pop("kv_capacity"))
            n_requests = int(g.pop("n_requests"))
            slo = dict(g.pop("slo"))
        except KeyError as e:
            raise KeyError(f"serve_grid needs arch/layers/prompt/max_new/"
                           f"kv_capacity/n_requests/slo; missing {e}")
        seed = int(g.pop("seed", 0))
        max_queue = int(g.pop("max_queue", 0))
        burst_x = float(g.pop("burst_x", 4.0))
        dwell_s = float(g.pop("dwell_s", 2.0))
        trace_path = g.pop("trace_path", None)
        tp = axis("tp", 1)
        ep = axis("ep", 1)
        dp = axis("dp", 1)
        pod = axis("pod", 0)
        slots = axis("slots", 8)
        policy = axis("policy", "continuous")
        traffic = axis("traffic", "poisson")
        rate = [float(r) for r in axis("rate_rps", None)
                if r is not None]
        if g:
            raise KeyError(f"unknown serve_grid keys {sorted(g)}")
        if not rate:
            raise KeyError("serve_grid needs a rate_rps axis")
        if layers < 1 or prompt < 1 or max_new < 1 or n_requests < 1:
            raise ValueError(
                f"serve_grid needs layers/prompt/max_new/n_requests "
                f">= 1, got {layers}/{prompt}/{max_new}/{n_requests}")
        if not {"ttft_ms", "tpot_ms"} <= set(slo):
            raise KeyError(f"serve_grid slo needs ttft_ms and tpot_ms, "
                           f"got {sorted(slo)}")
        bad_pol = [p for p in policy if p not in POLICIES]
        bad_tr = [t for t in traffic if t not in TRAFFIC_KINDS]
        if bad_pol or bad_tr:
            raise ValueError(f"serve_grid policy must be {POLICIES} and "
                             f"traffic {TRAFFIC_KINDS}; got "
                             f"{bad_pol + bad_tr}")
        if "jsonl" in traffic and not trace_path:
            raise KeyError("serve_grid traffic 'jsonl' needs trace_path")
        out: List[ServePoint] = []
        for t, e, d, pc in itertools.product(tp, ep, dp, pod):
            # arch/tp/ep/pod legality rides on the LM name validator
            # (registry arch, MoE-only ep, ...) — the cost model builds
            # exactly this name per step bucket
            parse_lm_name(lm_workload_name(
                arch, seq=prompt, batch=1, tp=t, ep=e,
                layers=layers, dp=1, pod=pc))
            for s, po, tr, r in itertools.product(slots, policy,
                                                  traffic, rate):
                tspec: Dict[str, Any] = {"kind": tr, "rate_rps": r,
                                         "n_requests": n_requests,
                                         "seed": seed}
                if tr == "bursty":
                    tspec.update(burst_x=burst_x, dwell_s=dwell_s)
                if tr == "jsonl":
                    tspec["path"] = trace_path
                name = (f"serve/{arch}/L{layers}/p{prompt}g{max_new}"
                        f"tp{t}" + (f"ep{e}" if e > 1 else "")
                        + f"dp{d}" + (f"pod{pc}" if pc else "")
                        + f"/s{s}kv{kv_capacity}/{po}/{tr}@r{r:g}")
                out.append(ServePoint(
                    workload=name,
                    params={"arch": arch, "layers": layers,
                            "prompt": prompt, "max_new": max_new,
                            "tp": t, "ep": e, "dp": d, "pod": pc,
                            "slots": int(s),
                            "kv_capacity": kv_capacity,
                            "policy": po, "max_queue": max_queue,
                            "traffic": tspec, "slo": slo},
                    overrides={"rate_rps": r, "policy": po,
                               "traffic": tr, "slots": int(s), "tp": t,
                               "ep": e, "dp": d, "pod": pc}))
        return out


@dataclass
class GridPoint:
    """One point of the campaign grid."""

    workload: str
    n_tiles: int
    overrides: Dict[str, Any]     # swept axis values (structural+analytic)
    structural: Dict[str, Any]

    def point_id(self) -> str:
        blob = json.dumps({"w": self.workload, "nt": self.n_tiles,
                           "ov": self.overrides}, sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:12]

    def cfg(self, spec: SweepSpec) -> HwConfig:
        return spec.hw_config(self.overrides)


@dataclass
class ServePoint:
    """One serving-fleet cell: a deployment under one traffic pattern.

    ``params`` carries everything ``serve.fleet.serve_payload`` needs
    beyond the spec-level plumbing (hw config, n_tiles, temp_c);
    ``overrides`` holds the swept axis values for the campaign record,
    mirroring ``GridPoint.overrides``.
    """

    workload: str
    params: Dict[str, Any]
    overrides: Dict[str, Any]

    def point_id(self) -> str:
        blob = json.dumps({"serve": self.params}, sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:12]


@dataclass
class SweepCell:
    """One structural cell: a shared task graph + its analytic sub-grid."""

    spec: SweepSpec
    workload: str
    n_tiles: int
    structural: Dict[str, Any]
    points: List[GridPoint]

    @property
    def label(self) -> str:
        s = ",".join(f"{k}={v}" for k, v in self.structural.items())
        return f"{self.workload}/t{self.n_tiles}" + (f"/{s}" if s else "")

    def base_cfg(self) -> HwConfig:
        """Cell compile config: base + structural overrides (analytic axes
        stay at their base values; they do not change the task graph)."""
        return self.spec.hw_config(self.structural)


# -- loading ---------------------------------------------------------------

def load_spec(path_or_name: str) -> SweepSpec:
    """Load a spec from a JSON file path, or by builtin name."""
    if os.path.exists(path_or_name):
        with open(path_or_name) as f:
            return SweepSpec.from_dict(json.load(f))
    return load_builtin_spec(path_or_name)


def load_builtin_spec(name: str) -> SweepSpec:
    p = os.path.join(BUILTIN_SPEC_DIR, f"{name}.json")
    if not os.path.exists(p):
        raise FileNotFoundError(
            f"no spec file and no builtin spec named {name!r}; "
            f"builtins: {builtin_spec_names()}")
    with open(p) as f:
        return SweepSpec.from_dict(json.load(f))


def builtin_spec_names() -> List[str]:
    if not os.path.isdir(BUILTIN_SPEC_DIR):
        return []
    return sorted(os.path.splitext(f)[0]
                  for f in os.listdir(BUILTIN_SPEC_DIR)
                  if f.endswith(".json"))
